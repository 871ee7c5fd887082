"""Attention over the sequence: the plain reference and ring attention,
``nos_tpu/parallel/ring.py`` over ``torch.distributed``.

``dense_attention`` is the plain O(S^2) attention, the
``attn_impl="dense"`` path and the ground truth for the flash kernel.

``ring_attention_local`` is sequence parallelism over the ``sp`` process
group: each rank holds its own [B, Sl, H, D] shard of q, k and v; q
stays, and the K/V shards travel one hop per step (rank i -> i + 1 by
``batch_isend_irecv``), with an online softmax so the [S, S] scores
never exist.  Causal masking is by *global* position, so the result is
dense attention on the gathered sequence.  The block products are plain
PyTorch in fp32, as in the JAX package (no kernel is involved).

P2P ops have no autograd, so the ring is one ``autograd.Function`` with
its own backward ring: dq stays local, and each K/V shard travels again
with its dk/dv accumulators, which reach home after n hops.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_NEG_INF = -1e30


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Reference O(S^2) attention, [B, S, H, D] layout, fp32 softmax.

    Scores accumulate in fp32, masked entries take -1e30 (a fully masked
    row is uniform, never NaN), causal alignment is bottom-right
    (``tril(k=sk-sq)``), and p is cast to v's dtype before P.V, whose
    product accumulates in fp32 before the cast back."""
    d = q.shape[-1]
    scale = d ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        mask = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril(
            sk - sq)
        s = torch.where(mask, s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(),
                        v.float()).to(v.dtype)


class _Ring:
    """One rank's place in the sp ring: it sends to the next rank and
    receives from the previous one."""

    def __init__(self, group) -> None:
        self.group = group
        self.n = dist.get_world_size(group)
        self.my = dist.get_rank(group)
        self.next = dist.get_global_rank(group, (self.my + 1) % self.n)
        self.prev = dist.get_global_rank(group, (self.my - 1) % self.n)

    def start(self, tensors: list[torch.Tensor]):
        """Issue one hop of ``tensors``; ``finish`` returns what arrived."""
        tensors = [t.contiguous() for t in tensors]
        recv = [torch.empty_like(t) for t in tensors]
        ops = [dist.P2POp(dist.isend, t, self.next, self.group)
               for t in tensors]
        ops += [dist.P2POp(dist.irecv, r, self.prev, self.group)
                for r in recv]
        return dist.batch_isend_irecv(ops), recv

    @staticmethod
    def finish(pending) -> list[torch.Tensor]:
        works, recv = pending
        for w in works:
            w.wait()
        return recv


def _block_scores(qf, kb, causal, q_pos, src, sl):
    """Scaled fp32 scores [B, H, Sl, Sl] of q against the K block that
    came from ring position ``src``, and the causal mask in global
    positions (None when not causal)."""
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kb.float())
    if not causal:
        return s, None
    k_pos = src * sl + torch.arange(sl, device=qf.device)[None]
    mask = q_pos >= k_pos
    return torch.where(mask, s, _NEG_INF), mask


class _RingAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, group, causal: bool, overlap: bool):
        ring = _Ring(group)
        n, my = ring.n, ring.my
        b, sl, h, d = q.shape
        qf = q.float() * d ** -0.5
        q_pos = my * sl + torch.arange(sl, device=q.device)[:, None]
        m = torch.full((b, h, sl, 1), _NEG_INF, device=q.device)
        l = torch.zeros((b, h, sl, 1), device=q.device)
        acc = torch.zeros((b, h, sl, d), device=q.device)
        kb, vb = k, v
        for step in range(n):
            last = step == n - 1
            # with overlap the next shard's hop is in flight during this
            # shard's products; the products read the shard held now, so
            # the numbers are the same either way
            pending = ring.start([kb, vb]) if overlap and not last else None
            s, mask = _block_scores(qf, kb, causal, q_pos, (my - step) % n,
                                    sl)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            if causal:
                p = torch.where(mask, p, 0.0)       # fully masked rows
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + torch.einsum("bhqk,bkhd->bhqd", p, vb.float())
            m = m_new
            if not last:
                kb, vb = ring.finish(pending or ring.start([kb, vb]))
        out = acc / torch.clamp(l, min=1e-20)
        ctx.save_for_backward(q, k, v, out, m + torch.log(l))
        ctx.ring, ctx.causal, ctx.overlap = ring, causal, overlap
        return out.permute(0, 2, 1, 3).to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        ring, causal, overlap = ctx.ring, ctx.causal, ctx.overlap
        n, my = ring.n, ring.my
        b, sl, h, d = q.shape
        scale = d ** -0.5
        qf = q.float() * scale
        q_pos = my * sl + torch.arange(sl, device=q.device)[:, None]
        do = dout.float().permute(0, 2, 1, 3)                  # [B, H, Sl, D]
        delta = (do * out).sum(-1, keepdim=True)
        dq = torch.zeros_like(out)
        kb, vb = k, v
        dkb = torch.zeros(k.shape, device=k.device)
        dvb = torch.zeros(v.shape, device=v.device)
        for step in range(n):
            last = step == n - 1
            pending = ring.start([kb, vb]) if overlap and not last else None
            s, mask = _block_scores(qf, kb, causal, q_pos, (my - step) % n,
                                    sl)
            p = torch.exp(s - lse)
            if causal:
                p = torch.where(mask, p, 0.0)
            dp = torch.einsum("bhqd,bkhd->bhqk", do, vb.float())
            ds = p * (dp - delta)
            dq += torch.einsum("bhqk,bkhd->bhqd", ds, kb.float())
            dkb += torch.einsum("bhqk,bqhd->bkhd", ds, qf)
            dvb += torch.einsum("bhqk,bhqd->bkhd", p, do)
            if not last:
                kb, vb = ring.finish(pending or ring.start([kb, vb]))
            # dk/dv travel after their K/V shard, one hop behind it; after
            # the n-th hop each rank holds its own shard's sums
            if n > 1:
                dkb, dvb = ring.finish(ring.start([dkb, dvb]))
        dq = (dq * scale).permute(0, 2, 1, 3).to(q.dtype)
        return dq, dkb.to(k.dtype), dvb.to(v.dtype), None, None, None


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         group=None, causal: bool = True,
                         overlap: bool = True) -> torch.Tensor:
    """This rank's shard of ring attention over ``group`` (the sp process
    group; the default group when None): q, k, v are the local sequence
    shards [B, Sl, H, D], shard i holding global positions [i*Sl,
    (i+1)*Sl); K/V must already have full (repeated) heads under
    grouped-query attention.  Returns the local [B, Sl, H, D] output in
    q's dtype.  Differentiable; every rank of the group must call it."""
    group = dist.group.WORLD if group is None else group
    return _RingAttention.apply(q, k, v, group, causal, overlap)


def ring_attention(mesh, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True, seq_axis: str = "sp",
                   overlap: bool = True) -> torch.Tensor:
    """``ring_attention_local`` over the ``seq_axis`` dim of ``mesh`` (a
    ``parallel.mesh.make_mesh`` DeviceMesh).  q, k, v are this rank's
    blocks: its rows of the batch (dp, fsdp), its sequence shard (sp) and
    its heads (tp), as the JAX wrapper's shard_map hands them out."""
    return ring_attention_local(q, k, v, mesh.get_group(seq_axis), causal,
                                overlap)
