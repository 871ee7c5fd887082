"""Llama-style decoder-only transformer, ``nos_tpu/models/llama.py`` in
PyTorch.

RMSNorm, rotate-half rotary embeddings, grouped-query attention and a
SwiGLU MLP, with the JAX model's numerics: activations in ``cfg.dtype``,
parameters stored in ``cfg.param_dtype`` (norm scales always fp32) and
cast to the activation dtype per matmul, fp32 norms, rope and softmax,
and tied-embedding logits in fp32 from activation-dtype inputs.

Attention is pluggable as in the JAX model: ``"dense"``
(``nos_tpu_torch.parallel.ring.dense_attention``), ``"flash"`` (the
Hopper kernels behind ``nos_tpu_torch.ops.attention.flash_attention``)
or ``"ring"`` (``ring_attention_local`` over the mesh's sp group).
``fused_qkv`` / ``fused_gate_up`` run one [E, H+2Hkv, D] and one [E, 2I]
projection, as in the JAX model.

Over a mesh (``Llama(cfg, mesh=...)``, a ``parallel.mesh.make_mesh``
DeviceMesh) each rank runs its own block of the work, where the JAX
model's arrays are global:

- sp: the rank holds a sequence shard; rope takes global positions, the
  loss's last local position predicts the next shard's first token, and
  the loss is the sp group's sum over the global ``bsz * (seq - 1)``.
  Only ring attention sees the other shards, so sp > 1 needs
  ``attn_impl="ring"`` (the kernels take no causal rectangle).
- tp: Megatron-style by hand.  q/k/v and gate/up hold the rank's output
  rows (its heads, its share of the MLP), o and down its input columns;
  an all-reduce over tp follows o and down, and its conjugate (identity
  forward, all-reduce backward) comes before q/k/v and gate/up.  The
  embedding and norm scales stay whole (``tp_slice`` cuts a full
  ``state_dict`` to a rank's share).

``forward(tokens, targets)`` returns the chunked next-token loss
(``_chunked_xent``).  With ``remat`` each layer is a selective
checkpoint region under grad: its outputs are recomputed in backward,
except those that ``remat_policy`` names (``_REMAT_POLICIES``), which
the projections, rope and the flash op produce as custom ops that carry
their checkpoint names.
``scan_layers`` only shapes the JAX parameter tree (see
``convert.params_from_jax``) and the layers always run as a loop.

Parameters are made empty on the module's device; ``init_params`` draws
them from an explicit ``torch.Generator`` and ``load_state_dict(...,
assign=True)`` installs them.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from nos_tpu_torch import resolve_device
from nos_tpu_torch.ops.attention import (FLASH_FWD_OP, flash_attention,
                                         repeat_kv)
from nos_tpu_torch.parallel.ring import dense_attention, ring_attention_local


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16     # activation dtype
    param_dtype: torch.dtype = torch.float32
    attn_impl: str = "dense"      # "dense" | "flash" | "ring"
    loss_chunk: int = 512
    remat: bool = True
    remat_policy: str = "nothing"
    scan_layers: bool = True
    fused_qkv: bool = False
    fused_gate_up: bool = False


# Llama-3-8B (meta-llama/Meta-Llama-3-8B).
LLAMA3_8B = LlamaConfig(
    vocab_size=128256, hidden_size=4096, intermediate_size=14336,
    num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
)

# Small configs for tests and the single-device bench.
TINY = LlamaConfig(
    vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
    num_heads=4, num_kv_heads=2, head_dim=16, max_seq_len=128,
    dtype=torch.float32,
)

# The flagship bench model: head_dim 128 makes it run the flash kernel.
BENCH_350M = LlamaConfig(
    vocab_size=32000, hidden_size=1024, intermediate_size=2816,
    num_layers=24, num_heads=8, num_kv_heads=4, head_dim=128,
    max_seq_len=2048,
)

# The JAX package's BENCH_350M training configuration: flash attention
# and the "rots" remat policy.
BENCH_350M_TRAIN = LlamaConfig(
    vocab_size=32000, hidden_size=1024, intermediate_size=2816,
    num_layers=24, num_heads=8, num_kv_heads=4, head_dim=128,
    max_seq_len=2048,
    attn_impl="flash", remat_policy="rots", scan_layers=True,
)


# What each remat policy keeps for the backward, by the JAX model's
# checkpoint names (nos_tpu/models/llama.py _REMAT_POLICIES); "dots" keeps
# every projection's output, and names the o and down projections, which
# the JAX model leaves unnamed, "attn_o" and "mlp_down".  Every named
# tensor is the output of one op that carries its name as its last
# argument, the op the policy sees: the projections (``LINEAR_OP``) and
# rope (``ROPE_OP``).  "attn_out" keeps the flash op's outputs (o, lse),
# so its kernel is not relaunched in backward; for dense attention it
# keeps nothing.
_REMAT_POLICIES: dict[str, frozenset[str]] = {
    "nothing": frozenset(),
    "dots": frozenset({"attn_q", "attn_k", "attn_v", "attn_qkv", "attn_o",
                       "mlp_gate", "mlp_up", "mlp_gate_up", "mlp_down"}),
    "attn": frozenset({"attn_out"}),
    "mlp": frozenset({"mlp_gate", "mlp_up", "mlp_gate_up"}),
    "mats": frozenset({"attn_out", "mlp_gate", "mlp_up", "mlp_gate_up"}),
    "all_mats": frozenset({"attn_q", "attn_k", "attn_v", "attn_qkv",
                           "attn_out", "mlp_gate", "mlp_up", "mlp_gate_up"}),
    "rots": frozenset({"attn_q_rot", "attn_k_rot", "attn_v", "attn_qkv",
                       "attn_out", "mlp_gate", "mlp_up", "mlp_gate_up"}),
}

# A selective checkpoint replays every op of its region in backward and
# skips only the kept ones, where XLA drops what nothing reads: a kept
# rotation would still rerun the projection it rotates.  So keeping
# attn_q_rot (attn_k_rot) keeps the q (k) projection's output as well,
# one more [B, S, H, D] ([B, S, Hkv, D]) per layer.
_KEPT_WITH = {"attn_q_rot": "attn_q", "attn_k_rot": "attn_k"}


@torch.library.custom_op("nos_tpu_torch::linear", mutates_args=())
def _linear_op(x: torch.Tensor, w: torch.Tensor, name: str) -> torch.Tensor:
    """x [..., in] . w [out, in]^T, named ``name`` for the remat policy."""
    return F.linear(x, w)


def _linear_setup(ctx, inputs, output):
    x, w, _ = inputs
    ctx.save_for_backward(x, w)


def _linear_backward(ctx, g):
    x, w = ctx.saved_tensors
    dw = g.reshape(-1, g.shape[-1]).t() @ x.reshape(-1, x.shape[-1])
    return g @ w, dw, None


_linear_op.register_autograd(_linear_backward, setup_context=_linear_setup)


@torch.library.custom_op("nos_tpu_torch::rope", mutates_args=())
def _rope_op(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
             name: str) -> torch.Tensor:
    """``_rope`` of x, named ``name`` for the remat policy."""
    return _rope(x, (cos, sin))


def _rope_setup(ctx, inputs, output):
    _, cos, sin, _ = inputs
    ctx.save_for_backward(cos, sin)


def _rope_backward(ctx, g):
    # The rotation's transpose: rotate by -angle, in fp32.
    cos, sin = ctx.saved_tensors
    return _rope(g, (cos, -sin)), None, None, None


_rope_op.register_autograd(_rope_backward, setup_context=_rope_setup)

# The ops as selective-checkpoint policies see them.
LINEAR_OP = torch.ops.nos_tpu_torch.linear.default
ROPE_OP = torch.ops.nos_tpu_torch.rope.default


def _remat_policy(saved: frozenset[str]):
    saved = saved | {_KEPT_WITH[n] for n in saved & _KEPT_WITH.keys()}

    def policy(ctx, func, *args, **kwargs):
        if func is FLASH_FWD_OP:
            keep = "attn_out" in saved
        elif func is LINEAR_OP or func is ROPE_OP:
            keep = args[-1] in saved
        else:
            keep = False
        return (CheckpointPolicy.MUST_SAVE if keep
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return policy


@dataclasses.dataclass(frozen=True)
class Parallel:
    """A rank's place on the model's mesh axes: the tp, sp and ep process
    groups, their sizes and the rank's index in each (no groups, sizes 1
    without a mesh)."""

    tp_group: object = None
    tp: int = 1
    tp_rank: int = 0
    sp_group: object = None
    sp: int = 1
    sp_rank: int = 0
    ep_group: object = None
    ep: int = 1
    ep_rank: int = 0

    @classmethod
    def of(cls, mesh) -> "Parallel":
        if mesh is None:
            return cls()
        return cls(*(x for ax in ("tp", "sp", "ep") for x in (
            mesh.get_group(ax), mesh[ax].size(), mesh[ax].get_local_rank())))


class _ToTP(torch.autograd.Function):
    """Identity forward, all-reduce of the gradient over tp backward:
    the input of a column-split projection."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _SumOver(torch.autograd.Function):
    """All-reduce (sum) over ``group`` forward, identity backward: the
    output of a row-split projection over tp, and the loss over sp (each
    rank's share of the sum depends on its own parameters only)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


# The dim of each weight that tp splits: the output rows of the
# column-split projections, the input columns of the row-split ones, and
# the MLP dim of the MoE experts' stacked [E, D, F] / [E, F, D] weights.
_TP_DIMS = {"q_proj": 0, "k_proj": 0, "v_proj": 0, "o_proj": 1,
            "gate_proj": 0, "up_proj": 0, "down_proj": 1}
EXPERT_WEIGHTS = ("w_gate", "w_up", "w_down")
_TP_EXPERT_DIMS = dict(zip(EXPERT_WEIGHTS, (2, 2, 1)))


def is_expert(name: str) -> bool:
    """Whether parameter ``name`` is an MoE layer's stacked expert
    weight (split over ep on dim 0)."""
    return name.rsplit(".", 1)[-1] in EXPERT_WEIGHTS


def tp_dim(name: str) -> int | None:
    """The dim of parameter ``name`` that tp splits, None if it is whole."""
    parts = name.split(".")
    if parts[-1] in _TP_EXPERT_DIMS:
        return _TP_EXPERT_DIMS[parts[-1]]
    return _TP_DIMS.get(parts[-2]) if len(parts) >= 2 else None


def tp_slice(state_dict: dict[str, torch.Tensor], tp: int, rank: int
             ) -> dict[str, torch.Tensor]:
    """Rank ``rank``'s share of a full ``state_dict`` under tp: the
    rank's contiguous block of each split dim (its heads, its share of
    the MLP), the rest whole."""
    out = {}
    for name, t in state_dict.items():
        dim = tp_dim(name)
        out[name] = t if dim is None or tp == 1 else \
            t.chunk(tp, dim=dim)[rank].contiguous()
    return out


def ep_slice(state_dict: dict[str, torch.Tensor], ep: int, rank: int
             ) -> dict[str, torch.Tensor]:
    """Rank ``rank``'s share of a full MoE ``state_dict`` under ep: its
    contiguous block of the experts (dim 0 of the stacked expert
    weights), the rest whole."""
    out = {}
    for name, t in state_dict.items():
        out[name] = t.chunk(ep, dim=0)[rank].contiguous() \
            if is_expert(name) and ep > 1 else t
    return out


def rope_tables(positions: torch.Tensor, dim: int, theta: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [B, S, 1, dim/2], computed once per forward and
    shared by every layer."""
    freqs = 1.0 / (theta ** (torch.arange(
        0, dim, 2, dtype=torch.float32, device=positions.device) / dim))
    angles = positions[:, :, None, None].float() * freqs
    return torch.cos(angles), torch.sin(angles)


def _rope(x: torch.Tensor, rope: tuple[torch.Tensor, torch.Tensor]
          ) -> torch.Tensor:
    """Rotary position embedding over the last dim of [B, S, H, D],
    rotate-half convention (pairs (i, i + D/2)), computed in fp32."""
    cos, sin = rope
    d2 = x.shape[-1] // 2
    x1 = x[..., :d2].float()
    x2 = x[..., d2:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5,
                 device: torch.device | None = None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(
            torch.empty(dim, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.eps)
        return (y * self.scale).to(x.dtype)


class Dense(nn.Module):
    """Bias-free projection, weight [out, in] in the parameter dtype, run
    in the activation dtype (flax DenseGeneral's dtype/param_dtype).
    ``name`` is the JAX checkpoint name a remat policy keeps this
    product's output under."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, param_dtype: torch.dtype,
                 device: torch.device | None, name: str):
        super().__init__()
        self.dtype = dtype
        self.name = name
        self.weight = nn.Parameter(torch.empty(
            out_features, in_features, dtype=param_dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear_op(x.to(self.dtype), self.weight.to(self.dtype),
                          self.name)


class Attention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device: torch.device | None = None,
                 par: Parallel = Parallel()):
        super().__init__()
        self.cfg, self.par = cfg, par
        e, hd = cfg.hidden_size, cfg.head_dim
        # this rank's heads
        self.nh, self.nkv = cfg.num_heads // par.tp, cfg.num_kv_heads // par.tp
        nh, nkv = self.nh, self.nkv
        args = (cfg.dtype, cfg.param_dtype, device)
        if cfg.fused_qkv:
            self.qkv_proj = Dense(e, (nh + 2 * nkv) * hd, *args,
                                  "attn_qkv")
        else:
            self.q_proj = Dense(e, nh * hd, *args, "attn_q")
            self.k_proj = Dense(e, nkv * hd, *args, "attn_k")
            self.v_proj = Dense(e, nkv * hd, *args, "attn_v")
        self.o_proj = Dense(nh * hd, e, *args, "attn_o")

    def forward(self, x: torch.Tensor,
                rope: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        cfg, par = self.cfg, self.par
        b, s, _ = x.shape
        nh, nkv, hd = self.nh, self.nkv, cfg.head_dim
        if par.tp > 1:
            x = _ToTP.apply(x, par.tp_group)
        if cfg.fused_qkv:
            qkv = self.qkv_proj(x).view(b, s, nh + 2 * nkv, hd)
            q, k, v = qkv[:, :, :nh], qkv[:, :, nh:nh + nkv], \
                qkv[:, :, nh + nkv:]
        else:
            q = self.q_proj(x).view(b, s, nh, hd)
            k = self.k_proj(x).view(b, s, nkv, hd)
            v = self.v_proj(x).view(b, s, nkv, hd)
        q = _rope_op(q, *rope, "attn_q_rot")
        k = _rope_op(k, *rope, "attn_k_rot")
        n_rep = cfg.num_heads // cfg.num_kv_heads
        k, v = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
        if cfg.attn_impl == "flash":
            out = flash_attention(q, k, v, True)
        elif cfg.attn_impl == "ring":
            out = ring_attention_local(q, k, v, par.sp_group, causal=True)
        else:
            out = dense_attention(q, k, v, causal=True)
        out = self.o_proj(out.reshape(b, s, nh * hd))
        return _SumOver.apply(out, par.tp_group) if par.tp > 1 else out


class MLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device: torch.device | None = None,
                 par: Parallel = Parallel()):
        super().__init__()
        self.cfg, self.par = cfg, par
        args = (cfg.dtype, cfg.param_dtype, device)
        e, i = cfg.hidden_size, cfg.intermediate_size // par.tp
        if cfg.fused_gate_up:
            self.gate_up_proj = Dense(e, 2 * i, *args, "mlp_gate_up")
        else:
            self.gate_proj = Dense(e, i, *args, "mlp_gate")
            self.up_proj = Dense(e, i, *args, "mlp_up")
        self.down_proj = Dense(i, e, *args, "mlp_down")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        par = self.par
        if par.tp > 1:
            x = _ToTP.apply(x, par.tp_group)
        if self.cfg.fused_gate_up:
            gate, up = self.gate_up_proj(x).chunk(2, dim=-1)
        else:
            gate, up = self.gate_proj(x), self.up_proj(x)
        out = self.down_proj(F.silu(gate) * up)
        return _SumOver.apply(out, par.tp_group) if par.tp > 1 else out


class Block(nn.Module):
    """One layer.  With ``remat_context`` (a selective-checkpoint context
    factory) its body is one checkpoint region under grad, taken inside
    the module's call, so hooks on the module (FSDP2's unshard and
    reshard) run outside the region."""

    def __init__(self, cfg: LlamaConfig, device: torch.device | None = None,
                 par: Parallel = Parallel(), remat_context=None):
        super().__init__()
        self.remat_context = remat_context
        self.attn_norm = RMSNorm(cfg.hidden_size, cfg.norm_eps, device)
        self.attn = Attention(cfg, device, par)
        self.mlp_norm = RMSNorm(cfg.hidden_size, cfg.norm_eps, device)
        self.mlp = MLP(cfg, device, par)

    def _body(self, x: torch.Tensor,
              rope: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        x = x + self.attn(self.attn_norm(x), rope)
        return x + self.mlp(self.mlp_norm(x))

    def forward(self, x: torch.Tensor,
                rope: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        if self.remat_context is not None and torch.is_grad_enabled():
            return checkpoint(self._body, x, rope, use_reentrant=False,
                              context_fn=self.remat_context)
        return self._body(x, rope)


def _product_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with an fp32 result.  On the card, a bf16/fp16 b makes it one
    product in b's dtype with fp32 output (a is rounded to b's dtype
    first); on the CPU both are upcast and the product is exact fp32."""
    if a.is_cuda and b.dtype != torch.float32:
        return torch.mm(a.to(b.dtype), b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _TiedHead(torch.autograd.Function):
    """fp32 logits [N, V] = x [N, E] . w [V, E]^T, both in the activation
    dtype: the JAX einsum with preferred_element_type=float32.  The
    gradients are the same products with the fp32 cotangent (rounded to
    the activation dtype on the card), returned in x's and w's dtypes as
    JAX's transpose rules return them."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _product_f32(x, w.t())

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return (_product_f32(g, w).to(x.dtype),
                _product_f32(g.t(), x).to(w.dtype))


def tied_logits(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """fp32 logits [..., V] of activations x [..., E] against the tied
    embedding already in the activation dtype."""
    lead = x.shape[:-1]
    return _TiedHead.apply(x.reshape(-1, x.shape[-1]), embed).view(
        *lead, embed.shape[0])


def _chunk_loss(x: torch.Tensor, embed: torch.Tensor, targets: torch.Tensor,
                start: int, seq: int) -> torch.Tensor:
    logits = tied_logits(x, embed)                       # [B, c, V] fp32
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    pos = torch.arange(start, start + x.shape[1], device=x.device)
    return ((lse - ll) * (pos < seq - 1)).sum()


def _next_tokens(tokens: torch.Tensor, par: Parallel) -> torch.Tensor:
    """The target of each position: the token after it in the global
    sequence.  Under sp the last local position's is the next shard's
    first token (the global last position's is masked out)."""
    targets = torch.roll(tokens, -1, dims=1)
    if par.sp > 1:
        firsts = [torch.empty_like(tokens[:, :1]) for _ in range(par.sp)]
        dist.all_gather(firsts, tokens[:, :1].contiguous(),
                        group=par.sp_group)
        targets[:, -1:] = firsts[(par.sp_rank + 1) % par.sp]
    return targets


def _chunked_xent(x: torch.Tensor, embed: torch.Tensor, tokens: torch.Tensor,
                  chunk: int, dtype: torch.dtype,
                  par: Parallel = Parallel()) -> torch.Tensor:
    """Next-token cross entropy with the tied head fused into the loss
    over sequence chunks, so the [B, S, vocab] fp32 logits never exist at
    once.  Each chunk is a checkpoint region: its logits are recomputed
    from the [B, chunk, E] activations in backward.  Position i predicts
    tokens[i+1]; the last position is masked out; the sum is normalised
    by bsz*(seq-1).  One chunk when seq % chunk or when there would be
    only one (``_chunked_xent`` in nos_tpu/models/llama.py).  Under sp,
    x and tokens are the rank's sequence shard, positions and the
    normaliser are global, and the result is summed over the sp group."""
    bsz, seq, _ = x.shape
    nch = seq // chunk if chunk else 1
    if nch <= 1 or seq % chunk:
        nch, chunk = 1, seq
    targets = _next_tokens(tokens, par)
    start, total_seq = par.sp_rank * seq, par.sp * seq
    w = embed.to(dtype)
    total = x.new_zeros((), dtype=torch.float32)
    for c in range(nch):
        sl = slice(c * chunk, (c + 1) * chunk)
        total = total + checkpoint(_chunk_loss, x[:, sl], w, targets[:, sl],
                                   start + c * chunk, total_seq,
                                   use_reentrant=False)
    total = total / (bsz * (total_seq - 1))
    return _SumOver.apply(total, par.sp_group) if par.sp > 1 else total


def _check_parallel(cfg: LlamaConfig, par: Parallel, mesh) -> None:
    if cfg.attn_impl not in ("dense", "flash", "ring"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}; one of "
                         f"'dense', 'flash', 'ring'")
    if cfg.attn_impl == "ring" and mesh is None:
        raise ValueError("ring attention needs a mesh")
    if par.sp > 1 and cfg.attn_impl != "ring":
        raise ValueError(
            f"sp={par.sp} needs attn_impl='ring': each rank holds a "
            f"sequence shard, and {cfg.attn_impl!r} attention would see "
            f"only its own")
    if par.tp > 1:
        if cfg.fused_qkv or cfg.fused_gate_up:
            raise ValueError(
                "fused_qkv / fused_gate_up under tp > 1: the split points "
                "are not shard boundaries (nos_tpu/models/llama.py)")
        for what in ("num_heads", "num_kv_heads", "intermediate_size"):
            if getattr(cfg, what) % par.tp:
                raise ValueError(f"{what}={getattr(cfg, what)} does not "
                                 f"divide over tp={par.tp}")


class Llama(nn.Module):
    """Decoder-only LM: forward(tokens [B, S] int) -> fp32 logits
    [B, S, vocab]; forward(tokens, targets) -> the scalar next-token loss
    of ``targets`` (the JAX model's ``__call__``; its trainer passes the
    tokens themselves).  Parameters are created empty on ``device``
    (``cuda`` when None); fill them with ``init_params`` or
    ``convert.params_from_jax`` (through ``tp_slice`` under tp).  Over
    ``mesh`` the rank runs its block of the batch, sequence and heads
    (see the module docstring)."""

    def __init__(self, cfg: LlamaConfig,
                 device: str | torch.device | None = None, mesh=None):
        super().__init__()
        if cfg.remat_policy not in _REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}; "
                             f"one of {sorted(_REMAT_POLICIES)}")
        par = Parallel.of(mesh)
        _check_parallel(cfg, par, mesh)
        if par.ep > 1:
            raise ValueError(
                f"ep={par.ep} shards experts, and a Llama has none: use "
                f"models.moe.MoELlama")
        dev = resolve_device(device)
        self.cfg, self.par = cfg, par
        remat_context = functools.partial(
            create_selective_checkpoint_contexts,
            _remat_policy(_REMAT_POLICIES[cfg.remat_policy])) \
            if cfg.remat else None
        self.embed = nn.Parameter(torch.empty(
            cfg.vocab_size, cfg.hidden_size, dtype=cfg.param_dtype,
            device=dev))
        self.layers = nn.ModuleList(
            Block(cfg, dev, par, remat_context)
            for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.norm_eps, dev)

    def forward(self, tokens: torch.Tensor,
                targets: torch.Tensor | None = None) -> torch.Tensor:
        cfg, par = self.cfg, self.par
        x = self.embed[tokens].to(cfg.dtype)
        seq = tokens.shape[1]
        positions = torch.arange(
            par.sp_rank * seq, (par.sp_rank + 1) * seq, dtype=torch.int32,
            device=tokens.device)[None].expand(tokens.shape)
        rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        for layer in self.layers:
            x = layer(x, rope)
        x = self.final_norm(x)
        if targets is not None:
            return _chunked_xent(x, self.embed, targets, cfg.loss_chunk,
                                 cfg.dtype, par)
        # Tied embeddings: activation-dtype inputs, fp32 logits.
        return tied_logits(x, self.embed.to(cfg.dtype))

    def param_count(self) -> int:
        cfg = self.cfg
        per_layer = (
            cfg.hidden_size * cfg.num_heads * cfg.head_dim
            + 2 * cfg.hidden_size * cfg.num_kv_heads * cfg.head_dim
            + cfg.num_heads * cfg.head_dim * cfg.hidden_size
            + 3 * cfg.hidden_size * cfg.intermediate_size
            + 2 * cfg.hidden_size
        )
        return (cfg.vocab_size * cfg.hidden_size
                + cfg.num_layers * per_layer + cfg.hidden_size)


class Draws:
    """flax's initializer distributions on an explicit generator: values
    drawn in fp32 on the generator's device, then cast on ``device``."""

    def __init__(self, generator: torch.Generator, device: torch.device):
        self.generator, self.device = generator, device

    def _draw(self, shape, fill, dtype: torch.dtype) -> torch.Tensor:
        t = torch.empty(shape, dtype=torch.float32,
                        device=self.generator.device)
        fill(t)
        return t.to(device=self.device, dtype=dtype)

    def normal(self, shape, std: float, dtype: torch.dtype) -> torch.Tensor:
        return self._draw(shape, lambda t: t.normal_(
            0.0, std, generator=self.generator), dtype)

    def lecun(self, shape, fan_in: int, dtype: torch.dtype) -> torch.Tensor:
        """flax lecun_normal: a truncated normal on [-2, 2] std, rescaled
        so the truncated draw keeps variance 1/fan_in."""
        std = math.sqrt(1.0 / fan_in) / .87962566103423978
        return self._draw(shape, lambda t: nn.init.trunc_normal_(
            t, 0.0, std, -2 * std, 2 * std, generator=self.generator), dtype)

    def ones(self, dim: int) -> torch.Tensor:
        return torch.ones(dim, dtype=torch.float32, device=self.device)


def init_attention(sd: dict[str, torch.Tensor], prefix: str,
                   cfg: LlamaConfig, draws: Draws) -> None:
    """One layer's attention norm and projections into ``sd``."""
    e, hd, pd = cfg.hidden_size, cfg.head_dim, cfg.param_dtype
    sd[prefix + "attn_norm.scale"] = draws.ones(e)
    if cfg.fused_qkv:
        sd[prefix + "attn.qkv_proj.weight"] = draws.lecun(
            ((cfg.num_heads + 2 * cfg.num_kv_heads) * hd, e), e, pd)
    else:
        sd[prefix + "attn.q_proj.weight"] = draws.lecun(
            (cfg.num_heads * hd, e), e, pd)
        for proj in ("k_proj", "v_proj"):
            sd[prefix + f"attn.{proj}.weight"] = draws.lecun(
                (cfg.num_kv_heads * hd, e), e, pd)
    sd[prefix + "attn.o_proj.weight"] = draws.lecun(
        (e, cfg.num_heads * hd), cfg.num_heads * hd, pd)


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device: str | torch.device | None = None
                ) -> dict[str, torch.Tensor]:
    """A seeded ``state_dict`` for ``Llama(cfg)`` with flax's initializer
    distributions: embed normal(0.02), projection weights lecun-normal
    (truncated normal, variance 1/fan_in), norm scales ones.  Values are
    drawn in fp32 on the generator's device, then cast to the parameter
    dtype on ``device`` (``cuda`` when None).  The bits do not match
    flax's."""
    draws = Draws(generator, resolve_device(device))
    e, i, pd = cfg.hidden_size, cfg.intermediate_size, cfg.param_dtype
    sd = {"embed": draws.normal((cfg.vocab_size, e), 0.02, pd)}
    for n in range(cfg.num_layers):
        p = f"layers.{n}."
        init_attention(sd, p, cfg, draws)
        sd[p + "mlp_norm.scale"] = draws.ones(e)
        if cfg.fused_gate_up:
            sd[p + "mlp.gate_up_proj.weight"] = draws.lecun((2 * i, e), e, pd)
        else:
            sd[p + "mlp.gate_proj.weight"] = draws.lecun((i, e), e, pd)
            sd[p + "mlp.up_proj.weight"] = draws.lecun((i, e), e, pd)
        sd[p + "mlp.down_proj.weight"] = draws.lecun((e, i), i, pd)
    sd["final_norm.scale"] = draws.ones(e)
    return sd
