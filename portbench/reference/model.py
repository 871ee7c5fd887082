"""The models' loss in plain fp32 PyTorch, computed in blocks so that a
cell's whole step fits on one card: each layer is a checkpoint region
(recomputed in backward), and inside it attention runs one (batch row,
KV head, query block) at a time and the MLP and the loss one block of
rows at a time, each a checkpoint region of its own.

Dense (Mistral): RMSNorm, rotate-half RoPE, causal grouped-query softmax
attention, SwiGLU, a tied output head, the next-token cross entropy
averaged over batch x (seq - 1) positions.  MoE (Mixtral): the MLP is a
softmax router over the experts, the top_k choices with their gates
renormalised, each expert's buffer of capacity max(1, ceil(T top_k / E
capacity_factor)) filled in token-major order (choices past it dropped),
and the Switch term E sum_e top1_e mean(probs)_e times the aux weight per
layer, added to the loss.

``Numerics(fp8=True)`` is the control, in the usual fp8 training recipe:
every tensor the program holds in bf16 (the residual stream, norm
outputs, products' inputs and outputs, attention's probabilities and
output, the experts' combined output) is rounded to float8 e4m3 in the
forward pass, and the gradient that flows back through it to float8
e5m2, each with a per-tensor scale (amax to the format's largest);
scores, softmax, the router's logits and the loss stay fp32, as the
program keeps them."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

# fp32 elements of one attention block's scores
_SCORE_BUDGET = 1 << 27
_ROWS = 8192


def _ckpt(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False)


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x through ``dtype`` with a per-tensor scale, back in fp32."""
    scale = torch.finfo(dtype).max / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).float() / scale


class _Fp8(torch.autograd.Function):
    """Forward values in e4m3, the gradient flowing back in e5m2."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, torch.float8_e5m2)


class Numerics:
    """How the reference rounds the inputs of its products."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def r(self, x: torch.Tensor) -> torch.Tensor:
        """x as the activation dtype holds it, and its gradient alike."""
        return _Fp8.apply(x) if self.fp8 else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """A product with its inputs and output in the activation dtype."""
        return self.r(self.r(a) @ self.r(b))


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope_tables(seq: int, dim: int, theta: float, device
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos, sin [seq, 1, dim/2] of position p at frequency
    theta^(-2i/dim), computed in float64."""
    inv = theta ** (-torch.arange(0, dim, 2, dtype=torch.float64,
                                  device=device) / dim)
    ang = torch.arange(seq, dtype=torch.float64, device=device)[:, None] * inv
    return (torch.cos(ang).float()[:, None, :],
            torch.sin(ang).float()[:, None, :])


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
         ) -> torch.Tensor:
    """Rotate-half rotary embedding of [..., S, H, D] (pairs i, i + D/2)."""
    h = x.shape[-1] // 2
    x1, x2 = x[..., :h], x[..., h:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attn_block(q, k, v, q0: int, num: Numerics):
    """Causal softmax attention of query rows q0.. [Q, G, D] against keys
    and values [K, D] (K = q0 + Q): out [Q, G, D]."""
    d = q.shape[-1]
    s = torch.einsum("qgd,kd->gqk", num.r(q), num.r(k)) / math.sqrt(d)
    rows = torch.arange(q0, q0 + q.shape[0], device=q.device)[:, None]
    cols = torch.arange(k.shape[0], device=q.device)[None, :]
    s = s.masked_fill(cols > rows, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return num.r(torch.einsum("gqk,kd->qgd", num.r(p), num.r(v)))


def attention(q, k, v, num: Numerics) -> torch.Tensor:
    """Causal grouped-query attention, q [B, S, Hq, D], k and v
    [B, S, Hkv, D] -> [B, S, Hq, D], a block at a time."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qb = max(128, min(s, _SCORE_BUDGET // (g * s)) // 128 * 128)
    rows = []
    for i in range(b):
        heads = []
        for h in range(hkv):
            blocks = []
            for q0 in range(0, s, qb):
                q1 = min(s, q0 + qb)
                blocks.append(_ckpt(
                    lambda qq, kk, vv, q0=q0: _attn_block(qq, kk, vv, q0, num),
                    q[i, q0:q1, h * g:(h + 1) * g], k[i, :q1, h],
                    v[i, :q1, h]))
            heads.append(torch.cat(blocks, dim=0))
        rows.append(torch.cat(heads, dim=1))
    return torch.stack(rows)


def _by_rows(fn, x: torch.Tensor) -> torch.Tensor:
    """fn over [N, ...] in blocks of rows, each a checkpoint region."""
    return torch.cat([_ckpt(fn, x[i:i + _ROWS])
                      for i in range(0, x.shape[0], _ROWS)])


def swiglu(x, w_gate, w_up, w_down, num: Numerics):
    """x [N, E] through SwiGLU with weights in the [E, F] / [F, E]
    layout of the experts (``x @ w``)."""
    def fn(rows):
        return num.mm(num.r(F.silu(num.mm(rows, w_gate))
                            * num.mm(rows, w_up)), w_down)
    return _by_rows(fn, x)


def attention_block(x, p: dict, pre: str, spec, cos, sin, num: Numerics):
    b, s, e = x.shape
    hd = spec.head_dim
    h = num.r(rms_norm(x, p[pre + "attn_norm.scale"], spec.norm_eps))
    q = num.mm(h, p[pre + "attn.q_proj.weight"].t()).view(b, s, -1, hd)
    k = num.mm(h, p[pre + "attn.k_proj.weight"].t()).view(b, s, -1, hd)
    v = num.mm(h, p[pre + "attn.v_proj.weight"].t()).view(b, s, -1, hd)
    o = attention(num.r(rope(q, cos, sin)), num.r(rope(k, cos, sin)), v,
                  num)
    return num.r(x + num.mm(o.reshape(b, s, -1),
                            p[pre + "attn.o_proj.weight"].t()))


def capacity(spec, tokens: int) -> int:
    return max(1, math.ceil(tokens * spec.top_k / spec.num_experts
                            * spec.capacity_factor))


def moe_mlp(h: torch.Tensor, p: dict, pre: str, spec, num: Numerics
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The routed experts on h [T, E]: (y [T, E], the layer's aux term)."""
    t, e = h.shape
    ne, k = spec.num_experts, spec.top_k
    probs = torch.softmax(h @ p[pre + "moe.router.weight"].t(), dim=-1)
    vals, idx = torch.topk(probs, k, dim=-1)
    gates = vals / vals.sum(-1, keepdim=True).clamp(min=1e-9)
    cap = capacity(spec, t)
    flat = idx.reshape(-1)                                  # token-major
    onehot = F.one_hot(flat, ne)
    position = ((torch.cumsum(onehot, 0) - 1) * onehot).sum(-1)
    kept = position < cap
    y = torch.zeros_like(h)
    token = torch.arange(t, device=h.device).repeat_interleave(k)
    for x in range(ne):
        sel = torch.nonzero((flat == x) & kept).squeeze(1)
        if sel.numel() == 0:
            continue
        rows = token[sel]
        out = swiglu(h[rows], p[pre + "moe.experts.w_gate"][x],
                     p[pre + "moe.experts.w_up"][x],
                     p[pre + "moe.experts.w_down"][x], num)
        y = y.index_add(0, rows, out * gates.reshape(-1)[sel][:, None])
    top1 = torch.bincount(idx[:, 0], minlength=ne).float() / t
    aux = spec.router_aux_weight * ne * (top1 * probs.mean(0)).sum()
    return y, aux


def layer(x, p: dict, n: int, spec, cos, sin, num: Numerics):
    """Layer n on x [B, S, E]: (x, its aux term, 0 for a dense layer)."""
    pre = f"layers.{n}."
    x = attention_block(x, p, pre, spec, cos, sin, num)
    b, s, e = x.shape
    if spec.family == "moe":
        h = num.r(rms_norm(x, p[pre + "moe_norm.scale"], spec.norm_eps))
        y, aux = moe_mlp(h.reshape(-1, e), p, pre, spec, num)
        return num.r(x + num.r(y).view(b, s, e)), aux
    h = num.r(rms_norm(x, p[pre + "mlp_norm.scale"], spec.norm_eps))
    y = swiglu(h.reshape(-1, e), p[pre + "mlp.gate_proj.weight"].t(),
               p[pre + "mlp.up_proj.weight"].t(),
               p[pre + "mlp.down_proj.weight"].t(), num)
    return num.r(x + y.view(b, s, e)), x.new_zeros(())


def loss(p: dict, tokens: torch.Tensor, spec, num: Numerics) -> torch.Tensor:
    """The training loss of tokens [B, S]: the mean next-token cross
    entropy of the tied head over B x (S - 1) positions, plus the layers'
    aux terms."""
    b, s = tokens.shape
    cos, sin = rope_tables(s, spec.head_dim, spec.rope_theta, tokens.device)
    x = num.r(p["embed"][tokens.long()])
    aux = x.new_zeros(())
    for n in range(spec.num_layers):
        x, a = _ckpt(lambda xx, n=n: layer(xx, p, n, spec, cos, sin, num), x)
        aux = aux + a
    x = num.r(rms_norm(x, p["final_norm.scale"], spec.norm_eps))[:, :-1]
    targets = tokens[:, 1:].long()
    total = x.new_zeros(())
    chunk = max(1, _ROWS // b)
    for c in range(0, s - 1, chunk):
        def xent(xc, tc):
            logits = num.r(xc) @ num.r(p["embed"].t())      # fp32 logits
            return (torch.logsumexp(logits, -1)
                    - logits.gather(-1, tc[..., None])[..., 0]).sum()
        total = total + _ckpt(xent, x[:, c:c + chunk], targets[:, c:c + chunk])
    return total / (b * (s - 1)) + aux
