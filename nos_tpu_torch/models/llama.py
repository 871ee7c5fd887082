"""Llama-style decoder-only transformer, ``nos_tpu/models/llama.py`` in
PyTorch.

RMSNorm, rotate-half rotary embeddings, grouped-query attention and a
SwiGLU MLP, with the JAX model's numerics: activations in ``cfg.dtype``,
parameters stored in ``cfg.param_dtype`` (norm scales always fp32) and
cast to the activation dtype per matmul, fp32 norms, rope and softmax,
and tied-embedding logits in fp32 from activation-dtype inputs.

Attention is pluggable as in the JAX model: ``"dense"``
(``nos_tpu_torch.parallel.ring.dense_attention``) or ``"flash"`` (the
Hopper kernels behind ``nos_tpu_torch.ops.attention.flash_attention``);
``"ring"`` is a later slice and raises NotImplementedError.
``fused_qkv`` / ``fused_gate_up`` run one [E, H+2Hkv, D] and one [E, 2I]
projection, as in the JAX model.

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
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from nos_tpu_torch import resolve_device
from nos_tpu_torch.ops.attention import (FLASH_FWD_OP, flash_attention,
                                         repeat_kv)
from nos_tpu_torch.parallel.ring import dense_attention


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
    attn_impl: str = "dense"      # "dense" | "flash" ("ring": later slice)
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
    def __init__(self, cfg: LlamaConfig, device: torch.device | None = None):
        super().__init__()
        self.cfg = cfg
        e, hd = cfg.hidden_size, cfg.head_dim
        nh, nkv = cfg.num_heads, cfg.num_kv_heads
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
        cfg = self.cfg
        b, s, _ = x.shape
        nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
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
        else:
            out = dense_attention(q, k, v, causal=True)
        return self.o_proj(out.reshape(b, s, cfg.num_heads * cfg.head_dim))


class MLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device: torch.device | None = None):
        super().__init__()
        self.cfg = cfg
        args = (cfg.dtype, cfg.param_dtype, device)
        e, i = cfg.hidden_size, cfg.intermediate_size
        if cfg.fused_gate_up:
            self.gate_up_proj = Dense(e, 2 * i, *args, "mlp_gate_up")
        else:
            self.gate_proj = Dense(e, i, *args, "mlp_gate")
            self.up_proj = Dense(e, i, *args, "mlp_up")
        self.down_proj = Dense(i, e, *args, "mlp_down")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.fused_gate_up:
            gate, up = self.gate_up_proj(x).chunk(2, dim=-1)
        else:
            gate, up = self.gate_proj(x), self.up_proj(x)
        return self.down_proj(F.silu(gate) * up)


class Block(nn.Module):
    def __init__(self, cfg: LlamaConfig, device: torch.device | None = None):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.hidden_size, cfg.norm_eps, device)
        self.attn = Attention(cfg, device)
        self.mlp_norm = RMSNorm(cfg.hidden_size, cfg.norm_eps, device)
        self.mlp = MLP(cfg, device)

    def forward(self, x: torch.Tensor,
                rope: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        x = x + self.attn(self.attn_norm(x), rope)
        return x + self.mlp(self.mlp_norm(x))


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


def _chunked_xent(x: torch.Tensor, embed: torch.Tensor, tokens: torch.Tensor,
                  chunk: int, dtype: torch.dtype) -> torch.Tensor:
    """Next-token cross entropy with the tied head fused into the loss
    over sequence chunks, so the [B, S, vocab] fp32 logits never exist at
    once.  Each chunk is a checkpoint region: its logits are recomputed
    from the [B, chunk, E] activations in backward.  Position i predicts
    tokens[i+1]; the last position is masked out; the sum is normalised
    by bsz*(seq-1).  One chunk when seq % chunk or when there would be
    only one (``_chunked_xent`` in nos_tpu/models/llama.py)."""
    bsz, seq, _ = x.shape
    nch = seq // chunk if chunk else 1
    if nch <= 1 or seq % chunk:
        nch, chunk = 1, seq
    targets = torch.roll(tokens, -1, dims=1)
    w = embed.to(dtype)
    total = x.new_zeros((), dtype=torch.float32)
    for c in range(nch):
        sl = slice(c * chunk, (c + 1) * chunk)
        total = total + checkpoint(_chunk_loss, x[:, sl], w, targets[:, sl],
                                   c * chunk, seq, use_reentrant=False)
    return total / (bsz * (seq - 1))


class Llama(nn.Module):
    """Decoder-only LM: forward(tokens [B, S] int) -> fp32 logits
    [B, S, vocab]; forward(tokens, targets) -> the scalar next-token loss
    of ``targets`` (the JAX model's ``__call__``; its trainer passes the
    tokens themselves).  Parameters are created empty on ``device``
    (``cuda`` when None); fill them with ``init_params`` or
    ``convert.params_from_jax``."""

    def __init__(self, cfg: LlamaConfig,
                 device: str | torch.device | None = None):
        super().__init__()
        if cfg.attn_impl not in ("dense", "flash"):
            raise NotImplementedError(
                f"attn_impl {cfg.attn_impl!r}: the port has 'dense' and "
                f"'flash' (ring attention is a later slice)")
        if cfg.remat_policy not in _REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}; "
                             f"one of {sorted(_REMAT_POLICIES)}")
        dev = resolve_device(device)
        self.cfg = cfg
        self._remat_context = functools.partial(
            create_selective_checkpoint_contexts,
            _remat_policy(_REMAT_POLICIES[cfg.remat_policy]))
        self.embed = nn.Parameter(torch.empty(
            cfg.vocab_size, cfg.hidden_size, dtype=cfg.param_dtype,
            device=dev))
        self.layers = nn.ModuleList(
            Block(cfg, dev) for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.norm_eps, dev)

    def forward(self, tokens: torch.Tensor,
                targets: torch.Tensor | None = None) -> torch.Tensor:
        cfg = self.cfg
        x = self.embed[tokens].to(cfg.dtype)
        positions = torch.arange(
            tokens.shape[1], dtype=torch.int32,
            device=tokens.device)[None].expand(tokens.shape)
        rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        remat = cfg.remat and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                x = checkpoint(layer, x, rope, use_reentrant=False,
                               context_fn=self._remat_context)
            else:
                x = layer(x, rope)
        x = self.final_norm(x)
        if targets is not None:
            return _chunked_xent(x, self.embed, targets, cfg.loss_chunk,
                                 cfg.dtype)
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


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device: str | torch.device | None = None
                ) -> dict[str, torch.Tensor]:
    """A seeded ``state_dict`` for ``Llama(cfg)`` with flax's initializer
    distributions: embed normal(0.02), projection weights lecun-normal
    (truncated normal, variance 1/fan_in), norm scales ones.  Values are
    drawn in fp32 on the generator's device, then cast to the parameter
    dtype on ``device`` (``cuda`` when None).  The bits do not match
    flax's."""
    dev = resolve_device(device)
    gen_dev = generator.device

    def draw(shape, fill):
        t = torch.empty(shape, dtype=torch.float32, device=gen_dev)
        fill(t)
        return t.to(device=dev, dtype=cfg.param_dtype)

    def lecun(out_f, in_f):
        # flax lecun_normal: truncated normal on [-2, 2] std, rescaled so
        # the truncated draw keeps variance 1/fan_in.
        std = math.sqrt(1.0 / in_f) / .87962566103423978
        return draw((out_f, in_f), lambda t: nn.init.trunc_normal_(
            t, 0.0, std, -2 * std, 2 * std, generator=generator))

    def ones():
        return torch.ones(cfg.hidden_size, dtype=torch.float32, device=dev)

    e, hd, i = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size
    sd = {"embed": draw((cfg.vocab_size, e), lambda t: t.normal_(
        0.0, 0.02, generator=generator))}
    for n in range(cfg.num_layers):
        p = f"layers.{n}."
        sd[p + "attn_norm.scale"] = ones()
        if cfg.fused_qkv:
            sd[p + "attn.qkv_proj.weight"] = lecun(
                (cfg.num_heads + 2 * cfg.num_kv_heads) * hd, e)
        else:
            sd[p + "attn.q_proj.weight"] = lecun(cfg.num_heads * hd, e)
            sd[p + "attn.k_proj.weight"] = lecun(cfg.num_kv_heads * hd, e)
            sd[p + "attn.v_proj.weight"] = lecun(cfg.num_kv_heads * hd, e)
        sd[p + "attn.o_proj.weight"] = lecun(e, cfg.num_heads * hd)
        sd[p + "mlp_norm.scale"] = ones()
        if cfg.fused_gate_up:
            sd[p + "mlp.gate_up_proj.weight"] = lecun(2 * i, e)
        else:
            sd[p + "mlp.gate_proj.weight"] = lecun(i, e)
            sd[p + "mlp.up_proj.weight"] = lecun(i, e)
        sd[p + "mlp.down_proj.weight"] = lecun(e, i)
    sd["final_norm.scale"] = ones()
    return sd
