"""Llama-style decoder-only transformer, the inference subset of
``nos_tpu/models/llama.py`` in PyTorch.

RMSNorm, rotate-half rotary embeddings, grouped-query attention and a
SwiGLU MLP, with the JAX model's numerics: activations in ``cfg.dtype``,
parameters stored in ``cfg.param_dtype`` (norm scales always fp32) and
cast to the activation dtype per matmul, fp32 norms, rope and softmax,
and tied-embedding logits accumulated and returned in fp32.

Attention is pluggable as in the JAX model: ``"dense"``
(``nos_tpu_torch.parallel.ring.dense_attention``) or ``"flash"`` (the
Hopper kernel behind ``nos_tpu_torch.ops.attention.flash_attention``).

What belongs to the training slice raises NotImplementedError: the fused
q/k/v and gate/up projections, the chunked loss (``targets``), and ring
attention.  ``remat``/``remat_policy`` only shape the backward and are
accepted and ignored; ``scan_layers`` only shapes the JAX parameter tree
(see ``convert.params_from_jax``) and the layers always run as a loop.

Parameters are made empty on the module's device; ``init_params`` draws
them from an explicit ``torch.Generator`` and ``load_state_dict(...,
assign=True)`` installs them.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from nos_tpu_torch import resolve_device
from nos_tpu_torch.ops.attention import flash_attention, repeat_kv
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

# The JAX package's measured-best BENCH_350M training configuration; its
# remat policy is accepted and ignored at inference.
BENCH_350M_TRAIN = LlamaConfig(
    vocab_size=32000, hidden_size=1024, intermediate_size=2816,
    num_layers=24, num_heads=8, num_kv_heads=4, head_dim=128,
    max_seq_len=2048,
    attn_impl="flash", remat_policy="rots", scan_layers=True,
)


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
    in the activation dtype (flax DenseGeneral's dtype/param_dtype)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, param_dtype: torch.dtype,
                 device: torch.device | None = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            out_features, in_features, dtype=param_dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype))


class Attention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device: torch.device | None = None):
        super().__init__()
        self.cfg = cfg
        e, hd = cfg.hidden_size, cfg.head_dim
        args = (cfg.dtype, cfg.param_dtype, device)
        self.q_proj = Dense(e, cfg.num_heads * hd, *args)
        self.k_proj = Dense(e, cfg.num_kv_heads * hd, *args)
        self.v_proj = Dense(e, cfg.num_kv_heads * hd, *args)
        self.o_proj = Dense(cfg.num_heads * hd, e, *args)

    def forward(self, x: torch.Tensor,
                rope: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        b, s, _ = x.shape
        q = self.q_proj(x).view(b, s, cfg.num_heads, cfg.head_dim)
        k = self.k_proj(x).view(b, s, cfg.num_kv_heads, cfg.head_dim)
        v = self.v_proj(x).view(b, s, cfg.num_kv_heads, cfg.head_dim)
        q, k = _rope(q, rope), _rope(k, rope)
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
        args = (cfg.dtype, cfg.param_dtype, device)
        e, i = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = Dense(e, i, *args)
        self.up_proj = Dense(e, i, *args)
        self.down_proj = Dense(i, e, *args)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


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


class Llama(nn.Module):
    """Decoder-only LM: forward(tokens [B, S] int) -> fp32 logits
    [B, S, vocab].  Parameters are created empty on ``device`` (``cuda``
    when None); fill them with ``init_params`` or
    ``convert.params_from_jax``."""

    def __init__(self, cfg: LlamaConfig,
                 device: str | torch.device | None = None):
        super().__init__()
        if cfg.fused_qkv or cfg.fused_gate_up:
            raise NotImplementedError(
                "fused_qkv / fused_gate_up are the training slice's work")
        if cfg.attn_impl not in ("dense", "flash"):
            raise NotImplementedError(
                f"attn_impl {cfg.attn_impl!r}: the port has 'dense' and "
                f"'flash' (ring attention is a later slice)")
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(
            cfg.vocab_size, cfg.hidden_size, dtype=cfg.param_dtype,
            device=dev))
        self.layers = nn.ModuleList(
            Block(cfg, dev) for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.norm_eps, dev)

    def forward(self, tokens: torch.Tensor,
                targets: torch.Tensor | None = None) -> torch.Tensor:
        if targets is not None:
            raise NotImplementedError(
                "the chunked next-token loss (targets) is the training "
                "slice's work")
        cfg = self.cfg
        x = self.embed[tokens].to(cfg.dtype)
        positions = torch.arange(
            tokens.shape[1], dtype=torch.int32,
            device=tokens.device)[None].expand(tokens.shape)
        rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        for layer in self.layers:
            x = layer(x, rope)
        x = self.final_norm(x)
        # Tied embeddings: activation-dtype inputs, fp32 accumulation and
        # fp32 logits (the JAX einsum's preferred_element_type).
        return torch.matmul(x.float(), self.embed.to(cfg.dtype).float().T)

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
        sd[p + "attn.q_proj.weight"] = lecun(cfg.num_heads * hd, e)
        sd[p + "attn.k_proj.weight"] = lecun(cfg.num_kv_heads * hd, e)
        sd[p + "attn.v_proj.weight"] = lecun(cfg.num_kv_heads * hd, e)
        sd[p + "attn.o_proj.weight"] = lecun(e, cfg.num_heads * hd)
        sd[p + "mlp_norm.scale"] = ones()
        sd[p + "mlp.gate_proj.weight"] = lecun(i, e)
        sd[p + "mlp.up_proj.weight"] = lecun(i, e)
        sd[p + "mlp.down_proj.weight"] = lecun(e, i)
    sd["final_norm.scale"] = ones()
    return sd
