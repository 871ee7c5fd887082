"""The inputs both sides get, made from ``--seed``: the weights (on the
device, fp32, from one draw of a ``torch.Generator`` on that device) and
the token batches (on the host, uniform over the vocabulary).

The weights carry the program's parameter names, so the same state dict
loads into the trainer and into the reference.  Draws: the embedding
normal(0, 0.02), every projection normal(0, fan_in^-1/2) (the router and
each expert's products too, fan_in the width they sum over), norm scales
ones."""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.cells import ModelSpec


def leaves(spec: ModelSpec) -> list[tuple[str, tuple[int, ...], float]]:
    """(name, shape, std) of every parameter, std 0 for a norm scale
    (ones), in the order of the draw."""
    e, f, hd = spec.hidden_size, spec.intermediate_size, spec.head_dim
    q, kv = spec.num_heads * hd, spec.num_kv_heads * hd
    out = [("embed", (spec.vocab_size, e), 0.02)]
    for n in range(spec.num_layers):
        p = f"layers.{n}."
        out += [(p + "attn_norm.scale", (e,), 0.0),
                (p + "attn.q_proj.weight", (q, e), e ** -0.5),
                (p + "attn.k_proj.weight", (kv, e), e ** -0.5),
                (p + "attn.v_proj.weight", (kv, e), e ** -0.5),
                (p + "attn.o_proj.weight", (e, q), q ** -0.5)]
        if spec.family == "moe":
            x = spec.num_experts
            out += [(p + "moe_norm.scale", (e,), 0.0),
                    (p + "moe.router.weight", (x, e), e ** -0.5),
                    (p + "moe.experts.w_gate", (x, e, f), e ** -0.5),
                    (p + "moe.experts.w_up", (x, e, f), e ** -0.5),
                    (p + "moe.experts.w_down", (x, f, e), f ** -0.5)]
        else:
            out += [(p + "mlp_norm.scale", (e,), 0.0),
                    (p + "mlp.gate_proj.weight", (f, e), e ** -0.5),
                    (p + "mlp.up_proj.weight", (f, e), e ** -0.5),
                    (p + "mlp.down_proj.weight", (e, f), f ** -0.5)]
    out.append(("final_norm.scale", (e,), 0.0))
    return out


def param_count(spec: ModelSpec) -> int:
    return sum(math.prod(shape) for _, shape, _ in leaves(spec))


def make_params(spec: ModelSpec, seed: int, device: str | torch.device
                ) -> dict[str, torch.Tensor]:
    """Every parameter as an fp32 view of one buffer of standard normals
    drawn on ``device`` by a generator seeded ``seed``, scaled in place
    (norm scales set to ones).  The same seed gives the same bits."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(param_count(spec), generator=gen, device=device,
                       dtype=torch.float32)
    out, at = {}, 0
    for name, shape, std in leaves(spec):
        n = math.prod(shape)
        view = flat[at:at + n].view(shape)
        if std:
            view.mul_(std)
        else:
            view.fill_(1.0)
        out[name] = view
        at += n
    return out


def batch(seed: int, step: int, batch_size: int, seq_len: int,
          vocab_size: int) -> np.ndarray:
    """The [batch_size, seq_len] int32 tokens of step ``step`` (0-based),
    uniform over the vocabulary."""
    rng = np.random.default_rng([seed, step])
    return rng.integers(0, vocab_size, size=(batch_size, seq_len),
                        dtype=np.int32)
