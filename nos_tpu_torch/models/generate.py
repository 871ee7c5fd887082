"""Autoregressive generation for the Llama family, the port of
``nos_tpu/models/generate.py``.

The same shape discipline as the JAX loop: a fixed-width token buffer,
and each step re-runs the forward over the whole buffer and reads the
logits at the current position (O(L·S²) total).  A KV-cache decode is a
later optimisation.  The model holds its own weights, so the calls take
the module where the JAX functions take (model, params).
"""

from __future__ import annotations

from collections.abc import Callable

import torch
import torch.nn.functional as F

from nos_tpu_torch.models.llama import Llama


def generate(model: Llama, prompt: torch.Tensor, steps: int,
             temperature: float = 0.0,
             generator: torch.Generator | None = None) -> torch.Tensor:
    """Append ``steps`` sampled tokens to ``prompt`` [B, P] -> int32
    [B, P+steps].

    temperature 0 = greedy argmax; otherwise categorical sampling at the
    given temperature, drawn from ``generator`` (one seeded 0 on the
    prompt's device when None, as the JAX loop defaults to key 0)."""
    batch, prompt_len = prompt.shape
    total = prompt_len + steps
    if total > model.cfg.max_seq_len:
        raise ValueError(
            f"prompt ({prompt_len}) + steps ({steps}) = {total} exceeds "
            f"max_seq_len {model.cfg.max_seq_len}: positions past it are "
            f"out of distribution for RoPE")
    if temperature > 0.0 and generator is None:
        generator = torch.Generator(device=prompt.device).manual_seed(0)

    buf = F.pad(prompt.to(torch.int32), (0, steps))
    with torch.no_grad():
        for pos in range(prompt_len, total):
            logits = model(buf)                     # [B, total, V]
            last = logits[:, pos - 1, :]            # predicts the token at pos
            if temperature > 0.0:
                probs = torch.softmax(last / temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
            else:
                nxt = torch.argmax(last, dim=-1)
            buf[:, pos] = nxt.to(torch.int32)
    return buf


def make_generate(model: Llama, steps: int, temperature: float = 0.0
                  ) -> Callable[..., torch.Tensor]:
    """generate closed over the model and step count:
    (prompt [B, P], generator?) -> [B, P+steps]."""
    def fn(prompt: torch.Tensor,
           generator: torch.Generator | None = None) -> torch.Tensor:
        return generate(model, prompt, steps, temperature=temperature,
                        generator=generator)

    return fn
