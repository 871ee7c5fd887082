"""Reference attention for the port, ``nos_tpu/parallel/ring.py``'s
``dense_attention``.

Ring attention (sequence parallelism over ``torch.distributed``) is a
later slice; this module holds the plain O(S^2) attention that is the
``attn_impl="dense"`` path and the ground truth for the flash kernel.
"""

from __future__ import annotations

import torch

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
