"""Roofline accounting for the port: the card's published peaks and the
analytic model FLOPs of a train step (``nos_tpu/ops/roofline.py``'s
``model_flops_per_step``, copied).

Peaks are NVIDIA's data-sheet figures for dense bf16 tensor-core work
and HBM bandwidth, matched by substring against
``torch.cuda.get_device_name()``; the SXM, PCIe and NVL parts of the H100
differ.  They assume the card's full power limit, which ``card_line``
reports beside a measurement.
"""

from __future__ import annotations

import subprocess

# (needle, bf16 FLOP/s, HBM bytes/s); more specific needles first.
_PEAKS = (
    ("h100 pcie", 756e12, 2.0e12),
    ("h100 nvl", 835e12, 3.9e12),
    ("h200", 989e12, 4.8e12),
    ("h100", 989e12, 3.35e12),      # SXM: "NVIDIA H100 80GB HBM3"
)


def peaks_for(device_name: str) -> tuple[float, float]:
    """(bf16 FLOP/s, HBM bytes/s) for a ``torch.cuda.get_device_name``
    string; raises ValueError for a card not in the table."""
    name = device_name.lower()
    for needle, flops, bandwidth in _PEAKS:
        if needle in name:
            return flops, bandwidth
    raise ValueError(f"no published peaks for {device_name!r}")


def card_line(device) -> str:
    """The card's ``name, power.limit`` as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (its
    first card), or "cpu" for a CPU ``device``."""
    import torch

    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def model_flops_per_step(cfg, batch: int, seq: int) -> float:
    """Analytic Llama train-step FLOPs (fwd+bwd, no remat credit): 6*T per
    matmul param + causal attention matmuls.  ``cfg`` is a LlamaConfig."""
    per_layer_mm = (
        cfg.hidden_size * cfg.num_heads * cfg.head_dim          # q
        + 2 * cfg.hidden_size * cfg.num_kv_heads * cfg.head_dim  # k, v
        + cfg.num_heads * cfg.head_dim * cfg.hidden_size        # o
        + 3 * cfg.hidden_size * cfg.intermediate_size           # mlp
    )
    n_mm = cfg.num_layers * per_layer_mm + cfg.vocab_size * cfg.hidden_size
    tokens = batch * seq
    matmul = 6 * n_mm * tokens
    # QK^T and PV: 2 matmuls x 2 FLOPs x B*H*S^2*D, causal halves it,
    # backward doubles it (fwd 1x + bwd 2x = 3x).
    attn = 3 * cfg.num_layers * 2 * batch * cfg.num_heads * seq * seq \
        * cfg.head_dim
    return float(matmul + attn)
