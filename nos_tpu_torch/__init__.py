"""nos_tpu_torch — the PyTorch / CUDA port of nos_tpu's workload compute
path, for NVIDIA Hopper (H100).

Mirrors ``nos_tpu`` module for module (``nos_tpu/ops/attention.py`` ->
``nos_tpu_torch/ops/attention.py`` and so on) and imports nothing of it,
nor of JAX.  Plain tensor code is PyTorch; every Pallas TPU kernel becomes
a kernel written by hand for Hopper under ``ops/csrc/``.

Entry points take an explicit ``device`` and run on ``cuda`` unless the
caller asks for the CPU; without a card they raise instead of quietly
running on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` when none is given.
    Raises RuntimeError when CUDA is asked for and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly")
    return dev
