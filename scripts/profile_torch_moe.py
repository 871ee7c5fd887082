"""Where the time of one MoE training step of the PyTorch port goes on the
card.

    python3 scripts/profile_torch_moe.py

``chip_smoke.py``'s moe phase (``nos_tpu_torch.entry.bench_moe_trainer``):
the MoE family at BENCH_350M_TRAIN's widths, 24 layers of 8 experts,
top-2, flash attention, every block rematerialised, through
``make_ep_trainer`` (optax adam(1e-3)) in a one-rank NCCL group on the
8 x 2048 synthetic batches.  After two warm-up steps, ``STEPS`` steps
run on the host clock alone and then ``STEPS`` under ``torch.profiler``,
grouped as ``scripts/profile_torch_train.py`` groups them (the experts'
batched products fall in the matrix products).  One JSON line.  Needs a
CUDA card; fails without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nos_tpu_torch.entry import bench_moe_trainer, train_loader  # noqa: E402
from scripts.profile_torch_train import STEPS, _profile  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_moe: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]

    import torch.distributed as dist

    state, step = bench_moe_trainer("cuda")
    cfg, loader = state.model.cfg, train_loader()
    row = _profile("make_ep_trainer (FSDP2, one NCCL rank)",
                   lambda batch: step(state, batch),
                   (loader.batch_at(i) for i in range(2 + 2 * STEPS)),
                   cfg.vocab_size, smi)
    print(json.dumps({"layers": cfg.num_layers, "experts": cfg.num_experts,
                      "top_k": cfg.top_k, "batch": loader.batch_size,
                      "seq": loader.seq_len, **row}), flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
