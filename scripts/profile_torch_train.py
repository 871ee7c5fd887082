"""Where the time of one training step of the PyTorch port goes on the card.

    python3 scripts/profile_torch_train.py

Two trainers, one JSON line each.  First ``chip_smoke.py``'s train phase
(``nos_tpu_torch.entry``): ``Trainer`` on BENCH_350M_TRAIN at 24 layers,
fp32 parameters from seed 0, flash attention, "rots" remat, 8 x 2048
synthetic tokens, the fused backward.  Then the same step as the
training main runs it (``nos_tpu_torch.cmd.train.build`` with its
defaults): ``ShardedTrainer`` under FSDP2 in a one-rank NCCL group, fed
by ``device_iter``.  For each, after two warm-up steps, ``STEPS`` steps
run on the host clock alone and then ``STEPS`` under ``torch.profiler``
(CPU and CUDA activities, input shapes recorded).  Each line holds: host
ms per step (synchronised) with and without the profiler, device kernel
ms per step by group, the device's busy and idle share of the profiled
wall time and of the unprofiled one (the profiler slows the host, not
the kernels), and the kernels that take the most time.

Groups: the flash forward and backward kernels; the loss head (the
kernels that ``aten::mm`` calls with a vocabulary-sized operand launch:
the tied head's forward, its recompute and its two gradient products);
the other matrix products (cuBLAS/CUTLASS kernel names); the optimizer
(the multi-tensor kernels of the clip and AdamW); NCCL's collectives;
everything else (elementwise, reductions, copies).  Needs a CUDA card;
fails without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nos_tpu_torch.cmd.train import TrainConfig, build  # noqa: E402
from nos_tpu_torch.entry import bench_trainer, train_loader  # noqa: E402

STEPS = 4
_MATMUL_MARKS = ("gemm", "nvjet", "cutlass", "xmma", "cublas")


def _group(name: str) -> str:
    if "flash_fwd" in name:
        return "flash_fwd"
    if "flash_bwd" in name or "flash_dq" in name:
        return "flash_bwd"
    if "multi_tensor_apply" in name:
        return "optimizer"
    if "nccl" in name.lower():
        return "collectives"
    if any(m in name for m in _MATMUL_MARKS):
        return "matmul"
    return "other"


def _union_us(intervals: list[tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _profile(label: str, step, batches, vocab: int, smi: str) -> dict:
    """``step(batch)`` over ``batches``: 2 warm-up, STEPS timed, STEPS
    profiled."""
    batches = iter(batches)
    for _ in range(2):
        step(next(batches))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        step(next(batches))
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) / STEPS * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step(next(batches))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    events = prof.events()
    # Device events, less the ranges that record_function marks on the
    # device timeline (Optimizer.step), which overlap the kernels.
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    by_group: dict[str, float] = {}
    by_name: dict[str, list] = {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        by_group[_group(e.name)] = by_group.get(_group(e.name), 0.0) + us
        row = by_name.setdefault(e.name, [0, 0.0])
        row[0] += 1
        row[1] += us
    # The loss head: kernels launched by aten::mm on a vocabulary-sized
    # operand, moved out of the matrix-product group.
    head_us, head_launches = 0.0, 0
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU or \
                not e.name.startswith("aten::mm"):
            continue
        if any(vocab in shape for shape in e.input_shapes if shape):
            for k in e.kernels:
                head_us += k.duration
                head_launches += 1
    by_group["loss_head"] = head_us
    by_group["matmul"] = by_group.get("matmul", 0.0) - head_us
    busy_us = _union_us([(e.time_range.start, e.time_range.end)
                         for e in kernels])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    n = STEPS
    return {
        "trainer": label, "nvidia_smi": smi, "steps": n,
        "host_ms_per_step": wall_us / n / 1e3,
        "host_ms_per_step_unprofiled": plain_ms,
        "kernels_captured": len(kernels),
        "kernel_launches_per_step": len(kernels) / n,
        "device_ms_per_step": {g: us / n / 1e3
                               for g, us in sorted(by_group.items())},
        "loss_head_launches_per_step": head_launches / n,
        "device_busy_share": busy_us / wall_us if kernels else None,
        "device_idle_share": 1 - busy_us / wall_us if kernels else None,
        "device_idle_share_unprofiled": 1 - busy_us / n / 1e3 / plain_ms,
        "top_kernels": [{"name": name[:120], "launches_per_step": c / n,
                         "ms_per_step": us / n / 1e3}
                        for name, (c, us) in top],
    }


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_train: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]

    trainer = bench_trainer("cuda")
    loader = train_loader()
    row = _profile("Trainer", trainer.train_step,
                   (loader.batch_at(i) for i in range(2 + 2 * STEPS)),
                   trainer.cfg.vocab_size, smi)
    print(json.dumps({"layers": trainer.cfg.num_layers,
                      "batch": loader.batch_size, "seq": loader.seq_len,
                      **row}), flush=True)
    del trainer

    import torch.distributed as dist

    sharded, loader, _, state, _ = build(TrainConfig(model="bench350m"))
    step_fn = sharded.train_step()
    row = _profile("ShardedTrainer (cmd.train, FSDP2, one NCCL rank)",
                   lambda batch: step_fn(state, batch),
                   loader.device_iter(sharded.mesh, 0, 2 + 2 * STEPS),
                   sharded.cfg.vocab_size, smi)
    print(json.dumps({"layers": sharded.cfg.num_layers,
                      "batch": loader.batch_size, "seq": loader.seq_len,
                      **row}), flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
