"""Where the time of one serving step of the PyTorch port goes on the card.

    python3 scripts/profile_torch_serve.py

One ``generate`` step re-runs the forward of BENCH_350M over the full
token buffer, so the step is one forward.  The model, the prompt and the
buffer's shape are those of ``chip_smoke.py``'s serve phase
(``nos_tpu_torch.entry``): the 24-layer ``bench_model`` and the
zero-padded 8 x (448 + 64) buffer of the first step.  After two
warm-up forwards, ``FORWARDS`` forwards run under ``torch.profiler``
(CPU and CUDA activities).  Printed as one
JSON line: host ms per forward (synchronised), device kernel ms per
forward by group (the flash kernel, matrix products, everything else),
the device's busy and idle share of the wall time, and the kernels that
take the most time.  Needs a CUDA card; fails without one.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nos_tpu_torch.entry import STEPS, bench_model, serve_prompt  # noqa: E402
from nos_tpu_torch.ops.roofline import card_line  # noqa: E402

FORWARDS = 3
_MATMUL_MARKS = ("gemm", "nvjet", "cutlass", "xmma", "cublas")


def _group(name: str) -> str:
    if "flash_fwd" in name:
        return "flash_fwd"
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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_serve: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    model = bench_model(device="cuda")
    tokens = F.pad(serve_prompt("cuda"), (0, STEPS))

    with torch.no_grad():
        for _ in range(2):
            model(tokens)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(FORWARDS):
                model(tokens)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_group: dict[str, float] = {}
    by_name: dict[str, list] = {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        by_group[_group(e.name)] = by_group.get(_group(e.name), 0.0) + us
        row = by_name.setdefault(e.name, [0, 0.0])
        row[0] += 1
        row[1] += us
    busy_us = _union_us([(e.time_range.start, e.time_range.end)
                         for e in kernels])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    smi = card_line("cuda")
    n = FORWARDS
    print(json.dumps({
        "nvidia_smi": smi, "layers": model.cfg.num_layers,
        "batch": tokens.shape[0], "seq": tokens.shape[1], "forwards": n,
        "host_ms_per_forward": wall_us / n / 1e3,
        "kernels_captured": len(kernels),
        "device_ms_per_forward": {g: us / n / 1e3
                                  for g, us in sorted(by_group.items())},
        "device_busy_share": busy_us / wall_us if kernels else None,
        "device_idle_share": 1 - busy_us / wall_us if kernels else None,
        "top_kernels": [{"name": name[:120], "launches_per_forward": c / n,
                         "ms_per_forward": us / n / 1e3}
                        for name, (c, us) in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
