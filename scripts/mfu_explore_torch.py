"""MFU exploration on one card: sweep the port's train step configs.

The card-side counterpart of ``scripts/mfu_explore.py``: the BENCH_350M
train step through ``ShardedTrainer`` on a one-rank mesh, across
{fused projections} x {batch} x {remat policy} at sequence 2048, JAX's
six variants in JAX's order.  Each variant runs WARMUP steps, then
REPEATS runs of STEPS steps each timed with CUDA events; its row gives
the band of ms per step over the repeats (min, median, max), tokens/s
and MFU at the median (``ops.roofline.model_flops_per_step`` over the
card's published bf16 peak, ``peaks_for``), the peak device memory, the
first warm-up step's loss (the loss at initialisation) and the last
loss, the flash kernels' launches per step (K1-K4) and the card's
``name, power.limit``.  A variant that runs out of device memory gives a
row with ``error``; any other failure raises.

    python3 scripts/mfu_explore_torch.py [--quick]

``--quick`` runs the first three variants.  One JSON line per variant.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import statistics
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from nos_tpu_torch import resolve_device  # noqa: E402
from nos_tpu_torch.cmd.train import maybe_init_distributed  # noqa: E402
from nos_tpu_torch.models.llama import BENCH_350M, LlamaConfig  # noqa: E402
from nos_tpu_torch.models.train import ShardedTrainer  # noqa: E402
from nos_tpu_torch.ops import attention as A  # noqa: E402
from nos_tpu_torch.ops.roofline import (card_line,  # noqa: E402
                                        model_flops_per_step, peaks_for)
from nos_tpu_torch.parallel.mesh import MeshSpec, make_mesh  # noqa: E402

SEQ = 2048
VARIANTS = [
    (8, False, "mats"),    # round-2 best (control)
    (8, True, "mats"),
    (16, True, "mats"),
    (16, False, "mats"),
    (16, True, "all_mats"),
    (32, True, "mats"),
]
QUICK = 3
WARMUP, STEPS, REPEATS = 2, 4, 3


def variant_config(fused: bool, remat_policy: str,
                   base: LlamaConfig = BENCH_350M) -> LlamaConfig:
    return dataclasses.replace(
        base, attn_impl="flash", remat_policy=remat_policy,
        scan_layers=False, fused_qkv=fused, fused_gate_up=fused)


def _launches() -> dict[str, int]:
    return {"flash_fwd": A.FLASH_FWD_LAUNCHES,
            "flash_bwd_fused": A.FLASH_BWD_FUSED_LAUNCHES,
            "flash_dq": A.FLASH_DQ_LAUNCHES,
            "flash_dkv": A.FLASH_DKV_LAUNCHES}


def _step_ms(step, state, tokens, dev: torch.device) -> tuple[list[float],
                                                               float]:
    """REPEATS runs of STEPS steps: each run's ms per step (CUDA events
    on the card, the host clock on the CPU) and the last loss."""
    times = []
    for _ in range(REPEATS):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(STEPS):
                state, loss = step(state, tokens)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / STEPS)
        else:
            t0 = time.perf_counter()
            for _ in range(STEPS):
                state, loss = step(state, tokens)
            loss.item()
            times.append((time.perf_counter() - t0) * 1e3 / STEPS)
    return times, loss.item()


def time_variant(batch: int, fused: bool, remat_policy: str, peak: float,
                 device: str | torch.device = "cuda",
                 base: LlamaConfig = BENCH_350M, seq: int = SEQ) -> dict:
    """One variant's row (see the module's docstring).  ``base`` and
    ``seq`` cut the model for tests."""
    dev = resolve_device(device)
    maybe_init_distributed(dev)
    cfg = variant_config(fused, remat_policy, base)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    trainer = ShardedTrainer(cfg, make_mesh(MeshSpec.for_device_count(1),
                                            dev.type),
                             batch_size=batch, seq_len=seq, device=dev)
    state = trainer.init_state(0)
    step = trainer.train_step()
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1)).to(dev)
    state, loss = step(state, tokens)
    loss0 = loss.item()
    for _ in range(WARMUP - 1):
        state, loss = step(state, tokens)
    loss.item()
    before = _launches()
    times, loss = _step_ms(step, state, tokens, dev)
    launched = {k: (v - before[k]) / (STEPS * REPEATS)
                for k, v in _launches().items()}
    ms = statistics.median(times)
    return {
        "batch": batch, "fused": fused, "remat": remat_policy,
        "step_ms": {"min": min(times), "median": ms, "max": max(times)},
        "tokens_per_s": batch * seq / (ms / 1e3),
        "mfu": model_flops_per_step(cfg, batch, seq) / (ms / 1e3) / peak,
        "loss0": loss0, "loss": loss,
        "peak_mem_bytes": (torch.cuda.max_memory_allocated()
                           if dev.type == "cuda" else None),
        "launches_per_step": launched,
        "device": card_line(dev),
    }


def sweep(variants, peak: float, device: str | torch.device = "cuda",
          **cut) -> list[dict]:
    """``time_variant`` for each (batch, fused, remat) in turn, one JSON
    line each as it ends.  Only running out of device memory is caught:
    it becomes a row with ``error``."""
    dev = resolve_device(device)
    rows = []
    for batch, fused, remat in variants:
        try:
            r = time_variant(batch, fused, remat, peak, dev, **cut)
        except torch.OutOfMemoryError as e:
            r = {"batch": batch, "fused": fused, "remat": remat,
                 "error": str(e)[:200]}
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        print(json.dumps(r), flush=True)
        rows.append(r)
    return rows


def main(argv: list[str] | None = None) -> list[dict]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--quick", action="store_true",
                        help="the first three variants only")
    args = parser.parse_args(argv)
    dev = resolve_device("cuda")
    peak = peaks_for(torch.cuda.get_device_name(dev))[0]
    return sweep(VARIANTS[:QUICK] if args.quick else VARIANTS, peak, dev)


if __name__ == "__main__":
    main()
