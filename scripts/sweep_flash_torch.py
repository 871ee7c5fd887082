"""Sweep every compiled tile of the port's flash kernels on one card, and
pick the tiles the autotuner ships (``PRETUNED`` in
``nos_tpu_torch/ops/autotune.py``).

    python3 scripts/sweep_flash_torch.py [--batch 8] [--heads 8]
        [--seqs 512,1024,2048,4096,8192] [--causal both] [--repeats 3]

The card-side counterpart of ``scripts/sweep_attention.py``,
``sweep_bwd.py`` and ``confirm_bwd.py``.  At each sequence length and
masking, for ``--repeats`` rounds (the tiles in turn within each round):

- every tile of K1-K4 (``ops.attention.KERNEL_TILES``) through its wrapper,
  on bf16 inputs from a seed (lse from K1), timed with CUDA events;
- each pass as the autotuner times it (``autotune.search``: the forward
  through the op, the backward through ``torch.autograd.grad`` with the
  forward at its default tile), with the backward implementation
  ``backward_impl`` picks at the shape.

One JSON line per (shape, kernel or pass, tile) with its ms per round
and their median, then one ``winner`` line per shape and pass: the tile
with the least median, which is what ``PRETUNED`` records.  The last
line gathers the winners.  Nothing is written to the autotune cache.
The env line of chip_smoke.py comes first (the card's name and power
limit).
"""

from __future__ import annotations

import argparse
import statistics
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as C  # noqa: E402
from nos_tpu_torch.ops import attention as A  # noqa: E402
from nos_tpu_torch.ops import autotune as T  # noqa: E402


def _kernel_calls(q, k, v, do, lse, delta, causal):
    """kernel -> callable(tile) launching it once on these inputs."""
    args = (q, k, v, do, lse, delta, causal)
    return {
        "flash_fwd": lambda t: A.flash_attention_fwd(q, k, v, causal, t),
        "flash_bwd_fused": lambda t: A.flash_attention_bwd_fused(*args, t),
        "flash_dq": lambda t: A.flash_attention_dq(*args, t),
        "flash_dkv": lambda t: A.flash_attention_dkv(*args, t),
    }


def sweep_shape(b: int, s: int, h: int, causal: bool, repeats: int,
                gen) -> dict[str, list[int]]:
    q, k, v, do = (torch.randn(b, s, h, 128, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    o, lse = A.flash_attention_fwd(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    del o
    shape = {"batch": b, "seq": s, "heads": h, "causal": causal}
    calls = _kernel_calls(q, k, v, do, lse, delta, causal)
    runs: dict[tuple[str, tuple[int, int]], list[float]] = {}
    for _ in range(repeats):
        for kernel, call in calls.items():
            for tile in A.KERNEL_TILES[kernel]:
                runs.setdefault((kernel, tile), []).append(C.time_ms(
                    lambda t=tile: call(t), inner=5, samples=10))
        for pass_ in ("fwd", "bwd"):
            _, timings = T.search(pass_, q, k, v, causal)
            for tile, t in timings.items():
                runs.setdefault((pass_, tile), []).append(t * 1e3)
    for (what, tile), ms in runs.items():
        C.emit({**shape, "what": what, "tile": list(tile), "ms": ms,
                "median_ms": statistics.median(ms)})
    winners = {}
    for pass_ in ("fwd", "bwd"):
        mine = {tile: statistics.median(ms)
                for (what, tile), ms in runs.items() if what == pass_}
        best = min(mine, key=mine.get)
        winners[pass_] = list(best)
        C.emit({**shape, "winner": pass_, "tile": list(best),
                "backward_impl": A.backward_impl(q, k),
                "median_ms": {f"{bq}x{bk}": ms
                              for (bq, bk), ms in mine.items()}})
    return winners


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--seqs", default="512,1024,2048,4096,8192")
    ap.add_argument("--causal", choices=("both", "causal", "full"),
                    default="both")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        C.fail("no CUDA device: the sweep runs on the card only")
    C.phase_env()
    gen = torch.Generator(device="cuda").manual_seed(0)
    masks = {"both": (True, False), "causal": (True,), "full": (False,)}
    table = {}
    for s in (int(x) for x in args.seqs.split(",")):
        for causal in masks[args.causal]:
            table[f"s{s}|{'causal' if causal else 'full'}"] = sweep_shape(
                args.batch, s, args.heads, causal, args.repeats, gen)
    C.emit({"pretuned": table, "device": torch.cuda.get_device_name(0)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
