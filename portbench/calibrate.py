"""The readings a cell's limits are set from, at the cell's own size on
the card: the program against the reference on each seed (the lower
readings), the fp8 control against the reference (the upper), and the
program with a fault planted under its timed call.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control 1,2,3] [--fault half_batch:1,2,3]

One JSON line a reading: seed, what was read (program, control or the
fault), each number and where it was taken, and the seconds each side
took.  Faults: ``half_batch`` feeds half of each batch (half the rows,
or half the sequence of a one-row batch), so the loss is the mean over
the rest; ``unchanged`` runs the step with the optimizer's update
skipped, so the state stays as it was."""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import run  # noqa: E402


def half_batch(feed):
    for b in feed:
        yield b[:len(b) // 2] if len(b) > 1 else b[:, :b.shape[1] // 2]


@contextlib.contextmanager
def unchanged():
    import torch

    saved = {c: c.step for c in (torch.optim.Adam, torch.optim.AdamW)}
    for c in saved:
        c.step = lambda self, closure=None: None
    try:
        yield
    finally:
        for c, step in saved.items():
            c.step = step


FAULTS = {"half_batch": (half_batch, contextlib.nullcontext),
          "unchanged": (lambda feed: feed, unchanged)}


def program(cell, seed: int, steps: int, device, fault: str | None = None):
    from portbench import readings

    entry = importlib.import_module(f"portbench.entries.{cell.entry}")
    wrap, ctx = FAULTS[fault] if fault else (lambda f: f,
                                             contextlib.nullcontext)
    with ctx():
        session = entry.Session(cell, seed, device)
        out = readings.program(session, wrap(session.batches()), steps,
                               cell.spec, seed, device)
        session.close()
    del session
    _free()
    return out


def _free():
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--fault", action="append", default=[],
                    help="name:seed,seed,...")
    args = ap.parse_args(argv)
    run.cache_env()
    from portbench import check, readings
    from portbench.cells import load_cell

    import torch

    cell = load_cell(args.workload)
    device = torch.device("cuda")
    steps = cell.traffic["check_steps"]
    plan = {"program": _seeds(args.seeds), "control": _seeds(args.control)}
    for f in args.fault:
        name, seeds = f.split(":")
        plan[name] = _seeds(seeds)
    for seed in sorted({s for v in plan.values() for s in v}):
        t = time.perf_counter()
        ref = readings.reference(cell.spec, seed, cell.batch_size,
                                 cell.seq_len, steps, device)
        ref_s = time.perf_counter() - t
        _free()
        for what, seeds in plan.items():
            if seed not in seeds:
                continue
            t = time.perf_counter()
            if what == "control":
                side = readings.reference(cell.spec, seed, cell.batch_size,
                                          cell.seq_len, steps, device,
                                          fp8=True)
            else:
                side = program(cell, seed, steps, device,
                               None if what == "program" else what)
            side_s = time.perf_counter() - t
            _free()
            found = check.gaps(side, ref)
            print(json.dumps({
                "workload": cell.name, "seed": seed, "read": what,
                "steps": steps, **{n: found[n] for n in check.NAMES},
                "left_out": found["left_out"], "losses": side.losses,
                "leaves": {n: [side.grad_norms[n], ref.grad_norms[n],
                               side.update_norms[n], ref.update_norms[n]]
                           for n in ref.grad_norms},
                "ref_losses": ref.losses, "side_s": side_s,
                "reference_s": ref_s}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
