"""Run one cell of the benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

(``python -m portbench.run`` alike.)  From the root of a checkout that
holds ``BENCHMARK.json``, ``portbench/`` and the program,
``nos_tpu_torch/``, on a machine with as many CUDA cards as the cell
asks for; without them it exits 2 and prints no result.

A run: set-up (imports, the kernels' libraries, the weights drawn on the
card from the seed, the trainer, the cell's first ``check_steps`` steps,
whose readings the check compares, and ``warm_steps`` more), then with
``--trace 0`` a window of ``--seconds`` in which steps run back to back
(the cell's end-to-end metrics), or with ``--trace 1`` ``traced_steps``
steps under ``torch.profiler`` (its per-layer metrics).  Then the
program's state is freed and the plain reference follows the first
steps; the check's numbers go to standard error, each beside its limit,
and the last line of standard output is the result as one JSON object.

Everything is found by name: the cell's entry in ``BENCHMARK.json``,
``portbench/workloads/<cell>.json`` (traffic and limits), the config
file it names (the model), ``portbench/entries/<family>_<kind>.py``
(the program's side) and ``portbench/metrics/<metric>.py`` (each
per-layer metric).  To add a cell, add its workload file and its
``workloads`` entry; a configuration, its file and its ``configs``
entry; a per-layer metric, its module and its ``per_layer`` entry.  See
``portbench/README.md``.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

HERE = Path(__file__).resolve().parent
CACHE = HERE / ".cache"
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "nos_tpu"})


def cache_env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    os.environ["NOS_TPU_AUTOTUNE_CACHE"] = str(CACHE / "flash_autotune.json")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")


def process_start() -> float:
    """This process's start on the ``time.time()`` clock (10 ms ticks)."""
    with open("/proc/self/stat") as f:
        started = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - (uptime - started / os.sysconf("SC_CLK_TCK"))


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


class Device:
    """Synchronisation and memory on the run's device (no-ops on the
    CPU, where only the tests run)."""

    def __init__(self, device):
        import torch

        self.torch, self.device = torch, torch.device(device)
        self.cuda = self.device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize(self.device)

    def mark(self):
        if not self.cuda:
            return None
        ev = self.torch.cuda.Event()
        ev.record()
        return ev

    def reset_peak(self) -> None:
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats(self.device)

    def peak(self) -> int | None:
        return (self.torch.cuda.max_memory_allocated(self.device)
                if self.cuda else None)

    def kind(self) -> str:
        return (self.torch.cuda.get_device_name(self.device) if self.cuda
                else "cpu")


def timed_window(session, feed, seconds: float, dev: Device) -> dict:
    """Steps back to back for ``seconds``: the host keeps one step queued
    ahead of the one it waits for, and stops issuing once a completed
    step ends past the window; every issued step is counted."""
    dev.reset_peak()
    dev.sync()
    t0 = time.perf_counter()
    losses, marks = [], []
    while True:
        losses.append(session.step(next(feed)))
        marks.append(dev.mark())
        if len(marks) >= 2:
            if marks[-2] is not None:
                marks[-2].synchronize()
            if time.perf_counter() - t0 >= seconds:
                break
    dev.sync()
    elapsed = time.perf_counter() - t0
    import torch

    values = torch.stack([x.float() for x in losses]).cpu()
    return {"steps": len(losses), "seconds": elapsed,
            "failed": int((~torch.isfinite(values)).sum()),
            "peak": dev.peak()}


def traced_window(session, feed, steps: int, dev: Device, path: Path):
    """``steps`` steps under torch.profiler, each in a ``portbench.step``
    annotation inside one ``portbench.window``; the Chrome trace goes to
    ``path`` and is read back."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench import trace as T

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if dev.cuda else [])
    dev.reset_peak()
    losses = []
    with profile(activities=acts) as prof:
        dev.sync()
        with record_function(T.WINDOW):
            for _ in range(steps):
                with record_function(T.STEP):
                    losses.append(session.step(next(feed)))
            dev.sync()
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    del prof
    values = torch.stack([x.float() for x in losses]).cpu()
    return (T.load(path), {"steps": steps,
                           "failed": int((~torch.isfinite(values)).sum()),
                           "peak": dev.peak()})


def run_cell(cell, bench: dict, seed: int, seconds: float, trace: bool,
             device, started: float, trace_dir: Path = CACHE / "traces"
             ) -> dict:
    """One run of ``cell``: the result's fields, in the order printed."""
    from portbench import check, readings
    from portbench.metrics import module
    from portbench.trace import breakdown

    dev = Device(device)
    entry = importlib.import_module(f"portbench.entries.{cell.entry}")
    traffic = cell.traffic
    session = entry.Session(cell, seed, dev.device)
    feed = session.batches()
    mine = readings.program(session, feed, traffic["check_steps"], cell.spec,
                            seed, dev.device)
    for _ in range(traffic["warm_steps"]):
        session.step(next(feed))
    dev.sync()
    setup_s = time.time() - started
    metrics, extra = {}, {}
    if trace:
        tr, done = traced_window(session, feed, traffic["traced_steps"], dev,
                                 trace_dir / f"{cell.name}.json")
        kind = dev.kind()
        for m in bench["per_layer"]:
            value = module(m["name"]).read(tr, cell, kind)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra = {"busy_s": tr.busy_s, "window_s": tr.window_s,
                 "breakdown": breakdown(tr)}
    else:
        done = timed_window(session, feed, seconds, dev)
        found = {"train_tokens_per_s":
                 done["steps"] * cell.tokens_per_step / done["seconds"],
                 "setup_s": setup_s}
        if done["peak"] is not None:
            found["peak_mem_gib"] = done["peak"] / 2 ** 30
        for m in bench["end_to_end"]:
            if m["name"] in found:
                metrics[m["name"]] = {"value": found[m["name"]],
                                      "unit": m["unit"]}
    session.close()
    del session, feed
    gc.collect()
    if dev.cuda:
        dev.torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    theirs = readings.reference(cell.spec, seed, cell.batch_size,
                                cell.seq_len, traffic["check_steps"],
                                dev.device)
    ref_s = time.perf_counter() - t_ref
    ok, shown = check.verdict(check.gaps(mine, theirs), cell.limits)
    result = {"correct": ok and done["failed"] == 0,
              "attempted": done["steps"], "failed": done["failed"],
              "metrics": metrics,
              "device": {"platform": "gpu" if dev.cuda else "cpu",
                         "kind": dev.kind(), "count": cell.chips,
                         "memory_peak_bytes": done["peak"]}}
    if trace:
        result["device"].update(busy_s=extra["busy_s"],
                                window_s=extra["window_s"])
        result["breakdown"] = extra["breakdown"]
    result["reference_s"] = ref_s
    result["check"] = shown
    return result


def card_line() -> str:
    """``name, power.limit`` of the first card, from nvidia-smi."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    return out.strip().splitlines()[0] if out.strip() else "nvidia-smi: none"


def main(argv=None) -> int:
    started = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env()
    from portbench.cells import benchmark, load_cell

    bench = benchmark()
    cell = load_cell(args.workload, bench)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"card: {card_line()}", file=sys.stderr, flush=True)
    result = run_cell(cell, bench, args.seed % 2 ** 63, args.seconds,
                      bool(args.trace), "cuda", started)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, v in result["check"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r} "
              f"(at {v['at']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
