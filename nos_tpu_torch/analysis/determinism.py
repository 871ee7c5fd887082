"""Dual-run determinism harness: the dynamic half of the noslint gate.

N011/N012 prove *statically* that no hash-ordered iteration feeds a
decision and no cached view outlives its invalidation event.  This
module proves it *dynamically*: run the real planner and scheduler on
the determinism trace (64 MIG nodes of 8 H100 80GB in 4 NVLink domains,
a 200-pod mixed pending batch; ``trace_spec``) in child interpreters
across a matrix of

    PYTHONHASHSEED in {0, 1, random}  x  plan_workers in {1, 4}
                                      x  incremental in {on, off}

and byte-diff the decision journals.  The ``incremental`` axis is the
dirty-set scheduler's correctness anchor: the watch-fed cache with its
persistent indexes and the native hot loops must emit the byte-identical
decision sequence as a full rescan.  The port's scheduler has no
switch for that, so ``incremental=off`` calls the cache's
``invalidate_all()`` before every cycle, which makes each cycle rebuild
its view from the API.  One stale cross-cycle memo, one skipped node
the full walk would have visited, or one native/Python comparator
divergence shows up as the first differing journal line.
``PYTHONHASHSEED`` only applies at interpreter start, so every cell is a
fresh subprocess; the child pins every other source of nondeterminism:

- the decision journal gets a logical clock (a counter), so ``ts`` is
  a step number, not wall time;
- the tracer is disabled, so journal records carry empty trace ids
  (span-id assignment order is thread-interleaving-dependent under
  ``plan_workers > 1`` and is not a *decision*);
- the parallel planner and the scheduler get a zero clock (the merge
  record includes a wall-time field; shard timings are telemetry, not
  decisions);
- the planner is built with ``min_shard_hosts=0`` so the 64-node trace
  actually exercises the sharded path (the production floor is
  ``PLAN_SHARD_MIN_HOSTS``).

What's left is exactly what the certification claims is deterministic:
the sequence of decisions.  A surviving hash-order tie-break or a
stale cross-cycle cache shows up as the first differing journal line.

CLI: ``python -m nos_tpu_torch.analysis --determinism``.  ``run_cell``
runs one cell; ``run_matrix`` runs them one after another and
``judge`` compares the journals, so a caller may run cells at once.
"""

from __future__ import annotations

import difflib
import itertools
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field

HASH_SEEDS = ("0", "1", "random")
PLAN_WORKERS = (1, 4)
INCREMENTAL = ("on", "off")
DEFAULT_CYCLES = 2

# Per-child wall bound: the gate must never hang.  A child starts an
# interpreter (the control plane's imports, no torch), then runs one
# plan and two scheduler cycles over 64 nodes (well under a second of
# work), so 120 s is deep headroom even on a loaded host.
CHILD_TIMEOUT_S = 120

# The trace: testing/fleet.py's MIG fleet, bench_plan.py's layout (64
# nodes, 32 of them full with a filler pod, in 4 NVLink domains of 16
# nodes at host indices 0-15) and 200 pending pods of MIG_POD_MIX, its
# 2x8 block pods (bench_plan.py's 4x4 row) among them, so the group
# pass carves blocks in the plan leg and the scheduler's gang path
# rejects them in the schedule leg.

# the child's timing line on stderr: {"trace_s": ...}
_TIMING_PREFIX = "nosdiff-child: "


def _repo_root() -> str:
    pkg_dir = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(pkg_dir))


def trace_spec() -> dict:
    """The trace's cluster as a ``testing.fleet`` spec."""
    from nos_tpu_torch.testing import fleet

    return fleet.mig_fleet_spec(0)


# -- child: one trace run, journal to stdout --------------------------------

def run_trace(plan_workers: int, cycles: int = DEFAULT_CYCLES,
              incremental: bool = True) -> list[dict]:
    """Run the determinism trace once in THIS interpreter and return the
    decision journal as dicts.  The caller (child_main via subprocess)
    owns interpreter-level determinism knobs like PYTHONHASHSEED; the
    process journal and tracer are restored on return."""
    from nos_tpu_torch.api import constants as C
    from nos_tpu_torch.cmd.assembly import build_scheduler
    from nos_tpu_torch.kube.client import APIServer, KIND_NODE, KIND_POD
    from nos_tpu_torch.obs.journal import DecisionJournal, set_journal
    from nos_tpu_torch.obs.trace import Tracer, set_tracer
    from nos_tpu_torch.partitioning.core import ParallelGeometryPlanner
    from nos_tpu_torch.partitioning.slicepart import (
        SlicePartitionCalculator, SliceProfileCalculator, SliceSnapshotTaker,
    )
    from nos_tpu_torch.partitioning.slicepart.group import (
        MultiHostGeometryPlanner,
    )
    from nos_tpu_torch.scheduler.framework import Framework
    from nos_tpu_torch.testing import fleet

    ticks = itertools.count(1)
    journal = DecisionJournal(maxlen=1 << 16,
                              clock=lambda: float(next(ticks)))
    prev_journal = set_journal(journal)
    prev_tracer = set_tracer(Tracer(enabled=False))
    try:
        spec = trace_spec()

        # -- plan leg: the sharded parallel planner over the MIG fleet,
        # the NVLink block pass in front as in the partitioner's factory
        planner = ParallelGeometryPlanner(
            lambda: MultiHostGeometryPlanner(
                Framework(), SliceProfileCalculator(),
                SlicePartitionCalculator()),
            SliceProfileCalculator(), kind=C.MIG_KIND,
            max_workers=plan_workers, min_shard_hosts=0,
            clock=lambda: 0.0)
        try:
            snapshot = SliceSnapshotTaker().take_snapshot(
                fleet.build_cluster(spec))
            planner.plan(snapshot, fleet.build_pending(spec))
        finally:
            planner.close()

        # -- schedule leg: real cycles over the same cluster through the
        # api (a fresh build: the plan leg's objects stay its own)
        api = APIServer()
        state = fleet.build_cluster(spec)
        nodes = state.nodes()
        for n in spec["nodes"]:
            api.create(KIND_NODE, nodes[n["name"]])
            for pod in sorted(state.pods_on(n["name"]), key=lambda p: p.key):
                api.create(KIND_POD, pod)
        for pod in fleet.build_pending(spec):
            api.create(KIND_POD, pod)
        scheduler = build_scheduler(api, clock=lambda: 0.0)
        try:
            for _ in range(cycles):
                if not incremental:
                    scheduler._cache.invalidate_all()
                scheduler.run_cycle()
        finally:
            scheduler.close()
    finally:
        set_tracer(prev_tracer)
        set_journal(prev_journal)
    return [rec.to_dict() for rec in journal.events()]


def child_main(plan_workers: int, cycles: int,
               incremental: bool = True) -> int:
    """``--determinism-child``: run the trace, one canonical JSON line
    per journal record on stdout, and the trace's seconds on stderr.
    Line-per-record keeps the parent's first-difference report
    readable."""
    t0 = time.perf_counter()
    records = run_trace(plan_workers, cycles, incremental=incremental)
    trace_s = time.perf_counter() - t0
    for rec in records:
        sys.stdout.write(
            json.dumps(rec, sort_keys=True, separators=(",", ":")) + "\n")
    sys.stderr.write(_TIMING_PREFIX
                     + json.dumps({"trace_s": trace_s}) + "\n")
    return 0


# -- parent: the matrix orchestrator ----------------------------------------

@dataclass
class CellResult:
    hash_seed: str
    plan_workers: int
    incremental: str
    output: bytes
    returncode: int
    stderr: str = ""
    wall_s: float = 0.0        # the child process, start to exit
    trace_s: float | None = None   # run_trace inside it (None: not said)

    @property
    def label(self) -> str:
        return (f"PYTHONHASHSEED={self.hash_seed} "
                f"plan_workers={self.plan_workers} "
                f"incremental={self.incremental}")


@dataclass
class DeterminismReport:
    cells: list[CellResult] = field(default_factory=list)
    failures: list[str] = field(default_factory=list)
    records: int = 0

    @property
    def ok(self) -> bool:
        return not self.failures

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "cells": [c.label for c in self.cells],
            "records": self.records,
            "failures": self.failures,
        }


def _first_divergence(ref: bytes, other: bytes) -> str:
    ref_lines = ref.decode(errors="replace").splitlines()
    other_lines = other.decode(errors="replace").splitlines()
    for i, (a, b) in enumerate(zip(ref_lines, other_lines)):
        if a != b:
            diff = "\n    ".join(difflib.ndiff([a], [b]))
            return f"first divergence at record {i + 1}:\n    {diff}"
    return (f"journals are a prefix of each other: "
            f"{len(ref_lines)} vs {len(other_lines)} records")


def _trace_seconds(stderr: str) -> float | None:
    for line in reversed(stderr.splitlines()):
        if line.startswith(_TIMING_PREFIX):
            try:
                return float(json.loads(
                    line[len(_TIMING_PREFIX):])["trace_s"])
            except (ValueError, KeyError, TypeError):
                return None
    return None


def run_cell(seed: str, workers: int, inc: str,
             cycles: int = DEFAULT_CYCLES) -> CellResult | str:
    """One cell in a fresh child interpreter: its result, or the failure
    text when the child outlived CHILD_TIMEOUT_S."""
    env = dict(os.environ)
    env["PYTHONHASHSEED"] = seed
    cmd = [sys.executable, "-m", "nos_tpu_torch.analysis",
           "--determinism-child",
           "--plan-workers", str(workers),
           "--incremental", inc,
           "--cycles", str(cycles)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            cmd, cwd=_repo_root(), env=env, capture_output=True,
            timeout=CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        return (f"child PYTHONHASHSEED={seed} plan_workers={workers} "
                f"incremental={inc} exceeded {CHILD_TIMEOUT_S}s")
    stderr = proc.stderr.decode(errors="replace")
    return CellResult(seed, workers, inc, proc.stdout, proc.returncode,
                      stderr, time.perf_counter() - t0,
                      _trace_seconds(stderr))


def judge(results: list[CellResult | str],
          verbose: bool = True) -> DeterminismReport:
    """Collect cell results (in matrix order) into a report: a child's
    timeout or non-zero exit is a failure, and every journal is
    byte-diffed against the first good cell's."""
    report = DeterminismReport()
    for result in results:
        if isinstance(result, str):
            report.failures.append(result)
            continue
        cell = result
        report.cells.append(cell)
        if cell.returncode != 0:
            report.failures.append(
                f"child {cell.label} exited {cell.returncode}:\n"
                f"{cell.stderr[-2000:]}")
        if verbose:
            print(f"nosdiff: {cell.label}: "
                  f"{len(cell.output.splitlines())} record(s)",
                  file=sys.stderr)
    good = [c for c in report.cells if c.returncode == 0]
    if not good:
        if not report.failures:
            report.failures.append("no child produced a journal")
        return report
    ref = good[0]
    report.records = len(ref.output.splitlines())
    if report.records == 0:
        report.failures.append(
            f"reference cell {ref.label} produced an EMPTY journal — "
            "the trace no longer records decisions, the gate is vacuous")
    for cell in good[1:]:
        if cell.output != ref.output:
            report.failures.append(
                f"journal diverges: {ref.label} vs {cell.label}\n"
                f"  {_first_divergence(ref.output, cell.output)}")
    return report


def matrix_cells(hash_seeds: tuple[str, ...] = HASH_SEEDS,
                 plan_workers: tuple[int, ...] = PLAN_WORKERS,
                 incremental: tuple[str, ...] = INCREMENTAL
                 ) -> list[tuple[str, int, str]]:
    """The matrix's (seed, workers, incremental) cells in order."""
    return list(itertools.product(hash_seeds, plan_workers, incremental))


def run_matrix(hash_seeds: tuple[str, ...] = HASH_SEEDS,
               plan_workers: tuple[int, ...] = PLAN_WORKERS,
               incremental: tuple[str, ...] = INCREMENTAL,
               cycles: int = DEFAULT_CYCLES,
               verbose: bool = True) -> DeterminismReport:
    """Spawn one child per (seed, workers, incremental) cell, one after
    another; byte-diff every journal against the first cell's."""
    return judge([run_cell(seed, workers, inc, cycles)
                  for seed, workers, inc
                  in matrix_cells(hash_seeds, plan_workers, incremental)],
                 verbose=verbose)


def main_determinism(fmt: str = "text",
                     cycles: int = DEFAULT_CYCLES) -> int:
    report = run_matrix(cycles=cycles, verbose=(fmt == "text"))
    if fmt == "json":
        print(json.dumps(report.to_dict(), indent=2))
    else:
        if report.ok:
            print(f"nosdiff: OK — {len(report.cells)} runs, "
                  f"{report.records} journal record(s), byte-identical "
                  f"across PYTHONHASHSEED x plan_workers x incremental")
        else:
            for failure in report.failures:
                print(f"nosdiff: FAIL — {failure}")
    return 0 if report.ok else 1
