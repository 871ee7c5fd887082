"""A traced run's profile, read from the Chrome trace that
``torch.profiler`` (Kineto) exports.

Each device activity (kernel, copy, memset) is tied to the CPU op that
launched it: the activity's ``correlation`` id names its CUDA launch
call, and the ops open on the launching thread at that
moment (``cpu_op`` and ``user_annotation`` events, nested) are its
chain, innermost first.  Where no launch call was recorded, the
activity's ``External id`` names the op.  Nothing is read from a
kernel's name, so a metric reads the same work whatever kernel does it.

The window is the ``portbench.window`` annotation, the steps the
``portbench.step`` annotations inside it; only activity that starts in
the window counts."""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
from pathlib import Path

WINDOW = "portbench.window"
STEP = "portbench.step"
_HOST = ("cpu_op", "user_annotation")
_LAUNCH = ("cuda_runtime", "cuda_driver")
_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Op:
    name: str
    ts: float
    end: float
    tid: tuple
    parent: int = -1


@dataclasses.dataclass
class Activity:
    name: str
    ts: float
    dur: float
    op: int          # innermost op that launched it, -1 for none


@dataclasses.dataclass
class Trace:
    ops: list[Op]
    device: list[Activity]
    window: tuple[float, float]       # us
    steps: int

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def chain(self, act: Activity) -> list[int]:
        """The op indices of an activity's chain, innermost first."""
        out, i = [], act.op
        while i >= 0:
            out.append(i)
            i = self.ops[i].parent
        return out

    def owner(self, act: Activity, rules: dict) -> tuple[str | None, int]:
        """The group of the innermost op in the chain that some rule
        (name -> predicate on an op name) matches, and that op; (None, -1)
        when no rule matches."""
        for i in self.chain(act):
            for group, match in rules.items():
                if match(self.ops[i].name):
                    return group, i
        return None, -1

    def busy(self) -> list[tuple[float, float]]:
        """The union of device activity in the window, as intervals."""
        spans = sorted((a.ts, min(a.ts + a.dur, self.window[1]))
                       for a in self.device)
        out: list[list[float]] = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) * 1e-6

    def host_at(self, t: float) -> str:
        """What the host was doing at time t: the outermost and innermost
        ops open then under the window (on any thread)."""
        best = None
        for i, op in enumerate(self.ops):
            if op.ts <= t <= op.end and op.name not in (WINDOW, STEP):
                if best is None or self._depth(i) > self._depth(best):
                    best = i
        if best is None:
            return "host outside any op"
        top = best
        while self.ops[top].parent >= 0 and \
                self.ops[self.ops[top].parent].name not in (WINDOW, STEP):
            top = self.ops[top].parent
        if top == best:
            return self.ops[best].name
        return f"{self.ops[top].name} > {self.ops[best].name}"

    def _depth(self, i: int) -> int:
        d = 0
        while self.ops[i].parent >= 0:
            i, d = self.ops[i].parent, d + 1
        return d


def _nest(ops: list[Op]) -> None:
    """Set each op's parent: the innermost op of its thread open at its
    start."""
    by_tid = collections.defaultdict(list)
    for i, op in enumerate(ops):
        by_tid[op.tid].append(i)
    for idx in by_tid.values():
        idx.sort(key=lambda i: (ops[i].ts, -ops[i].end))
        stack: list[int] = []
        for i in idx:
            while stack and ops[stack[-1]].end < ops[i].ts:
                stack.pop()
            ops[i].parent = stack[-1] if stack else -1
            stack.append(i)


def _innermost(ops: list[Op], starts: dict, tid: tuple, t: float) -> int:
    """The innermost op of thread ``tid`` open at time t, -1 if none."""
    idx, keys = starts.get(tid, ([], []))
    j = bisect.bisect_right(keys, t) - 1
    # the op that starts last before t, or the parent of it still open
    i = idx[j] if j >= 0 else -1
    while i >= 0 and ops[i].end < t:
        i = ops[i].parent
    return i


def parse(events: list[dict]) -> Trace:
    ops: list[Op] = []
    by_ext: dict[int, int] = {}
    launches: dict[int, tuple[tuple, float]] = {}
    device: list[dict] = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, args = ev.get("cat", ""), ev.get("args", {})
        if cat in _HOST:
            ops.append(Op(ev["name"], float(ev["ts"]),
                          float(ev["ts"]) + float(ev.get("dur", 0)),
                          (ev.get("pid"), ev.get("tid"))))
            if "External id" in args and cat == "cpu_op":
                by_ext[args["External id"]] = len(ops) - 1
        elif cat in _LAUNCH and "correlation" in args:
            launches[args["correlation"]] = ((ev.get("pid"), ev.get("tid")),
                                             float(ev["ts"]))
        elif cat in _DEVICE:
            device.append(ev)
    _nest(ops)
    starts: dict = {}
    for tid in {op.tid for op in ops}:
        idx = sorted((i for i, op in enumerate(ops) if op.tid == tid),
                     key=lambda i: ops[i].ts)
        starts[tid] = (idx, [ops[i].ts for i in idx])
    windows = [op for op in ops if op.name == WINDOW]
    if len(windows) != 1:
        raise ValueError(f"the trace has {len(windows)} {WINDOW} "
                         f"annotations, not one")
    window = (windows[0].ts, windows[0].end)
    steps = sum(1 for op in ops if op.name == STEP
                and window[0] <= op.ts <= window[1])
    acts = []
    for ev in device:
        ts = float(ev["ts"])
        if not window[0] <= ts <= window[1]:
            continue
        args = ev.get("args", {})
        op = -1
        launch = launches.get(args.get("correlation"))
        if launch is not None:
            op = _innermost(ops, starts, *launch)
        if op < 0:
            op = by_ext.get(args.get("External id"), -1)
        acts.append(Activity(ev["name"], ts, float(ev.get("dur", 0)), op))
    return Trace(ops, acts, window, steps)


def load(path: str | Path) -> Trace:
    return parse(json.loads(Path(path).read_text())["traceEvents"])


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time in the window, by op
    chain (outermost op under the step > innermost > kernel), and the
    longest idle gaps by what the host was doing, in seconds."""
    time: collections.Counter = collections.Counter()
    for a in trace.device:
        chain = [trace.ops[i].name for i in trace.chain(a)
                 if trace.ops[i].name not in (WINDOW, STEP)]
        where = " > ".join(dict.fromkeys([chain[-1], chain[0]])) \
            if chain else "no op"
        time[f"{where} > {a.name[:80]}"] += a.dur * 1e-6
    busy = trace.busy()
    edges = [trace.window[0]] + [t for s, e in busy for t in (s, e)] \
        + [trace.window[1]]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    return {"device_ops": [[n, s] for n, s in time.most_common(top)],
            "idle_gaps": [[trace.host_at((s + e) / 2), (e - s) * 1e-6]
                          for s, e in gaps[:top]]}
