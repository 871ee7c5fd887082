"""Trace composition, ``nos_tpu/sim/trace.py`` for the port (copied):
reusable event sources that merge into one stream.

Each ``TraceSource`` knows how to install its events onto a
``SimEngine``; ``compose`` merges any number of them into one scenario.
Because the engine's tie-break contract orders same-timestamp events by
``(priority, label, seq)`` and every source stamps a stable label, the
composed stream is independent of composition order — the property the
worst-week scenario leans on when it stacks node kills *during* a
maintenance drain *during* a serving burst *during* a quota storm.

Sources come in two flavours:

- **schedule-complete** (``AtSource``, ``WindowSource`` subclasses):
  the fire times are known up front and installed eagerly;
- **self-scheduling** (``TickSource``, ``ArrivalSource``): each firing
  schedules the next, so a week-long Poisson process costs one pending
  event at a time, not a week of materialized ones.

All randomness is pre-seeded ``random.Random`` per source — a scenario
seed reproduces the exact event stream (time is an argument, never a
call).
"""

from __future__ import annotations

import math
import random
from typing import Callable, Optional, Sequence

from .engine import PRIO_FAULT, PRIO_SAMPLE, PRIO_TICK, PRIO_TRACE, SimEngine


class TraceSource:
    """One reusable event source.  ``install`` schedules this source's
    events onto the engine; the label namespaces its tie-breaks."""

    label = "trace"

    def install(self, engine: SimEngine) -> None:
        raise NotImplementedError


class ComposedTrace(TraceSource):
    """Any number of sources merged into one stream.  Installation
    order is irrelevant to the fired order (the engine orders by label
    at equal timestamps); sources are still installed sorted by label
    so the seq numbers themselves are reproducible too."""

    label = "composed"

    def __init__(self, *sources: TraceSource) -> None:
        self.sources = list(sources)

    def install(self, engine: SimEngine) -> None:
        for src in sorted(self.sources, key=lambda s: s.label):
            src.install(engine)


def compose(*sources: TraceSource) -> ComposedTrace:
    return ComposedTrace(*sources)


class TickSource(TraceSource):
    """Periodic control-loop work — the ported bench tick body.  Exact
    ``while now < until: now += period; fn()`` semantics (see
    ``SimEngine.tick_loop``)."""

    def __init__(self, period: float, fn: Callable[[], None], *,
                 until: float,
                 while_fn: Optional[Callable[[], bool]] = None,
                 label: str = "tick",
                 priority: int = PRIO_TICK) -> None:
        self.period = period
        self.fn = fn
        self.until = until
        self.while_fn = while_fn
        self.label = label
        self.priority = priority

    def install(self, engine: SimEngine) -> None:
        engine.tick_loop(self.period, self.fn, until=self.until,
                         while_fn=self.while_fn, priority=self.priority,
                         label=self.label)


class AtSource(TraceSource):
    """Fire ``fn(t)`` at each listed time — the one-shot scenario
    events: a node kill, a replacement joining, a quota re-split."""

    def __init__(self, times: Sequence[float],
                 fn: Callable[[float], None], *,
                 label: str, priority: int = PRIO_FAULT) -> None:
        self.times = sorted(times)
        self.fn = fn
        self.label = label
        self.priority = priority

    def install(self, engine: SimEngine) -> None:
        for t in self.times:
            engine.at(t, (lambda when=t: self.fn(when)),
                      priority=self.priority, label=self.label)


class WindowSource(TraceSource):
    """A fault with an extent: ``open_fn(t)`` at start,
    ``close_fn(t)`` at start+duration — stockouts, maintenance drains,
    serving bursts."""

    def __init__(self, windows: Sequence[tuple[float, float]],
                 open_fn: Callable[[float], None],
                 close_fn: Callable[[float], None], *,
                 label: str, priority: int = PRIO_FAULT) -> None:
        self.windows = sorted(windows)
        self.open_fn = open_fn
        self.close_fn = close_fn
        self.label = label
        self.priority = priority

    def install(self, engine: SimEngine) -> None:
        for start, duration in self.windows:
            engine.at(start, (lambda t=start: self.open_fn(t)),
                      priority=self.priority, label=self.label + "/open")
            engine.at(start + duration,
                      (lambda t=start + duration: self.close_fn(t)),
                      priority=self.priority, label=self.label + "/close")


class ArrivalSource(TraceSource):
    """Inhomogeneous Poisson arrivals by thinning, lazily scheduled:
    ``rate_fn(t)`` is the instantaneous rate (events/s), bounded by
    ``peak_rate``; each accepted arrival calls ``fn(t)``.  One pending
    event regardless of horizon — a week of arrivals costs a week of
    arrivals, not a week of ticks."""

    def __init__(self, seed: int, rate_fn: Callable[[float], float],
                 fn: Callable[[float], None], *, peak_rate: float,
                 until: float, label: str = "arrival",
                 priority: int = PRIO_TRACE) -> None:
        if peak_rate <= 0.0:
            raise ValueError("peak_rate must be > 0")
        self.rng = random.Random(seed)
        self.rate_fn = rate_fn
        self.fn = fn
        self.peak_rate = peak_rate
        self.until = until
        self.label = label
        self.priority = priority

    def install(self, engine: SimEngine) -> None:
        self._arm(engine, engine.now())

    def _arm(self, engine: SimEngine, t: float) -> None:
        # thinning: candidate gaps at the peak rate, accepted with
        # probability rate(t)/peak — both draws consumed unconditionally
        # so the stream is a pure function of (seed, rate_fn)
        while True:
            t += -math.log(1.0 - self.rng.random()) / self.peak_rate
            accept = self.rng.random() < self.rate_fn(t) / self.peak_rate
            if t >= self.until:
                return
            if accept:
                break
        engine.at(t, (lambda when=t: self._fire(engine, when)),
                  priority=self.priority, label=self.label)

    def _fire(self, engine: SimEngine, t: float) -> None:
        self.fn(t)
        self._arm(engine, t)


class DiurnalLoadSource(TraceSource):
    """Periodic samples of a diurnal serving-load curve: every
    ``period`` seconds, ``fn(t, load)`` with ``load = load_fn(t)`` —
    the autoscaler reconcile cadence of the worst-week scenario.
    ``load_fn`` is typically ``DiurnalTrace.load_at``
    (``serving/trace.py``), reused rather than re-derived."""

    def __init__(self, load_fn: Callable[[float], float],
                 fn: Callable[[float, float], None], *, period: float,
                 until: float, label: str = "diurnal",
                 priority: int = PRIO_TRACE) -> None:
        self.load_fn = load_fn
        self.fn = fn
        self.period = period
        self.until = until
        self.label = label
        self.priority = priority

    def install(self, engine: SimEngine) -> None:
        t = engine.now() + self.period
        while t <= self.until:
            engine.at(t, (lambda when=t: self.fn(when,
                                                 self.load_fn(when))),
                      priority=self.priority, label=self.label)
            t += self.period


class NodeKillSource(TraceSource):
    """Seeded Poisson node kills (spot reclamations / hardware loss)
    over the horizon: each event calls ``kill_fn(t)`` which picks its
    own victim deterministically.  A fixed schedule (the bench ports'
    pinned kill times) uses ``AtSource`` with label ``node-kill``."""

    label = "node-kill"

    def __init__(self, seed: int, rate_per_s: float,
                 kill_fn: Callable[[float], None], *,
                 until: float) -> None:
        self._arrivals = ArrivalSource(
            seed, lambda _t: rate_per_s, kill_fn,
            peak_rate=max(rate_per_s, 1e-12), until=until,
            label=self.label, priority=PRIO_FAULT)

    def install(self, engine: SimEngine) -> None:
        self._arrivals.install(engine)


class SamplerSource(TraceSource):
    """Periodic observation work that must see post-tick state — SLO
    sampling, utilization gauges, ledger observes.  Same cadence
    mechanics as DiurnalLoadSource but at PRIO_SAMPLE so it orders
    after every same-timestamp mutation."""

    def __init__(self, period: float, fn: Callable[[float], None], *,
                 until: float, label: str = "sample") -> None:
        self.period = period
        self.fn = fn
        self.until = until
        self.label = label

    def install(self, engine: SimEngine) -> None:
        t = engine.now() + self.period
        while t <= self.until:
            engine.at(t, (lambda when=t: self.fn(when)),
                      priority=PRIO_SAMPLE, label=self.label)
            t += self.period
