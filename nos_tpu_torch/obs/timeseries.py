"""Windowed samples of the metrics registry, ``nos_tpu/obs/timeseries.py``
for the port.

The SLO engine (``obs/slo.py``) judges windows ("the last 60 s against
the last 5 min"), but the registry holds lifetime aggregates only.  A
run loop calls ``TimeSeriesSampler.tick()``, which takes one
``Registry.snapshot()`` into a bounded ring and starts the registry's
next max window (``Registry.reset_window()``: the ``<name>_max`` series
are the max since the last tick).

As the journal: the ring is bounded (the newest ``maxlen`` ticks, the
evicted ones counted), ``tick()`` builds its point before it takes the
ring's lock and calls nothing under it, and timestamps come from the
sampler's injectable clock.
"""

from __future__ import annotations

import time
from typing import Callable

from nos_tpu_torch.exporter.metrics import REGISTRY, Registry

from ._ring import BoundedRing

REGISTRY.describe("nos_tpu_timeseries_points_dropped_total",
                  "Sample points evicted from the bounded series ring")


class SamplePoint:
    """One tick's view of every series: ``values`` is the
    ``Registry.snapshot()`` dict (name -> {series: value})."""

    __slots__ = ("ts", "values")

    def __init__(self, ts: float, values: dict) -> None:
        self.ts = ts
        self.values = values

    def get(self, name: str, series: str = "") -> float | None:
        return self.values.get(name, {}).get(series)

    def to_dict(self) -> dict:
        return {"ts": self.ts, "values": self.values}


class TimeSeriesSampler(BoundedRing):
    """The bounded ring of registry samples.  ``maxlen`` times the tick
    interval is the longest window the engine can judge: 720 points at
    a 1 s tick hold the 5-minute slow window 2.4 times over."""

    def __init__(self, registry: Registry | None = None,
                 maxlen: int = 720,
                 clock: Callable[[], float] = time.monotonic) -> None:
        super().__init__(maxlen)
        self._registry = registry if registry is not None else REGISTRY
        self._clock = clock

    def tick(self) -> SamplePoint:
        """Sample every series and start the next max window; the
        registry's lock is released before the ring's is taken."""
        values = self._registry.snapshot()
        self._registry.reset_window()
        point = SamplePoint(self._clock(), values)
        with self._lock:
            evicted = self._push_locked(point)
        if evicted:
            # into the sampled registry: a sampler over a registry of its
            # own reports its truncation there, not in the process's
            self._registry.inc("nos_tpu_timeseries_points_dropped_total")
        return point

    # -- windowed reads ------------------------------------------------------
    def points(self) -> list[SamplePoint]:
        """Every kept point, oldest first."""
        with self._lock:
            return list(self._items)

    def latest(self) -> SamplePoint | None:
        with self._lock:
            return self._items[-1] if self._items else None

    def bracket(self, window_s: float) -> tuple[SamplePoint, SamplePoint] | None:
        """(start, end) spanning at least ``window_s`` seconds up to the
        newest point: start is the newest point at or before ``end.ts -
        window_s``.  None until the ring covers a whole window, which
        the engine reads as "not yet observable", never as a verdict."""
        with self._lock:
            pts = list(self._items)
        if len(pts) < 2:
            return None
        end = pts[-1]
        cutoff = end.ts - window_s
        start: SamplePoint | None = None
        for p in pts:
            if p.ts <= cutoff:
                start = p
            else:
                break
        if start is None or start is end:
            return None
        return start, end
