"""Fault injectors as trace sources, ``nos_tpu/sim/injectors.py`` for the
port.

``ChaosAPIServer`` and ``ChaosCloudGPUAPI`` (``testing/chaos.py``) model
the production fault classes: write conflicts, transient errors, watch
drops, stockouts, slow provisioning.  The injectors here put them on the
engine's clock, so a scenario schedules chaos instead of running under a
constant rate: a stockout opened during a demand step, the conflict rate
raised for one window, dropped watch events replayed at a pinned
instant.

Injectors compose on one run (``tests/test_torch_sim.py`` holds it
against the JAX package's): each is a ``TraceSource`` with a label of
its own, so events at the same instant order by the engine's contract.
"""

from __future__ import annotations

from typing import Optional, Sequence

from nos_tpu_torch.testing.chaos import ChaosAPIServer, ChaosCloudGPUAPI

from .engine import PRIO_FAULT, SimEngine
from .trace import TraceSource, WindowSource


class APIChaosInjector(TraceSource):
    """Windows of elevated APIServer fault rates: during each
    ``(start, duration)`` window the chaos server runs at the given
    conflict/transient rates; outside the windows it is clean.  A
    scheduled ``replay_dropped`` at window close converges any withheld
    watch events (the informer-resync model)."""

    label = "api-chaos"

    def __init__(self, api: ChaosAPIServer,
                 windows: Sequence[tuple[float, float]], *,
                 conflict_rate: float = 0.0,
                 transient_rate: float = 0.0,
                 drop_watch_rate: float = 0.0) -> None:
        self.api = api
        self.conflict_rate = conflict_rate
        self.transient_rate = transient_rate
        self.drop_watch_rate = drop_watch_rate
        self._windows = WindowSource(
            windows, self._open, self._close, label=self.label,
            priority=PRIO_FAULT)

    def _open(self, _t: float) -> None:
        self.api._conflict_rate = self.conflict_rate
        self.api._transient_rate = self.transient_rate
        self.api._drop_watch_rate = self.drop_watch_rate

    def _close(self, _t: float) -> None:
        self.api._conflict_rate = 0.0
        self.api._transient_rate = 0.0
        self.api._drop_watch_rate = 0.0
        self.api.replay_dropped()

    def install(self, engine: SimEngine) -> None:
        self._windows.install(engine)


class CloudChaosInjector(TraceSource):
    """Scheduled zonal stockouts on the cloud node-pool API: each
    window opens ``inject_stockout`` for its duration (the API clears
    it by its own clock; an explicit clear at close keeps the window
    authoritative even if the API's duration drifts)."""

    label = "cloud-chaos"

    def __init__(self, cloud: ChaosCloudGPUAPI,
                 windows: Sequence[tuple[float, float]], *,
                 machine_class: str, zone: str = "-") -> None:
        self.cloud = cloud
        self.machine_class = machine_class
        self.zone = zone
        self._windows = WindowSource(
            windows, self._open, self._close,
            label=f"{self.label}/{machine_class}/{zone}",
            priority=PRIO_FAULT)
        self.opened = 0
        self.closed = 0

    def _open(self, _t: float) -> None:
        self.opened += 1
        self.cloud.inject_stockout(
            self.machine_class, self.zone, duration_s=float("inf"))

    def _close(self, _t: float) -> None:
        self.closed += 1
        self.cloud.clear_stockout(self.machine_class, self.zone)

    def install(self, engine: SimEngine) -> None:
        self._windows.install(engine)


def install_all(engine: SimEngine,
                injectors: Sequence[TraceSource],
                extra: Optional[Sequence[TraceSource]] = None) -> None:
    """Install fault injectors (plus any extra sources) onto one run,
    label-sorted like ``compose`` so composition order never changes
    the stream."""
    sources = list(injectors) + list(extra or [])
    for src in sorted(sources, key=lambda s: s.label):
        src.install(engine)
