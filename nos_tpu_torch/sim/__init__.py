"""nos_tpu_torch.sim: the event-driven simulator, ``nos_tpu/sim`` for the
port.  So far its clock, its sources and its fault injectors: one
virtual clock and one deterministically ordered event queue
(``engine``), reusable trace sources that compose into one stream
(``trace``), which the request router's tests and the serving fleets
(``testing/fleet.py``) drive, and the chaos substrates scheduled as
sources (``injectors``).

The declarative scenario assembly, the report contract and the
worst-week scenario with its what-if planner are still to come
(ROADMAP).
"""

from .engine import PRIO_FAULT, PRIO_SAMPLE, PRIO_TICK, PRIO_TRACE, SimEngine
from .trace import (
    ArrivalSource, AtSource, ComposedTrace, DiurnalLoadSource,
    NodeKillSource, SamplerSource, TickSource, TraceSource, WindowSource,
    compose)
from .injectors import APIChaosInjector, CloudChaosInjector, install_all

__all__ = [
    "APIChaosInjector", "CloudChaosInjector", "install_all",
    "PRIO_FAULT", "PRIO_SAMPLE", "PRIO_TICK", "PRIO_TRACE", "SimEngine",
    "ArrivalSource", "AtSource", "ComposedTrace", "DiurnalLoadSource",
    "NodeKillSource", "SamplerSource", "TickSource", "TraceSource",
    "WindowSource", "compose",
]
