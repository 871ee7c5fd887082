"""nos_tpu_torch.sim: the event-driven simulator, ``nos_tpu/sim`` for the
port.  So far its clock and sources alone: one virtual clock and one
deterministically ordered event queue (``engine``), and reusable trace
sources that compose into one stream (``trace``), which the request
router's tests and the serving fleets (``testing/fleet.py``) drive.

The chaos injectors, the declarative scenario assembly, the report
contract and the worst-week scenario with its what-if planner wait for
the capacity plane (``capacity/``), whose chaos cloud the injectors
drive (ROADMAP).
"""

from .engine import PRIO_FAULT, PRIO_SAMPLE, PRIO_TICK, PRIO_TRACE, SimEngine
from .trace import (
    ArrivalSource, AtSource, ComposedTrace, DiurnalLoadSource,
    NodeKillSource, SamplerSource, TickSource, TraceSource, WindowSource,
    compose)

__all__ = [
    "PRIO_FAULT", "PRIO_SAMPLE", "PRIO_TICK", "PRIO_TRACE", "SimEngine",
    "ArrivalSource", "AtSource", "ComposedTrace", "DiurnalLoadSource",
    "NodeKillSource", "SamplerSource", "TickSource", "TraceSource",
    "WindowSource", "compose",
]
