"""nos_tpu_torch.sim: the event-driven fleet simulator, ``nos_tpu/sim``
for the port.

One virtual clock and one deterministically ordered event queue
(``engine``), reusable trace sources that compose into one scenario
(``trace``), pluggable chaos injectors (``injectors``), a declarative
control-plane assembly harness (``scenario``), the single report
contract (``report``), and the composed worst-week scenario with its
what-if capacity planner (``worstweek``, ``python -m
nos_tpu_torch.sim``).  The simulator runs in virtual time on the host:
nothing in it touches a GPU.
"""

from .engine import PRIO_FAULT, PRIO_SAMPLE, PRIO_TICK, PRIO_TRACE, SimEngine
from .injectors import APIChaosInjector, CloudChaosInjector, install_all
from .report import emit, stdout_to_stderr, write_report
from .scenario import (
    ControlPlane, PoolSpec, QuotaSpec, Scenario, assemble_control_plane)
from .trace import (
    ArrivalSource, AtSource, ComposedTrace, DiurnalLoadSource,
    NodeKillSource, SamplerSource, TickSource, TraceSource, WindowSource,
    compose)
from .worstweek import WorstWeek, WorstWeekConfig, run_what_if

__all__ = [
    "PRIO_FAULT", "PRIO_SAMPLE", "PRIO_TICK", "PRIO_TRACE", "SimEngine",
    "APIChaosInjector", "CloudChaosInjector", "install_all",
    "emit", "stdout_to_stderr", "write_report",
    "ControlPlane", "PoolSpec", "QuotaSpec", "Scenario",
    "assemble_control_plane",
    "ArrivalSource", "AtSource", "ComposedTrace", "DiurnalLoadSource",
    "NodeKillSource", "SamplerSource", "TickSource", "TraceSource",
    "WindowSource", "compose",
    "WorstWeek", "WorstWeekConfig", "run_what_if",
]
