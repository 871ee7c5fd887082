"""The MIG node agent, ``nos_tpu/controllers/sliceagent`` for the port
(reference cmd/migagent and internal/controllers/migagent)."""

from .agent import SliceAgent
from .actuator import SliceActuator
from .reporter import SliceReporter
from .shared import SharedState

__all__ = ["SliceAgent", "SliceActuator", "SliceReporter", "SharedState"]
