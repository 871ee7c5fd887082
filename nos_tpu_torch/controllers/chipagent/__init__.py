"""The MPS node agent, ``nos_tpu/controllers/chipagent`` for the port
(reference cmd/gpuagent and internal/controllers/gpuagent)."""

from .agent import ChipAgent
from .reporter import ChipReporter

__all__ = ["ChipAgent", "ChipReporter"]
