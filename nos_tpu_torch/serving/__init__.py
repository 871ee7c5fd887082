"""The serving plane, ``nos_tpu/serving`` for the port: the latency-SLO
inference workload class.

- the tier contract (``api/constants.py``'s LABEL_TIER, read by
  ``utils.pod_util.workload_tier``): serving pods are scheduled first
  every cycle and are never in-quota preemption victims;
- the replica autoscaler (``serving.autoscaler``): scales each
  service's replica pods on their load annotations, with hysteresis and
  cooldowns inside a min/max band;
- the request-stream generator (``serving.trace``): a deterministic
  bursty, diurnal, millions-of-users load curve, which the serving
  fleets (``testing/fleet.py``) drive through the control plane.
"""

from .autoscaler import (
    ReplicaAutoscaler, ServingService, replica_load, replica_sessions,
)
from .trace import DiurnalTrace

__all__ = ["ReplicaAutoscaler", "ServingService", "DiurnalTrace",
           "replica_load", "replica_sessions"]
