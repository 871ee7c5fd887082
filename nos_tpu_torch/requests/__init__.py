"""The inference request data plane, ``nos_tpu/requests`` for the port:
the path from user to GPU, modelled request by request.

- ``costs``: the prefill/decode split priced from the card's published
  peaks (compute-bound prompt processing, memory-bound token
  generation) and the KV capacity the replica's GB leave after the
  weights;
- ``replica``: a continuous-batching replica: bounded admission queue,
  reserve-ahead KV occupancy, prefill/decode time-sharing and the
  disaggregation handoff;
- ``router``: session-affine, KV-aware routing with shed-with-retry, the
  prefill/decode pool split, and the downward-API publication the
  replica autoscaler scales on.

The plane is deterministic end to end: time is injected, request
streams are seeded arrival processes (``sim/trace.py``), and a routed
run's journal is byte-identical across source installation order and
router worker counts.
"""

from .costs import (
    HBM_BYTES_PER_S, ModelProfile, RequestCostModel, hbm_bandwidth_for,
)
from .replica import ContinuousBatchingReplica, Request
from .router import (
    PHASE_DECODE, PHASE_PREFILL, PHASE_TOTAL, RouterService,
    ServingRouter,
)

__all__ = [
    "HBM_BYTES_PER_S",
    "ModelProfile",
    "RequestCostModel",
    "hbm_bandwidth_for",
    "ContinuousBatchingReplica",
    "Request",
    "PHASE_DECODE",
    "PHASE_PREFILL",
    "PHASE_TOTAL",
    "RouterService",
    "ServingRouter",
]
