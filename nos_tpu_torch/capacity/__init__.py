"""The cloud capacity plane, ``nos_tpu/capacity`` for the port: the
provisioner that grows, shrinks and heals the GPU node fleet against a
(stand-in) cloud node-pool API.

Every layer above assumes that the set of nodes is what the API server
says; this package is the only one that changes the set.  Two halves:

- ``cloudapi``: the provider, an asynchronous create and delete API
  whose operations land after a provisioning delay, with the fault seams
  (stockout, quota, 429, slow, zombie, failed delete) that
  ``nos_tpu_torch.testing.chaos.ChaosCloudGPUAPI`` overrides;
- ``provisioner``: the level-triggered reconcile: scale-up on sustained
  pending demand, scale-down of drained empty top-index nodes, warm
  spare replacement, a stockout breaker per (machine class, zone) with
  cross-pool spare borrowing, and deadline reaping of zombies.  It is
  crash-safe: the desired state is derived anew every poll from the
  observed inventory and a durable size record per pool.

Off means off: with ``ProvisionerConfig.enabled`` false (the default)
none of it is constructed, and the decision journal is byte-identical to
a build without the plane (``testing/fleet.py``'s quiescent capacity
fleet holds it).
"""

from .cloudapi import (
    AlreadyExistsError,
    CloudError,
    CloudGPUAPI,
    CloudNotFoundError,
    DeleteFailedError,
    QuotaExceededError,
    RateLimitedError,
    StockoutError,
)
from .provisioner import (
    BREAKER_CLOSED,
    BREAKER_HALF_OPEN,
    BREAKER_OPEN,
    CapacityProvisioner,
    StockoutBreaker,
)

__all__ = [
    "AlreadyExistsError",
    "BREAKER_CLOSED",
    "BREAKER_HALF_OPEN",
    "BREAKER_OPEN",
    "CapacityProvisioner",
    "CloudError",
    "CloudGPUAPI",
    "CloudNotFoundError",
    "DeleteFailedError",
    "QuotaExceededError",
    "RateLimitedError",
    "StockoutError",
    "StockoutBreaker",
]
