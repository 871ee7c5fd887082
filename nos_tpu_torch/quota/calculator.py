"""GPU resource calculator: a pod's request in the quota currency,
``nos_tpu/quota/calculator.py`` for the port.

The reference derives the scalar ``nos.nebuly.com/gpu-memory`` (GB) from
a pod's GPU requests so that one quota covers whole GPUs, MIG instances
and shared GPUs in one fungible unit (pkg/gpu/util/resource.go:28-86):

- whole GPUs (``nvidia.com/gpu``): count x ``gb_per_gpu``;
- MIG profiles (``nvidia.com/mig-<g>g.<N>gb``): the profile's memory in
  the H100 80GB table (``topology/known.py``; 3g.40gb -> 40), the N of
  its name for a profile the table lacks;
- MPS shares (``nvidia.com/gpu-<N>gb``): N.

The JAX package's host-shard accounting (``chips_per_host``, one unit
of a multi-host slice charged its host's share) has no GPU counterpart:
no MIG instance or MPS share spans nodes, so every unit is charged whole.
"""

from __future__ import annotations

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.kube.resources import ResourceList, pod_request
from nos_tpu_torch.topology.known import H100_80GB
from nos_tpu_torch.topology.profile import (
    PROFILE_RE, gb_from_resource, profile_from_resource,
)


class GPUResourceCalculator:
    """Pod requests with ``nos.nebuly.com/gpu-memory`` added.
    ``gb_per_gpu`` is the reference operator's
    ``nvidiaGpuResourceMemoryGB`` (80 here, an H100 80GB)."""

    def __init__(self, gb_per_gpu: int = 80) -> None:
        self.gb_per_gpu = gb_per_gpu

    def compute_pod_request(self, pod) -> ResourceList:
        req = pod_request(pod)
        req[C.RESOURCE_GPU_MEMORY] = float(
            self.compute_required_gpu_memory_gb(req))
        return req

    def compute_required_gpu_memory_gb(self, request: ResourceList) -> int:
        total = 0
        for resource, qty in request.items():
            if qty <= 0:
                continue
            if resource == C.RESOURCE_GPU:
                total += self.gb_per_gpu * int(qty)
                continue
            profile = profile_from_resource(resource)
            if profile is not None:
                total += self.profile_gb(profile) * int(qty)
                continue
            gb = gb_from_resource(resource)
            if gb is not None:
                total += gb * int(qty)
        return total

    def profile_gb(self, profile: str) -> int:
        row = H100_80GB.profile(profile)
        if row is not None:
            return row.memory_gb
        return int(PROFILE_RE.match(profile).group("gb"))
