"""GPU resource calculator: a pod's request in the quota currency,
``nos_tpu/quota/calculator.py`` for the port.

The reference derives the scalar ``nos.nebuly.com/gpu-memory`` (GB) from
a pod's GPU requests so that one quota covers whole GPUs, MIG instances
and shared GPUs in one fungible unit (pkg/gpu/util/resource.go:28-86):

- whole GPUs (``nvidia.com/gpu``): count x ``gb_per_gpu``;
- MIG profiles (``nvidia.com/mig-<g>g.<N>gb``): the profile's memory in
  the H100 80GB table (``topology/known.py``; 3g.40gb -> 40), the N of
  its name for a profile the table lacks;
- MPS shares (``nvidia.com/gpu-<N>gb``): N;
- NVLink block members (``nos.nebuly.com/nvlink-block-<N>x<G>``): the
  block's GPUs x ``gb_per_gpu``, or, with host-shard accounting on, one
  node's share of them.

Host-shard accounting (``gpus_per_host`` > 0, the JAX package's
``chips_per_host``): one unit of a block is one node's shard of it (the
partitioner advertises a unit per member node, and each gang member
binds one), so a member is charged the GPUs it owns, not the whole
block.  With 0 each member of an N-node gang books the block N times,
which overstates a gang-heavy namespace's usage N-fold.  Set it to the
nodes' GPU count (8 on an HGX H100) unless node sizes are mixed; as in
the JAX package it applies only where it divides the block's GPUs.
"""

from __future__ import annotations

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.kube.resources import ResourceList, pod_request
from nos_tpu_torch.topology.known import H100_80GB
from nos_tpu_torch.topology.profile import (
    PROFILE_RE, block_gpus, gb_from_resource, is_block_profile,
    profile_from_resource,
)


class GPUResourceCalculator:
    """Pod requests with ``nos.nebuly.com/gpu-memory`` added.
    ``gb_per_gpu`` is the reference operator's
    ``nvidiaGpuResourceMemoryGB`` (80 here, an H100 80GB)."""

    def __init__(self, gb_per_gpu: int = 80, gpus_per_host: int = 0) -> None:
        self.gb_per_gpu = gb_per_gpu
        self.gpus_per_host = gpus_per_host

    def _unit_gpus(self, profile: str) -> int:
        """The GPUs charged for one unit of a block profile."""
        gpus = block_gpus(profile)
        if 0 < self.gpus_per_host < gpus \
                and gpus % self.gpus_per_host == 0:
            return self.gpus_per_host
        return gpus

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
        if is_block_profile(profile):
            return self._unit_gpus(profile) * self.gb_per_gpu
        row = H100_80GB.profile(profile)
        if row is not None:
            return row.memory_gb
        return int(PROFILE_RE.match(profile).group("gb"))
