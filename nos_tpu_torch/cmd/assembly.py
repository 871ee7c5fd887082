"""Component assembly, the part of ``nos_tpu/cmd/assembly.py`` the port
has: ``build_scheduler``, the scheduler a main, the smoke run and the
tests all wire the same way."""

from __future__ import annotations

from nos_tpu_torch.kube.client import APIServer
from nos_tpu_torch.quota import GPUResourceCalculator
from nos_tpu_torch.scheduler.capacityscheduling import CapacityScheduling
from nos_tpu_torch.scheduler.framework import (
    Framework, MigrationDrainGuard, NodeResourcesFit, SpareGuard,
)
from nos_tpu_torch.scheduler.gang import TopologyFilter
from nos_tpu_torch.scheduler.scheduler import Scheduler


def build_scheduler(api: APIServer, gpu_memory_gb_per_gpu: int = 80,
                    clock=None) -> Scheduler:
    """The rebuilt kube-scheduler (reference cmd/scheduler/
    scheduler.go:43-59): NodeResourcesFit, the recovery plane's
    SpareGuard and MigrationDrainGuard, the gangs' TopologyFilter, then
    CapacityScheduling with its ledger attached to ``api``, quotas in
    ``gpu-memory`` GB at ``gpu_memory_gb_per_gpu`` a whole GPU; the JAX
    package's order.  The guards reject only what the recovery plane
    marks (a warm-spare label, a migration drain), so with the plane off
    the framework decides as it would without them."""
    plugin = CapacityScheduling(GPUResourceCalculator(gpu_memory_gb_per_gpu))
    fw = Framework([NodeResourcesFit(), SpareGuard(), MigrationDrainGuard(),
                    TopologyFilter(api), plugin])
    plugin.set_framework(fw)
    plugin.attach(api)
    kwargs = {} if clock is None else {"clock": clock}
    return Scheduler(api, fw, plugin, **kwargs)
