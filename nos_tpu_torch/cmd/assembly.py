"""Component assembly shared by the mains, the smoke run and the tests,
``nos_tpu/cmd/assembly.py`` for the port: the construction the reference
spreads over its mains (cmd/gpupartitioner/gpupartitioner.go:72-380 et
al.), factored so that a main and a test wire the same control plane.

``build_provisioner_main`` waits for the capacity plane (ROADMAP item 9
part 2).
"""

from __future__ import annotations

import logging

from nos_tpu_torch.api.config import (
    HYBRID_KIND, MIG_KIND, MPS_KIND, PartitionerConfig, missing_planes,
)
from nos_tpu_torch.cmd._runtime import Main
from nos_tpu_torch.kube.client import APIServer
from nos_tpu_torch.partitioning.state import ClusterState
from nos_tpu_torch.quota import GPUResourceCalculator
from nos_tpu_torch.scheduler.capacityscheduling import CapacityScheduling
from nos_tpu_torch.scheduler.framework import (
    Framework, MigrationDrainGuard, NodeResourcesFit, SpareGuard,
)
from nos_tpu_torch.scheduler.gang import TopologyFilter
from nos_tpu_torch.scheduler.scheduler import Scheduler

logger = logging.getLogger(__name__)


def log_missing_planes(name: str, cfg) -> None:
    """Name, once, the ROADMAP item of each plane whose knobs the config
    carries at the JAX package's defaults."""
    for line in missing_planes(cfg):
        logger.info("%s: %s", name, line)


def build_partitioner_main(api: APIServer, state: ClusterState,
                           cfg: PartitionerConfig,
                           main: Main | None = None) -> tuple[Main, list]:
    """The node and pod controllers and the partitioner controller of
    each configured kind (``mig``, ``mps``, both for ``hybrid``) as run
    loops on ``main``, with every knob of the config passed on."""
    from nos_tpu_torch.controllers.node_controller import NodeController
    from nos_tpu_torch.controllers.pod_controller import PodController
    from nos_tpu_torch.partitioning.slicepart.factory import (
        new_slice_initializer, new_slice_partitioner_controller,
    )
    from nos_tpu_torch.partitioning.timeshare.factory import (
        new_timeshare_partitioner_controller,
    )

    if cfg.known_geometries_file:
        from nos_tpu_torch.topology import DEFAULT_REGISTRY

        DEFAULT_REGISTRY.load_overrides(cfg.known_geometries_file)
    main = main or Main("nos-tpu-partitioner", cfg.health_probe_addr,
                        api=api)
    log_missing_planes(main.name, cfg)
    controllers = []
    timing = {"batch_timeout_s": cfg.batch_timeout_s,
              "batch_idle_s": cfg.batch_idle_s,
              "plan_deadline_s": cfg.plan_deadline_s or None,
              "replan_epoch_s": cfg.replan_epoch_s or None,
              "plan_shard_min_hosts": cfg.plan_shard_min_hosts,
              "plan_workers": cfg.plan_workers,
              "spare_hosts_per_pool": cfg.spare_hosts_per_pool,
              "node_suspect_after_s": cfg.node_suspect_after_s,
              "migrate_grace_s": cfg.migrate_grace_s}

    def bind_controllers() -> None:
        """The watch-bound controllers write (node init, spec
        annotations), so under leader election they bind only on
        gaining the lease: a standby must not reconcile."""
        NodeController(api, state, new_slice_initializer(api)).bind()
        PodController(api, state).bind()
        if cfg.kind in (MIG_KIND, HYBRID_KIND):
            ctl = new_slice_partitioner_controller(api, state, **timing)
            ctl.bind()
            controllers.append(ctl)
            main.add_loop("partitioner-mig", ctl.process_if_ready,
                          cfg.poll_interval_s)
        if cfg.kind in (MPS_KIND, HYBRID_KIND):
            ctl = new_timeshare_partitioner_controller(
                api, state, cm_name=cfg.device_plugin_cm_name,
                cm_namespace=cfg.device_plugin_cm_namespace, **timing)
            ctl.bind()
            controllers.append(ctl)
            main.add_loop("partitioner-mps", ctl.process_if_ready,
                          cfg.poll_interval_s)

    if cfg.leader_election:
        from nos_tpu_torch.kube.leaderelection import LeaderElector

        main.attach_leader_election(LeaderElector(
            api, "nos-tpu-partitioner-leader",
            on_started_leading=bind_controllers))
    else:
        bind_controllers()
    return main, controllers


def build_scheduler(api: APIServer, gpu_memory_gb_per_gpu: int = 80,
                    preempt_budget_per_cycle: int | None = None,
                    displaced_age_cap_s: float | None = None,
                    clock=None) -> Scheduler:
    """The rebuilt kube-scheduler (reference cmd/scheduler/
    scheduler.go:43-59): NodeResourcesFit, the recovery plane's
    SpareGuard and MigrationDrainGuard, the gangs' TopologyFilter, then
    CapacityScheduling with its ledger attached to ``api``, quotas in
    ``gpu-memory`` GB at ``gpu_memory_gb_per_gpu`` a whole GPU; the JAX
    package's order.  The guards reject only what the recovery plane
    marks (a warm-spare label, a migration drain), so with the plane off
    the framework decides as it would without them.  None for a knob
    keeps the scheduler's default (``scheduler/scheduler.py``)."""
    plugin = CapacityScheduling(GPUResourceCalculator(gpu_memory_gb_per_gpu))
    fw = Framework([NodeResourcesFit(), SpareGuard(), MigrationDrainGuard(),
                    TopologyFilter(api), plugin])
    plugin.set_framework(fw)
    plugin.attach(api)
    kwargs = {} if clock is None else {"clock": clock}
    return Scheduler(api, fw, plugin,
                     preempt_budget_per_cycle=preempt_budget_per_cycle,
                     displaced_age_cap_s=displaced_age_cap_s, **kwargs)
