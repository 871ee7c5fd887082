"""Component assembly shared by the mains, the smoke run and the tests,
``nos_tpu/cmd/assembly.py`` for the port: the construction the reference
spreads over its mains (cmd/gpupartitioner/gpupartitioner.go:72-380 et
al.), factored so that a main and a test wire the same control plane.
"""

from __future__ import annotations

import logging

from nos_tpu_torch.api.config import (
    HYBRID_KIND, MIG_KIND, MPS_KIND, PartitionerConfig, ProvisionerConfig,
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
            ctl = new_slice_partitioner_controller(
                api, state, defrag_enabled=cfg.defrag_enabled,
                defrag_payback_min=cfg.defrag_payback_min,
                defrag_interval_s=cfg.defrag_interval_s or None,
                defrag_drain_timeout_s=cfg.defrag_drain_timeout_s,
                **timing)
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


def build_provisioner_main(api: APIServer, cfg: ProvisionerConfig,
                           cloud=None, main: Main | None = None,
                           clock=None) -> Main:
    """The capacity provisioner as a leader-gated run loop; returns the
    Main (``main.provisioner`` is the reconciler, for tests and the
    smoke run).

    Off means off: only for ``cfg.enabled`` true; the disabled path
    (``cmd/provisioner.py``, the fleets' plane-off runs) never constructs
    the plane, so its decision journal is byte-identical to a build
    without it.  ``cloud`` defaults to an in-memory ``CloudGPUAPI``
    (tests pass a ``ChaosCloudGPUAPI``).  The report is the ``capacity``
    block of the flight snapshot (``obs capacity``)."""
    from nos_tpu_torch.capacity import CapacityProvisioner, CloudGPUAPI
    from nos_tpu_torch.obs import set_flight_block

    if not cfg.enabled:
        raise ValueError("build_provisioner_main requires enabled=true "
                         "(off means off: the disabled path never "
                         "constructs the capacity plane)")
    main = main or Main("nos-tpu-provisioner", cfg.health_probe_addr,
                        api=api)
    kwargs = {} if clock is None else {"clock": clock}
    if cloud is None:
        cloud = CloudGPUAPI(provision_delay_s=cfg.provision_delay_s,
                            quota_nodes=cfg.quota_nodes, **kwargs)
    provisioner = CapacityProvisioner(
        api, cloud,
        scale_up_deficit_chips=cfg.scale_up_deficit_chips,
        scale_up_after_s=cfg.scale_up_after_s,
        scale_up_cooldown_s=cfg.scale_up_cooldown_s,
        max_pending_creates=cfg.max_pending_creates,
        scale_down_idle_s=cfg.scale_down_idle_s,
        scale_down_cooldown_s=cfg.scale_down_cooldown_s,
        min_hosts_per_pool=cfg.min_hosts_per_pool,
        provision_deadline_s=cfg.provision_deadline_s,
        join_grace_s=cfg.join_grace_s,
        vacancy_grace_s=cfg.vacancy_grace_s,
        breaker_threshold=cfg.breaker_threshold,
        breaker_open_s=cfg.breaker_open_s,
        spare_target_per_pool=cfg.spare_target_per_pool,
        inventory_configmap=cfg.inventory_configmap,
        inventory_namespace=cfg.inventory_namespace,
        chips_per_host_cap=cfg.chips_per_host_cap,
        hbm_gb_per_chip=cfg.hbm_gb_per_chip,
        cloud_attempts=cfg.cloud_attempts,
        **kwargs)
    main.provisioner = provisioner
    set_flight_block("capacity", provisioner.report)

    def bind() -> None:
        """The reconcile writes (cloud creates and deletes, Node
        deletes, the inventory ConfigMap), so under leader election it
        binds only on gaining the lease: a standby must not
        provision."""
        main.add_loop("provisioner", provisioner.reconcile,
                      cfg.poll_interval_s)

    if cfg.leader_election:
        from nos_tpu_torch.kube.leaderelection import LeaderElector

        main.attach_leader_election(LeaderElector(
            api, "nos-tpu-provisioner-leader", on_started_leading=bind))
    else:
        bind()
    if cfg.slo_interval_s > 0:
        main.attach_slo(interval_s=cfg.slo_interval_s)
    return main


def build_scheduler(api: APIServer, gpu_memory_gb_per_gpu: int = 80,
                    preempt_budget_per_cycle: int | None = None,
                    displaced_age_cap_s: float | None = None,
                    elastic_grow_budget_per_cycle: int = 1,
                    clock=None,
                    drain_preempt_after_cycles: int = 0,
                    drain_preempt_max_busy_fraction: float = 0.25,
                    drain_preempt_spare_progress: float = 0.75,
                    drain_preempt_progress_fn=None,
                    shard_chips_per_host: int = 0,
                    registry=None) -> Scheduler:
    """The rebuilt kube-scheduler (reference cmd/scheduler/
    scheduler.go:43-59): NodeResourcesFit, the recovery plane's
    SpareGuard and MigrationDrainGuard, the gangs' TopologyFilter, then
    CapacityScheduling with its ledger attached to ``api``, quotas in
    ``gpu-memory`` GB at ``gpu_memory_gb_per_gpu`` a whole GPU; the JAX
    package's order.  The guards reject only what the recovery plane
    marks (a warm-spare label, a migration drain), so with the plane off
    the framework decides as it would without them.  None for a knob
    keeps the scheduler's default (``scheduler/scheduler.py``); the
    elastic grow pass grows up to ``elastic_grow_budget_per_cycle``
    gangs a cycle (0: off), 1 as in the JAX package.  Drain preemption
    runs with ``drain_preempt_after_cycles`` above 0 (0: off, as in the
    JAX package's config), and ``shard_chips_per_host`` above 0 charges
    one unit of an NVLink block that many GPUs of quota.  ``registry``
    (None: the default) is the GPU models whose blocks the score's window
    term reads."""
    plugin = CapacityScheduling(GPUResourceCalculator(
        gpu_memory_gb_per_gpu, shard_chips_per_host))
    fw = Framework([NodeResourcesFit(), SpareGuard(), MigrationDrainGuard(),
                    TopologyFilter(api), plugin])
    plugin.set_framework(fw)
    plugin.attach(api)
    kwargs = {} if clock is None else {"clock": clock}
    if registry is not None:
        kwargs["registry"] = registry
    return Scheduler(
        api, fw, plugin, preempt_budget_per_cycle=preempt_budget_per_cycle,
        displaced_age_cap_s=displaced_age_cap_s,
        elastic_grow_budget_per_cycle=elastic_grow_budget_per_cycle,
        drain_preempt_after_cycles=drain_preempt_after_cycles or None,
        drain_preempt_max_busy_fraction=drain_preempt_max_busy_fraction,
        drain_preempt_spare_progress=drain_preempt_spare_progress,
        drain_preempt_progress_fn=drain_preempt_progress_fn,
        **kwargs)
