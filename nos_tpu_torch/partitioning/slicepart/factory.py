"""Wiring of the MIG partitioner controller,
``nos_tpu/partitioning/slicepart/factory.py`` for the port (reference
internal/partitioning/mig/factory.go:31-64).

As ``timeshare/factory.py`` does, ``new_slice_partitioner_controller``
wraps the sequential ``GeometryPlanner`` in a ``ParallelGeometryPlanner``
and builds the recovery plane when ``spare_hosts_per_pool`` or
``node_suspect_after_s`` is set, and passes the plan deadline and the
replan epoch to the controller.  With ``defrag_enabled`` it builds the
background defragmenter (``core/defrag.py``), stepping at most every
``defrag_interval_s`` (None: the replan epoch, else the batch's idle
window); disabled, it is never built.  ``registry`` is the MIG tables
the snapshot and the defragmenter read (a restricted table, as the
fleets' stand-in has it); None is the default registry.  The planner is
a ``MultiHostGeometryPlanner``, as in the JAX factory: the per-node
planner with ``group.py``'s NVLink block pass in front.  The MPS family
has no defragmenter, as in the JAX package.
"""

from __future__ import annotations

import time
from typing import Callable

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.kube.client import APIServer
from nos_tpu_torch.scheduler.framework import Framework
from nos_tpu_torch.topology.known import DEFAULT_REGISTRY, GpuModelRegistry
from nos_tpu_torch.utils.batcher import Batcher

from ..core import (
    PLAN_SHARD_MIN_HOSTS, DefragProposer, GeometryActuator,
    ParallelGeometryPlanner, QuarantineList, SelfHealingPolicy,
)
from ..state import ClusterState
from .calculators import SlicePartitionCalculator, SliceProfileCalculator
from .group import MultiHostGeometryPlanner
from .partitioner import SliceNodeInitializer, SlicePartitioner
from .snapshot_taker import SliceSnapshotTaker


def new_slice_partitioner_controller(
    api: APIServer, cluster_state: ClusterState,
    batch_timeout_s: float = 60.0, batch_idle_s: float = 10.0,
    plan_deadline_s: float | None = None,
    replan_epoch_s: float | None = None,
    plan_shard_min_hosts: int = PLAN_SHARD_MIN_HOSTS,
    plan_workers: int = 0,
    defrag_enabled: bool = False,
    defrag_payback_min: float = 1.5,
    defrag_interval_s: float | None = None,
    defrag_drain_timeout_s: float = 120.0,
    defrag_progress_fn: Callable | None = None,
    spare_hosts_per_pool: int = 0,
    node_suspect_after_s: float = 0.0,
    migrate_grace_s: float = 5.0,
    registry: GpuModelRegistry | None = None,
    clock: Callable[[], float] = time.monotonic,
):
    from nos_tpu_torch.controllers.partitioner_controller import (
        PartitionerController,
    )

    partition_calculator = SlicePartitionCalculator()

    def make_planner() -> MultiHostGeometryPlanner:
        # one framework per shard: its plugin lock must not serialise
        # concurrent shards
        return MultiHostGeometryPlanner(
            framework=Framework(), calculator=SliceProfileCalculator(),
            partition_calculator=partition_calculator)

    planner = ParallelGeometryPlanner(
        make_planner, SliceProfileCalculator(), kind=C.MIG_KIND,
        max_workers=plan_workers, min_shard_hosts=plan_shard_min_hosts,
        clock=clock)
    quarantine = QuarantineList(kind=C.MIG_KIND, clock=clock)
    actuator = GeometryActuator(SlicePartitioner(api), partition_calculator,
                                quarantine=quarantine)
    batcher = Batcher(batch_timeout_s, batch_idle_s, clock=clock)
    defrag = None
    if defrag_enabled:
        defrag = DefragProposer(
            api, C.MIG_KIND, SliceProfileCalculator(),
            payback_min=defrag_payback_min,
            interval_s=(defrag_interval_s if defrag_interval_s is not None
                        else (replan_epoch_s or batch_idle_s)),
            drain_timeout_s=defrag_drain_timeout_s,
            progress_fn=defrag_progress_fn,
            registry=registry or DEFAULT_REGISTRY, clock=clock)
    recovery = None
    if spare_hosts_per_pool > 0 or node_suspect_after_s > 0:
        recovery = SelfHealingPolicy(
            api, C.MIG_KIND, quarantine,
            spare_hosts_per_pool=spare_hosts_per_pool,
            suspect_after_s=node_suspect_after_s,
            migrate_grace_s=migrate_grace_s, clock=clock)
    return PartitionerController(
        api=api, cluster_state=cluster_state, kind=C.MIG_KIND,
        planner=planner, actuator=actuator,
        snapshot_taker=(SliceSnapshotTaker() if registry is None
                        else SliceSnapshotTaker(registry)),
        batcher=batcher,
        quarantine=quarantine, plan_deadline_s=plan_deadline_s,
        replan_epoch_s=replan_epoch_s, defrag=defrag, recovery=recovery,
        clock=clock,
    )


def new_slice_initializer(api: APIServer) -> SliceNodeInitializer:
    return SliceNodeInitializer(api)
