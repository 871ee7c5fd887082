"""Wiring of the MIG partitioner controller,
``nos_tpu/partitioning/slicepart/factory.py`` for the port (reference
internal/partitioning/mig/factory.go:31-64).

As ``timeshare/factory.py`` does, ``new_slice_partitioner_controller``
wraps the sequential ``GeometryPlanner`` in a ``ParallelGeometryPlanner``
and builds the recovery plane when ``spare_hosts_per_pool`` or
``node_suspect_after_s`` is set, and passes the plan deadline and the
replan epoch to the controller.  The JAX factory's planner is a
``MultiHostGeometryPlanner`` (``group.py``: multi-host carves, which no
MIG instance needs), and it adds the defrag plane, which waits for the
windows, elastic gangs and the ledger (ROADMAP item 6).
"""

from __future__ import annotations

import time
from typing import Callable

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.kube.client import APIServer
from nos_tpu_torch.scheduler.framework import Framework
from nos_tpu_torch.utils.batcher import Batcher

from ..core import (
    PLAN_SHARD_MIN_HOSTS, GeometryActuator, GeometryPlanner,
    ParallelGeometryPlanner, QuarantineList, SelfHealingPolicy,
)
from ..state import ClusterState
from .calculators import SlicePartitionCalculator, SliceProfileCalculator
from .partitioner import SliceNodeInitializer, SlicePartitioner
from .snapshot_taker import SliceSnapshotTaker


def new_slice_partitioner_controller(
    api: APIServer, cluster_state: ClusterState,
    batch_timeout_s: float = 60.0, batch_idle_s: float = 10.0,
    plan_deadline_s: float | None = None,
    replan_epoch_s: float | None = None,
    plan_shard_min_hosts: int = PLAN_SHARD_MIN_HOSTS,
    plan_workers: int = 0,
    spare_hosts_per_pool: int = 0,
    node_suspect_after_s: float = 0.0,
    migrate_grace_s: float = 5.0,
    clock: Callable[[], float] = time.monotonic,
):
    from nos_tpu_torch.controllers.partitioner_controller import (
        PartitionerController,
    )

    partition_calculator = SlicePartitionCalculator()

    def make_planner() -> GeometryPlanner:
        # one framework per shard: its plugin lock must not serialise
        # concurrent shards
        return GeometryPlanner(
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
        snapshot_taker=SliceSnapshotTaker(), batcher=batcher,
        quarantine=quarantine, plan_deadline_s=plan_deadline_s,
        replan_epoch_s=replan_epoch_s, recovery=recovery, clock=clock,
    )


def new_slice_initializer(api: APIServer) -> SliceNodeInitializer:
    return SliceNodeInitializer(api)
