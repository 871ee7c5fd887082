"""Wiring of the MPS partitioner controller,
``nos_tpu/partitioning/timeshare/factory.py`` for the port (reference
internal/partitioning/mps/factory.go).

``new_timeshare_partitioner_controller`` wraps the sequential
``GeometryPlanner`` (one per shard, each on its own ``Framework``) in a
``ParallelGeometryPlanner``, which for one pool, or fewer than
``plan_shard_min_hosts`` nodes, is that sequential planner.  The
recovery plane (``spare_hosts_per_pool``, ``node_suspect_after_s``,
``migrate_grace_s``) is built only when one of the first two knobs is
set.  The plan deadline and the replan epoch go to the controller
(None: its defaults); the partitioner main sets them.
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
from .calculators import TimesharePartitionCalculator, TimeshareProfileCalculator
from .partitioner import (
    DEVICE_PLUGIN_CM_NAME, DEVICE_PLUGIN_CM_NAMESPACE, TimesharePartitioner,
)
from .snapshot_taker import TimeshareSnapshotTaker


def new_timeshare_partitioner_controller(
    api: APIServer, cluster_state: ClusterState,
    batch_timeout_s: float = 60.0, batch_idle_s: float = 10.0,
    cm_name: str = DEVICE_PLUGIN_CM_NAME,
    cm_namespace: str = DEVICE_PLUGIN_CM_NAMESPACE,
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

    partition_calculator = TimesharePartitionCalculator()

    def make_planner() -> GeometryPlanner:
        return GeometryPlanner(
            framework=Framework(),
            calculator=TimeshareProfileCalculator(),
            partition_calculator=partition_calculator,
        )

    planner = ParallelGeometryPlanner(
        make_planner, TimeshareProfileCalculator(), kind=C.MPS_KIND,
        max_workers=plan_workers, min_shard_hosts=plan_shard_min_hosts,
        clock=clock)
    quarantine = QuarantineList(kind=C.MPS_KIND, clock=clock)
    actuator = GeometryActuator(
        TimesharePartitioner(api, cm_name, cm_namespace),
        partition_calculator, quarantine=quarantine)
    batcher = Batcher(batch_timeout_s, batch_idle_s, clock=clock)
    recovery = None
    if spare_hosts_per_pool > 0 or node_suspect_after_s > 0:
        recovery = SelfHealingPolicy(
            api, C.MPS_KIND, quarantine,
            spare_hosts_per_pool=spare_hosts_per_pool,
            suspect_after_s=node_suspect_after_s,
            migrate_grace_s=migrate_grace_s, clock=clock)
    return PartitionerController(
        api=api, cluster_state=cluster_state, kind=C.MPS_KIND,
        planner=planner, actuator=actuator,
        snapshot_taker=TimeshareSnapshotTaker(), batcher=batcher,
        quarantine=quarantine, plan_deadline_s=plan_deadline_s,
        replan_epoch_s=replan_epoch_s, recovery=recovery, clock=clock,
    )
