"""Wiring of the MPS partitioner controller,
``nos_tpu/partitioning/timeshare/factory.py`` for the port (reference
internal/partitioning/mps/factory.go).

``new_timeshare_partitioner_controller`` builds a ``GeometryPlanner``
directly, on the default ``Framework``.  The JAX factory wraps it in a ``ParallelGeometryPlanner``,
which for one pool, or for fewer than ``PLAN_SHARD_MIN_HOSTS`` = 128
hosts, is that sequential planner
(``nos_tpu/partitioning/core/parallel.py:73, 141-145``).  The parallel
planner, with its worker and shard knobs, and the recovery plane's
knobs (warm spares, heartbeat suspicion, migration grace) come with
ROADMAP item 6; a framework of other plugins, the plan deadline and the
replan epoch with the mains that set them (item 8).
"""

from __future__ import annotations

import time
from typing import Callable

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.kube.client import APIServer
from nos_tpu_torch.scheduler.framework import Framework
from nos_tpu_torch.utils.batcher import Batcher

from ..core import GeometryActuator, GeometryPlanner, QuarantineList
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
    clock: Callable[[], float] = time.monotonic,
):
    from nos_tpu_torch.controllers.partitioner_controller import (
        PartitionerController,
    )

    partition_calculator = TimesharePartitionCalculator()
    planner = GeometryPlanner(
        framework=Framework(),
        calculator=TimeshareProfileCalculator(),
        partition_calculator=partition_calculator,
    )
    quarantine = QuarantineList(kind=C.MPS_KIND, clock=clock)
    actuator = GeometryActuator(
        TimesharePartitioner(api, cm_name, cm_namespace),
        partition_calculator, quarantine=quarantine)
    batcher = Batcher(batch_timeout_s, batch_idle_s, clock=clock)
    return PartitionerController(
        api=api, cluster_state=cluster_state, kind=C.MPS_KIND,
        planner=planner, actuator=actuator,
        snapshot_taker=TimeshareSnapshotTaker(), batcher=batcher,
        quarantine=quarantine, clock=clock,
    )
