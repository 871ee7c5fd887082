"""Wiring of the MIG partitioner controller,
``nos_tpu/partitioning/slicepart/factory.py`` for the port (reference
internal/partitioning/mig/factory.go:31-64).

As ``timeshare/factory.py`` does, ``new_slice_partitioner_controller``
builds the sequential ``GeometryPlanner`` on the default ``Framework``.
The JAX factory wraps a ``MultiHostGeometryPlanner`` (``group.py``:
multi-host carves, which no MIG instance needs) in a
``ParallelGeometryPlanner``, and adds the defrag and recovery planes;
the parallel planner and both planes come with ROADMAP queue 1 item 6.
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
from .calculators import SlicePartitionCalculator, SliceProfileCalculator
from .partitioner import SliceNodeInitializer, SlicePartitioner
from .snapshot_taker import SliceSnapshotTaker


def new_slice_partitioner_controller(
    api: APIServer, cluster_state: ClusterState,
    batch_timeout_s: float = 60.0, batch_idle_s: float = 10.0,
    clock: Callable[[], float] = time.monotonic,
):
    from nos_tpu_torch.controllers.partitioner_controller import (
        PartitionerController,
    )

    partition_calculator = SlicePartitionCalculator()
    planner = GeometryPlanner(
        framework=Framework(), calculator=SliceProfileCalculator(),
        partition_calculator=partition_calculator)
    quarantine = QuarantineList(kind=C.MIG_KIND, clock=clock)
    actuator = GeometryActuator(SlicePartitioner(api), partition_calculator,
                                quarantine=quarantine)
    batcher = Batcher(batch_timeout_s, batch_idle_s, clock=clock)
    return PartitionerController(
        api=api, cluster_state=cluster_state, kind=C.MIG_KIND,
        planner=planner, actuator=actuator,
        snapshot_taker=SliceSnapshotTaker(), batcher=batcher,
        quarantine=quarantine, clock=clock,
    )


def new_slice_initializer(api: APIServer) -> SliceNodeInitializer:
    return SliceNodeInitializer(api)
