"""Device-agnostic partitioning engine core, ``nos_tpu/partitioning/core``
for the port (reference internal/partitioning/core/).  The parallel
planner and its pools, the defragmenter, the failure plane and the
quarantine list wait for later slices."""

from .interfaces import (
    Actuator, PartitionableNode, PartitionCalculator, Partitioner, Planner,
    ProfileRequest, SliceCalculator, SliceFilter, SnapshotTaker, Sorter,
)
from .snapshot import ClusterSnapshot, SnapshotError
from .tracker import SliceTracker
from .sorter import ProfileAwareSorter
from .planner import GeometryPlanner
from .actuator import GeometryActuator, compute_partitioning_state, new_plan_id

__all__ = [
    "Actuator", "PartitionableNode", "PartitionCalculator", "Partitioner",
    "Planner", "ProfileRequest", "SliceCalculator", "SliceFilter",
    "SnapshotTaker", "Sorter",
    "ClusterSnapshot", "SnapshotError", "SliceTracker", "ProfileAwareSorter",
    "GeometryPlanner", "GeometryActuator", "compute_partitioning_state",
    "new_plan_id",
]
