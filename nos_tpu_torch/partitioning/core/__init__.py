"""Device-agnostic partitioning engine core, ``nos_tpu/partitioning/core``
for the port (reference internal/partitioning/core/).  The parallel
planner and its pools, the defragmenter and the failure plane wait for
ROADMAP item 6."""

from .interfaces import (
    Actuator, NodeInitializer, PartitionableNode, PartitionCalculator,
    Partitioner, Planner, ProfileRequest, SliceCalculator, SliceFilter,
    SnapshotTaker, Sorter,
)
from .snapshot import ClusterSnapshot, SnapshotError
from .tracker import SliceTracker
from .sorter import ProfileAwareSorter
from .planner import GeometryPlanner
from .quarantine import (
    REASON_ACTUATION, REASON_PLAN_DEADLINE, QuarantineList,
)
from .actuator import GeometryActuator, compute_partitioning_state, new_plan_id

__all__ = [
    "Actuator", "NodeInitializer", "PartitionableNode",
    "PartitionCalculator", "Partitioner",
    "Planner", "ProfileRequest", "SliceCalculator", "SliceFilter",
    "SnapshotTaker", "Sorter",
    "ClusterSnapshot", "SnapshotError", "SliceTracker", "ProfileAwareSorter",
    "GeometryPlanner", "GeometryActuator", "compute_partitioning_state",
    "new_plan_id", "QuarantineList", "REASON_ACTUATION",
    "REASON_PLAN_DEADLINE",
]
