"""Device-agnostic partitioning engine core, ``nos_tpu/partitioning/core``
for the port (reference internal/partitioning/core/): the planner, the
parallel planner and its pools, the actuator, the quarantine, the
recovery plane and the background defragmenter."""

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
    REASON_ACTUATION, REASON_PLAN_DEADLINE, REASON_SUSPECT, QuarantineList,
)
from .actuator import GeometryActuator, compute_partitioning_state, new_plan_id
from .pools import PlanPool, partition_pools, split_pods
from .defrag import DefragProposer
from .parallel import PLAN_SHARD_MIN_HOSTS, ParallelGeometryPlanner
from .failure import (
    SelfHealingPolicy, heal_stray_migration_drains, healthy_spares_by_pool,
    host_index_vacancies, is_warm_spare, promote_spare,
)

__all__ = [
    "Actuator", "NodeInitializer", "PartitionableNode",
    "PartitionCalculator", "Partitioner",
    "Planner", "ProfileRequest", "SliceCalculator", "SliceFilter",
    "SnapshotTaker", "Sorter",
    "ClusterSnapshot", "SnapshotError", "SliceTracker", "ProfileAwareSorter",
    "GeometryPlanner", "GeometryActuator", "compute_partitioning_state",
    "new_plan_id", "QuarantineList", "REASON_ACTUATION",
    "REASON_PLAN_DEADLINE", "REASON_SUSPECT",
    "PlanPool", "partition_pools", "split_pods", "DefragProposer",
    "PLAN_SHARD_MIN_HOSTS", "ParallelGeometryPlanner",
    "SelfHealingPolicy", "heal_stray_migration_drains",
    "healthy_spares_by_pool", "host_index_vacancies", "is_warm_spare",
    "promote_spare",
]
