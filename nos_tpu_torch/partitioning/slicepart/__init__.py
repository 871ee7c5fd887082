"""The MIG partitioning strategy, ``nos_tpu/partitioning/slicepart`` for
the port (reference internal/partitioning/mig/), with ``factory.py``'s
wiring of the partitioner controller and the virgin-node initializer."""

from .calculators import (
    SlicePartitionCalculator, SliceProfileCalculator, SliceProfileFilter,
)
from .node import SliceNode, units_from_node
from .partitioner import (
    SliceNodeInitializer, SlicePartitioner, is_node_initialized,
)
from .snapshot_taker import SliceSnapshotTaker
from .factory import new_slice_initializer, new_slice_partitioner_controller

__all__ = [
    "SliceNode", "units_from_node",
    "SliceProfileCalculator", "SliceProfileFilter", "SlicePartitionCalculator",
    "SlicePartitioner", "SliceNodeInitializer", "is_node_initialized",
    "SliceSnapshotTaker", "new_slice_partitioner_controller",
    "new_slice_initializer",
]
