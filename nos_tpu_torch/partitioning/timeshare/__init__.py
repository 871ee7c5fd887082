"""The MPS partitioning strategy, ``nos_tpu/partitioning/timeshare`` for
the port (reference internal/partitioning/mps/ and pkg/gpu/slicing/).
``factory.py``, which wires the PartitionerController, waits for the
controller slice."""

from .calculators import (
    TimesharePartitionCalculator, TimeshareProfileCalculator,
    TimeshareProfileFilter,
)
from .node import TimeshareNode, gpu_count, units_from_node
from .partitioner import (
    DEVICE_PLUGIN_CM_NAME, DEVICE_PLUGIN_CM_NAMESPACE, TimesharePartitioner,
    config_key, key_belongs_to_node, plan_id_from_key, to_plugin_config,
)
from .snapshot_taker import TimeshareSnapshotTaker

__all__ = [
    "TimeshareNode", "gpu_count", "units_from_node",
    "TimeshareProfileCalculator", "TimeshareProfileFilter",
    "TimesharePartitionCalculator",
    "TimesharePartitioner", "TimeshareSnapshotTaker",
    "DEVICE_PLUGIN_CM_NAME", "DEVICE_PLUGIN_CM_NAMESPACE",
    "config_key", "key_belongs_to_node", "plan_id_from_key",
    "to_plugin_config",
]
