"""Device: one allocatable sub-resource instance on a node,
``nos_tpu/topology/device.py`` for the port.

Analog of reference pkg/gpu/device.go:26-137 (`gpu.Device`/`DeviceList`):
a device couples an extended resource name with a concrete device id and
the partition root (the GPU) it was carved from, plus a used/free status
derived from the kubelet pod-resources view.
"""

from __future__ import annotations

from dataclasses import dataclass

USED = "used"
FREE = "free"


@dataclass(frozen=True)
class Device:
    resource_name: str      # e.g. "nvidia.com/mig-1g.10gb"
    device_id: str          # runtime device id (a MIG UUID on the card)
    status: str             # USED | FREE
    unit_index: int         # partition root: the GPU's index


class DeviceList(list):
    def group_by_unit(self) -> dict[int, "DeviceList"]:
        out: dict[int, DeviceList] = {}
        for d in self:
            out.setdefault(d.unit_index, DeviceList()).append(d)
        return out

    def group_by_resource(self) -> dict[str, "DeviceList"]:
        out: dict[str, DeviceList] = {}
        for d in self:
            out.setdefault(d.resource_name, DeviceList()).append(d)
        return out

    def with_status(self, status: str) -> "DeviceList":
        return DeviceList(d for d in self if d.status == status)

    def ids(self) -> list[str]:
        return [d.device_id for d in self]


def make_device_id(unit_index: int, resource_suffix: str, ordinal: int) -> str:
    """The framework's id for a device it carved (the JAX package's
    format, so both packages' control planes read one vocabulary)."""
    return f"tpu-{unit_index}-{resource_suffix}-{ordinal}"
