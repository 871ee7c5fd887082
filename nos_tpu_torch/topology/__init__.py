"""GPU domain model: the H100's MIG profiles and memory shares, the port
of ``nos_tpu/topology`` (the analog of reference pkg/gpu/)."""

from .known import (DEFAULT_REGISTRY, H100_80GB, MODELS, GpuModel,
                    GpuModelRegistry, MigProfile)
from .geometry import Geometry, geometry_equal, num_slices, fewest_slices_geometry
from .packing import Placement, pack, feasible, extend, enumerate_geometries
from .device import Device, DeviceList, USED, FREE, make_device_id
from . import errors, profile

__all__ = [
    "GpuModel", "MigProfile", "GpuModelRegistry", "DEFAULT_REGISTRY",
    "H100_80GB", "MODELS",
    "Geometry", "geometry_equal", "num_slices", "fewest_slices_geometry",
    "Placement", "pack", "feasible", "extend", "enumerate_geometries",
    "Device", "DeviceList", "USED", "FREE", "make_device_id",
    "errors", "profile",
]
