"""Typed errors for the GPU domain layer, ``nos_tpu/topology/errors.py``
for the port.

Analog of reference pkg/gpu/errors.go:17-99 (NotFoundErr/GenericErr with
IsNotFound, ErrorList).
"""

from __future__ import annotations


class TopologyError(Exception):
    """Base class for accelerator domain errors."""


class DeviceNotFoundError(TopologyError):
    pass


class InvalidGeometryError(TopologyError):
    pass


class PlacementInfeasibleError(TopologyError):
    """A create set that cannot be placed around the pinned used devices.
    Distinct from transient failures: retrying the same plan is pointless,
    and the planner must re-plan with placement knowledge (the reference's
    exhausted NVML permutation search, pkg/gpu/nvml/client.go:286-340)."""


class InvalidProfileError(TopologyError):
    pass


class ErrorList(TopologyError):
    def __init__(self, errors: list[Exception]):
        self.errors = errors
        super().__init__("; ".join(str(e) for e in errors))

    def __bool__(self) -> bool:
        return bool(self.errors)


def is_not_found(err: Exception) -> bool:
    return isinstance(err, DeviceNotFoundError)
