"""Device-layer interfaces: the native boundary seam,
``nos_tpu/device/tpuclient.py`` for the port.

Analogs of reference pkg/gpu/nvml/interface.go:23-35 (`nvml.Client`, the
CGo boundary), pkg/gpu/mig/client.go:28-35 (`mig.Client`, node-local
orchestration of NVML ∩ kubelet pod-resources), and
pkg/resource/client.go:26-29 (`resource.Client`, kubelet pod-resources).

Everything above this seam is testable with fakes
(``nos_tpu_torch/device/fake.py``).  On the card the implementation is
``nos_tpu_torch/device/nvml.py``, NVML through ``ctypes``.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

from nos_tpu_torch.topology import Device, DeviceList, FREE, Placement, USED


class GpuRuntimeClient(ABC):
    """The native boundary: MIG device lifecycle on one host."""

    @abstractmethod
    def topology(self) -> tuple[str, tuple[bool, ...]]:
        """(accelerator name, MIG mode of each GPU in index order)."""

    @abstractmethod
    def list_devices(self) -> DeviceList:
        """Every MIG device on this host (no used/free knowledge)."""

    @abstractmethod
    def placements(self) -> dict[str, Placement]:
        """device id -> its placement on its GPU's memory slots."""

    @abstractmethod
    def create_slices(self, unit_index: int, profiles: list[str]) -> list[str]:
        """Create MIG devices of ``profiles`` on GPU ``unit_index``,
        placed around the existing ones; all-or-nothing with cleanup on
        failure (the NVML permutation search, reference
        pkg/gpu/nvml/client.go:286-340)."""

    @abstractmethod
    def delete_slice(self, device_id: str) -> None: ...

    @abstractmethod
    def delete_all_except(self, device_ids: set[str]) -> list[str]:
        """Startup cleanup (reference cmd/migagent/migagent.go:190-199)."""


class PodResourcesClient(ABC):
    """Which device ids are allocated to running pods (kubelet
    pod-resources socket analog, reference pkg/resource/lister.go:28)."""

    @abstractmethod
    def used_device_ids(self) -> set[str]: ...


class SliceDeviceClient:
    """mig.Client analog: runtime devices ∩ pod-resources usage ->
    used/free DeviceList (reference pkg/gpu/mig/client.go:28-174)."""

    def __init__(self, runtime: GpuRuntimeClient,
                 pod_resources: PodResourcesClient) -> None:
        self.runtime = runtime
        self.pod_resources = pod_resources

    def get_devices(self) -> DeviceList:
        used_ids = self.pod_resources.used_device_ids()
        out = DeviceList()
        for d in self.runtime.list_devices():
            status = USED if d.device_id in used_ids else FREE
            out.append(Device(d.resource_name, d.device_id, status, d.unit_index))
        return out

    def create_slices(self, unit_index: int, profiles: list[str]) -> list[str]:
        return self.runtime.create_slices(unit_index, profiles)

    def delete_slice(self, device_id: str) -> None:
        self.runtime.delete_slice(device_id)

    def delete_all_except(self, keep: set[str]) -> list[str]:
        return self.runtime.delete_all_except(keep)
