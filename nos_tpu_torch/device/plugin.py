"""MIG device-plugin re-advertisement, ``nos_tpu/device/plugin.py`` for
the port.

The reference reloads the device inventory by deleting the device-plugin
pod and waiting for its recreation (pkg/gpu/client.go:37-135).  Here
``refresh`` recomputes the node's ``nvidia.com/mig-<profile>``
allocatable and capacity straight from the runtime's device list and
stamps a generation annotation, a readiness signal in place of the
reference's blind sleep.  The kubelet-facing gRPC plugin manager that
the JAX client can also sync is left out with the device plugins
(ROADMAP tag 24b).
"""

from __future__ import annotations

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.kube.client import APIServer, KIND_NODE
from nos_tpu_torch.kube.objects import Node
from nos_tpu_torch.topology.profile import is_slice_resource
from nos_tpu_torch.utils.retry import retry_on_conflict

from .gpuclient import GpuRuntimeClient


class DevicePluginClient:
    def __init__(self, api: APIServer, node_name: str,
                 runtime: GpuRuntimeClient) -> None:
        self._api = api
        self._node_name = node_name
        self._runtime = runtime

    def refresh(self) -> int:
        """Re-advertise the MIG resources from the carved devices;
        returns the new plugin generation."""
        counts: dict[str, float] = {}
        for d in self._runtime.list_devices():
            counts[d.resource_name] = counts.get(d.resource_name, 0.0) + 1.0
        new_gen = 0

        def mutate(node: Node) -> None:
            nonlocal new_gen
            for table in (node.status.allocatable, node.status.capacity):
                for res in [r for r in table if is_slice_resource(r)]:
                    del table[res]
            node.status.allocatable.update(counts)
            node.status.capacity.update(node.status.allocatable)
            new_gen = int(node.metadata.annotations.get(
                C.ANNOT_PLUGIN_GENERATION, "0")) + 1
            node.metadata.annotations[C.ANNOT_PLUGIN_GENERATION] = str(new_gen)

        retry_on_conflict(self._api, KIND_NODE, self._node_name, mutate,
                          component="device-plugin")
        return new_gen
