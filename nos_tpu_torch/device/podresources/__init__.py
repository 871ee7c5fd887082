"""Kubelet pod-resources gRPC client, ``nos_tpu/device/podresources`` for
the port: the production ``PodResourcesClient``.

The reference dials the kubelet's pod-resources unix socket to learn
which devices are allocated to running pods
(pkg/resource/lister.go:28-38, client.go:39-87); this is the same
client for the MIG devices and the MPS shares
(``GPU_RESOURCE_PREFIXES``: ``nvidia.com/mig-*``, ``nvidia.com/gpu*``).
The proto subset lives in podresources.proto (its generated
podresources_pb2.py committed, byte for byte the JAX package's;
regenerate with ``protoc --python_out=. podresources.proto``).
``grpc`` and the generated module are imported in the constructor.

Everything above the ``PodResourcesClient`` seam keeps running against
``FakePodResources`` off a cluster.
"""

from __future__ import annotations

from nos_tpu_torch.device.gpuclient import PodResourcesClient
from nos_tpu_torch.device.plugin import POD_RESOURCES_SOCKET

DEFAULT_SOCKET = POD_RESOURCES_SOCKET
_LIST_METHOD = "/v1.PodResourcesLister/List"

# Resource prefixes whose device ids name GPU hardware.
GPU_RESOURCE_PREFIXES = ("nvidia.com/mig-", "nvidia.com/gpu")


class KubeletPodResourcesClient(PodResourcesClient):
    """PodResourcesClient over the kubelet's gRPC socket."""

    def __init__(self, socket_path: str = DEFAULT_SOCKET,
                 timeout_s: float = 5.0,
                 resource_prefixes=GPU_RESOURCE_PREFIXES) -> None:
        import grpc

        from . import podresources_pb2

        self._pb = podresources_pb2
        self._timeout = timeout_s
        self._prefixes = tuple(resource_prefixes)
        target = socket_path if "://" in socket_path \
            else f"unix://{socket_path}"
        self._channel = grpc.insecure_channel(target)
        self._list = self._channel.unary_unary(
            _LIST_METHOD,
            request_serializer=podresources_pb2.ListPodResourcesRequest
            .SerializeToString,
            response_deserializer=podresources_pb2.ListPodResourcesResponse
            .FromString,
        )

    def close(self) -> None:
        self._channel.close()

    def list_pod_resources(self):
        """Raw ListPodResourcesResponse (all resources, all pods)."""
        return self._list(self._pb.ListPodResourcesRequest(),
                          timeout=self._timeout)

    def used_device_ids(self) -> set[str]:
        out: set[str] = set()
        resp = self.list_pod_resources()
        for pod in resp.pod_resources:
            for container in pod.containers:
                for dev in container.devices:
                    if dev.resource_name.startswith(self._prefixes):
                        out.update(dev.device_ids)
        return out


__all__ = ["DEFAULT_SOCKET", "GPU_RESOURCE_PREFIXES",
           "KubeletPodResourcesClient"]
