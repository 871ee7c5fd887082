"""Kubelet device-plugin servers, ``nos_tpu/device/deviceplugin`` for the
port: advertise the carved MIG devices and the MPS shares to the kubelet.

The reference rides the out-of-tree NVIDIA device plugin and reloads it
by deleting its pod (pkg/gpu/client.go:51-135) or through an MPS
ConfigMap; the port ships its own plugin, which advertises exactly what
the partitioner carved (``nvidia.com/mig-<profile>``,
``nvidia.com/gpu-<N>gb``).  One ``SliceDevicePlugin`` serves a gRPC
DevicePlugin endpoint per advertised resource name:

- register with the kubelet's Registration service on kubelet.sock;
- stream the device inventory on ListAndWatch, re-sending whenever the
  MIG agent's actuation changes the carved devices (a version-stamped
  condition, so no notification is missed);
- answer Allocate with the device ids (``NOS_TPU_SLICE_IDS``) and, for
  one MIG device named by its ``MIG-…`` UUID, the visibility grant
  ``NOS_TPU_VISIBLE_CHIPS_<suffix>``, which ``device/workload_env.py``
  turns into ``CUDA_VISIBLE_DEVICES``.  A member of an NVLink block
  (``nos.nebuly.com/nvlink-block-NxG``) owns its whole node: its grant
  names every GPU of the node by its ``GPU-…`` UUID
  (``block_allocate_envs``), never as MIG devices, since a CUDA process
  sees one MIG device only.

The H100 translation of the JAX module: a grant names the MIG device's
UUID, where JAX names local chip ids and the host block
(``NOS_TPU_HOST_BOUNDS``).  A UUID is absolute, so the port needs no
bounds key and has none.  CUDA enumerates one MIG device a process, so
a grant of several MIG devices goes out as ids only, with a warning, as
JAX's does for a grant that spans units; so does an id that is not a
UUID (the fake runtime's).  The MPS replica plugin's Allocate gives the
memory grant and, like JAX's, names no device.

The proto subset is deviceplugin.proto (its generated
deviceplugin_pb2.py committed, byte for byte the JAX package's, so both
register one descriptor in a process; regenerate with
``protoc --python_out=. deviceplugin.proto``).  ``grpc`` and the
generated module are imported in the constructors: a process that
builds no plugin needs neither ``grpcio`` nor ``protobuf``.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Callable

from nos_tpu_torch.device.plugin import PLUGINS_DIR
from nos_tpu_torch.topology.profile import is_block_resource
from nos_tpu_torch.device.workload_env import (
    ENV_SLICE_IDS, ENV_TIMESHARE_GB, ENV_VISIBLE_CHIPS, granted_device_ids,
)

logger = logging.getLogger(__name__)

KUBELET_SOCKET = os.path.join(PLUGINS_DIR, "kubelet.sock")
API_VERSION = "v1beta1"
ENV_DEVICE_IDS = ENV_SLICE_IDS


def block_allocate_envs(resource: str, ids: list[str],
                        gpu_uuids: list[str]) -> dict:
    """The Allocate envs of an NVLink block member: its shard's device id
    and the visibility grant of every GPU of its node, by ``GPU-…``
    UUID.  Ids only where a UUID is missing or malformed (never a grant
    that cannot be backed)."""
    envs = {ENV_DEVICE_IDS: ",".join(ids)}
    grant = granted_device_ids({ENV_VISIBLE_CHIPS: ",".join(gpu_uuids)}) \
        if gpu_uuids else None
    if not grant or len(grant) != len(gpu_uuids) \
            or not all(str(g).startswith("GPU-") for g in grant):
        logger.warning("allocate %s: the node's GPUs are not named by "
                       "GPU UUIDs (%s); ids-only", resource, gpu_uuids)
        return envs
    envs[f"{ENV_VISIBLE_CHIPS}_{_env_suffix(resource)}"] = \
        ",".join(gpu_uuids)
    return envs


def _env_suffix(resource: str) -> str:
    """The per-resource key suffix (the kubelet merges the Allocate
    envs of every plugin a container uses, so one key would clobber):
    the name after the domain with ``-`` and ``.`` as ``_``, a shell
    name (``nvidia.com/mig-3g.40gb`` -> ``mig_3g_40gb``)."""
    return resource.rsplit("/", 1)[-1].replace("-", "_").replace(".", "_")


class SliceDevicePlugin:
    """One DevicePlugin gRPC server advertising one resource name.

    ``allocate_envs(device_ids) -> {env: value}`` customizes the
    Allocate response; the default hands the granted device ids to the
    workload (``NOS_TPU_SLICE_IDS``, read by ``device/workload_env.py``)."""

    def __init__(self, resource_name: str,
                 list_devices: Callable[[], list[str]],
                 plugins_dir: str = PLUGINS_DIR,
                 kubelet_socket: str = KUBELET_SOCKET,
                 allocate_envs: Callable[[list[str]], dict] | None = None,
                 ) -> None:
        import grpc

        from . import deviceplugin_pb2

        self._pb = deviceplugin_pb2
        self._grpc = grpc
        self.resource_name = resource_name
        self._list_devices = list_devices
        self._plugins_dir = plugins_dir
        self._kubelet_socket = kubelet_socket
        self._allocate_envs = allocate_envs or (
            lambda ids: {ENV_DEVICE_IDS: ",".join(ids)})
        self._endpoint = (
            "nos-tpu-torch-" + resource_name.replace("/", "-") + ".sock")
        self._stop = threading.Event()
        self._changed = threading.Condition()
        self._version = 0        # bumped by notify_changed
        self._server = None

    @property
    def socket_path(self) -> str:
        return os.path.join(self._plugins_dir, self._endpoint)

    # -- DevicePlugin service ------------------------------------------------
    def _devices(self):
        return self._pb.ListAndWatchResponse(devices=[
            self._pb.Device(ID=did, health="Healthy")
            for did in sorted(self._list_devices())
        ])

    def _list_and_watch(self, request, context):
        """Stream the inventory; re-send on every notify_changed().  The
        change counter makes notifications level-triggered: one fired
        between the snapshot check and the wait cannot be missed."""
        last = None
        seen_version = -1
        while not self._stop.is_set():
            resp = self._devices()
            snapshot = tuple(d.ID for d in resp.devices)
            if snapshot != last:
                last = snapshot
                yield resp
            with self._changed:
                if seen_version == self._version:
                    self._changed.wait(timeout=5.0)
                seen_version = self._version

    def _allocate(self, request, context):
        responses = []
        for creq in request.container_requests:
            ids = list(creq.devices_IDs)
            responses.append(self._pb.ContainerAllocateResponse(
                envs={k: str(v)
                      for k, v in self._allocate_envs(ids).items()}))
        return self._pb.AllocateResponse(container_responses=responses)

    def _options(self, request, context):
        return self._pb.DevicePluginOptions(
            pre_start_required=False,
            get_preferred_allocation_available=False)

    # -- lifecycle -----------------------------------------------------------
    def serve(self) -> None:
        """Bind the plugin socket and start serving."""
        import concurrent.futures

        grpc, pb = self._grpc, self._pb
        handler = grpc.method_handlers_generic_handler(
            "v1beta1.DevicePlugin", {
                "GetDevicePluginOptions": grpc.unary_unary_rpc_method_handler(
                    self._options,
                    request_deserializer=pb.Empty.FromString,
                    response_serializer=pb.DevicePluginOptions
                    .SerializeToString),
                "ListAndWatch": grpc.unary_stream_rpc_method_handler(
                    self._list_and_watch,
                    request_deserializer=pb.Empty.FromString,
                    response_serializer=pb.ListAndWatchResponse
                    .SerializeToString),
                "Allocate": grpc.unary_unary_rpc_method_handler(
                    self._allocate,
                    request_deserializer=pb.AllocateRequest.FromString,
                    response_serializer=pb.AllocateResponse
                    .SerializeToString),
            })
        self._server = grpc.server(
            concurrent.futures.ThreadPoolExecutor(max_workers=4))
        self._server.add_generic_rpc_handlers((handler,))
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass
        self._server.add_insecure_port(f"unix://{self.socket_path}")
        self._server.start()
        logger.info("device plugin %s serving on %s",
                    self.resource_name, self.socket_path)

    def register(self) -> None:
        """Dial the kubelet's Registration service and announce this
        plugin's endpoint and resource name."""
        grpc, pb = self._grpc, self._pb
        channel = grpc.insecure_channel(f"unix://{self._kubelet_socket}")
        try:
            register = channel.unary_unary(
                "/v1beta1.Registration/Register",
                request_serializer=pb.RegisterRequest.SerializeToString,
                response_deserializer=pb.Empty.FromString)
            register(pb.RegisterRequest(
                version=API_VERSION,
                endpoint=self._endpoint,
                resource_name=self.resource_name,
                options=pb.DevicePluginOptions()), timeout=5.0)
            logger.info("device plugin %s registered with kubelet",
                        self.resource_name)
        finally:
            channel.close()

    def notify_changed(self) -> None:
        """Re-advertise: the MIG agent calls this after actuating a plan
        (the version-stamped reload in place of the reference's restart
        of the plugin's pod)."""
        with self._changed:
            self._version += 1
            self._changed.notify_all()

    def stop(self) -> None:
        self._stop.set()
        self.notify_changed()
        if self._server is not None:
            self._server.stop(grace=1.0)
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass


class DevicePluginManager:
    """One SliceDevicePlugin per carved resource name, kept in step with
    the runtime's device list.  The MIG agent's DevicePluginClient calls
    sync() after every actuation: a new profile gets a served and
    registered plugin, an existing one re-advertises, a vanished one
    keeps serving an empty inventory (the kubelet wants the resource to
    drop to 0, not the endpoint to disappear)."""

    def __init__(self, runtime, plugins_dir: str = PLUGINS_DIR,
                 kubelet_socket: str = KUBELET_SOCKET) -> None:
        self._runtime = runtime
        self._plugins_dir = plugins_dir
        self._kubelet_socket = kubelet_socket
        self._plugins: dict[str, SliceDevicePlugin] = {}
        self._registered: set[str] = set()
        self._kubelet_id: tuple | None = None   # (st_dev, st_ino)

    def _kubelet_identity(self) -> tuple | None:
        try:
            st = os.stat(self._kubelet_socket)
            return (st.st_dev, st.st_ino)
        except OSError:
            return None

    def _register(self, resource: str, plugin: SliceDevicePlugin) -> None:
        try:
            plugin.register()
            self._registered.add(resource)
        except Exception as e:  # noqa: BLE001 — kubelet may be restarting
            logger.warning("device plugin %s: registration failed (%s); "
                           "will retry next sync", resource, e)

    def _ids_for(self, resource: str) -> list[str]:
        return [d.device_id for d in self._runtime.list_devices()
                if d.resource_name == resource]

    # -- subclass hooks ------------------------------------------------------
    def _current_resources(self) -> set[str]:
        return {d.resource_name for d in self._runtime.list_devices()}

    def _slice_allocate_envs(self, resource: str, ids: list[str]) -> dict:
        """Device ids plus, for one MIG device the runtime holds and
        names by its UUID, the visibility grant.  Falls back to ids only
        where that cannot be derived: never claim visibility we cannot
        back."""
        if is_block_resource(resource):
            return block_allocate_envs(resource, ids,
                                       self._runtime.gpu_uuids())
        envs = {ENV_DEVICE_IDS: ",".join(ids)}
        if len(ids) != 1:
            # CUDA enumerates only one MIG device a process
            logger.warning("allocate %s: a grant of %d MIG devices; "
                           "ids-only", resource, len(ids))
            return envs
        (did,) = ids
        grant = granted_device_ids({ENV_VISIBLE_CHIPS: did})
        if not grant or not str(grant[0]).startswith("MIG-"):
            logger.warning("allocate %s: device %s is not named by a MIG "
                           "UUID; ids-only", resource, did)
            return envs
        try:
            held = {d.device_id for d in self._runtime.list_devices()}
        except Exception as e:  # noqa: BLE001 — runtime may be restarting
            logger.warning("allocate %s: no device list (%s)", resource, e)
            return envs
        if did not in held:
            logger.warning("allocate %s: device %s is not on this node",
                           resource, did)
            return envs
        envs[f"{ENV_VISIBLE_CHIPS}_{_env_suffix(resource)}"] = did
        return envs

    def _make_plugin(self, resource: str) -> SliceDevicePlugin:
        return SliceDevicePlugin(
            resource,
            lambda r=resource: self._ids_for(r),
            plugins_dir=self._plugins_dir,
            kubelet_socket=self._kubelet_socket,
            allocate_envs=lambda ids, r=resource:
                self._slice_allocate_envs(r, ids))

    def sync(self) -> None:
        # A recreated kubelet.sock means the kubelet restarted and forgot
        # every plugin registration: re-register them all.
        kubelet_id = self._kubelet_identity()
        if kubelet_id != self._kubelet_id:
            if self._kubelet_id is not None:
                logger.info("kubelet socket changed: re-registering "
                            "%d plugin(s)", len(self._plugins))
            self._kubelet_id = kubelet_id
            self._registered.clear()
        for resource in sorted(self._current_resources()
                               - set(self._plugins)):
            plugin = self._make_plugin(resource)
            plugin.serve()
            self._plugins[resource] = plugin
        for resource, plugin in self._plugins.items():
            if resource not in self._registered:
                self._register(resource, plugin)
            plugin.notify_changed()

    def stop(self) -> None:
        for plugin in self._plugins.values():
            plugin.stop()


class TimeshareReplicaPlugin(SliceDevicePlugin):
    """MPS memory shares (``nvidia.com/gpu-<N>gb``) as device-plugin
    replicas: the advertised count is how many sharers the MPS plan
    allows, and Allocate hands the workload its memory grant, gb x the
    number of granted replicas, under a per-profile key so a container
    holding several profiles sums its grants
    (``device/workload_env.py`` turns the total into the CUDA caching
    allocator's cap before the first CUDA call).  Like the JAX plugin's,
    the replicas (``<profile>::<i>``) name no GPU.

    Not ``device.timeshare_plugin.TimeshareDevicePlugin``: that one
    patches the node's allocatable; this one speaks the kubelet's gRPC."""

    def __init__(self, resource_name: str, gb: int,
                 num_replicas: Callable[[], int],
                 plugins_dir: str = PLUGINS_DIR,
                 kubelet_socket: str = KUBELET_SOCKET) -> None:
        suffix = _env_suffix(resource_name)
        profile = resource_name.rsplit("/", 1)[-1]

        def list_devices() -> list[str]:
            n = max(0, int(num_replicas()))
            return [f"{profile}::{i}" for i in range(n)]

        super().__init__(
            resource_name, list_devices, plugins_dir=plugins_dir,
            kubelet_socket=kubelet_socket,
            allocate_envs=lambda ids: {
                f"{ENV_TIMESHARE_GB}_{suffix}": gb * len(ids),
                ENV_DEVICE_IDS: ",".join(ids),
            })


class TimesharePluginManager(DevicePluginManager):
    """Device plugins for the MPS shares a node advertises: the chip
    agent's main syncs the replica counts from the node's allocatable
    every report interval (the MPS plan's re-advertise reaches the
    kubelet through here)."""

    def __init__(self, api, node_name: str,
                 plugins_dir: str = PLUGINS_DIR,
                 kubelet_socket: str = KUBELET_SOCKET) -> None:
        super().__init__(runtime=None, plugins_dir=plugins_dir,
                         kubelet_socket=kubelet_socket)
        self._api = api
        self._node_name = node_name
        self._counts: dict[str, int] = {}

    def _current_resources(self) -> set[str]:
        from nos_tpu_torch.kube.client import KIND_NODE
        from nos_tpu_torch.topology.profile import TIMESHARE_RESOURCE_RE

        node = self._api.get(KIND_NODE, self._node_name)
        current: dict[str, int] = {}
        for res, qty in node.status.allocatable.items():
            if TIMESHARE_RESOURCE_RE.match(res):
                current[res] = int(qty)
        self._counts = current
        return set(current)

    def _make_plugin(self, resource: str) -> SliceDevicePlugin:
        from nos_tpu_torch.topology.profile import TIMESHARE_RESOURCE_RE

        gb = int(TIMESHARE_RESOURCE_RE.match(resource).group("gb"))
        return TimeshareReplicaPlugin(
            resource, gb=gb,
            num_replicas=lambda r=resource: self._counts.get(r, 0),
            plugins_dir=self._plugins_dir,
            kubelet_socket=self._kubelet_socket)


__all__ = ["API_VERSION", "DevicePluginManager", "ENV_DEVICE_IDS",
           "KUBELET_SOCKET", "PLUGINS_DIR", "SliceDevicePlugin",
           "TimeshareReplicaPlugin", "TimesharePluginManager"]
