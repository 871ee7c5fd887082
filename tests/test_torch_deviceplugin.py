"""The port's kubelet data plane (``nos_tpu_torch/device/deviceplugin``,
``device/podresources``, the manager seams of ``device/plugin.py`` and
``SliceAgent``) against the JAX package's, over real gRPC on unix
sockets with kubelet-shaped stubs.

``tests/test_deviceplugin.py``'s six cases run through both packages,
names mapped (``nos.tpu/slice-2x2`` ↔ ``nvidia.com/mig-3g.40gb``,
``nos.tpu/tpu-8gb`` ↔ ``nvidia.com/gpu-8gb``), and must answer alike.
Then the H100 MIG grant: one MIG device named by its UUID (NVML over
the fake library, ``nos_tpu_torch/testing/nvml.py``) is granted as
``NOS_TPU_VISIBLE_CHIPS_<suffix>``, which ``workload_env`` turns into
``CUDA_VISIBLE_DEVICES``; two MIG devices, or an id that is not a UUID,
go out as ids only.  Last, ``KubeletPodResourcesClient`` of both
packages against a stub ``List`` server.

The two packages' generated modules are byte-identical, so they register
one descriptor in protobuf's pool and share its message classes.
Sockets live in a short temporary directory: a unix socket's path is
capped at 107 bytes, which a pytest ``tmp_path`` can pass.
"""

from __future__ import annotations

import concurrent.futures
import filecmp
import logging
import os
import queue
import tempfile
import threading
from pathlib import Path

import grpc
import pytest

import nos_tpu.device.deviceplugin as jax_dp
import nos_tpu.device.podresources as jax_pr
from nos_tpu.device import workload_env as jax_workload_env
from nos_tpu.device.deviceplugin import deviceplugin_pb2 as jax_pb2
from nos_tpu.device.podresources import podresources_pb2 as jax_pr_pb2

import nos_tpu_torch.device.deviceplugin as port_dp
import nos_tpu_torch.device.podresources as port_pr
from nos_tpu_torch.device import workload_env
from nos_tpu_torch.device.deviceplugin import deviceplugin_pb2 as api_pb2
from nos_tpu_torch.device.podresources import podresources_pb2 as pr_pb2

ROOT = Path(__file__).resolve().parent.parent
MIG_A = "MIG-aaaaaaaa-0000-4000-8000-000000000001"
MIG_B = "MIG-aaaaaaaa-0000-4000-8000-000000000002"
# per package: the module, a MIG/slice resource, its device ids, an MPS
# share resource and its per-profile grant key
SIDES = {
    "jax": (jax_dp, "nos.tpu/slice-2x2", ["tpu-0-2x2-1", "tpu-0-2x2-2"],
            "nos.tpu/tpu-8gb", "NOS_TPU_TIMESHARE_GB_tpu_8gb"),
    "port": (port_dp, "nvidia.com/mig-3g.40gb", [MIG_A, MIG_B],
             "nvidia.com/gpu-8gb", "NOS_TPU_TIMESHARE_GB_gpu_8gb"),
}


@pytest.fixture
def sockdir():
    with tempfile.TemporaryDirectory(prefix="dp") as d:
        yield d


@pytest.fixture
def kubelet(sockdir):
    """A Registration-service stub recording RegisterRequests."""
    requests: queue.Queue = queue.Queue()

    def register(request, context):
        requests.put(request)
        return api_pb2.Empty()

    handler = grpc.method_handlers_generic_handler(
        "v1beta1.Registration",
        {"Register": grpc.unary_unary_rpc_method_handler(
            register,
            request_deserializer=api_pb2.RegisterRequest.FromString,
            response_serializer=api_pb2.Empty.SerializeToString)})
    server = grpc.server(
        concurrent.futures.ThreadPoolExecutor(max_workers=2))
    server.add_generic_rpc_handlers((handler,))
    sock = f"{sockdir}/kubelet.sock"
    server.add_insecure_port(f"unix://{sock}")
    server.start()
    yield sock, requests
    server.stop(0)


@pytest.fixture(params=sorted(SIDES))
def side(request):
    return request.param


@pytest.fixture
def plugin(side, sockdir, kubelet):
    dp, resource, ids, _, _ = SIDES[side]
    kubelet_sock, _ = kubelet
    devices = {"ids": list(ids)}
    p = dp.SliceDevicePlugin(
        resource, lambda: list(devices["ids"]),
        plugins_dir=sockdir, kubelet_socket=kubelet_sock)
    p.serve()
    yield p, devices
    p.stop()


def _channel(p):
    return grpc.insecure_channel(f"unix://{p.socket_path}")


def _allocate(p, ids: list[str]) -> dict:
    channel = _channel(p)
    try:
        allocate = channel.unary_unary(
            "/v1beta1.DevicePlugin/Allocate",
            request_serializer=api_pb2.AllocateRequest.SerializeToString,
            response_deserializer=api_pb2.AllocateResponse.FromString)
        resp = allocate(api_pb2.AllocateRequest(container_requests=[
            api_pb2.ContainerAllocateRequest(devices_IDs=ids)]),
            timeout=5.0)
    finally:
        channel.close()
    return dict(resp.container_responses[0].envs)


def _watch(p):
    channel = _channel(p)
    return channel, channel.unary_stream(
        "/v1beta1.DevicePlugin/ListAndWatch",
        request_serializer=api_pb2.Empty.SerializeToString,
        response_deserializer=api_pb2.ListAndWatchResponse.FromString,
    )(api_pb2.Empty())


class TestProtos:
    @pytest.mark.parametrize("name", [
        "deviceplugin/deviceplugin.proto", "deviceplugin/deviceplugin_pb2.py",
        "podresources/podresources.proto",
        "podresources/podresources_pb2.py"])
    def test_copies_are_byte_identical(self, name):
        assert filecmp.cmp(ROOT / "nos_tpu" / "device" / name,
                           ROOT / "nos_tpu_torch" / "device" / name,
                           shallow=False)

    def test_one_descriptor_serves_both_packages(self):
        assert api_pb2.AllocateRequest is jax_pb2.AllocateRequest
        assert (pr_pb2.ListPodResourcesResponse
                is jax_pr_pb2.ListPodResourcesResponse)
        assert api_pb2.DESCRIPTOR.package == "v1beta1"


class TestDevicePlugin:
    def test_registers_with_kubelet(self, side, plugin, kubelet):
        p, _ = plugin
        _, requests = kubelet
        p.register()
        req = requests.get(timeout=5.0)
        assert req.version == SIDES[side][0].API_VERSION == "v1beta1"
        assert req.resource_name == SIDES[side][1]
        assert req.endpoint == p.socket_path.rsplit("/", 1)[-1]
        prefix = {"jax": "nos-tpu-", "port": "nos-tpu-torch-"}[side]
        assert req.endpoint == (
            prefix + SIDES[side][1].replace("/", "-") + ".sock")

    def test_list_and_watch_streams_inventory_and_changes(self, side,
                                                          plugin):
        p, devices = plugin
        channel, stream = _watch(p)
        first = next(stream)
        assert sorted(d.ID for d in first.devices) == SIDES[side][2]
        assert all(d.health == "Healthy" for d in first.devices)

        # actuation changes the carved devices -> re-advertise
        devices["ids"] = SIDES[side][2][:1]
        got = queue.Queue()
        threading.Thread(target=lambda: got.put(next(stream)),
                         daemon=True).start()
        p.notify_changed()
        second = got.get(timeout=5.0)
        assert [d.ID for d in second.devices] == SIDES[side][2][:1]
        channel.close()

    def test_allocate_returns_device_ids_env(self, side, plugin):
        p, _ = plugin
        did = SIDES[side][2][1]
        assert _allocate(p, [did]) == {SIDES[side][0].ENV_DEVICE_IDS: did}
        assert port_dp.ENV_DEVICE_IDS == jax_dp.ENV_DEVICE_IDS


class TestTimesharePlugin:
    def test_replicas_and_memory_grant_env(self, side, sockdir, kubelet):
        dp, _, _, resource, key = SIDES[side]
        kubelet_sock, _ = kubelet
        profile = resource.rsplit("/", 1)[-1]
        p = dp.TimeshareReplicaPlugin(
            resource, gb=8, num_replicas=lambda: 3,
            plugins_dir=sockdir, kubelet_socket=kubelet_sock)
        p.serve()
        try:
            channel, stream = _watch(p)
            first = next(stream)
            assert [d.ID for d in first.devices] == [
                f"{profile}::{i}" for i in range(3)]
            channel.close()
            # TWO replicas granted -> the env carries 2 x 8 GB, no device
            envs = _allocate(p, [f"{profile}::1", f"{profile}::2"])
            assert envs == {key: "16",
                            "NOS_TPU_SLICE_IDS":
                                f"{profile}::1,{profile}::2"}
        finally:
            p.stop()

    def test_grants_sum_into_workload_env_cap(self):
        """Per-profile Allocate envs sum into one memory cap: JAX's XLA
        fraction of a 16 GB v5e chip, the port's caching-allocator
        fraction of an 80 GB H100."""
        applied = jax_workload_env.apply({
            "NOS_TPU_TIMESHARE_GB_tpu_8gb": "8",
            "NOS_TPU_TIMESHARE_GB_tpu_4gb": "4",
            "TPU_ACCELERATOR_TYPE": "v5litepod-8"})
        assert float(applied["XLA_PYTHON_CLIENT_MEM_FRACTION"]) == \
            pytest.approx(12 / 16 * 0.9)
        env = {"NOS_TPU_TIMESHARE_GB_gpu_40gb": "40",
               "NOS_TPU_TIMESHARE_GB_gpu_20gb": "20"}
        applied = workload_env.apply(env, memory_gb=80)
        assert applied == {workload_env.ENV_MEM_FRACTION: "0.675"}
        assert env[workload_env.ENV_MEM_FRACTION] == "0.675"


def _node_api(side):
    if side == "jax":
        from nos_tpu.kube.client import APIServer, KIND_NODE
        from nos_tpu.testing.factory import make_tpu_node

        node = make_tpu_node("ts-0", partitioning="timeshare")
    else:
        from nos_tpu_torch.kube.client import APIServer, KIND_NODE
        from nos_tpu_torch.testing.factory import make_gpu_node

        node = make_gpu_node("ts-0")
    return APIServer(), KIND_NODE, node


class TestTimesharePluginManager:
    def test_syncs_from_node_allocatable(self, side, sockdir, kubelet):
        dp, _, _, r8, _ = SIDES[side]
        r4 = r8.replace("8gb", "4gb")
        kubelet_sock, requests = kubelet
        api, kind_node, node = _node_api(side)
        node.status.allocatable[r8] = 2.0
        node.status.allocatable[r4] = 4.0
        api.create(kind_node, node)

        mgr = dp.TimesharePluginManager(
            api, "ts-0", plugins_dir=sockdir, kubelet_socket=kubelet_sock)
        try:
            mgr.sync()
            assert set(mgr._plugins) == {r8, r4}
            names = {requests.get(timeout=5.0).resource_name
                     for _ in range(2)}
            assert names == {r8, r4}
            p8 = mgr._plugins[r8]
            assert len(p8._devices().devices) == 2

            def shrink(n):
                n.status.allocatable[r8] = 1.0

            api.patch(kind_node, "ts-0", mutate=shrink)
            mgr.sync()
            assert len(p8._devices().devices) == 1
            assert requests.empty()     # registered once
        finally:
            mgr.stop()

    def test_a_restarted_kubelet_is_registered_again(self, sockdir):
        """A recreated kubelet.sock (a new inode) means the kubelet
        forgot every plugin: the next sync registers them again."""
        api, kind_node, node = _node_api("port")
        node.status.allocatable["nvidia.com/gpu-8gb"] = 1.0
        api.create(kind_node, node)
        sock = f"{sockdir}/kubelet.sock"
        mgr = port_dp.TimesharePluginManager(
            api, "ts-0", plugins_dir=sockdir, kubelet_socket=sock)
        seen: list[str] = []
        try:
            for _ in range(2):
                requests: queue.Queue = queue.Queue()

                def register(request, context, q=requests):
                    q.put(request)
                    return api_pb2.Empty()

                server = grpc.server(
                    concurrent.futures.ThreadPoolExecutor(max_workers=2))
                server.add_generic_rpc_handlers((
                    grpc.method_handlers_generic_handler(
                        "v1beta1.Registration",
                        {"Register": grpc.unary_unary_rpc_method_handler(
                            register,
                            request_deserializer=api_pb2.RegisterRequest
                            .FromString,
                            response_serializer=api_pb2.Empty
                            .SerializeToString)}),))
                server.add_insecure_port(f"unix://{sock}")
                server.start()
                try:
                    mgr.sync()
                    mgr.sync()          # the same kubelet: no new request
                    seen.append(requests.get(timeout=5.0).resource_name)
                    assert requests.empty()
                    # a second name keeps the inode taken after the
                    # server removes the socket: a freed inode number
                    # may be handed straight to the next socket
                    os.link(sock, f"{sock}.{len(seen)}")
                finally:
                    server.stop(0)
        finally:
            mgr.stop()
        assert seen == ["nvidia.com/gpu-8gb"] * 2


def _mig_runtime():
    """NVML over the fake library: GPU 0 in MIG mode holding a 3g.40gb
    (MIG_A, slot 4) and a 1g.10gb (MIG_B, slot 1), GPU 1 not."""
    from nos_tpu_torch.device import nvml
    from nos_tpu_torch.testing.nvml import FakeGpu, FakeNvmlLibrary

    lib = FakeNvmlLibrary([
        FakeGpu(uuid="GPU-00000000-0000-4000-8000-000000000000", mig=True,
                instances=[(MIG_A, 2, 4, 4), (MIG_B, 0, 1, 1)]),
        FakeGpu(uuid="GPU-00000000-0000-4000-8000-000000000001")])
    return nvml.NvmlGpuRuntime(lib=lib)


class TestMigGrant:
    def test_one_mig_uuid_becomes_cuda_visibility(self, sockdir, kubelet):
        kubelet_sock, requests = kubelet
        runtime = _mig_runtime()
        mgr = port_dp.DevicePluginManager(
            runtime, plugins_dir=sockdir, kubelet_socket=kubelet_sock)
        try:
            mgr.sync()
            assert set(mgr._plugins) == {"nvidia.com/mig-3g.40gb",
                                         "nvidia.com/mig-1g.10gb"}
            assert {requests.get(timeout=5.0).resource_name
                    for _ in range(2)} == set(mgr._plugins)
            p = mgr._plugins["nvidia.com/mig-3g.40gb"]
            assert [d.ID for d in p._devices().devices] == [MIG_A]
            envs = _allocate(p, [MIG_A])
            assert envs == {"NOS_TPU_SLICE_IDS": MIG_A,
                            "NOS_TPU_VISIBLE_CHIPS_mig_3g_40gb": MIG_A}
            env = dict(envs)
            applied = workload_env.apply(env)
            assert applied["CUDA_VISIBLE_DEVICES"] == MIG_A
            assert applied["CUDA_DEVICE_ORDER"] == "PCI_BUS_ID"
            assert applied[workload_env.ENV_VISIBLE_SLICE_IDS] == MIG_A
        finally:
            mgr.stop()
            runtime.close()

    @pytest.mark.parametrize("ids", [[MIG_A, MIG_B], ["tpu-0-3g.40gb-1"],
                                     [MIG_A.replace("a", "b")]],
                             ids=["two-migs", "not-a-uuid", "not-held"])
    def test_what_cannot_be_granted_goes_out_as_ids(self, ids, caplog):
        runtime = _mig_runtime()
        mgr = port_dp.DevicePluginManager(runtime)
        try:
            with caplog.at_level(logging.WARNING):
                envs = mgr._slice_allocate_envs("nvidia.com/mig-3g.40gb",
                                                ids)
        finally:
            runtime.close()
        assert envs == {"NOS_TPU_SLICE_IDS": ",".join(ids)}
        assert "ids-only" in caplog.text or "not on this node" in caplog.text
        assert "CUDA_VISIBLE_DEVICES" not in workload_env.apply(dict(envs))

    def test_the_fake_runtime_s_ids_are_not_granted(self):
        from nos_tpu_torch.device.fake import FakeGpuRuntime

        runtime = FakeGpuRuntime()
        (did,) = runtime.create_slices(0, ["7g.80gb"])
        mgr = port_dp.DevicePluginManager(runtime)
        assert mgr._slice_allocate_envs("nvidia.com/mig-7g.80gb",
                                        [did]) == {"NOS_TPU_SLICE_IDS": did}


class TestSeams:
    def test_refresh_syncs_the_manager_first(self):
        from nos_tpu_torch.controllers.sliceagent.agent import SliceAgent
        from nos_tpu_torch.device.fake import FakeGpuRuntime, FakePodResources
        from nos_tpu_torch.kube.client import APIServer, KIND_NODE
        from nos_tpu_torch.testing.factory import make_gpu_node

        calls: list[str] = []

        class Manager:
            def sync(self):
                calls.append("sync")

        api = APIServer()
        api.create(KIND_NODE, make_gpu_node("n", gpus=1,
                                            partitioning="mig"))
        agent = SliceAgent(api, "n", FakeGpuRuntime(), FakePodResources(),
                           plugin_manager=Manager())
        assert agent.plugin.refresh() == 1 and calls == ["sync"]
        assert SliceAgent(api, "n", FakeGpuRuntime(),
                          FakePodResources()).plugin._manager is None


@pytest.fixture
def pod_resources_server(sockdir):
    """A PodResourcesLister stub answering one fixed List."""
    resp = pr_pb2.ListPodResourcesResponse(pod_resources=[
        pr_pb2.PodResources(name="w", namespace="team", containers=[
            pr_pb2.ContainerResources(name="c", devices=[
                pr_pb2.ContainerDevices(
                    resource_name="nvidia.com/mig-3g.40gb",
                    device_ids=[MIG_A]),
                pr_pb2.ContainerDevices(
                    resource_name="nvidia.com/gpu-20gb",
                    device_ids=["gpu-20gb::0"]),
                pr_pb2.ContainerDevices(
                    resource_name="nos.tpu/slice-2x2",
                    device_ids=["tpu-0-2x2-1"]),
                pr_pb2.ContainerDevices(
                    resource_name="example.com/fpga",
                    device_ids=["fpga-0"])])])])
    server = grpc.server(
        concurrent.futures.ThreadPoolExecutor(max_workers=2))
    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
        "v1.PodResourcesLister",
        {"List": grpc.unary_unary_rpc_method_handler(
            lambda req, ctx: resp,
            request_deserializer=pr_pb2.ListPodResourcesRequest.FromString,
            response_serializer=pr_pb2.ListPodResourcesResponse
            .SerializeToString)}),))
    sock = f"{sockdir}/pod-resources.sock"
    server.add_insecure_port(f"unix://{sock}")
    server.start()
    yield sock
    server.stop(0)


class TestPodResources:
    def test_used_device_ids_by_prefix(self, pod_resources_server):
        jax_client = jax_pr.KubeletPodResourcesClient(pod_resources_server)
        port_client = port_pr.KubeletPodResourcesClient(pod_resources_server)
        try:
            assert jax_client.used_device_ids() == {"tpu-0-2x2-1"}
            assert port_client.used_device_ids() == {MIG_A, "gpu-20gb::0"}
            assert (port_client.list_pod_resources()
                    == jax_client.list_pod_resources())
        finally:
            jax_client.close()
            port_client.close()
        assert port_pr.GPU_RESOURCE_PREFIXES == ("nvidia.com/mig-",
                                                 "nvidia.com/gpu")
        assert port_pr.DEFAULT_SOCKET == jax_pr.DEFAULT_SOCKET
