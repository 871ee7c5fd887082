"""The port's device layer (nos_tpu_torch/device): the NVML client and
discovery driven through a fake NVML function table
(nos_tpu_torch.testing.nvml), the fake MIG runtime, and the runtime
choice.  Discovery keeps the JAX module's ladder (device, env,
configured) and its source words; its NVML rung has no JAX counterpart
(the JAX env rung reads Cloud TPU metadata), so it is held against the
described host."""

import logging
import types

import pytest
import torch

import nos_tpu.device.discovery as jax_discovery
from nos_tpu_torch.device import default_gpu_runtime, discovery, nvml
from nos_tpu_torch.device.fake import (FakeGpuRuntime, FakePodResources,
                                       SliceCreationError)
from nos_tpu_torch.device.gpuclient import SliceDeviceClient
from nos_tpu_torch.testing.nvml import (H100_BYTES, H100_NAME,
                                        H100_RESERVED, NOT_FOUND,
                                        UNKNOWN, FakeGpu, FakeNvmlLibrary,
                                        profile_rows)
from nos_tpu_torch.topology import FREE, H100_80GB, USED, Placement
from nos_tpu_torch.topology.errors import (DeviceNotFoundError,
                                           PlacementInfeasibleError)

UUID0 = "GPU-11111111-2222-3333-4444-555555555555"
UUID1 = "GPU-66666666-7777-8888-9999-aaaaaaaaaaaa"
MIG_A = "MIG-aaaaaaaa-0000-4000-8000-000000000001"
MIG_B = "MIG-aaaaaaaa-0000-4000-8000-000000000002"


def two_gpus(**kw) -> FakeNvmlLibrary:
    return FakeNvmlLibrary([
        FakeGpu(uuid=UUID0, mig=True, instances=[(MIG_A, 2, 4, 4),
                                                 (MIG_B, 0, 1, 1)]),
        FakeGpu(uuid=UUID1)], **kw)


@pytest.fixture
def no_cuda_calls(monkeypatch):
    """Any CUDA query or start fails the test."""
    def boom(*a, **k):
        raise AssertionError("a CUDA call on the NVML rung")

    for name in ("init", "_lazy_init", "is_available", "device_count",
                 "get_device_properties", "get_device_name", "set_device",
                 "current_device", "mem_get_info"):
        monkeypatch.setattr(torch.cuda, name, boom)


def test_sources_keep_the_jax_words():
    assert (discovery.SOURCE_DEVICE, discovery.SOURCE_ENV,
            discovery.SOURCE_CONFIGURED) == (
        jax_discovery.SOURCE_DEVICE, jax_discovery.SOURCE_ENV,
        jax_discovery.SOURCE_CONFIGURED)


class TestNvmlClient:
    def test_read_gpus(self):
        with nvml.Nvml(two_gpus()) as lib:
            gpus = nvml.read_gpus(lib)
        assert [(g["name"], g["uuid"], g["memory_total"],
                 g["memory_reserved"], g["mig"]) for g in gpus] == [
            (H100_NAME, UUID0, H100_BYTES, H100_RESERVED, True),
            (H100_NAME, UUID1, H100_BYTES, H100_RESERVED, False)]
        # what CUDA reports as an H100 80GB HBM3's total: NVML's total
        # less the driver's 480 MiB
        assert gpus[0]["memory_usable"] == 85_017_493_504

    def test_init_and_shutdown_balance(self):
        lib = two_gpus()
        with nvml.Nvml(lib) as n:
            assert lib.open == 1
            n.device_count()
        assert lib.open == 0 and lib.calls[0] == "nvmlInit_v2" \
            and lib.calls[-1] == "nvmlShutdown"

    @pytest.mark.parametrize("call", ["nvmlInit_v2", "nvmlDeviceGetCount_v2",
                                      "nvmlDeviceGetName", "nvmlDeviceGetUUID",
                                      "nvmlDeviceGetMemoryInfo_v2",
                                      "nvmlDeviceGetMigMode"])
    def test_an_error_code_raises_with_its_string(self, call):
        lib = two_gpus(fail={call: UNKNOWN})
        with pytest.raises(nvml.NvmlError, match=f"{call}: NVML error 999: "
                                                 f"Unknown Error") as e:
            with nvml.Nvml(lib) as n:
                nvml.read_gpus(n)
        assert e.value.code == UNKNOWN and e.value.call == call

    def test_no_mig_support_reads_as_disabled(self):
        lib = FakeNvmlLibrary([FakeGpu(mig_supported=False)])
        with nvml.Nvml(lib) as n:
            assert n.mig_mode(n.handle(0)) == (False, False)

    def test_profile_table_agrees_with_known(self):
        with nvml.Nvml(two_gpus()) as n:
            table = nvml.read_profile_table(n, n.handle(0), H100_80GB)
        assert nvml.profile_table_mismatches(H100_80GB, table) == []
        assert table["1g.20gb"]["placements"] == [(0, 2), (2, 2), (4, 2),
                                                  (6, 2)]

    def test_profile_table_mismatches_are_named(self):
        rows = profile_rows()
        rows[2] = dict(rows[2], placements=[(0, 4)])     # 3g.40gb
        rows[3] = dict(rows[3], count=2)                  # 4g.40gb
        del rows[9]                                       # 1g.20gb
        lib = FakeNvmlLibrary([FakeGpu(mig=True)], profiles=rows)
        with nvml.Nvml(lib) as n:
            table = nvml.read_profile_table(n, n.handle(0), H100_80GB)
        bad = nvml.profile_table_mismatches(H100_80GB, table)
        assert len(bad) == 3
        assert any(b.startswith("1g.20gb: not offered") for b in bad)
        assert any(b.startswith("3g.40gb: placements") for b in bad)
        assert any(b.startswith("4g.40gb: max_count") for b in bad)

    def test_load_library_without_the_driver_raises(self, tmp_path):
        with pytest.raises(nvml.NvmlUnavailable):
            nvml.load_library(str(tmp_path / "libnvidia-ml.so.1"))

    def test_every_bound_call_has_its_types(self):
        # what load_library declares is what the client calls
        lib = two_gpus()
        with nvml.Nvml(lib) as n:
            runtime_calls = set(lib.calls)
            nvml.read_gpus(n)
            for h in (n.handle(0),):
                nvml.read_profile_table(n, h, H100_80GB)
                for m in n.mig_devices(h):
                    n.gpu_instance(h, m)
        assert set(lib.calls) | runtime_calls <= set(nvml.SIGNATURES)


class TestNvmlRuntime:
    def test_read_only_runtime(self):
        lib = two_gpus()
        rt = nvml.NvmlGpuRuntime(lib=lib)
        try:
            assert rt.model is H100_80GB
            assert rt.topology() == ("nvidia-h100-80gb-hbm3", (True, False))
            devs = rt.list_devices()
            assert [(d.resource_name, d.device_id, d.status, d.unit_index)
                    for d in devs] == [
                ("nvidia.com/mig-3g.40gb", MIG_A, FREE, 0),
                ("nvidia.com/mig-1g.10gb", MIG_B, FREE, 0)]
            assert rt.placements() == {MIG_A: Placement("3g.40gb", 4, 4),
                                       MIG_B: Placement("1g.10gb", 1, 1)}
            # reading changes nothing; the runtime's writes are
            # tests/test_torch_nvml_runtime.py's
            assert not [c for c in lib.calls if c in nvml.WRITE_CALLS]
            (new,) = rt.create_slices(0, ["1g.10gb"])
            assert rt.placements()[new] == Placement("1g.10gb", 0, 1)
            rt.delete_slice(MIG_A)
            assert sorted(rt.delete_all_except(set())) == sorted([MIG_B, new])
            assert rt.list_devices() == []
        finally:
            rt.close()
        assert lib.open == 0

    def test_empty_mig_slots_are_skipped(self):
        lib = FakeNvmlLibrary([FakeGpu(mig=True, instances=[])])
        rt = nvml.NvmlGpuRuntime(lib=lib)
        assert rt.list_devices() == []
        assert lib.calls.count("nvmlDeviceGetMigDeviceHandleByIndex") == 7
        rt.close()
        assert NOT_FOUND == nvml.NVML_ERROR_NOT_FOUND

    def test_an_unknown_card_raises(self):
        lib = FakeNvmlLibrary([FakeGpu(name="NVIDIA B200")])
        with pytest.raises(LookupError, match="B200"):
            nvml.NvmlGpuRuntime(lib=lib)
        assert lib.open == 0
        # a named model skips the product match
        nvml.NvmlGpuRuntime(model=H100_80GB, lib=lib).close()

    def test_an_instance_outside_the_table_raises(self):
        rows = profile_rows()             # NVML_GPU_INSTANCE_PROFILE_6_SLICE:
        rows[6] = {"id": 6, "slices": 6, "count": 1, "mb": 80_000,
                   "placements": [(0, 8)]}        # no H100 profile
        lib = FakeNvmlLibrary([FakeGpu(mig=True, instances=[
            (MIG_A, 6, 0, 8)])], profiles=rows)
        rt = nvml.NvmlGpuRuntime(lib=lib)
        with pytest.raises(LookupError, match="profile 6"):
            rt.list_devices()
        rt.close()

    def test_a_media_instance_reads_under_its_resource_name(self):
        lib = FakeNvmlLibrary([FakeGpu(mig=True, instances=[
            (MIG_A, 7, 3, 1)])])          # NVML's 1_SLICE_REV1
        rt = nvml.NvmlGpuRuntime(lib=lib)
        try:
            assert [(d.resource_name, d.device_id) for d in
                    rt.list_devices()] == [("nvidia.com/mig-1g.10gb.me",
                                            MIG_A)]
            assert rt.placements() == {MIG_A: Placement("1g.10gb+me", 3, 1)}
        finally:
            rt.close()


class TestDiscovery:
    def test_nvml_rung(self, no_cuda_calls):
        found = discovery.discover(allow_cuda=False, nvml_lib=two_gpus())
        assert found.source == discovery.SOURCE_ENV
        assert found.model is H100_80GB
        assert found.num_local_gpus == 2 and found.num_hosts == 1
        assert found.product_name == H100_NAME
        assert found.uuids == (UUID0, UUID1)
        assert found.mig_modes == (True, False)
        assert found.memory_bytes == (H100_BYTES - H100_RESERVED,) * 2

    def test_unknown_card_falls_through(self, no_cuda_calls, caplog):
        lib = FakeNvmlLibrary([FakeGpu(name="NVIDIA B200")])
        with caplog.at_level(logging.WARNING):
            found = discovery.discover(allow_cuda=False, nvml_lib=lib)
        assert found.source == discovery.SOURCE_CONFIGURED
        assert found.model is H100_80GB
        assert "B200" in caplog.text

    def test_an_nvml_error_falls_through_and_never_raises(self,
                                                         no_cuda_calls):
        lib = two_gpus(fail={"nvmlDeviceGetUUID": UNKNOWN})
        found = discovery.discover(allow_cuda=False, nvml_lib=lib)
        assert found.source == discovery.SOURCE_CONFIGURED
        assert lib.open == 0

    def test_configured_rung_without_libnvidia_ml(self, no_cuda_calls):
        # a host without the NVIDIA driver, as the CPU test hosts are
        with pytest.raises(nvml.NvmlUnavailable):
            nvml.load_library()
        found = discovery.discover()
        assert found.source == discovery.SOURCE_CONFIGURED
        assert found.model is H100_80GB and found.num_local_gpus == 1
        other = object.__new__(type(H100_80GB))
        assert discovery.discover(configured=other).model is other

    def test_num_hosts_from_torchrun(self):
        env = {"WORLD_SIZE": "16", "LOCAL_WORLD_SIZE": "8"}
        assert discovery.discover(environ=env).num_hosts == 2
        assert discovery.discover(environ={"WORLD_SIZE": "x"}).num_hosts == 1
        assert discovery.discover(environ={"WORLD_SIZE": "4"}).num_hosts == 1

    def test_device_rung_only_with_cuda_up(self, monkeypatch):
        props = [types.SimpleNamespace(
            name="NVIDIA H100 80GB HBM3 MIG 3g.40gb",
            uuid="aaaaaaaa-0000-4000-8000-000000000001",
            total_memory=42_000_000_000, multi_processor_count=60)]
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda i: props[i])
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
        assert discovery.discover(nvml_lib=two_gpus()).source == \
            discovery.SOURCE_ENV
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        found = discovery.discover(nvml_lib=two_gpus())
        assert found.source == discovery.SOURCE_DEVICE
        assert found.uuids == (MIG_A,) and found.mig_modes == (True,)
        assert found.memory_bytes == (42_000_000_000,)
        assert discovery.discover(allow_cuda=False,
                                  nvml_lib=two_gpus()).source == \
            discovery.SOURCE_ENV

    def test_torch_device_for(self, monkeypatch):
        props = [types.SimpleNamespace(uuid=UUID1[4:].upper()),
                 types.SimpleNamespace(uuid=UUID0[4:])]
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda i: props[i])
        found = discovery.discover(allow_cuda=False, nvml_lib=two_gpus())
        assert found.torch_device_for(UUID0) == torch.device("cuda", 1)
        assert found.torch_device_for(0) == torch.device("cuda", 1)
        assert found.torch_device_for(1) == torch.device("cuda", 0)
        with pytest.raises(LookupError):
            found.torch_device_for(2)
        with pytest.raises(LookupError):
            found.torch_device_for(MIG_A)


class TestFakeRuntime:
    def test_create_places_around_existing(self):
        rt = FakeGpuRuntime(num_gpus=2)
        a = rt.create_slices(0, ["3g.40gb"])
        b = rt.create_slices(0, ["2g.20gb", "1g.10gb"])
        assert len(a) == 1 and len(b) == 2
        pls = rt.placements()
        assert pls[a[0]] == Placement("3g.40gb", 0, 4)
        assert sorted((pls[d].profile, pls[d].start) for d in b) == [
            ("1g.10gb", 6), ("2g.20gb", 4)]
        with pytest.raises(PlacementInfeasibleError):
            rt.create_slices(0, ["1g.10gb"])     # 7 compute slices taken
        assert rt.topology() == ("nvidia-h100-80gb-hbm3", (True, True))
        devs = rt.list_devices()
        assert {d.resource_name for d in devs} == {
            "nvidia.com/mig-3g.40gb", "nvidia.com/mig-2g.20gb",
            "nvidia.com/mig-1g.10gb"}
        assert all(d.unit_index == 0 for d in devs)

    def test_create_is_all_or_nothing(self):
        rt = FakeGpuRuntime()
        rt.create_slices(0, ["4g.40gb"])
        before = rt.placements()
        with pytest.raises(PlacementInfeasibleError):
            rt.create_slices(0, ["3g.40gb", "1g.10gb"])
        assert rt.placements() == before

    def test_a_failure_part_way_cleans_up(self):
        rt = FakeGpuRuntime(fail_after=2)
        before = rt.placements()
        with pytest.raises(SliceCreationError):
            rt.create_slices(0, ["1g.10gb"] * 4)
        assert rt.placements() == before == {}
        rt.fail_after = None
        assert len(rt.create_slices(0, ["1g.10gb"] * 4)) == 4

    def test_injected_failure_and_unknown_gpu(self):
        rt = FakeGpuRuntime(fail_creates=True)
        with pytest.raises(SliceCreationError):
            rt.create_slices(0, ["1g.10gb"])
        rt.fail_creates = False
        with pytest.raises(DeviceNotFoundError):
            rt.create_slices(1, ["1g.10gb"])
        assert rt.create_calls == 2

    def test_delete_path(self):
        rt = FakeGpuRuntime()
        ids = rt.create_slices(0, ["3g.40gb", "3g.40gb"])
        rt.delete_slice(ids[0])
        assert set(rt.placements()) == {ids[1]}
        with pytest.raises(DeviceNotFoundError):
            rt.delete_slice(ids[0])
        # the freed slots take a new instance
        more = rt.create_slices(0, ["2g.20gb", "1g.20gb"])
        assert rt.delete_all_except({ids[1]}) == more
        assert set(rt.placements()) == {ids[1]}
        assert rt.delete_calls == 2

    def test_slice_device_client_marks_used(self):
        rt = FakeGpuRuntime()
        pods = FakePodResources()
        client = SliceDeviceClient(rt, pods)
        ids = client.create_slices(0, ["1g.10gb", "1g.10gb"])
        pods.allocate("ns/p", {ids[0]})
        got = {d.device_id: d.status for d in client.get_devices()}
        assert got == {ids[0]: USED, ids[1]: FREE}
        pods.release("ns/p")
        assert pods.allocated_pod_keys() == []
        assert {d.status for d in client.get_devices()} == {FREE}
        client.delete_slice(ids[0])
        assert client.delete_all_except(set()) == [ids[1]]


class TestDefaultRuntime:
    def test_fake_only_when_asked_for_the_cpu(self):
        rt = default_gpu_runtime(device="cpu")
        assert isinstance(rt, FakeGpuRuntime)
        assert rt.topology()[0] == "nvidia-h100-80gb-hbm3"

    def test_no_quiet_fallback_without_nvml(self):
        with pytest.raises(nvml.NvmlUnavailable):
            default_gpu_runtime()
        with pytest.raises(nvml.NvmlUnavailable):
            default_gpu_runtime(H100_80GB, device="cuda")

    def test_nvml_on_the_card(self, monkeypatch):
        monkeypatch.setattr(nvml, "load_library", lambda: two_gpus())
        rt = default_gpu_runtime()
        assert isinstance(rt, nvml.NvmlGpuRuntime)
        assert rt.topology() == ("nvidia-h100-80gb-hbm3", (True, False))
        rt.close()
