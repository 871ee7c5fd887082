"""The port's workload env (nos_tpu_torch/device/workload_env.py) against
the JAX package's nos_tpu/device/workload_env.py on the same environment
dicts: the grant parsing, the timeshare total and the memory fraction
string are exact equalities, and a device-count mismatch raises in both
``check_confinement``s (JAX given coord-less fake devices).  Then what
only the GPU has: UUID grants, the CUDA visibility keys, the absolute
UUID check, and the cap installed on every visible device (CUDA's calls
recorded under a CPU-only torch)."""

import os
import types
from contextlib import contextmanager

import pytest
import torch

import nos_tpu.device.workload_env as jax_env
from nos_tpu_torch.device import workload_env as W

GPU_A = "GPU-5d7b5fb2-1c5c-4b3f-9a41-0c2e7d9f8e11"
GPU_B = "GPU-00000000-1111-2222-3333-444444444444"
MIG_A = "MIG-aaaaaaaa-0000-4000-8000-000000000001"

# One environment dict, fed to both packages.
ENVS = {
    "none": {},
    "one_index": {"NOS_TPU_VISIBLE_CHIPS": "3"},
    "indices": {"NOS_TPU_VISIBLE_CHIPS": "2,0, 1"},
    "profile_suffixes": {"NOS_TPU_VISIBLE_CHIPS_slice_1x1": "0",
                         "NOS_TPU_VISIBLE_CHIPS_slice_2x2": "4,5,6,7",
                         "NOS_TPU_VISIBLE_CHIPS": "5"},
    "corrupt_token": {"NOS_TPU_VISIBLE_CHIPS_slice_1x1": "0",
                      "NOS_TPU_VISIBLE_CHIPS_slice_2x2": "4,x"},
    "empty_token": {"NOS_TPU_VISIBLE_CHIPS": "1,,2"},
    "timeshare": {"NOS_TPU_TIMESHARE_GB": "24"},
    "timeshare_suffixes": {"NOS_TPU_TIMESHARE_GB_tpu_8gb": "16",
                           "NOS_TPU_TIMESHARE_GB_tpu_24gb": "24",
                           "NOS_TPU_TIMESHARE_GB": "2.5"},
    "timeshare_garbage": {"NOS_TPU_TIMESHARE_GB": "lots",
                          "NOS_TPU_TIMESHARE_GB_tpu_8gb": "8"},
    "timeshare_only_garbage": {"NOS_TPU_TIMESHARE_GB": "lots"},
    "timeshare_over_the_card": {"NOS_TPU_TIMESHARE_GB": "200"},
    "both": {"NOS_TPU_TIMESHARE_GB": "40", "NOS_TPU_VISIBLE_CHIPS": "0,1",
             "NOS_TPU_SLICE_IDS": "tpu-0-1g.10gb-1"},
    "visibility_preset": {"NOS_TPU_VISIBLE_CHIPS": "1",
                          "CUDA_VISIBLE_DEVICES": "0",
                          "TPU_VISIBLE_CHIPS": "0"},
    "unrelated_keys": {"NOS_TPU_VISIBLE_CHIPSX": "9",
                       "NOS_TPU_TIMESHARE_GBX": "9"},
}


@pytest.mark.parametrize("name", sorted(ENVS))
class TestParityWithJax:
    def test_granted_ids(self, name):
        env = ENVS[name]
        assert W.granted_device_ids(dict(env)) == \
            jax_env.granted_chip_ids(dict(env))

    def test_granted_timeshare_gb(self, name):
        env = ENVS[name]
        assert W.granted_timeshare_gb(dict(env)) == \
            jax_env.granted_timeshare_gb(dict(env))

    def test_fraction_string(self, name):
        ours = W.apply(dict(ENVS[name]), memory_gb=80)
        theirs = jax_env.apply(dict(ENVS[name]), hbm_gb_per_chip=80)
        assert ours.get(W.ENV_MEM_FRACTION) == \
            theirs.get("XLA_PYTHON_CLIENT_MEM_FRACTION")
        assert ours.get(W.ENV_VISIBLE_SLICE_IDS) == \
            theirs.get("TPU_VISIBLE_SLICE_IDS")


@pytest.mark.parametrize("name", [n for n in sorted(ENVS)
                                  if W.granted_device_ids(dict(ENVS[n]))])
def test_count_mismatch_raises_in_both(name):
    granted = W.granted_device_ids(dict(ENVS[name]))
    coordless = [types.SimpleNamespace() for _ in granted]
    # the right count passes both, one fewer or more fails both
    W.check_confinement(granted, [GPU_A] * len(granted))
    jax_env.check_confinement(granted, coordless, "")
    for n in (len(granted) - 1, len(granted) + 1):
        with pytest.raises(W.ConfinementError):
            W.check_confinement(granted, [GPU_A] * n)
        with pytest.raises(jax_env.ConfinementError):
            jax_env.check_confinement(
                granted, [types.SimpleNamespace()] * n, "")


def test_constants_match_jax():
    assert (W.ENV_TIMESHARE_GB, W.ENV_SLICE_IDS, W.ENV_VISIBLE_CHIPS,
            W.SAFETY) == (jax_env.ENV_TIMESHARE_GB, jax_env.ENV_SLICE_IDS,
                          jax_env.ENV_VISIBLE_CHIPS, jax_env.SAFETY)


class TestGrants:
    def test_uuid_grants(self):
        env = {"NOS_TPU_VISIBLE_CHIPS_mig_1g_10gb": MIG_A,
               "NOS_TPU_VISIBLE_CHIPS": f" {GPU_B},{GPU_A}"}
        assert W.granted_device_ids(env) == sorted([GPU_A, GPU_B, MIG_A])

    @pytest.mark.parametrize("value", [
        f"0,{GPU_A}",                       # a mix of the two kinds
        "-1", "1_0", "+1", "GPU-1234", "gpu0", f"{GPU_A}x", ""])
    def test_corrupt_or_mixed_voids_the_grant(self, value):
        assert W.granted_device_ids({"NOS_TPU_VISIBLE_CHIPS": value}) is None

    def test_apply_sets_visibility_in_pci_order(self):
        env = {"NOS_TPU_VISIBLE_CHIPS": "2,0", "NOS_TPU_TIMESHARE_GB": "24"}
        applied = W.apply(env, memory_gb=80)
        assert applied == {W.ENV_MEM_FRACTION: "0.270",
                           "CUDA_VISIBLE_DEVICES": "0,2",
                           "CUDA_DEVICE_ORDER": "PCI_BUS_ID"}
        assert all(env[k] == v for k, v in applied.items())

    def test_apply_passes_uuids(self):
        env = {"NOS_TPU_VISIBLE_CHIPS": MIG_A}
        assert W.apply(env)["CUDA_VISIBLE_DEVICES"] == MIG_A

    @pytest.mark.parametrize("preset", ["CUDA_VISIBLE_DEVICES",
                                        "CUDA_DEVICE_ORDER"])
    def test_visibility_all_or_none(self, preset):
        env = {"NOS_TPU_VISIBLE_CHIPS": "1", preset: "x"}
        applied = W.apply(env)
        assert not set(applied) & set(W.VISIBILITY_KEYS)
        assert env[preset] == "x" and len(
            [k for k in W.VISIBILITY_KEYS if k in env]) == 1

    def test_an_operators_fraction_wins(self):
        env = {"NOS_TPU_TIMESHARE_GB": "24", W.ENV_MEM_FRACTION: "0.5"}
        W.apply(env, memory_gb=80)
        assert env[W.ENV_MEM_FRACTION] == "0.5"
        assert W.memory_fraction(env) == 0.5

    def test_memory_from_discovery_without_cuda(self, monkeypatch):
        # no driver here: the configured H100 80GB
        def boom(*a, **k):
            raise AssertionError("apply touched CUDA")

        monkeypatch.setattr(torch.cuda, "device_count", boom)
        monkeypatch.setattr(torch.cuda, "is_initialized", boom)
        env = {"NOS_TPU_TIMESHARE_GB": "8"}
        assert W.apply(env)[W.ENV_MEM_FRACTION] == "0.090"

    @pytest.mark.parametrize("value", ["x", "0", "1.5", "-0.2"])
    def test_a_bad_fraction_raises(self, value):
        with pytest.raises(W.ConfinementError):
            W.memory_fraction({W.ENV_MEM_FRACTION: value})


class TestCheckConfinement:
    def test_uuid_grant_is_checked_absolutely(self):
        # CUDA spells UUIDs bare and in lower case
        W.check_confinement([GPU_A], [GPU_A[4:].upper()])
        W.check_confinement([GPU_A, MIG_A], [MIG_A, GPU_A])
        with pytest.raises(W.ConfinementError, match="STOP"):
            W.check_confinement([GPU_A], [GPU_B])
        with pytest.raises(W.ConfinementError, match="promised 1"):
            W.check_confinement([GPU_A], [])

    def test_index_grant_is_checked_by_count(self):
        W.check_confinement([3, 5], [GPU_A, GPU_B])
        with pytest.raises(W.ConfinementError):
            W.check_confinement([3, 5], [GPU_A])


class _Cuda:
    """CUDA's calls recorded, for a host with these device UUIDs."""

    def __init__(self, monkeypatch, uuids):
        self.calls = []
        props = [types.SimpleNamespace(name="NVIDIA H100 80GB HBM3",
                                       uuid=u[4:], total_memory=85_017_493_504)
                 for u in uuids]

        @contextmanager
        def device(i):
            self.calls.append(("device", i))
            yield

        monkeypatch.setattr(torch.backends.cuda, "is_built", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count",
                            lambda: self.calls.append(("count",)) or len(props))
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda i: props[i])
        monkeypatch.setattr(torch.cuda, "device", device)
        monkeypatch.setattr(
            torch.cuda, "set_per_process_memory_fraction",
            lambda f, i: self.calls.append(("fraction", f, i)))

    def fractions(self):
        return [c[1:] for c in self.calls if c[0] == "fraction"]


class TestValidateConfinement:
    def test_no_grant(self, monkeypatch):
        cuda = _Cuda(monkeypatch, [GPU_A])
        assert W.validate_confinement({}) is False
        assert cuda.calls == []

    def test_cap_on_every_visible_device(self, monkeypatch):
        cuda = _Cuda(monkeypatch, [GPU_A, GPU_B])
        env = {"NOS_TPU_VISIBLE_CHIPS": f"{GPU_B},{GPU_A}",
               "NOS_TPU_TIMESHARE_GB": "24"}
        W.apply(env, memory_gb=80)
        assert W.validate_confinement(env) is True
        assert cuda.fractions() == [(0.27, 0), (0.27, 1)]
        assert ("device", 1) in cuda.calls

    def test_timeshare_only(self, monkeypatch):
        cuda = _Cuda(monkeypatch, [GPU_A])
        env = {"NOS_TPU_TIMESHARE_GB": "8"}
        W.apply(env, memory_gb=80)
        assert W.validate_confinement(env) is True
        assert cuda.fractions() == [(0.09, 0)]

    def test_mismatch_raises_before_the_cap(self, monkeypatch):
        cuda = _Cuda(monkeypatch, [GPU_B])
        env = {"NOS_TPU_VISIBLE_CHIPS": GPU_A, "NOS_TPU_TIMESHARE_GB": "24"}
        W.apply(env, memory_gb=80)
        with pytest.raises(W.ConfinementError):
            W.validate_confinement(env)
        assert cuda.fractions() == []

    def test_zero_devices_is_a_confinement_error(self, monkeypatch):
        cuda = _Cuda(monkeypatch, [])
        with pytest.raises(W.ConfinementError, match="CUDA sees 0"):
            W.validate_confinement({"NOS_TPU_VISIBLE_CHIPS": GPU_A})
        with pytest.raises(W.ConfinementError, match="no device"):
            W.validate_confinement({W.ENV_MEM_FRACTION: "0.27"})
        assert cuda.fractions() == []

    def test_cpu_run_returns_false_and_installs_no_cap(self, monkeypatch):
        cuda = _Cuda(monkeypatch, [GPU_A])
        env = {"NOS_TPU_VISIBLE_CHIPS": GPU_A, W.ENV_MEM_FRACTION: "0.27"}
        assert W.validate_confinement(env, device="cpu") is False
        monkeypatch.setattr(torch.backends.cuda, "is_built", lambda: False)
        assert W.validate_confinement(env) is False
        assert cuda.calls == []

    def test_a_cpu_only_torch_is_a_cpu_run(self, monkeypatch):
        calls = []
        monkeypatch.setattr(torch.cuda, "set_per_process_memory_fraction",
                            lambda *a: calls.append(a))
        env = {"NOS_TPU_VISIBLE_CHIPS": "0", W.ENV_MEM_FRACTION: "0.27"}
        assert torch.backends.cuda.is_built() is False
        assert W.validate_confinement(env) is False and calls == []


def test_apply_defaults_to_the_process_environment():
    assert W.apply.__defaults__[0] is os.environ
    assert W.validate_confinement.__defaults__[0] is os.environ
