"""A fake NVML function table for the CPU tests: the C calls that
``nos_tpu_torch/device/nvml.py`` binds, taking the same ``ctypes``
arguments, over a described host of GPUs and MIG instances."""

from __future__ import annotations

import ctypes
import dataclasses

from nos_tpu_torch.topology import H100_80GB, GpuModel

H100_NAME = "NVIDIA H100 80GB HBM3"
H100_BYTES = 85_520_809_984
H100_RESERVED = 503_316_480
SUCCESS, INVALID_ARGUMENT, NOT_SUPPORTED, NOT_FOUND, UNKNOWN = 0, 2, 3, 6, 999
_STRINGS = {SUCCESS: b"Success", INVALID_ARGUMENT: b"Invalid Argument",
            NOT_SUPPORTED: b"Not Supported", NOT_FOUND: b"Not Found",
            UNKNOWN: b"Unknown Error"}
_GPU, _MIG, _GI = 0x1000, 0x2000, 0x3000
_PROFILE_ID_BASE = 100      # NVML's profile info id differs from the index


@dataclasses.dataclass
class FakeGpu:
    name: str = H100_NAME
    uuid: str = "GPU-11111111-2222-3333-4444-555555555555"
    memory: int = H100_BYTES
    reserved: int = H100_RESERVED
    mig: bool = False
    mig_pending: bool = False
    mig_supported: bool = True
    # (MIG UUID, NVML profile id, start, size)
    instances: list = dataclasses.field(default_factory=list)


def profile_rows(model: GpuModel = H100_80GB) -> dict[int, dict]:
    """What NVML reports per GPU instance profile of ``model``'s table."""
    return {p.nvml_id: {"slices": p.compute_slices, "count": p.max_count,
                        "mb": p.memory_gb * 1000,
                        "placements": [(s, p.memory_slices) for s in p.starts]}
            for p in model.mig_profiles}


class FakeNvmlLibrary:
    """``fail`` maps a call's name to the return code it gives."""

    def __init__(self, gpus: list[FakeGpu], profiles: dict | None = None,
                 fail: dict[str, int] | None = None) -> None:
        self.gpus = gpus
        self.profiles = profile_rows() if profiles is None else profiles
        self.fail = dict(fail or {})
        self.calls: list[str] = []
        self.open = 0

    def _enter(self, call: str) -> int:
        self.calls.append(call)
        return self.fail.get(call, SUCCESS)

    def _gpu(self, handle) -> FakeGpu | None:
        i = getattr(handle, "value", handle) - _GPU
        return self.gpus[i] if 0 <= i < len(self.gpus) else None

    def nvmlErrorString(self, rc):
        return _STRINGS.get(rc, b"Unknown Error")

    def nvmlInit_v2(self):
        rc = self._enter("nvmlInit_v2")
        self.open += rc == SUCCESS
        return rc

    def nvmlShutdown(self):
        rc = self._enter("nvmlShutdown")
        self.open -= rc == SUCCESS
        return rc

    def nvmlDeviceGetCount_v2(self, count):
        rc = self._enter("nvmlDeviceGetCount_v2")
        if rc == SUCCESS:
            count._obj.value = len(self.gpus)
        return rc

    def nvmlDeviceGetHandleByIndex_v2(self, index, handle):
        rc = self._enter("nvmlDeviceGetHandleByIndex_v2")
        if rc == SUCCESS:
            if not 0 <= index < len(self.gpus):
                return INVALID_ARGUMENT
            handle._obj.value = _GPU + index
        return rc

    def _string(self, call, handle, buf, value):
        rc = self._enter(call)
        if rc == SUCCESS:
            buf.value = value.encode()
        return rc

    def nvmlDeviceGetName(self, handle, buf, length):
        return self._string("nvmlDeviceGetName", handle, buf,
                            self._gpu(handle).name)

    def nvmlDeviceGetUUID(self, handle, buf, length):
        gpu = self._gpu(handle)
        if gpu is None:       # a MIG device
            v = handle.value - _MIG
            uuid = self.gpus[v // 16].instances[v % 16][0]
        else:
            uuid = gpu.uuid
        return self._string("nvmlDeviceGetUUID", handle, buf, uuid)

    def nvmlDeviceGetMemoryInfo_v2(self, handle, mem):
        rc = self._enter("nvmlDeviceGetMemoryInfo_v2")
        if rc == SUCCESS:
            if mem._obj.version != ctypes.sizeof(mem._obj) | (2 << 24):
                return INVALID_ARGUMENT      # NVML_ERROR_ARGUMENT_VERSION_MISMATCH
            gpu = self._gpu(handle)
            mem._obj.total = gpu.memory
            mem._obj.reserved = gpu.reserved
            mem._obj.free = gpu.memory - gpu.reserved
        return rc

    def nvmlDeviceGetMigMode(self, handle, current, pending):
        rc = self._enter("nvmlDeviceGetMigMode")
        gpu = self._gpu(handle)
        if rc == SUCCESS and not gpu.mig_supported:
            return NOT_SUPPORTED
        if rc == SUCCESS:
            current._obj.value = int(gpu.mig)
            pending._obj.value = int(gpu.mig_pending)
        return rc

    def nvmlDeviceGetMaxMigDeviceCount(self, handle, count):
        rc = self._enter("nvmlDeviceGetMaxMigDeviceCount")
        if rc == SUCCESS:
            count._obj.value = 7 if self._gpu(handle).mig else 0
        return rc

    def nvmlDeviceGetMigDeviceHandleByIndex(self, handle, index, out):
        rc = self._enter("nvmlDeviceGetMigDeviceHandleByIndex")
        gpu_index = handle.value - _GPU
        if rc == SUCCESS:
            if index >= len(self.gpus[gpu_index].instances):
                return NOT_FOUND
            out._obj.value = _MIG + 16 * gpu_index + index
        return rc

    def nvmlDeviceGetGpuInstanceId(self, mig, gi_id):
        rc = self._enter("nvmlDeviceGetGpuInstanceId")
        if rc == SUCCESS:
            gi_id._obj.value = (mig.value - _MIG) % 16 + 1
        return rc

    def nvmlDeviceGetGpuInstanceById(self, handle, gi_id, gi):
        rc = self._enter("nvmlDeviceGetGpuInstanceById")
        if rc == SUCCESS:
            gi._obj.value = _GI + 16 * (handle.value - _GPU) + gi_id - 1
        return rc

    def nvmlGpuInstanceGetInfo(self, gi, info):
        rc = self._enter("nvmlGpuInstanceGetInfo")
        if rc == SUCCESS:
            v = gi.value - _GI
            _, profile, start, size = self.gpus[v // 16].instances[v % 16]
            info._obj.profileId = profile
            info._obj.placement.start = start
            info._obj.placement.size = size
        return rc

    def nvmlDeviceGetGpuInstanceProfileInfo(self, handle, nvml_id, info):
        rc = self._enter("nvmlDeviceGetGpuInstanceProfileInfo")
        if rc == SUCCESS:
            row = self.profiles.get(nvml_id)
            if not self._gpu(handle).mig or row is None:
                return NOT_SUPPORTED
            info._obj.id = _PROFILE_ID_BASE + nvml_id
            info._obj.sliceCount = row["slices"]
            info._obj.instanceCount = row["count"]
            info._obj.memorySizeMB = row["mb"]
        return rc

    def nvmlDeviceGetGpuInstancePossiblePlacements_v2(self, handle,
                                                      profile_id, out, count):
        rc = self._enter("nvmlDeviceGetGpuInstancePossiblePlacements_v2")
        if rc == SUCCESS:
            places = self.profiles[profile_id - _PROFILE_ID_BASE]["placements"]
            if out is not None:
                if count._obj.value < len(places):
                    return INVALID_ARGUMENT
                for i, (start, size) in enumerate(places):
                    out[i].start, out[i].size = start, size
            count._obj.value = len(places)
        return rc
