"""A fake NVML function table for the CPU tests: the C calls that
``nos_tpu_torch/device/nvml.py`` binds, taking the same ``ctypes``
arguments, over a described host of GPUs, their GPU instances, compute
instances and MIG devices.

It keeps NVML's rules as far as the runtime meets them: MIG calls are
refused with MIG mode off (NOT_SUPPORTED); a GPU instance is asked by
its profile's info ``id`` (on the H100 the ids ``nvidia-smi mig -lgip``
lists, which are not the ``NVML_GPU_INSTANCE_PROFILE_*`` values a
profile's info is asked by), only at one of the profile's placements
(INVALID_ARGUMENT), and not over another instance, beyond the profile's
count or beyond the card's compute slices (INSUFFICIENT_RESOURCES); a
MIG device appears only once a compute instance lies in its GPU
instance; a GPU instance holding a compute instance, or a compute
instance a process uses (``busy``), is not destroyed (IN_USE).  Handles
name what they stand for, so they stay valid across other deletes.
"""

from __future__ import annotations

import ctypes
import dataclasses

from nos_tpu_torch.topology import H100_80GB, GpuModel

H100_NAME = "NVIDIA H100 80GB HBM3"
H100_BYTES = 85_520_809_984
H100_RESERVED = 503_316_480
(SUCCESS, INVALID_ARGUMENT, NOT_SUPPORTED, NO_PERMISSION, NOT_FOUND,
 IN_USE, INSUFFICIENT_RESOURCES, UNKNOWN) = 0, 2, 3, 4, 6, 19, 23, 999
_STRINGS = {SUCCESS: b"Success", INVALID_ARGUMENT: b"Invalid Argument",
            NOT_SUPPORTED: b"Not Supported",
            NO_PERMISSION: b"Insufficient Permissions",
            NOT_FOUND: b"Not Found",
            INSUFFICIENT_RESOURCES: b"Insufficient Resources",
            IN_USE: b"In use by another client", UNKNOWN: b"Unknown Error"}
# NVML's GPU instance profile ids on an H100 80GB (the NVIDIA MIG User
# Guide's ``nvidia-smi mig -lgip``), by profile
H100_PROFILE_IDS = {"1g.10gb": 19, "1g.10gb+me": 20, "1g.20gb": 15,
                    "2g.20gb": 14, "3g.40gb": 9, "4g.40gb": 5, "7g.80gb": 0}
COMPUTE_SLICES = 7
# NVML_COMPUTE_INSTANCE_PROFILE_* -> compute slices; a compute profile's
# info id is its enum value
_CI_SLICES = {0: 1, 1: 2, 2: 3, 3: 4, 4: 7, 5: 8, 6: 6}
# handles: a GPU is _GPU + index; a GPU instance, compute instance or
# MIG device carries its kind, GPU, GPU instance id and compute id
_GPU, _MIG, _GI, _CI = 0x1000, 1, 2, 3


def _handle(kind: int, gpu: int, gi: int = 0, ci: int = 0) -> int:
    return kind << 20 | gpu << 16 | gi << 8 | ci


def _value(handle) -> int:
    return getattr(handle, "value", handle) or 0


@dataclasses.dataclass
class FakeGi:
    """A GPU instance: its profile (NVML_GPU_INSTANCE_PROFILE_*), its
    placement, and its compute instances (id -> (compute profile id,
    the MIG device's UUID))."""

    profile: int
    start: int
    size: int
    cis: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class FakeGpu:
    name: str = H100_NAME
    uuid: str = "GPU-11111111-2222-3333-4444-555555555555"
    memory: int = H100_BYTES
    reserved: int = H100_RESERVED
    mig: bool = False
    mig_pending: bool = False
    mig_supported: bool = True
    # the MIG devices the card starts with, each a GPU instance with one
    # compute instance over it: (MIG UUID, NVML_GPU_INSTANCE_PROFILE_*,
    # start, size)
    instances: list = dataclasses.field(default_factory=list)
    # GPU instance id -> FakeGi, the live state
    gis: dict = dataclasses.field(default_factory=dict, init=False)

    def __post_init__(self) -> None:
        for i, (uuid, profile, start, size) in enumerate(self.instances):
            self.gis[i + 1] = FakeGi(profile, start, size,
                                     {0: (None, uuid)})

    def mig_devices(self) -> list[tuple[int, int, str]]:
        """(GPU instance id, compute instance id, UUID) of each MIG
        device, in NVML's index order."""
        return [(g, c, uuid) for g, gi in sorted(self.gis.items())
                for c, (_, uuid) in sorted(gi.cis.items())]


def profile_rows(model: GpuModel = H100_80GB) -> dict[int, dict]:
    """What NVML reports per GPU instance profile of ``model``'s table,
    by NVML_GPU_INSTANCE_PROFILE_*: the info ``id`` (the H100's own),
    compute slices, most instances, MB and placements."""
    return {p.nvml_id: {"id": H100_PROFILE_IDS[p.name],
                        "slices": p.compute_slices, "count": p.max_count,
                        "mb": p.memory_gb * 1000,
                        "placements": [(s, p.memory_slices) for s in p.starts]}
            for p in model.mig_profiles}


class FakeNvmlLibrary:
    """``fail`` maps a call's name to the return code it gives.
    ``fail_after`` lets that many creates (GPU or compute instance)
    succeed and fails the next with ``fail_code``, once, as a driver
    error part-way through a carve would.  ``busy`` holds the UUIDs of
    MIG devices a process uses."""

    def __init__(self, gpus: list[FakeGpu], profiles: dict | None = None,
                 fail: dict[str, int] | None = None) -> None:
        self.gpus = gpus
        self.profiles = profile_rows() if profiles is None else profiles
        for gpu in gpus:
            for gi in gpu.gis.values():
                slices = self.profiles[gi.profile]["slices"]
                gi.cis = {c: (self._ci_profile(slices), uuid)
                          for c, (_, uuid) in gi.cis.items()}
        self.fail = dict(fail or {})
        self.fail_after: int | None = None
        self.fail_code = UNKNOWN
        self.busy: set[str] = set()
        self.calls: list[str] = []
        self.open = 0
        self._serial = 0

    @staticmethod
    def _ci_profile(slices: int) -> int:
        return {s: p for p, s in _CI_SLICES.items()}[slices]

    def _enter(self, call: str) -> int:
        self.calls.append(call)
        return self.fail.get(call, SUCCESS)

    def _injected(self) -> int:
        if self.fail_after is None:
            return SUCCESS
        if self.fail_after == 0:
            self.fail_after = None
            return self.fail_code
        self.fail_after -= 1
        return SUCCESS

    def _gpu(self, handle) -> FakeGpu | None:
        i = _value(handle) - _GPU
        return self.gpus[i] if 0 <= i < len(self.gpus) else None

    def _parts(self, handle, kind: int):
        """(GPU, GPU instance id, compute id) of a handle of ``kind``,
        or None where it names nothing that exists."""
        v = _value(handle)
        gpu, gi, ci = v >> 16 & 0xF, v >> 8 & 0xFF, v & 0xFF
        if v >> 20 != kind or gpu >= len(self.gpus) \
                or gi not in self.gpus[gpu].gis:
            return None
        if kind != _GI and ci not in self.gpus[gpu].gis[gi].cis:
            return None
        return gpu, gi, ci

    def _row(self, profile_id: int) -> tuple[int, dict] | tuple[None, None]:
        for enum, row in self.profiles.items():
            if row["id"] == profile_id:
                return enum, row
        return None, None

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
            parts = self._parts(handle, _MIG)
            if parts is None:
                self.calls.append("nvmlDeviceGetUUID")
                return INVALID_ARGUMENT
            g, gi, ci = parts
            uuid = self.gpus[g].gis[gi].cis[ci][1]
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
            count._obj.value = COMPUTE_SLICES if self._gpu(handle).mig else 0
        return rc

    def nvmlDeviceGetMigDeviceHandleByIndex(self, handle, index, out):
        rc = self._enter("nvmlDeviceGetMigDeviceHandleByIndex")
        if rc == SUCCESS:
            g = _value(handle) - _GPU
            devices = self.gpus[g].mig_devices()
            if index >= len(devices):
                return NOT_FOUND
            gi, ci, _ = devices[index]
            out._obj.value = _handle(_MIG, g, gi, ci)
        return rc

    def nvmlDeviceGetGpuInstanceId(self, mig, gi_id):
        rc = self._enter("nvmlDeviceGetGpuInstanceId")
        if rc == SUCCESS:
            parts = self._parts(mig, _MIG)
            if parts is None:
                return INVALID_ARGUMENT
            gi_id._obj.value = parts[1]
        return rc

    def nvmlDeviceGetGpuInstanceById(self, handle, gi_id, gi):
        rc = self._enter("nvmlDeviceGetGpuInstanceById")
        if rc == SUCCESS:
            g = _value(handle) - _GPU
            if gi_id not in self.gpus[g].gis:
                return NOT_FOUND
            gi._obj.value = _handle(_GI, g, gi_id)
        return rc

    def nvmlGpuInstanceGetInfo(self, gi, info):
        rc = self._enter("nvmlGpuInstanceGetInfo")
        if rc == SUCCESS:
            parts = self._parts(gi, _GI)
            if parts is None:
                return INVALID_ARGUMENT
            g, gi_id, _ = parts
            inst = self.gpus[g].gis[gi_id]
            info._obj.device = _GPU + g
            info._obj.id = gi_id
            info._obj.profileId = self.profiles[inst.profile]["id"]
            info._obj.placement.start = inst.start
            info._obj.placement.size = inst.size
        return rc

    def nvmlDeviceGetGpuInstanceProfileInfo(self, handle, nvml_id, info):
        rc = self._enter("nvmlDeviceGetGpuInstanceProfileInfo")
        if rc == SUCCESS:
            row = self.profiles.get(nvml_id)
            if not self._gpu(handle).mig or row is None:
                return NOT_SUPPORTED
            info._obj.id = row["id"]
            info._obj.sliceCount = row["slices"]
            info._obj.instanceCount = row["count"]
            info._obj.memorySizeMB = row["mb"]
        return rc

    def nvmlDeviceGetGpuInstancePossiblePlacements_v2(self, handle,
                                                      profile_id, out, count):
        rc = self._enter("nvmlDeviceGetGpuInstancePossiblePlacements_v2")
        if rc == SUCCESS:
            _, row = self._row(profile_id)
            if row is None:
                return INVALID_ARGUMENT
            places = row["placements"]
            if out is not None:
                if count._obj.value < len(places):
                    return INVALID_ARGUMENT
                for i, (start, size) in enumerate(places):
                    out[i].start, out[i].size = start, size
            count._obj.value = len(places)
        return rc

    # -- the MIG lifecycle --------------------------------------------------
    def nvmlDeviceGetGpuInstances(self, handle, profile_id, out, count):
        rc = self._enter("nvmlDeviceGetGpuInstances")
        if rc != SUCCESS:
            return rc
        gpu = self._gpu(handle)
        if not gpu.mig:
            return NOT_SUPPORTED
        enum, row = self._row(profile_id)
        if row is None or out is None or len(out) < row["count"]:
            return INVALID_ARGUMENT
        ids = [i for i, gi in sorted(gpu.gis.items()) if gi.profile == enum]
        for k, i in enumerate(ids):
            out[k] = _handle(_GI, _value(handle) - _GPU, i)
        count._obj.value = len(ids)
        return SUCCESS

    def nvmlDeviceCreateGpuInstanceWithPlacement(self, handle, profile_id,
                                                 placement, out):
        rc = self._enter("nvmlDeviceCreateGpuInstanceWithPlacement")
        if rc == SUCCESS:
            rc = self._injected()
        if rc != SUCCESS:
            return rc
        g = _value(handle) - _GPU
        gpu = self.gpus[g]
        if not gpu.mig:
            return NOT_SUPPORTED
        enum, row = self._row(profile_id)
        start, size = placement._obj.start, placement._obj.size
        if row is None or (start, size) not in row["placements"]:
            return INVALID_ARGUMENT
        mask = ((1 << size) - 1) << start
        taken = [gi for gi in gpu.gis.values()]
        if sum(gi.profile == enum for gi in taken) >= row["count"] \
                or any(mask & ((1 << gi.size) - 1) << gi.start
                       for gi in taken) \
                or row["slices"] + sum(self.profiles[gi.profile]["slices"]
                                       for gi in taken) > COMPUTE_SLICES:
            return INSUFFICIENT_RESOURCES
        gi_id = min(set(range(1, len(gpu.gis) + 2)) - set(gpu.gis))
        gpu.gis[gi_id] = FakeGi(enum, start, size)
        out._obj.value = _handle(_GI, g, gi_id)
        return SUCCESS

    def nvmlGpuInstanceGetComputeInstanceProfileInfo(self, gi, profile,
                                                     eng_profile, info):
        rc = self._enter("nvmlGpuInstanceGetComputeInstanceProfileInfo")
        if rc != SUCCESS:
            return rc
        parts = self._parts(gi, _GI)
        if parts is None:
            return INVALID_ARGUMENT
        g, gi_id, _ = parts
        gi_slices = self.profiles[self.gpus[g].gis[gi_id].profile]["slices"]
        slices = _CI_SLICES.get(profile)
        if slices is None or slices > gi_slices or eng_profile != 0:
            return NOT_SUPPORTED
        info._obj.id = profile
        info._obj.sliceCount = slices
        info._obj.instanceCount = gi_slices // slices
        return SUCCESS

    def nvmlGpuInstanceCreateComputeInstance(self, gi, profile_id, out):
        rc = self._enter("nvmlGpuInstanceCreateComputeInstance")
        if rc == SUCCESS:
            rc = self._injected()
        if rc != SUCCESS:
            return rc
        parts = self._parts(gi, _GI)
        if parts is None or profile_id not in _CI_SLICES:
            return INVALID_ARGUMENT
        g, gi_id, _ = parts
        inst = self.gpus[g].gis[gi_id]
        used = sum(_CI_SLICES[p] for p, _ in inst.cis.values())
        if used + _CI_SLICES[profile_id] > \
                self.profiles[inst.profile]["slices"]:
            return INSUFFICIENT_RESOURCES
        ci_id = min(set(range(len(inst.cis) + 1)) - set(inst.cis))
        self._serial += 1
        inst.cis[ci_id] = (profile_id, f"MIG-{g:08x}-fa4e-4000-8000-"
                                       f"{self._serial:012x}")
        out._obj.value = _handle(_CI, g, gi_id, ci_id)
        return SUCCESS

    def nvmlGpuInstanceGetComputeInstances(self, gi, profile_id, out, count):
        rc = self._enter("nvmlGpuInstanceGetComputeInstances")
        if rc != SUCCESS:
            return rc
        parts = self._parts(gi, _GI)
        if parts is None or out is None:
            return INVALID_ARGUMENT
        g, gi_id, _ = parts
        ids = [c for c, (p, _) in sorted(self.gpus[g].gis[gi_id].cis.items())
               if p == profile_id]
        for k, c in enumerate(ids):
            out[k] = _handle(_CI, g, gi_id, c)
        count._obj.value = len(ids)
        return SUCCESS

    def nvmlComputeInstanceDestroy(self, ci):
        rc = self._enter("nvmlComputeInstanceDestroy")
        if rc != SUCCESS:
            return rc
        parts = self._parts(ci, _CI)
        if parts is None:
            return INVALID_ARGUMENT
        g, gi_id, ci_id = parts
        cis = self.gpus[g].gis[gi_id].cis
        if cis[ci_id][1] in self.busy:
            return IN_USE
        del cis[ci_id]
        return SUCCESS

    def nvmlGpuInstanceDestroy(self, gi):
        rc = self._enter("nvmlGpuInstanceDestroy")
        if rc != SUCCESS:
            return rc
        parts = self._parts(gi, _GI)
        if parts is None:
            return INVALID_ARGUMENT
        g, gi_id, _ = parts
        if self.gpus[g].gis[gi_id].cis:
            return IN_USE
        del self.gpus[g].gis[gi_id]
        return SUCCESS
