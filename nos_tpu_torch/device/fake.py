"""Fake device layer for tests and the hardware-free simulator,
``nos_tpu/device/fake.py`` for the port.

The analog of the mockery-generated nvml/mig/resource mocks (reference
pkg/test/mocks/**), but stateful: FakeGpuRuntime keeps MIG devices with
their placements on each fake GPU's memory slots and carves them through
the exact packer, so agent tests meet the same placement rules NVML
enforces on the card.  An NVLink block shard (profile "NxG",
``partitioning/slicepart/group.py``) is recorded as one device that
takes its whole GPU: it is created only on a GPU with no device, alone,
and it has no MIG placement.
"""

from __future__ import annotations

import itertools
import threading

from nos_tpu_torch.topology import (
    H100_80GB, Device, DeviceList, FREE, GpuModel, Placement, extend,
    make_device_id,
)
from nos_tpu_torch.topology.errors import (DeviceNotFoundError,
                                           PlacementInfeasibleError)
from nos_tpu_torch.topology.profile import (
    is_block_profile, slice_resource_name,
)

from .gpuclient import GpuRuntimeClient, PodResourcesClient


class SliceCreationError(Exception):
    pass


class FakeGpuRuntime(GpuRuntimeClient):
    """``num_gpus`` fake cards of ``model``, all in MIG mode.

    Fault injection: ``fail_creates`` refuses every create up front;
    ``fail_after`` lets that many instances of a create call be made and
    fails the next one, as a driver error part-way through would, so the
    call must delete what it made."""

    def __init__(self, model: GpuModel = H100_80GB, num_gpus: int = 1,
                 fail_creates: bool = False,
                 fail_after: int | None = None,
                 gpu_uuids: list[str] | None = None) -> None:
        self._model = model
        self._num_gpus = num_gpus
        # each fake GPU's UUID (a caller standing a fake in for a real
        # card gives the card's); well-formed, of no device, by default
        self._gpu_uuids = list(gpu_uuids) if gpu_uuids is not None else [
            f"GPU-00000000-0000-4000-8000-{i:012x}" for i in range(num_gpus)]
        self._lock = threading.RLock()
        self._devices: dict[str, tuple[int, Placement]] = {}
        self._ids = itertools.count(1)
        self.fail_creates = fail_creates
        self.fail_after = fail_after
        self.create_calls = 0
        self.delete_calls = 0

    # -- GpuRuntimeClient ---------------------------------------------------
    def topology(self) -> tuple[str, tuple[bool, ...]]:
        return self._model.name, (True,) * self._num_gpus

    def gpu_uuids(self) -> list[str]:
        return list(self._gpu_uuids)

    def list_devices(self) -> DeviceList:
        with self._lock:
            out = DeviceList()
            for did, (unit, pl) in sorted(self._devices.items()):
                out.append(Device(slice_resource_name(pl.profile), did, FREE,
                                  unit))
            return out

    def placements(self) -> dict[str, Placement]:
        with self._lock:
            return {did: pl for did, (_, pl) in self._devices.items()
                    if not is_block_profile(pl.profile)}

    def create_slices(self, unit_index: int, profiles: list[str]) -> list[str]:
        with self._lock:
            self.create_calls += 1
            if self.fail_creates:
                raise SliceCreationError("injected create failure")
            if not 0 <= unit_index < self._num_gpus:
                raise DeviceNotFoundError(f"no GPU {unit_index}")
            fixed = [pl for u, pl in self._devices.values()
                     if u == unit_index]
            if any(is_block_profile(p) for p in profiles):
                # a block shard is the whole card
                if len(profiles) != 1 or fixed:
                    raise PlacementInfeasibleError(
                        f"a block shard takes GPU {unit_index} whole: "
                        f"{profiles} beside {len(fixed)} existing devices")
                did = make_device_id(unit_index, profiles[0],
                                     next(self._ids))
                self._devices[did] = (unit_index, Placement(
                    profiles[0], 0, self._model.memory_slices))
                return [did]
            counts: dict[str, int] = {}
            for p in profiles:
                counts[p] = counts.get(p, 0) + 1
            placements = extend(self._model, fixed, counts)
            if placements is None:
                raise PlacementInfeasibleError(
                    f"cannot place {profiles} on GPU {unit_index} around "
                    f"{len(fixed)} existing devices")
            created: list[str] = []
            try:
                for pl in placements:
                    if self.fail_after is not None \
                            and len(created) >= self.fail_after:
                        raise SliceCreationError(
                            f"injected failure creating {pl.profile} at "
                            f"slot {pl.start}")
                    did = make_device_id(unit_index, pl.profile,
                                         next(self._ids))
                    self._devices[did] = (unit_index, pl)
                    created.append(did)
            except SliceCreationError:
                # all-or-nothing: undo the part already made
                for did in created:
                    del self._devices[did]
                raise
            return created

    def delete_slice(self, device_id: str) -> None:
        with self._lock:
            self.delete_calls += 1
            if device_id not in self._devices:
                raise DeviceNotFoundError(device_id)
            del self._devices[device_id]

    def delete_all_except(self, keep: set[str]) -> list[str]:
        with self._lock:
            doomed = [d for d in self._devices if d not in keep]
            for d in doomed:
                del self._devices[d]
            return doomed


class FakePodResources(PodResourcesClient):
    """Used-device tracking; the simulator marks devices used/free as pods
    bind/terminate (standing in for the kubelet pod-resources socket)."""

    def __init__(self) -> None:
        self._used: dict[str, set[str]] = {}      # pod key -> device ids

    def allocate(self, pod_key: str, device_ids: set[str]) -> None:
        self._used[pod_key] = set(device_ids)

    def release(self, pod_key: str) -> None:
        self._used.pop(pod_key, None)

    def allocated_pod_keys(self) -> list[str]:
        return list(self._used)

    def used_device_ids(self) -> set[str]:
        out: set[str] = set()
        for ids in self._used.values():
            out |= ids
        return out
