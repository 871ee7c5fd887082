"""GPU discovery: observe the hardware instead of asserting it,
``nos_tpu/device/discovery.py`` for the port.

The analog of the reference's NVML device enumeration
(pkg/gpu/nvml/client.go:31-518): the one place the framework learns which
accelerators exist on this host.  Sources, in order of authority (the
``source`` words are the JAX package's, so a consumer reads the same
ones):

1. **The CUDA devices** (``SOURCE_DEVICE``) through
   ``torch.cuda.get_device_properties``: name, UUID, total memory and SM
   count of each device this process sees, after its grant confined it.
   Tried only when allowed and CUDA is already initialised, as the JAX
   package tries PJRT only once jax is loaded: discovery never starts a
   CUDA context itself, nor imports torch: a process that has not
   imported it has no CUDA context, and a control-plane process does not.
2. **Driver metadata through NVML** (``SOURCE_ENV``): every GPU of the
   host, its name, UUID, memory and MIG mode, read without a CUDA context
   (``device/nvml.py``).  Control-plane callers and ``workload_env.apply``,
   which must run before the first CUDA call, use this rung
   (``allow_cuda=False``).
3. **The configured model** (``SOURCE_CONFIGURED``), ``H100_80GB`` unless
   the caller names another: the fallback where there is no driver.

A product name that no known model matches falls through to the next
rung with a warning.
"""

from __future__ import annotations

import logging
import os
import sys
from dataclasses import dataclass
from typing import TYPE_CHECKING

from nos_tpu_torch.topology import DEFAULT_REGISTRY, H100_80GB, GpuModel

if TYPE_CHECKING:
    import torch

logger = logging.getLogger(__name__)

SOURCE_DEVICE = "device"
SOURCE_ENV = "env"
SOURCE_CONFIGURED = "configured"


def uuid_key(uuid: str) -> str:
    """A UUID without its ``GPU-`` / ``MIG-`` prefix, lower case: CUDA's
    properties spell a device's UUID bare, NVML and CUDA_VISIBLE_DEVICES
    with the prefix."""
    u = uuid.strip().lower()
    return u[4:] if u.startswith(("gpu-", "mig-")) else u


def cuda_uuid(props) -> str:
    """A CUDA device's UUID as NVML spells it (``GPU-``; ``MIG-`` for a
    MIG instance, whose CUDA name says so)."""
    prefix = "MIG-" if " MIG " in f" {props.name} " else "GPU-"
    return prefix + str(props.uuid)


@dataclass(frozen=True)
class DiscoveredTopology:
    """What this host observed about its own GPUs."""

    model: GpuModel
    num_local_gpus: int
    num_hosts: int
    source: str                   # SOURCE_DEVICE | SOURCE_ENV | SOURCE_CONFIGURED
    product_name: str | None = None        # raw name (NVML or CUDA)
    uuids: tuple[str, ...] = ()            # per GPU, GPU-/MIG- prefixed
    mig_modes: tuple[bool, ...] = ()       # per GPU
    # per GPU, the memory CUDA reports as its total (NVML: total less the
    # driver's reserve)
    memory_bytes: tuple[int, ...] = ()

    def torch_device_for(self, uuid_or_index: str | int) -> torch.device:
        """The live CUDA device that a discovered GPU (its UUID, or its
        index in ``uuids``) is in this process: the proof that a granted
        GPU names a real device.  Raises LookupError when CUDA does not
        show it (not granted to this process, or not on this host)."""
        import torch

        if isinstance(uuid_or_index, int):
            if not 0 <= uuid_or_index < len(self.uuids):
                raise LookupError(f"no discovered GPU {uuid_or_index}")
            uuid_or_index = self.uuids[uuid_or_index]
        want = uuid_key(uuid_or_index)
        for i in range(torch.cuda.device_count()):
            if uuid_key(str(torch.cuda.get_device_properties(i).uuid)) \
                    == want:
                return torch.device("cuda", i)
        raise LookupError(f"no CUDA device with UUID {uuid_or_index}")


def _num_hosts(environ) -> int:
    """torchrun's WORLD_SIZE // LOCAL_WORLD_SIZE, else 1."""
    try:
        world = int(environ.get("WORLD_SIZE", "1"))
        local = int(environ.get("LOCAL_WORLD_SIZE", str(world)))
    except ValueError:
        return 1
    return max(1, world // local) if local > 0 else 1


def _match(name: str) -> GpuModel | None:
    model = DEFAULT_REGISTRY.match(name)
    if model is None:
        logger.warning("unrecognised GPU %r; topology discovery falling "
                       "back", name)
    return model


def _discover_from_device(environ) -> DiscoveredTopology | None:
    """The CUDA devices this process sees; needs CUDA up already."""
    import torch

    n = torch.cuda.device_count()
    if n == 0:
        return None
    props = [torch.cuda.get_device_properties(i) for i in range(n)]
    model = _match(props[0].name)
    if model is None:
        return None
    return DiscoveredTopology(
        model=model, num_local_gpus=n, num_hosts=_num_hosts(environ),
        source=SOURCE_DEVICE, product_name=props[0].name,
        uuids=tuple(cuda_uuid(p) for p in props),
        mig_modes=tuple(" MIG " in f" {p.name} " for p in props),
        memory_bytes=tuple(p.total_memory for p in props))


def _discover_from_nvml(environ, nvml_lib) -> DiscoveredTopology | None:
    """Driver metadata through NVML: no CUDA context."""
    from . import nvml

    try:
        with nvml.Nvml(nvml_lib) as lib:
            gpus = nvml.read_gpus(lib)
    except (nvml.NvmlUnavailable, nvml.NvmlError) as e:
        logger.debug("NVML discovery unavailable: %s", e)
        return None
    if not gpus:
        return None
    model = _match(gpus[0]["name"])
    if model is None:
        return None
    return DiscoveredTopology(
        model=model, num_local_gpus=len(gpus), num_hosts=_num_hosts(environ),
        source=SOURCE_ENV, product_name=gpus[0]["name"],
        uuids=tuple(g["uuid"] for g in gpus),
        mig_modes=tuple(g["mig"] for g in gpus),
        memory_bytes=tuple(g["memory_usable"] for g in gpus))


def discover(configured: GpuModel | None = None, allow_cuda: bool = True,
             environ=os.environ, nvml_lib=None) -> DiscoveredTopology:
    """Observe this host's GPUs; never raises.

    allow_cuda=False skips the CUDA rung even where CUDA is up: callers
    that must not depend on a CUDA context (the control plane, and
    ``workload_env.apply`` before the first CUDA call) read NVML and the
    configured model only.  ``nvml_lib`` injects NVML's function table
    (``device/nvml.py``)."""
    torch = sys.modules.get("torch")
    if allow_cuda and torch is not None and torch.cuda.is_initialized():
        try:
            found = _discover_from_device(environ)
        except RuntimeError as e:
            logger.debug("CUDA device discovery unavailable: %s", e)
            found = None
        if found is not None:
            return found
    found = _discover_from_nvml(environ, nvml_lib)
    if found is not None:
        return found
    model = configured or H100_80GB
    return DiscoveredTopology(
        model=model, num_local_gpus=1, num_hosts=_num_hosts(environ),
        source=SOURCE_CONFIGURED)
