"""Workload-side device environment: honor what the scheduler granted,
``nos_tpu/device/workload_env.py`` for the port.

The control plane's grants reach the container as environment variables
(the device plugin's Allocate response, plus the pod's own resource
requests mirrored by the operator), under the JAX package's keys, so one
granter serves both packages.  The workload calls ``apply`` BEFORE its
first CUDA call and ``validate_confinement`` right after CUDA starts:

- a **timeshare** grant (``nvidia.com/gpu-<N>gb``: ``NOS_TPU_TIMESHARE_GB``
  and its per-profile ``NOS_TPU_TIMESHARE_GB_*`` keys, summed) caps the
  process's CUDA caching allocator at the granted share of the card's
  memory.  Without it a process allocates as much as it likes, and the
  co-located sharers the timeshare plan promised run out of memory (the
  MPS memory-limit analog).  torch reads no environment variable for the
  cap, so ``apply`` exports the fraction under ``ENV_MEM_FRACTION`` and
  ``validate_confinement`` installs it with
  ``torch.cuda.set_per_process_memory_fraction`` on every visible device.
  The card's memory size comes from discovery through NVML (no CUDA
  context), so the fraction is right on every model;
- a **device** grant (``NOS_TPU_VISIBLE_CHIPS`` and its per-profile
  ``NOS_TPU_VISIBLE_CHIPS_*`` keys, united) names local GPU indices, or
  GPU and MIG UUIDs (``GPU-…``, ``MIG-…``), and becomes
  ``CUDA_VISIBLE_DEVICES``, so the process sees ONLY the granted devices
  (MIG device visibility, reference pkg/gpu/nvml/client.go:286-340);
- the carved devices' ids (``NOS_TPU_SLICE_IDS``) pass through for
  job-side tooling, under the JAX package's ``TPU_VISIBLE_SLICE_IDS``.

Numbering: an index grant counts GPUs as NVML and the device plugin do,
in PCI bus order, while CUDA's default order is fastest first.  So
``apply`` sets ``CUDA_DEVICE_ORDER=PCI_BUS_ID`` beside the visibility
(the GPU form of the JAX module's numbering CAVEAT).  ``validate_confinement``
then checks what CUDA shows: the device count always, and for a UUID
grant the UUIDs themselves, since CUDA reports each device's UUID: an
absolute identity, where the JAX check can prove only the shape.
"""

from __future__ import annotations

import logging
import os
import re

logger = logging.getLogger(__name__)

# The grant keys, the JAX package's.
ENV_TIMESHARE_GB = "NOS_TPU_TIMESHARE_GB"
ENV_SLICE_IDS = "NOS_TPU_SLICE_IDS"
ENV_VISIBLE_CHIPS = "NOS_TPU_VISIBLE_CHIPS"
# What apply emits.
ENV_MEM_FRACTION = "NOS_TPU_TORCH_MEM_FRACTION"
ENV_VISIBLE_SLICE_IDS = "TPU_VISIBLE_SLICE_IDS"
VISIBILITY_KEYS = ("CUDA_VISIBLE_DEVICES", "CUDA_DEVICE_ORDER")

_INDEX = re.compile(r"^[0-9]+$")
_UUID = re.compile(r"^(GPU|MIG)-[0-9a-fA-F]{8}-[0-9a-fA-F]{4}-[0-9a-fA-F]{4}"
                   r"-[0-9a-fA-F]{4}-[0-9a-fA-F]{12}$")


def _is_grant_key(key: str, base: str) -> bool:
    return key == base or key.startswith(base + "_")


def granted_device_ids(environ) -> list[int] | list[str] | None:
    """Union of every per-profile visibility grant: local GPU indices
    (ints, sorted) or GPU-/MIG- UUIDs (strings, sorted).  A corrupt token
    (empty, negative, not an index or a UUID) or a mix of the two kinds
    voids the WHOLE grant (returns None): confining the process to a
    silently under-sized subset of its grant is worse than not confining
    it.  No grant: [].  Stricter than the JAX package's ``int()`` parse,
    which takes "-1" or "1_0": ``CUDA_VISIBLE_DEVICES`` stops at an
    index it cannot use, which would hide granted devices."""
    indices: set[int] = set()
    uuids: set[str] = set()
    for key, value in environ.items():
        if not _is_grant_key(key, ENV_VISIBLE_CHIPS):
            continue
        for part in str(value).split(","):
            token = part.strip()
            if _INDEX.match(token):
                indices.add(int(token))
            elif _UUID.match(token):
                uuids.add(token)
            else:
                logger.warning("corrupt visibility grant %s=%r: not "
                               "confining", key, value)
                return None
    if indices and uuids:
        logger.warning("visibility grant mixes indices %s and UUIDs %s: "
                       "not confining", sorted(indices), sorted(uuids))
        return None
    return sorted(uuids) if uuids else sorted(indices)


def granted_timeshare_gb(environ) -> float:
    total = 0.0
    for key, value in environ.items():
        if _is_grant_key(key, ENV_TIMESHARE_GB):
            try:
                total += float(value)
            except ValueError:
                logger.warning("ignoring unparseable %s=%r", key, value)
    return total


# Leave headroom below the granted fraction: the caching allocator needs
# slack for fragmentation, and N sharers at exactly 1/N would
# collectively exceed the card's memory.
SAFETY = 0.9
CEILING = 0.95


def apply(environ=os.environ, memory_gb: float | None = None) -> dict[str, str]:
    """Derive the process's CUDA settings from the scheduler's grants and
    set those not already set; returns what it derived.  Must run before
    the first CUDA call (CUDA reads its visibility once, at start)."""
    applied: dict[str, str] = {}
    gb = granted_timeshare_gb(environ)
    if gb > 0:
        if memory_gb is None:
            # NVML or the configured model, never a CUDA context: a 24 GB
            # grant must cap 24/80 on an H100 80GB, 24/141 on an H200
            from nos_tpu_torch.device import discovery

            memory_gb = discovery.discover(
                allow_cuda=False, environ=environ).model.memory_gb
        fraction = min(gb / memory_gb * SAFETY, CEILING)
        applied[ENV_MEM_FRACTION] = f"{fraction:.3f}"
    slice_ids = environ.get(ENV_SLICE_IDS, "")
    if slice_ids:
        applied[ENV_VISIBLE_SLICE_IDS] = slice_ids
    ids = granted_device_ids(environ)
    if ids and not any(k in environ for k in VISIBILITY_KEYS):
        # Both keys or neither, and never over an operator's own: the
        # grant's numbering holds only in PCI bus order.
        applied["CUDA_VISIBLE_DEVICES"] = ",".join(str(i) for i in ids)
        applied["CUDA_DEVICE_ORDER"] = "PCI_BUS_ID"
    for key, value in applied.items():
        environ.setdefault(key, value)
        logger.info("workload env: %s=%s", key, environ[key])
    return applied


class ConfinementError(RuntimeError):
    """The process does NOT see what its grant says: running on would
    share devices with another workload, or miss granted ones."""


def check_confinement(granted: list[int] | list[str],
                      visible: list[str]) -> None:
    """Pure core of validate_confinement (tested without a card).
    ``visible`` holds the UUIDs of the devices CUDA shows the confined
    process.  Raises ConfinementError when the count differs from the
    grant's, or, for a UUID grant, when the visible UUIDs are not the
    granted set.  An index grant is checked by count only: its indices
    are the host's, which CUDA renumbers from 0."""
    from .discovery import uuid_key

    if len(visible) != len(granted):
        raise ConfinementError(
            f"visibility grant promised {len(granted)} device(s) "
            f"{granted} but CUDA sees {len(visible)}: CUDA did not honor "
            f"CUDA_VISIBLE_DEVICES, or the grant was clobbered")
    if granted and isinstance(granted[0], str):
        want = {uuid_key(u) for u in granted}
        got = {uuid_key(u) for u in visible}
        if got != want:
            raise ConfinementError(
                f"CUDA shows devices {sorted(visible)}, the grant names "
                f"{sorted(granted)}: STOP, the process may be on another "
                f"workload's device")


def memory_fraction(environ=os.environ) -> float | None:
    """The cap ``apply`` exported (or an operator set), or None."""
    raw = environ.get(ENV_MEM_FRACTION)
    if raw is None:
        return None
    try:
        fraction = float(raw)
    except ValueError:
        raise ConfinementError(f"{ENV_MEM_FRACTION}={raw!r} is not a "
                               f"number") from None
    if not 0.0 < fraction <= 1.0:
        raise ConfinementError(f"{ENV_MEM_FRACTION}={raw!r} is outside "
                               f"(0, 1]")
    return fraction


def validate_confinement(environ=os.environ, device="cuda") -> bool:
    """After CUDA starts, and before any allocation: prove the process
    is confined to its grant, then install the timeshare cap on every
    visible device.  Returns True when it verified a visibility grant or
    installed a cap, False when there was nothing to do, or on a CPU
    run (``device="cpu"``, or a torch built without CUDA), where neither
    binds.  Raises ConfinementError
    on a mismatch, a zero-device grant included, before any work runs."""
    import torch

    granted = granted_device_ids(environ)
    fraction = memory_fraction(environ)
    if not granted and fraction is None:
        return False
    if torch.device(device).type != "cuda" \
            or not torch.backends.cuda.is_built():
        return False    # a CPU run: visibility and the cap bind CUDA only
    # device_count, not is_available: a grant naming no device of this
    # host shows as zero devices, which must stop the run here
    n = torch.cuda.device_count()
    if granted:
        from .discovery import cuda_uuid

        check_confinement(granted, [
            cuda_uuid(torch.cuda.get_device_properties(i))
            for i in range(n)])
    if fraction is not None:
        if n == 0:
            raise ConfinementError(
                f"a timeshare cap of {fraction} was granted but CUDA sees "
                f"no device")
        for i in range(n):
            with torch.cuda.device(i):
                torch.cuda.set_per_process_memory_fraction(fraction, i)
    return True
