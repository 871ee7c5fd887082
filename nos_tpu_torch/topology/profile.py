"""Profiles: the schedulable sub-resources carved from a GPU,
``nos_tpu/topology/profile.py`` for the port.

Two families, the reference ``nos``'s own resource names:

- **Slice profiles** are MIG GPU instances, named ``<g>g.<N>gb``
  ("3g.40gb"); extended resource ``nvidia.com/mig-3g.40gb``
  (reference pkg/gpu/mig/profile.go:29-47, util.go:36-66).  The JAX
  package's slices are TPU sub-meshes; here a slice is a MIG instance.
  A profile with media extensions ends in ``+me`` ("1g.10gb+me": the
  instance also holds the card's video decoders, JPEG and OFA engines).
  ``+`` is legal in neither a resource name nor an annotation key, so
  NVIDIA's device plugin publishes such a profile with ``.`` in its
  place (``nvidia.com/mig-1g.10gb.me``); ``profile_key`` and
  ``profile_from_key`` are the one mapping between the two spellings.
- **Timeshare profiles** are memory shares of one card under MPS-style
  time sharing, named ``<N>gb``; extended resource ``nvidia.com/gpu-24gb``
  (reference pkg/gpu/slicing/profile.go:29-64).

A third spelling belongs to the slice family: a **block profile**
``<N>x<G>``, N whole nodes of G GPUs each in one NVLink domain (N >= 2),
extended resource ``nos.nebuly.com/nvlink-block-2x8``.  It is the JAX
package's multi-host slice shape ("4x4" on v5e's 8-chip hosts is the
port's "2x8" on 8-GPU nodes): the partitioner carves it as whole-node
shards (``partitioning/slicepart/group.py``), each member node
advertising one unit, and a gang of one pod per node consumes it.  The
slice helpers below (``slice_resource_name``, ``profile_from_resource``,
``extract_slice_requests``) take both spellings; ``is_block_profile``
tells them apart.

Requests are plain ``{resource name: quantity}`` dicts.
"""

from __future__ import annotations

import re
from functools import lru_cache
from typing import Mapping

RESOURCE_SLICE_PREFIX = "nvidia.com/mig-"
RESOURCE_BLOCK_PREFIX = "nos.nebuly.com/nvlink-block-"
RESOURCE_TIMESHARE_PREFIX = "nvidia.com/gpu-"
MEDIA_SUFFIX = "+me"
_MEDIA_KEY_SUFFIX = ".me"
PROFILE_RE = re.compile(r"^(?P<g>\d+)g\.(?P<gb>\d+)gb(?P<me>\+me)?$")
SLICE_RESOURCE_RE = re.compile(
    rf"^{re.escape(RESOURCE_SLICE_PREFIX)}(?P<key>\d+g\.\d+gb(?:\.me)?)$")
TIMESHARE_RESOURCE_RE = re.compile(
    rf"^{re.escape(RESOURCE_TIMESHARE_PREFIX)}(?P<gb>\d+)gb$")
BLOCK_PROFILE_RE = re.compile(r"^(?P<n>\d+)x(?P<g>\d+)$")
BLOCK_RESOURCE_RE = re.compile(
    rf"^{re.escape(RESOURCE_BLOCK_PREFIX)}(?P<key>\d+x\d+)$")

# ---------------------------------------------------------------------------
# Slice (MIG) profiles
# ---------------------------------------------------------------------------


def is_media_profile(profile: str) -> bool:
    return profile.endswith(MEDIA_SUFFIX)


def profile_key(profile: str) -> str:
    """A profile as it stands in a resource name or an annotation key:
    "1g.10gb+me" -> "1g.10gb.me"; every other profile (MIG or MPS) as
    it is."""
    if is_media_profile(profile):
        return profile[:-len(MEDIA_SUFFIX)] + _MEDIA_KEY_SUFFIX
    return profile


def profile_from_key(key: str) -> str:
    """``profile_key``'s inverse: "1g.10gb.me" -> "1g.10gb+me"."""
    if key.endswith(_MEDIA_KEY_SUFFIX):
        return key[:-len(_MEDIA_KEY_SUFFIX)] + MEDIA_SUFFIX
    return key


@lru_cache(maxsize=4096)
def block_dims(profile: str) -> tuple[int, int] | None:
    """(nodes, GPUs per node) of a block profile "NxG" (N >= 2, G >= 1),
    or None for any other spelling."""
    m = BLOCK_PROFILE_RE.match(profile)
    if m is None:
        return None
    n, g = int(m.group("n")), int(m.group("g"))
    if n < 2 or g < 1:
        return None
    return n, g


def is_block_profile(profile: str) -> bool:
    return block_dims(profile) is not None


def block_gpus(profile: str) -> int:
    """Every GPU of the block, N x G (the JAX package's ``shape.chips``
    of a multi-host slice)."""
    n, g = block_dims(profile)
    return n * g


@lru_cache(maxsize=4096)
def slice_resource_name(profile: str) -> str:
    if PROFILE_RE.match(profile):
        return f"{RESOURCE_SLICE_PREFIX}{profile_key(profile)}"
    if is_block_profile(profile):
        return f"{RESOURCE_BLOCK_PREFIX}{profile}"
    raise ValueError(f"not a MIG or block profile: {profile!r}")


@lru_cache(maxsize=4096)
def profile_from_resource(resource: str) -> str | None:
    m = SLICE_RESOURCE_RE.match(resource)
    if m:
        return profile_from_key(m.group("key"))
    m = BLOCK_RESOURCE_RE.match(resource)
    if m and is_block_profile(m.group("key")):
        return m.group("key")
    return None


def is_slice_resource(resource: str) -> bool:
    return profile_from_resource(resource) is not None


def is_block_resource(resource: str) -> bool:
    profile = profile_from_resource(resource)
    return profile is not None and is_block_profile(profile)


def extract_slice_requests(request: Mapping[str, int]) -> dict[str, int]:
    out: dict[str, int] = {}
    for res, qty in request.items():
        profile = profile_from_resource(res)
        if profile is not None and qty > 0:
            out[profile] = out.get(profile, 0) + int(qty)
    return out


# ---------------------------------------------------------------------------
# Timeshare profiles
# ---------------------------------------------------------------------------


@lru_cache(maxsize=4096)
def timeshare_resource_name(gb: int) -> str:
    return f"{RESOURCE_TIMESHARE_PREFIX}{gb}gb"


@lru_cache(maxsize=4096)
def gb_from_resource(resource: str) -> int | None:
    m = TIMESHARE_RESOURCE_RE.match(resource)
    return int(m.group("gb")) if m else None


def is_timeshare_resource(resource: str) -> bool:
    return TIMESHARE_RESOURCE_RE.match(resource) is not None


def extract_timeshare_requests(request: Mapping[str, int]) -> dict[int, int]:
    out: dict[int, int] = {}
    for res, qty in request.items():
        gb = gb_from_resource(res)
        if gb is not None and qty > 0:
            out[gb] = out.get(gb, 0) + int(qty)
    return out


def profile_sort_key(profile: str) -> tuple[int, str]:
    """Smaller-profile-first ordering across both families (the pod
    sorter's tiebreak, reference internal/partitioning/core/util.go:34-71):
    by memory GB, which both families are sized in, then name."""
    m = PROFILE_RE.match(profile)
    if m:
        return (int(m.group("gb")), profile)
    if is_block_profile(profile):
        # a whole node's memory per member: after every MIG profile
        return (block_gpus(profile) * 1000, profile)
    m = re.match(r"^(\d+)gb$", profile)
    if m:
        return (int(m.group(1)), profile)
    return (10**9, profile)
