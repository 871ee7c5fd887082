"""Profiles: the schedulable sub-resources carved from a GPU,
``nos_tpu/topology/profile.py`` for the port.

Two families, the reference ``nos``'s own resource names:

- **Slice profiles** are MIG GPU instances, named ``<g>g.<N>gb``
  ("3g.40gb"); extended resource ``nvidia.com/mig-3g.40gb``
  (reference pkg/gpu/mig/profile.go:29-47, util.go:36-66).  The JAX
  package's slices are TPU sub-meshes; here a slice is a MIG instance.
- **Timeshare profiles** are memory shares of one card under MPS-style
  time sharing, named ``<N>gb``; extended resource ``nvidia.com/gpu-24gb``
  (reference pkg/gpu/slicing/profile.go:29-64).

Requests are plain ``{resource name: quantity}`` dicts.
"""

from __future__ import annotations

import re
from functools import lru_cache
from typing import Mapping

RESOURCE_SLICE_PREFIX = "nvidia.com/mig-"
RESOURCE_TIMESHARE_PREFIX = "nvidia.com/gpu-"
PROFILE_RE = re.compile(r"^(?P<g>\d+)g\.(?P<gb>\d+)gb$")
SLICE_RESOURCE_RE = re.compile(
    rf"^{re.escape(RESOURCE_SLICE_PREFIX)}(?P<profile>\d+g\.\d+gb)$")
TIMESHARE_RESOURCE_RE = re.compile(
    rf"^{re.escape(RESOURCE_TIMESHARE_PREFIX)}(?P<gb>\d+)gb$")

# ---------------------------------------------------------------------------
# Slice (MIG) profiles
# ---------------------------------------------------------------------------


@lru_cache(maxsize=4096)
def slice_resource_name(profile: str) -> str:
    if not PROFILE_RE.match(profile):
        raise ValueError(f"not a MIG profile: {profile!r}")
    return f"{RESOURCE_SLICE_PREFIX}{profile}"


@lru_cache(maxsize=4096)
def profile_from_resource(resource: str) -> str | None:
    m = SLICE_RESOURCE_RE.match(resource)
    return m.group("profile") if m else None


def is_slice_resource(resource: str) -> bool:
    return SLICE_RESOURCE_RE.match(resource) is not None


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
    m = re.match(r"^(\d+)gb$", profile)
    if m:
        return (int(m.group(1)), profile)
    return (10**9, profile)
