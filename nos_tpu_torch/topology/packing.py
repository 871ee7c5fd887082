"""Exact placement of MIG profiles on a GPU's memory slots,
``nos_tpu/topology/packing.py`` for the port.

The JAX package places TPU sub-meshes as cuboids in a host's chip block.
On a GPU, MIG places each GPU instance on a run of the card's memory
slots (8 on an H100): a profile of size s may start only at the slots
its table row allows, instances may not overlap, and the instances'
compute slices may sum to at most the card's 7.  A geometry is valid
exactly when such a placement exists, which is what the MIG manager's
create path searches for (the reference's NVML permutation search,
pkg/gpu/nvml/client.go:286-340).  The slots are few, so the exact
search is cheap; its results are memoised per model, as are the derived
geometry tables.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Iterable, Mapping

from .known import GpuModel


@dataclass(frozen=True)
class Placement:
    """One GPU instance on the memory slots [start, start + size)."""

    profile: str
    start: int
    size: int

    @property
    def mask(self) -> int:
        return ((1 << self.size) - 1) << self.start


def _counts_key(counts: Mapping[str, int]) -> tuple[tuple[str, int], ...]:
    return tuple(sorted((p, int(c)) for p, c in counts.items() if c > 0))


@lru_cache(maxsize=65536)
def _pack_cached(model: GpuModel, key: tuple[tuple[str, int], ...],
                 fixed: tuple[Placement, ...]) -> tuple[Placement, ...] | None:
    occupied = 0
    used_g = 0
    for pl in fixed:
        prof = model.profile(pl.profile)
        if prof is None or occupied & pl.mask:
            return None
        occupied |= pl.mask
        used_g += prof.compute_slices
    rows = []
    for name, count in key:
        prof = model.profile(name)
        if prof is None or count > prof.max_count:
            return None
        rows.extend([prof] * count)
    if used_g + sum(p.compute_slices for p in rows) > model.compute_slices:
        return None
    # largest first; equal profiles take increasing starts (no symmetric
    # re-search of the same set)
    rows.sort(key=lambda p: (-p.memory_slices, -p.compute_slices, p.name))
    full = (1 << model.memory_slices) - 1
    out: list[Placement] = []

    def rec(i: int, occ: int, min_start: int) -> bool:
        if i == len(rows):
            return True
        prof = rows[i]
        for start in prof.starts:
            if start < min_start:
                continue
            pl = Placement(prof.name, start, prof.memory_slices)
            if pl.mask & occ or pl.mask & ~full:
                continue
            out.append(pl)
            nxt = rows[i + 1] if i + 1 < len(rows) else None
            if rec(i + 1, occ | pl.mask,
                   start + 1 if nxt is prof else 0):
                return True
            out.pop()
        return False

    return tuple(out) if rec(0, occupied, 0) else None


def pack(model: GpuModel, counts: Mapping[str, int],
         fixed: Iterable[Placement] = ()) -> list[Placement] | None:
    """Place the multiset ``counts`` ({profile: count}) on ``model``'s
    memory slots around the ``fixed`` instances: no overlap, each at one
    of its profile's starts, compute slices (fixed ones included) within
    the card's.  Returns the new placements, or None if there is none
    (also for a profile the model's table lacks)."""
    res = _pack_cached(model, _counts_key(counts), tuple(fixed))
    return list(res) if res is not None else None


def feasible(model: GpuModel, counts: Mapping[str, int]) -> bool:
    return pack(model, counts) is not None


def extend(model: GpuModel, fixed: Iterable[Placement],
           counts: Mapping[str, int]) -> list[Placement] | None:
    """Pack ``counts`` around already-placed ``fixed`` instances (the
    actuator's create path: used devices must keep their placement, the
    delete-free-then-create plan of reference
    internal/controllers/migagent/plan/plan.go:31-92)."""
    return pack(model, counts, fixed)


@lru_cache(maxsize=None)
def enumerate_geometries(model: GpuModel) -> tuple[tuple[tuple[str, int], ...], ...]:
    """Every maximal valid geometry of ``model``: the profile multisets
    that can be placed and to which no further instance can be added
    (the derived allowed-geometry table, in place of the reference's
    hand-maintained known_configs.go:24-142)."""
    names = model.profile_names()
    valid: set[tuple[tuple[str, int], ...]] = set()

    def rec(i: int, counts: dict[str, int]) -> None:
        if i == len(names):
            if counts and feasible(model, counts):
                valid.add(_counts_key(counts))
            return
        name = names[i]
        for c in range(model.profile(name).max_count + 1):
            counts[name] = c
            if c and not feasible(model, counts):
                break
            rec(i + 1, counts)
        counts.pop(name, None)

    rec(0, {})

    def grown(g, name):
        d = dict(g)
        d[name] = d.get(name, 0) + 1
        return _counts_key(d)

    return tuple(sorted(g for g in valid
                        if not any(grown(g, n) in valid for n in names)))
