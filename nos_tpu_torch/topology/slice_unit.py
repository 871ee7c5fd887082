"""SliceUnit: one GPU's MIG geometry, ``nos_tpu/topology/slice_unit.py``
for the port (reference pkg/gpu/mig/gpu.go:27-259, ``mig.GPU``).

It keeps the GPU's used and free MIG instances per profile and answers
``can_apply_geometry`` / ``apply_geometry`` / ``init_geometry`` /
``update_geometry_for``.  The JAX unit checks a geometry against the
exact tilings of a TPU host block; here a geometry is valid when it is
one of the card's maximal geometries, which the exact packer derives
from the model's MIG table (``packing.enumerate_geometries``: placements
on 8 memory slots, at most 7 compute slices).  So 1g.10gb x 7 is valid
although it leaves a memory slot empty.

A GPU may instead be a shard of an NVLink block (``is_block_shard``): the
whole card belongs to a block "NxG" spanning N nodes, the JAX unit's
multi-host membership.  Only the partitioner's group pass makes or
breaks a shard (``make_member_of``, ``reset_virgin``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import Mapping

from .errors import InvalidGeometryError
from .geometry import Geometry, fewest_slices_geometry
from .known import GpuModel
from .packing import Placement, enumerate_geometries, extend
from .profile import is_block_profile, is_media_profile


@lru_cache(maxsize=None)
def _geometry_keys(model: GpuModel) -> frozenset:
    return frozenset(enumerate_geometries(model))


@lru_cache(maxsize=None)
def _media_profiles(model: GpuModel) -> frozenset:
    return frozenset(p.name for p in model.mig_profiles
                     if is_media_profile(p.name))


def _canon(geometry: Mapping[str, int]) -> dict[str, int]:
    return {p: c for p, c in geometry.items() if c > 0}


@dataclass
class SliceUnit:
    model: GpuModel
    index: int = 0                       # the GPU's index on its node
    used: dict[str, int] = field(default_factory=dict)   # profile -> count
    free: dict[str, int] = field(default_factory=dict)
    # Observed instance placements (the agent's placements annotation).
    # Used placements are pins: new instances must be placed around them
    # (packing.extend), so a geometry whose counts are valid can still be
    # impossible to carve.  Empty lists: no placement data, and every
    # check is on counts alone.
    placed_used: list[Placement] = field(default_factory=list)
    placed_free: list[Placement] = field(default_factory=list)

    def __deepcopy__(self, memo):
        # planner forks clone every unit: the model and the placements
        # are frozen and shared, only the tables and lists are copied
        return SliceUnit(model=self.model, index=self.index,
                         used=dict(self.used), free=dict(self.free),
                         placed_used=list(self.placed_used),
                         placed_free=list(self.placed_free))

    # -- placement data ----------------------------------------------------
    def has_placement_data(self) -> bool:
        """Pins are trusted only when the used placements agree with the
        used counts (they drift for one report interval after a bound
        pod's usage is claimed by the snapshot)."""
        if not self.placed_used and not any(c > 0 for c in self.used.values()):
            return False
        counts: dict[str, int] = {}
        for pl in self.placed_used:
            counts[pl.profile] = counts.get(pl.profile, 0) + 1
        return counts == _canon(self.used)

    def drop_placement_data(self) -> None:
        self.placed_used = []
        self.placed_free = []

    # -- views -------------------------------------------------------------
    def allowed_geometries(self) -> list[dict[str, int]]:
        """The card's maximal geometries, in ``enumerate_geometries``'
        fixed (sorted) order: the re-carve's tie-break sees them so."""
        return [dict(g) for g in enumerate_geometries(self.model)]

    def geometry_names(self) -> Geometry:
        geo: dict[str, int] = {}
        for src in (self.used, self.free):
            for p, c in src.items():
                if c > 0:
                    geo[p] = geo.get(p, 0) + c
        return geo

    def used_names(self) -> Geometry:
        return _canon(self.used)

    def free_names(self) -> Geometry:
        return _canon(self.free)

    # -- geometry transitions ----------------------------------------------
    def can_apply_geometry(self, geometry: Mapping[str, int]) -> bool:
        """The geometry must be one of the card's maximal geometries and
        keep every used instance (reference mig/gpu.go CanApplyGeometry);
        with placements known, the instances beyond the used ones must
        be placeable around the pinned used placements (the agent
        deletes and re-creates only free instances)."""
        geometry = _canon(geometry)
        if tuple(sorted(geometry.items())) not in _geometry_keys(self.model):
            return False
        if not all(geometry.get(p, 0) >= c
                   for p, c in self.used.items() if c > 0):
            return False
        if self.has_placement_data() and self.placed_used:
            creates = {p: geometry.get(p, 0) - self.used.get(p, 0)
                       for p in geometry}
            return extend(self.model, self.placed_used, creates) is not None
        return True

    def apply_geometry(self, geometry: Mapping[str, int]) -> None:
        geometry = _canon(geometry)
        if not self.can_apply_geometry(geometry):
            raise InvalidGeometryError(
                f"geometry {geometry} not applicable to GPU {self.index} "
                f"(used={self.used_names()})")
        had_data = self.has_placement_data()
        # sorted: the tables' order reaches the allocatable, and must not
        # hang on string hashing
        self.free = _canon({p: geometry.get(p, 0) - self.used.get(p, 0)
                            for p in sorted(set(geometry) | set(self.used))})
        if had_data:
            # what the agent will do: free instances placed around the
            # pinned used ones (can_apply guaranteed a placement)
            placed = extend(self.model, self.placed_used, self.free)
            if placed is None:
                self.drop_placement_data()
            else:
                self.placed_free = placed

    def init_geometry(self) -> None:
        """A virgin GPU gets the fewest-slices geometry, 7g.80gb on an
        H100 (reference mig/gpu.go InitGeometry)."""
        self.apply_geometry(fewest_slices_geometry(self.allowed_geometries()))

    def update_geometry_for(self, lacking: Mapping[str, int]) -> bool:
        """Re-carve the free capacity to provide as many lacking
        instances as possible; keep the current geometry unless a
        candidate does strictly better (reference mig/gpu.go:158-212:
        score every allowed geometry against the lacking profiles, ties
        to fewer devices).

        Memoised for units without pins: a candidate's score depends on
        a lacking count only up to what one card can hold of the
        profile (its ``max_count``), so counts are clamped before
        keying, and a fleet plan asking many virgin cards for the same
        profiles resolves the search once."""
        relevant: dict[str, int] = {}
        for p, n in lacking.items():
            prof = self.model.profile(p)
            if n > 0 and prof is not None and prof.max_count > 0:
                relevant[p] = min(n, prof.max_count)
        if not relevant:
            # every candidate scores 0: nothing can strictly improve
            return False
        if self.placed_used or self.placed_free:
            best = self._search_recarve(relevant)
        else:
            cached = _best_recarve(
                self.model,
                frozenset(_canon(self.used).items()),
                frozenset(_canon(self.free).items()),
                frozenset(relevant.items()))
            best = dict(cached) if cached is not None else None
        if best is None:
            return False
        self.apply_geometry(best)
        return True

    def _search_recarve(self,
                        lacking: Mapping[str, int]) -> dict[str, int] | None:
        """Score every allowed geometry; None keeps the current one.  A
        geometry holding a media-extension profile ("+me") that no
        lacking pod asks for and no pod uses here is skipped: such a
        profile is carved only for a pod that asks for it."""

        def score(free: Mapping[str, int]) -> int:
            return sum(min(free.get(p, 0), n) for p, n in lacking.items())

        unasked = _media_profiles(self.model) - set(lacking) - {
            p for p, c in self.used.items() if c > 0}
        best_geo: dict[str, int] | None = None
        best = score(self.free)
        for geo in self.allowed_geometries():
            if unasked.intersection(geo) or not self.can_apply_geometry(geo):
                continue
            sc = score({p: geo[p] - self.used.get(p, 0) for p in geo})
            if sc > best or (sc == best and best_geo is not None
                             and sum(geo.values()) < sum(best_geo.values())):
                best, best_geo = sc, geo
        return best_geo

    # -- NVLink block membership -------------------------------------------
    def is_block_shard(self) -> bool:
        """The GPU is (part of) a block spanning nodes."""
        for src in (self.used, self.free):
            for p, c in src.items():
                if c > 0 and is_block_profile(p):
                    return True
        return False

    def make_member_of(self, profile: str) -> None:
        """Dedicate the whole GPU as one shard of a block: it advertises
        the block's profile, quantity 1.  Only on a GPU with no used
        instance."""
        if any(c > 0 for c in self.used.values()):
            raise InvalidGeometryError(
                f"GPU {self.index} has used instances; cannot join "
                f"block {profile}")
        self.free = {profile: 1}
        self.drop_placement_data()

    def reset_virgin(self) -> None:
        """Back to the fewest-slices geometry (breaking up a free
        shard)."""
        if any(c > 0 for c in self.used.values()):
            raise InvalidGeometryError(
                f"GPU {self.index} has used instances; cannot reset")
        self.used = {}
        self.free = {}
        self.drop_placement_data()
        self.init_geometry()

    # -- allocation --------------------------------------------------------
    def allocate(self, profile: str) -> bool:
        """Move one free instance to used (reference mig/gpu.go AddPod)."""
        if self.free.get(profile, 0) <= 0:
            return False
        self.free[profile] -= 1
        self.used[profile] = self.used.get(profile, 0) + 1
        self._move_placement(profile, self.placed_free, self.placed_used)
        return True

    def release(self, profile: str) -> bool:
        if self.used.get(profile, 0) <= 0:
            return False
        self.used[profile] -= 1
        self.free[profile] = self.free.get(profile, 0) + 1
        self._move_placement(profile, self.placed_used, self.placed_free)
        return True

    def _move_placement(self, profile: str, src: list[Placement],
                        dst: list[Placement]) -> None:
        """Keep the placements in step with an allocate or release: move
        a placement of that profile (which device admission picks is as
        arbitrary); if none is there, drop the data and fall back to
        counts rather than reason from wrong pins.  Scans from the end,
        so a release right after an allocate (``add_pod``'s rollback)
        undoes exactly the staged move."""
        if not src and not dst:
            return
        for i in range(len(src) - 1, -1, -1):
            if src[i].profile == profile:
                dst.append(src.pop(i))
                return
        self.drop_placement_data()


@lru_cache(maxsize=8192)
def _best_recarve(model: GpuModel, used_key: frozenset, free_key: frozenset,
                  lacking_key: frozenset) -> tuple | None:
    """The re-carve search without pins, memoised: its outcome is a pure
    function of the model, the used and free counts and the clamped
    lacking counts.  Returns the chosen geometry as sorted items, or
    None to keep the current one."""
    probe = SliceUnit(model=model, used=dict(used_key), free=dict(free_key))
    best = probe._search_recarve(dict(lacking_key))
    return None if best is None else tuple(sorted(best.items()))
