"""TimeshareUnit: one GPU's memory carved into MPS shares,
``nos_tpu/topology/timeshare_unit.py`` for the port (reference
pkg/gpu/slicing/gpu.go:27-265).

A share is ``<N>gb`` of the card's memory (``nvidia.com/gpu-<N>gb``);
the card's memory is its ``GpuModel.memory_gb`` (80 on an H100 80GB).
``update_geometry_for`` creates requested shares from spare memory,
sacrificing existing *free* shares when it must and restoring what
still fits afterwards (reference gpu.go:162-265).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping

from .geometry import Geometry


@dataclass
class TimeshareUnit:
    memory_gb: int
    index: int = 0                      # GPU index on the node
    used: dict[int, int] = field(default_factory=dict)   # gb -> count
    free: dict[int, int] = field(default_factory=dict)

    def __deepcopy__(self, memo):
        # hot on planner forks; every key and value is an int
        return TimeshareUnit(memory_gb=self.memory_gb, index=self.index,
                             used=dict(self.used), free=dict(self.free))

    def _gb(self, table: Mapping[int, int]) -> int:
        return sum(gb * c for gb, c in table.items())

    @property
    def used_gb(self) -> int:
        return self._gb(self.used)

    @property
    def spare_gb(self) -> int:
        return self.memory_gb - self.used_gb - self._gb(self.free)

    def geometry_names(self) -> Geometry:
        geo: dict[str, int] = {}
        for src in (self.used, self.free):
            for gb, c in src.items():
                if c > 0:
                    geo[f"{gb}gb"] = geo.get(f"{gb}gb", 0) + c
        return geo

    def used_names(self) -> Geometry:
        return {f"{gb}gb": c for gb, c in self.used.items() if c > 0}

    def free_names(self) -> Geometry:
        return {f"{gb}gb": c for gb, c in self.free.items() if c > 0}

    def can_apply_geometry(self, geometry: Mapping[int, int]) -> bool:
        if self._gb(geometry) > self.memory_gb:
            return False
        return all(geometry.get(gb, 0) >= c for gb, c in self.used.items() if c > 0)

    def apply_geometry(self, geometry: Mapping[int, int]) -> None:
        if not self.can_apply_geometry(geometry):
            raise ValueError(
                f"timeshare geometry {dict(geometry)} not applicable "
                f"(memory={self.memory_gb}gb, used={self.used})"
            )
        self.free = {
            gb: geometry.get(gb, 0) - self.used.get(gb, 0)
            for gb in set(geometry) | set(self.used)
        }
        self.free = {gb: c for gb, c in self.free.items() if c > 0}

    def update_geometry_for(self, lacking: Mapping[int, int]) -> bool:
        """Provide as many lacking shares as possible: create from spare
        memory first; if spare is short, sacrifice free shares (largest
        first) and restore whatever still fits.  A carve is accepted only
        if it satisfies no fewer lacking shares than before, or
        reconciles could oscillate between two partial carves."""

        def satisfaction(free: Mapping[int, int]) -> int:
            return sum(min(free.get(gb, 0), n) for gb, n in lacking.items())

        before_free = dict(self.free)
        created: dict[int, int] = {}
        sacrificable = dict(self.free)
        spare = self.spare_gb
        changed = False
        for gb, want in sorted(lacking.items()):
            need = max(0, want - self.free.get(gb, 0))
            for _ in range(need):
                if spare < gb:
                    for fgb in sorted(sacrificable, reverse=True):
                        while spare < gb and sacrificable.get(fgb, 0) > 0:
                            sacrificable[fgb] -= 1
                            spare += fgb
                if spare < gb:
                    break
                spare -= gb
                created[gb] = created.get(gb, 0) + 1
                changed = True
        if not changed:
            return False
        # restore sacrificed memory into its original share sizes where
        # spare memory still allows, largest first
        new_free: dict[int, int] = {gb: c for gb, c in sacrificable.items() if c > 0}
        for gb, c in created.items():
            new_free[gb] = new_free.get(gb, 0) + c
        restored_spare = self.memory_gb - self.used_gb - self._gb(new_free)
        for fgb in sorted(self.free, reverse=True):
            lost = self.free.get(fgb, 0) - sacrificable.get(fgb, 0)
            while lost > 0 and restored_spare >= fgb:
                new_free[fgb] = new_free.get(fgb, 0) + 1
                restored_spare -= fgb
                lost -= 1
        if satisfaction(new_free) < satisfaction(before_free):
            return False
        self.free = new_free
        return True

    def allocate(self, gb: int) -> bool:
        if self.free.get(gb, 0) <= 0:
            return False
        self.free[gb] -= 1
        self.used[gb] = self.used.get(gb, 0) + 1
        return True

    def release(self, gb: int) -> bool:
        if self.used.get(gb, 0) <= 0:
            return False
        self.used[gb] -= 1
        self.free[gb] = self.free.get(gb, 0) + 1
        return True
