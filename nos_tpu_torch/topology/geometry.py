"""Geometry: a multiset of profiles carved from one partition root,
``nos_tpu/topology/geometry.py`` for the port.

Analog of reference pkg/gpu/partitioning.go:28-79 (`gpu.Geometry`,
`GetFewestSlicesGeometry`).  A Geometry is a plain dict profile-name ->
count ("1g.10gb" -> 2, or "24gb" -> 3); helpers are pure functions.
"""

from __future__ import annotations

from typing import Iterable, Mapping

Geometry = dict[str, int]


def geometry_equal(a: Mapping[str, int], b: Mapping[str, int]) -> bool:
    return {k: v for k, v in a.items() if v} == {k: v for k, v in b.items() if v}


def num_slices(g: Mapping[str, int]) -> int:
    return sum(v for v in g.values() if v > 0)


def fewest_slices_geometry(geometries: Iterable[Mapping[str, int]]) -> Geometry | None:
    """The coarsest geometry (fewest devices) — used for virgin-node init
    (reference partitioning.go:64-79, mig/gpu.go InitGeometry)."""
    best: Geometry | None = None
    for g in geometries:
        if best is None or num_slices(g) < num_slices(best):
            best = dict(g)
    return best
