"""Mesh shapes, the part of ``nos_tpu/topology/shape.py`` the gang path
reads: a PodGroup's ``mesh`` ("4x8") parsed, and its device count.  On
the card a mesh axis counts GPUs, so ``chips`` is the GPUs the job's
mesh spans."""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class Shape:
    dims: tuple[int, ...]

    def __post_init__(self) -> None:
        if not self.dims or any(d < 1 for d in self.dims):
            raise ValueError(f"invalid shape dims {self.dims}")

    @staticmethod
    def parse(s: str) -> "Shape":
        try:
            dims = tuple(int(d) for d in s.lower().split("x"))
        except ValueError as e:
            raise ValueError(f"invalid shape {s!r}") from e
        return Shape(dims)

    @property
    def chips(self) -> int:
        return math.prod(self.dims)
