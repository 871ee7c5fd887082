"""Known GPU models and their MIG profile tables, ``nos_tpu/topology/known.py``
for the port.

The JAX package derives each TPU generation's geometry table from its
host chip block.  A GPU's partitions are fixed by the hardware instead:
MIG carves the card into ``compute_slices`` compute slices and
``memory_slices`` memory slots, and each GPU instance profile may start
only at the slots NVIDIA allows (the NVIDIA MIG User Guide's table per
card, which is the reference's hand-kept table,
pkg/gpu/mig/known_configs.go:24-142).  The valid geometries are derived
from the profile table by the exact packer (``topology.packing``) and
cached.  An operator can restrict the table, or add a card, from JSON
(``GpuModelRegistry.load_overrides``, the SetKnownGeometries analog,
known_configs.go:144-150).
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class MigProfile:
    """One GPU instance profile of a card's MIG table."""

    name: str                 # "1g.10gb"
    compute_slices: int       # g
    memory_slices: int        # memory slots it spans: its placement's size
    memory_gb: int
    max_count: int            # the most instances of it on one card
    starts: tuple[int, ...]   # memory slots where an instance may start
    nvml_id: int              # NVML_GPU_INSTANCE_PROFILE_* of this profile


@dataclass(frozen=True, eq=False)
class GpuModel:
    """One GPU model's partitioning parameters.

    eq=False: models are compared (and hashed) by IDENTITY, as the JAX
    package's ``Generation`` is: every consumer holds the registry's
    instance, ``load_overrides`` installs a NEW object (so caches keyed
    on the model see the change), and the derived-geometry cache keys on
    it without re-hashing the profile table per lookup."""

    name: str                           # accelerator label value
    product_patterns: tuple[str, ...]   # regexes over NVML's product name
    memory_gb: int
    sm_count: int
    compute_slices: int = 7
    memory_slices: int = 8
    mig_profiles: tuple[MigProfile, ...] = ()

    def profile(self, name: str) -> MigProfile | None:
        for p in self.mig_profiles:
            if p.name == name:
                return p
        return None

    def profile_names(self) -> list[str]:
        return [p.name for p in self.mig_profiles]

    def matches(self, product_name: str) -> bool:
        return any(re.search(pat, product_name, re.IGNORECASE)
                   for pat in self.product_patterns)


def _profiles(*rows) -> tuple[MigProfile, ...]:
    return tuple(MigProfile(name, g, size, gb, count, tuple(starts), nvml)
                 for name, g, size, gb, count, starts, nvml in rows)


# The H100 80GB (SXM5, HBM3) table from the NVIDIA MIG User Guide: name,
# compute slices, memory slots (the placement's size), GB, the most
# instances, the allowed start slots, NVML's profile id.  The "+me"
# media-extension profiles are left out.
H100_80GB = GpuModel(
    name="nvidia-h100-80gb-hbm3",
    product_patterns=(r"\bH100\b.*\b80\s*GB\b.*\bHBM3\b",),
    memory_gb=80,
    sm_count=132,
    compute_slices=7,
    memory_slices=8,
    mig_profiles=_profiles(
        ("1g.10gb", 1, 1, 10, 7, range(7), 0),
        ("1g.20gb", 1, 2, 20, 4, (0, 2, 4, 6), 9),
        ("2g.20gb", 2, 2, 20, 3, (0, 2, 4), 1),
        ("3g.40gb", 3, 4, 40, 2, (0, 4), 2),
        ("4g.40gb", 4, 4, 40, 1, (0,), 3),
        ("7g.80gb", 7, 8, 80, 1, (0,), 4),
    ),
)

MODELS: dict[str, GpuModel] = {m.name: m for m in (H100_80GB,)}


def _profile_from_json(spec: dict) -> MigProfile:
    return MigProfile(
        name=spec["name"], compute_slices=int(spec["compute_slices"]),
        memory_slices=int(spec["memory_slices"]),
        memory_gb=int(spec["memory_gb"]), max_count=int(spec["max_count"]),
        starts=tuple(int(s) for s in spec["starts"]),
        nvml_id=int(spec["nvml_id"]))


@dataclass
class GpuModelRegistry:
    """Mutable registry consulted by discovery and the planner; supports
    operator overrides from JSON (the SetKnownGeometries analog)."""

    models: dict[str, GpuModel] = field(default_factory=lambda: dict(MODELS))

    def get(self, accelerator: str) -> GpuModel:
        try:
            return self.models[accelerator]
        except KeyError:
            raise KeyError(f"unknown accelerator {accelerator!r}; "
                           f"known: {sorted(self.models)}") from None

    def match(self, product_name: str) -> GpuModel | None:
        """The model whose product-name patterns match what NVML or CUDA
        reports for a card, or None."""
        for model in self.models.values():
            if model.matches(product_name):
                return model
        return None

    def load_overrides(self, path: str) -> None:
        """JSON, one object per model name.  For a known model,
        ``mig_profiles`` lists the profile names to keep: restricting the
        table restricts the derived geometries.  A new card (H100 NVL,
        H200, A100) gives every field, its profile rows as objects:

            {"nvidia-h100-80gb-hbm3": {"mig_profiles": ["1g.10gb", "7g.80gb"]},
             "nvidia-a100-80gb": {"product_patterns": ["A100.*80GB"],
                                  "memory_gb": 80, "sm_count": 108,
                                  "mig_profiles": [{"name": "1g.10gb", ...}]}}
        """
        with open(path) as f:
            data = json.load(f)
        for name, spec in data.items():
            if name in self.models:
                base = self.models[name]
                keep = spec["mig_profiles"]
                unknown = set(keep) - set(base.profile_names())
                if unknown:
                    raise ValueError(f"{name}: unknown MIG profiles "
                                     f"{sorted(unknown)}")
                self.models[name] = replace(base, mig_profiles=tuple(
                    p for p in base.mig_profiles if p.name in keep))
            else:
                self.models[name] = GpuModel(
                    name=name,
                    product_patterns=tuple(spec["product_patterns"]),
                    memory_gb=int(spec["memory_gb"]),
                    sm_count=int(spec["sm_count"]),
                    compute_slices=int(spec.get("compute_slices", 7)),
                    memory_slices=int(spec.get("memory_slices", 8)),
                    mig_profiles=tuple(_profile_from_json(r)
                                       for r in spec["mig_profiles"]))


DEFAULT_REGISTRY = GpuModelRegistry()
