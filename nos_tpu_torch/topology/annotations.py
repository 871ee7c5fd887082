"""Spec and status node-annotation codec, ``nos_tpu/topology/annotations.py``
for the port.

The planner writes *desired* partitioning as
``nos.nebuly.com/spec-gpu-<index>-<profile>=<qty>`` node annotations plus
a plan id; the node side reports *observed* state as
``nos.nebuly.com/status-gpu-<index>-<profile>-<free|used>=<qty>`` plus the
last applied plan id (reference pkg/gpu/annotation.go:29-224,
pkg/api/nos.nebuly.com/v1alpha1/annotations.go:21-58).  ``<profile>`` is
a MIG profile ("1g.10gb", the MIG family) or a memory share ("24gb", the
MPS family); both families share the codec.  A key spells a profile as
``profile.profile_key`` does ("1g.10gb+me" as "1g.10gb.me").
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Mapping

from nos_tpu_torch.api import constants as C

from .packing import Placement
from .profile import (
    PROFILE_RE, is_block_profile, profile_from_key, profile_key,
)


@dataclass(frozen=True)
class SpecAnnotation:
    index: int
    profile: str
    quantity: int

    @property
    def key(self) -> str:
        return f"{C.ANNOT_SPEC_PREFIX}{self.index}-{profile_key(self.profile)}"


@dataclass(frozen=True)
class StatusAnnotation:
    index: int
    profile: str
    status: str            # "free" | "used"
    quantity: int

    @property
    def key(self) -> str:
        return (f"{C.ANNOT_STATUS_PREFIX}{self.index}-"
                f"{profile_key(self.profile)}-{self.status}")


def _parse_qty(v: str) -> int | None:
    """Annotations come from the API server and may be corrupt; an
    unparseable quantity is skipped, not raised."""
    try:
        return int(v)
    except (TypeError, ValueError):
        return None


def parse_spec_annotations(annotations: Mapping[str, str]) -> list[SpecAnnotation]:
    out = []
    for k, v in annotations.items():
        m = C.SPEC_ANNOT_RE.match(k)
        qty = _parse_qty(v) if m else None
        if m and qty is not None:
            out.append(SpecAnnotation(int(m.group("index")),
                                      profile_from_key(m.group("profile")),
                                      qty))
    return sorted(out, key=lambda a: (a.index, a.profile))


def parse_status_annotations(annotations: Mapping[str, str]) -> list[StatusAnnotation]:
    out = []
    for k, v in annotations.items():
        m = C.STATUS_ANNOT_RE.match(k)
        qty = _parse_qty(v) if m else None
        if m and qty is not None:
            out.append(StatusAnnotation(
                int(m.group("index")), profile_from_key(m.group("profile")),
                m.group("status"), qty))
    return sorted(out, key=lambda a: (a.index, a.profile, a.status))


def spec_from_geometries(geometries: Mapping[int, Mapping[str, int]]) -> dict[str, str]:
    """index -> (profile -> qty)  ==>  annotation map."""
    out: dict[str, str] = {}
    for idx, geo in geometries.items():
        for profile, qty in geo.items():
            if qty > 0:
                out[SpecAnnotation(idx, profile, qty).key] = str(qty)
    return out


def status_from_units(units: Iterable) -> dict[str, str]:
    """Render used/free annotations from units (``TimeshareUnit``)."""
    out: dict[str, str] = {}
    for u in units:
        for profile, qty in u.used_names().items():
            out[StatusAnnotation(u.index, profile, "used", qty).key] = str(qty)
        for profile, qty in u.free_names().items():
            out[StatusAnnotation(u.index, profile, "free", qty).key] = str(qty)
    return out


def encode_placement_records(records: Iterable[tuple[str, Placement]]) -> str:
    """Render (status, placement) pairs as the placements annotation
    value, ``<u|f>|<profile>|<start>|<size>`` joined by ";".  ``status``
    is "u" (used) or "f" (free)."""
    parts = ["|".join((status, pl.profile, str(pl.start), str(pl.size)))
             for status, pl in records]
    return ";".join(sorted(parts))


def parse_placement_annotations(
    annotations: Mapping[str, str],
) -> dict[int, list[tuple[str, Placement]]]:
    """GPU index -> [(status, Placement)].  A corrupt record is skipped
    (annotations come from the API server), not raised; so is one whose
    placement runs past the card's memory slots (8 on every card the
    MIG table lists)."""
    out: dict[int, list[tuple[str, Placement]]] = {}
    for k, v in annotations.items():
        m = C.PLACEMENT_ANNOT_RE.match(k)
        if not m:
            continue
        records = out.setdefault(int(m.group("index")), [])
        for part in v.split(";"):
            if not part:
                continue
            try:
                status, profile, start_s, size_s = part.split("|")
                start, size = int(start_s), int(size_s)
            except ValueError:
                continue
            if status not in ("u", "f") or not PROFILE_RE.match(profile) \
                    or start < 0 or size < 1 or start + size > 8:
                continue
            records.append((status, Placement(profile, start, size)))
    return out


def profile_family(profile: str) -> str:
    """"mig" for a MIG profile ("3g.40gb") and an NVLink block ("2x8",
    carved over MIG-family nodes), "mps" for a memory share."""
    return C.MIG_KIND if PROFILE_RE.match(profile) \
        or is_block_profile(profile) else C.MPS_KIND


def spec_matches_status(annotations: Mapping[str, str],
                        family: str | None = None) -> bool:
    """Desired == observed, per index and profile (reference
    pkg/gpu/mig/annotation.go:24).  ``family`` restricts the comparison
    to one profile family, so a hybrid node's other family cannot defeat
    the convergence check."""
    def keep(profile: str) -> bool:
        return family is None or profile_family(profile) == family

    spec: dict[tuple[int, str], int] = {}
    for a in parse_spec_annotations(annotations):
        if keep(a.profile):
            spec[(a.index, a.profile)] = \
                spec.get((a.index, a.profile), 0) + a.quantity
    status: dict[tuple[int, str], int] = {}
    for a in parse_status_annotations(annotations):
        if keep(a.profile):
            key = (a.index, a.profile)
            status[key] = status.get(key, 0) + a.quantity
    return ({k: v for k, v in spec.items() if v > 0}
            == {k: v for k, v in status.items() if v > 0})


def strip_spec_annotations(annotations: dict[str, str],
                           family: str | None = None) -> None:
    """Remove spec annotations; ``family`` restricts to one family."""
    for k in list(annotations):
        m = C.SPEC_ANNOT_RE.match(k)
        if m and (family is None
                  or profile_family(profile_from_key(m.group("profile")))
                  == family):
            del annotations[k]


def strip_status_annotations(annotations: dict[str, str],
                             family: str | None = None) -> None:
    for k in list(annotations):
        m = C.STATUS_ANNOT_RE.match(k)
        if m and (family is None
                  or profile_family(profile_from_key(m.group("profile")))
                  == family):
            del annotations[k]
        elif family in (None, C.MIG_KIND) and C.PLACEMENT_ANNOT_RE.match(k):
            # placement records describe MIG devices only
            del annotations[k]


def spec_plan_id(annotations: Mapping[str, str],
                 family: str = C.MIG_KIND) -> str:
    return annotations.get(C.spec_plan_annotation(family), "")


def status_plan_id(annotations: Mapping[str, str],
                   family: str = C.MIG_KIND) -> str:
    return annotations.get(C.status_plan_annotation(family), "")
