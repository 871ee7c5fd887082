"""The port's MIG strategy (nos_tpu_torch/topology/slice_unit.py,
partitioning/slicepart/, the in-flux guard of scheduler/framework.py)
against the JAX package's slice strategy where an exact oracle exists,
and against an independent oracle where none does.

**The stand-in.**  The JAX package plans TPU cuboids in a host block; a
MIG geometry is a maximal set of placements on a GPU's 8 memory slots.
Under one restriction the two domains are the same: the JAX v5e
generation restricted to {2x4, 2x2} (``TopologyRegistry.load_overrides``)
and the H100 80GB restricted to {7g.80gb, 3g.40gb}
(``GpuModelRegistry.load_overrides``).  In each the valid geometries are
{whole: 1} and {half: 2}, and the placements match one to one: 2x4 at
(0, 0) ↔ 7g.80gb at slot 0, 2x2 at (0, 0) or (0, 2) ↔ 3g.40gb at slot 0
or 4.  One JAX host block stands for one GPU; a JAX node with a status
annotation per GPU index has a unit per GPU, so multi-GPU nodes are
compared with every GPU reporting.  On the stand-in every unit decision,
every planner decision and every write must equal JAX's, names mapped
and plan ids masked.

The candidate order is the one thing the port weighs differently: a MIG
instance counts g/7 of a GPU, a 3g.40gb 3/7, where JAX counts a 2x2 as
half its host's chips.  ``TestCandidateOrder`` pins that difference
against JAX's order.  The planner comparisons hold the port against the
JAX package as it is wherever the two weightings visit the nodes in one
order; only a cluster where they do not (``ORDERS_DIFFER``) gives the
JAX snapshot the port's weighting (``jax_orders_as_the_port``), so that
it holds every other decision exactly.

**The full H100 table** has no JAX counterpart.  Its oracle is written
here from the NVIDIA MIG User Guide and imports nothing of the port's
``topology/``: a brute force over start slots (memory bitmasks, at most
7 compute slices) gives the maximal geometries, and a direct rewrite of
the reference's scoring rule (mig/gpu.go ``UpdateGeometryFor``: score
every applicable geometry by the lacking profiles it provides, ties to
fewer devices) gives the re-carve.  Random inputs come from numpy
generators seeded per case.
"""

from __future__ import annotations

import json
import tempfile

import numpy as np
import pytest

import nos_tpu.api.constants as JC
import nos_tpu.partitioning.core as jax_core
import nos_tpu.partitioning.slicepart as jax_sp
import nos_tpu.partitioning.slicepart.node as jax_sp_node
import nos_tpu.partitioning.state as jax_state
import nos_tpu.scheduler.framework as jax_fw
import nos_tpu.topology.annotations as jax_annotations
from nos_tpu.kube.client import APIServer as JaxAPIServer
from nos_tpu.obs import trace as jax_trace
from nos_tpu.testing import factory as jax_factory
from nos_tpu.topology import Shape
from nos_tpu.topology.known import TopologyRegistry
from nos_tpu.topology.packing import Placement as JaxPlacement
from nos_tpu.topology.errors import (
    InvalidGeometryError as JaxInvalidGeometryError)
from nos_tpu.topology.profile import shape_from_resource
from nos_tpu.topology.slice_unit import SliceUnit as JaxSliceUnit

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.kube.client import APIServer, KIND_NODE
from nos_tpu_torch.obs import trace
from nos_tpu_torch.partitioning import core, slicepart as sp
from nos_tpu_torch.partitioning.core import snapshot as port_snapshot
from nos_tpu_torch.scheduler import framework as fw
from nos_tpu_torch.testing import factory, fleet
from nos_tpu_torch.topology import H100_80GB, enumerate_geometries
from nos_tpu_torch.topology.annotations import encode_placement_records
from nos_tpu_torch.topology.errors import InvalidGeometryError
from nos_tpu_torch.topology.known import GpuModelRegistry
from nos_tpu_torch.topology.packing import Placement
from nos_tpu_torch.topology.slice_unit import SliceUnit

SPAN_COUNTS = ("forks", "commits", "reverts")
JAX_KIND = {C.MIG_KIND: "slice", C.MPS_KIND: "timeshare"}
TO_PORT = {"2x4": "7g.80gb", "2x2": "3g.40gb"}
TO_JAX = {v: k for k, v in TO_PORT.items()}
WHOLE, HALF = "7g.80gb", "3g.40gb"


def _standin_registries() -> tuple[TopologyRegistry, GpuModelRegistry]:
    with tempfile.TemporaryDirectory() as tmp:
        jpath, ppath = f"{tmp}/jax.json", f"{tmp}/port.json"
        with open(jpath, "w") as f:
            json.dump({"tpu-v5e": {"slice_shapes": ["2x2", "2x4"]}}, f)
        with open(ppath, "w") as f:
            json.dump({H100_80GB.name: {"mig_profiles": [HALF, WHOLE]}}, f)
        jreg, preg = TopologyRegistry(), GpuModelRegistry()
        jreg.load_overrides(jpath)
        preg.load_overrides(ppath)
    return jreg, preg


JAX_REG, PORT_REG = _standin_registries()
JAX_GEN = JAX_REG.get("tpu-v5e")
STANDIN = PORT_REG.get(H100_80GB.name)

# the placements a GPU of the stand-in can hold, as (profile, start)
STANDIN_SETS = ((), ((WHOLE, 0),), ((HALF, 0),), ((HALF, 4),),
                ((HALF, 0), (HALF, 4)))


# ---------------------------------------------------------------------------
# Name mapping between the stand-ins
# ---------------------------------------------------------------------------


def jax_table(table: dict[str, int]) -> dict:
    return {Shape.parse(TO_JAX[p]): c for p, c in table.items()}


def port_table(table) -> dict[str, int]:
    return {TO_PORT[s.name]: c for s, c in table.items() if c > 0}


def jax_placement(pl: Placement) -> JaxPlacement:
    if pl.profile == WHOLE:
        return JaxPlacement(Shape.parse("2x4"), (0, 0), (2, 4))
    return JaxPlacement(Shape.parse("2x2"), (0, pl.start // 2), (2, 2))


def port_placement(pl: JaxPlacement) -> Placement:
    profile = TO_PORT[pl.shape.name]
    return Placement(profile, pl.offset[1] * 2,
                     STANDIN.profile(profile).memory_slices)


def port_resource(resource: str) -> str:
    """A JAX resource name under the port's name."""
    shape = shape_from_resource(resource)
    if shape is not None:
        return f"nvidia.com/mig-{TO_PORT[shape.name]}"
    if resource == JC.RESOURCE_TPU:
        return C.RESOURCE_GPU
    return resource


NODE_KEYS = {
    JC.spec_plan_annotation("slice"): C.spec_plan_annotation(C.MIG_KIND),
    JC.status_plan_annotation("slice"): C.status_plan_annotation(C.MIG_KIND),
    JC.heartbeat_annotation("slice"): C.heartbeat_annotation(C.MIG_KIND),
    JC.ANNOT_PLUGIN_GENERATION: C.ANNOT_PLUGIN_GENERATION,
}


def port_annotation(key: str, value: str) -> tuple[str, str]:
    """A JAX node annotation under the port's key and value."""
    m = JC.SPEC_ANNOT_RE.match(key)
    if m:
        return (f"{C.ANNOT_SPEC_PREFIX}{m['index']}-"
                f"{TO_PORT.get(m['profile'], m['profile'])}", value)
    m = JC.STATUS_ANNOT_RE.match(key)
    if m:
        return (f"{C.ANNOT_STATUS_PREFIX}{m['index']}-"
                f"{TO_PORT.get(m['profile'], m['profile'])}-{m['status']}",
                value)
    m = JC.PLACEMENT_ANNOT_RE.match(key)
    if m:
        (records,) = jax_annotations.parse_placement_annotations(
            {key: value}).values()
        return (f"{C.ANNOT_PLACEMENTS_PREFIX}{m['index']}",
                encode_placement_records(
                    (st, port_placement(pl)) for st, pl in records))
    return NODE_KEYS.get(key, key), value


# ---------------------------------------------------------------------------
# Cluster specs (testing/fleet.py's format) and their JAX twins
# ---------------------------------------------------------------------------


def _random_gpu(rng, allow_virgin: bool):
    """A stand-in GPU's report: placements, each used or free."""
    sets = STANDIN_SETS if allow_virgin else STANDIN_SETS[1:]
    chosen = sets[int(rng.integers(0, len(sets)))]
    return [("u" if rng.random() < 0.5 else "f", p, s) for p, s in chosen]


def small_spec(seed: int, pins: bool = True) -> dict:
    """1-4 MIG nodes of 1-3 GPUs on the stand-in, every GPU reporting
    (a one-GPU node may be virgin), random used and free instances with
    their placements (``pins``), one bound pod per used instance and, at
    times, one bound since the last report; one MPS node the MIG taker
    must skip; 3-14 pending pods of 3g.40gb or 7g.80gb, one of them
    asking for three 7g.80gb (only a node of three free GPUs holds it)."""
    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(int(rng.integers(1, 5))):
        gpus = int(rng.integers(1, 4))
        status: dict[int, dict] = {}
        placements: dict[int, list] = {}
        bound = []
        for g in range(gpus):
            records = _random_gpu(rng, allow_virgin=gpus == 1)
            for st, p, start in records:
                table = status.setdefault(g, {}).setdefault(
                    "used" if st == "u" else "free", {})
                table[p] = table.get(p, 0) + 1
                if st == "u":
                    bound.append({"name": f"held-{i}-{len(bound)}",
                                  "profiles": {p: 1}, "filler": False})
            if records and pins:
                placements[g] = [[st, p, start,
                                  STANDIN.profile(p).memory_slices]
                                 for st, p, start in records]
        free = [p for t in status.values() for p, c in t.get("free", {}).items()
                for _ in range(c)]
        if free and rng.random() < 0.3:
            bound.append({"name": f"late-{i}", "profiles": {free[0]: 1},
                          "filler": False})
        nodes.append({"name": f"mig-{i}", "kind": C.MIG_KIND, "gpus": gpus,
                      "status": status, "placements": placements,
                      "bound": bound})
    nodes.append({"name": "mps-0", "kind": C.MPS_KIND, "gpus": 1,
                  "status": {0: {"free": {"80gb": 1}}}, "bound": []})
    pending = []
    for i in range(int(rng.integers(3, 15))):
        pending.append({"name": f"p{i}",
                        "profile": HALF if rng.random() < 0.6 else WHOLE,
                        "qty": int(rng.choice([1, 1, 1, 2])),
                        "priority": int(rng.integers(0, 3)),
                        "created": float(rng.integers(0, 100))})
    pending.append({"name": "three-whole", "profile": WHOLE, "qty": 3,
                    "priority": 2, "created": 0.0})
    return {"nodes": nodes, "pending": pending}


def standin_fleet_spec(seed: int = 0) -> dict:
    """``fleet.mig_fleet_spec`` on the stand-in: 32 nodes x 8 GPUs, half
    full, 200 pending pods of the bench's mix restricted to the
    stand-in's profiles (2x2:4, 2x4:2 ↔ 3g.40gb:4, 7g.80gb:2)."""
    spec = fleet.mig_fleet_spec(seed, nodes=fleet.NODES,
                                full_nodes=fleet.FULL_NODES)
    rng = np.random.default_rng(seed)
    pods, i = [], 0
    while len(pods) < fleet.PENDING_PODS:
        for profile, weight in ((HALF, 4), (WHOLE, 2)):
            for _ in range(weight):
                if len(pods) < fleet.PENDING_PODS:
                    pods.append({"name": f"pending-{i}", "profile": profile,
                                 "qty": 1, "priority": i % 3,
                                 "created": float(rng.integers(0, 3600))})
                    i += 1
    spec["pending"] = pods
    return spec


def jax_node(n: dict):
    node = jax_factory.make_tpu_node(n["name"], generation=JAX_GEN,
                                     partitioning=JAX_KIND[n["kind"]])
    # one host block per GPU: the whole-host resource counts 8 a GPU
    for table in (node.status.allocatable, node.status.capacity):
        table[JC.RESOURCE_TPU] = 8.0 * n["gpus"]
    alloc = node.status.allocatable
    for index, tables in n["status"].items():
        for status, table in tables.items():
            for profile, qty in table.items():
                jname = TO_JAX.get(profile, profile)
                node.metadata.annotations[
                    f"{JC.ANNOT_STATUS_PREFIX}{index}-{jname}-{status}"] = \
                    str(qty)
                res = (f"{JC.RESOURCE_SLICE_PREFIX}{jname}" if "x" in jname
                       else f"{JC.RESOURCE_TIMESHARE_PREFIX}{jname}")
                alloc[res] = alloc.get(res, 0.0) + qty
    for index, records in n.get("placements", {}).items():
        node.metadata.annotations[f"{JC.ANNOT_PLACEMENTS_PREFIX}{index}"] = \
            jax_annotations.encode_placement_records(
                (st, jax_placement(Placement(p, start, size)))
                for st, p, start, size in records)
    return node


def jax_cluster(spec: dict) -> jax_state.ClusterState:
    """fleet.build_cluster's JAX twin."""
    state = jax_state.ClusterState()
    for n in spec["nodes"]:
        node = jax_node(n)
        bound = []
        for b in n["bound"]:
            if b["filler"]:
                res = dict(node.status.allocatable)
            else:
                res = {f"{JC.RESOURCE_SLICE_PREFIX}{TO_JAX[p]}": float(q)
                       for p, q in b["profiles"].items()} | {"cpu": 1.0}
            bound.append(jax_factory.make_pod(
                name=b["name"], node_name=n["name"], resources=res))
        state.update_node(node, bound)
    return state


def jax_pending(spec: dict) -> list:
    return [jax_factory.make_slice_pod(
        TO_JAX[p["profile"]], p["qty"], name=p["name"],
        priority=p["priority"], creation_timestamp=p["created"])
        for p in spec["pending"]]


def port_cluster(spec: dict):
    return fleet.build_cluster(spec, model=STANDIN)


def _jax_sevenths(self) -> tuple[float, float, bool]:
    """JAX SliceNode.pool_free with the port's weighting: a GPU (8 of
    the host's chips) counts 7, a 2x4 7, a 2x2 3 (the port's 3g.40gb)."""
    ni = self.node_info()
    total, has_free = 0.0, False
    for res, aq in ni.allocatable.items():
        qty = aq - ni.requested.get(res, 0.0)
        if qty <= 0:
            continue
        has_free = True
        shape = shape_from_resource(res)
        if shape is not None:
            total += {"2x4": 7, "2x2": 3}[shape.name] * qty
        elif res == JC.RESOURCE_TPU:
            total += 7 * qty / 8
    return total, 0.0, has_free


def candidate_orders(spec) -> tuple[list[str], list[str]]:
    """The port's and the unpatched JAX package's candidate orders on
    the snapshot of ``spec``: the planner walks the nodes in this order,
    once per plan."""
    snap = sp.SliceSnapshotTaker(PORT_REG).take_snapshot(port_cluster(spec))
    jsnap = jax_sp.SliceSnapshotTaker(JAX_REG).take_snapshot(
        jax_cluster(spec))
    return ([n.name for n in snap.get_candidate_nodes()],
            [n.name for n in jsnap.get_candidate_nodes()])


def jax_orders_as_the_port(monkeypatch, spec) -> bool:
    """Give the JAX snapshot the port's weighting only where the two
    orders differ on ``spec``; True if it did."""
    order, jorder = candidate_orders(spec)
    if order == jorder:
        return False
    monkeypatch.setattr(jax_sp_node.SliceNode, "pool_free", _jax_sevenths)
    assert candidate_orders(spec)[1] == order
    return True


# ---------------------------------------------------------------------------
# SliceUnit on the stand-in
# ---------------------------------------------------------------------------


def _random_unit(rng, pins: bool, index: int = 0):
    records = _random_gpu(rng, allow_virgin=True)
    used: dict[str, int] = {}
    free: dict[str, int] = {}
    placed_used, placed_free = [], []
    for st, p, start in records:
        table = used if st == "u" else free
        table[p] = table.get(p, 0) + 1
        pl = Placement(p, start, STANDIN.profile(p).memory_slices)
        (placed_used if st == "u" else placed_free).append(pl)
    if not pins:
        placed_used, placed_free = [], []
    port = SliceUnit(model=STANDIN, index=index, used=dict(used),
                     free=dict(free), placed_used=list(placed_used),
                     placed_free=list(placed_free))
    jax = JaxSliceUnit(generation=JAX_GEN, index=index, used=jax_table(used),
                       free=jax_table(free),
                       placed_used=[jax_placement(p) for p in placed_used],
                       placed_free=[jax_placement(p) for p in placed_free])
    return port, jax


def _same_unit(port: SliceUnit, jax: JaxSliceUnit) -> None:
    assert port_table(jax.used) == {p: c for p, c in port.used.items() if c}
    assert port_table(jax.free) == {p: c for p, c in port.free.items() if c}
    assert sorted(map(port_placement, jax.placed_used), key=repr) == \
        sorted(port.placed_used, key=repr)
    assert sorted(map(port_placement, jax.placed_free), key=repr) == \
        sorted(port.placed_free, key=repr)
    assert port.has_placement_data() == jax.has_placement_data()


CANDIDATES = ({WHOLE: 1}, {HALF: 2}, {HALF: 1}, {WHOLE: 1, HALF: 1},
              {HALF: 3}, {})


class TestSliceUnitParity:
    def test_allowed_geometries_are_the_jax_tilings(self):
        unit = SliceUnit(model=STANDIN)
        jax = JaxSliceUnit(generation=JAX_GEN)
        assert sorted(map(sorted, (g.items() for g in
                                   unit.allowed_geometries()))) == \
            sorted(map(sorted, (port_table(g).items() for g in
                                jax.allowed_geometries())))

    @pytest.mark.parametrize("pins", [True, False])
    @pytest.mark.parametrize("seed", range(6))
    def test_decisions_match_jax(self, seed, pins):
        rng = np.random.default_rng(seed)
        for _ in range(40):
            port, jax = _random_unit(rng, pins)
            _same_unit(port, jax)
            for geo in CANDIDATES:
                assert port.can_apply_geometry(geo) == \
                    jax.can_apply_geometry(jax_table(geo)), geo
            lacking = {p: int(rng.integers(0, 4)) for p in (WHOLE, HALF)}
            assert port.update_geometry_for(lacking) == \
                jax.update_geometry_for(jax_table(lacking))
            _same_unit(port, jax)
            geo = CANDIDATES[int(rng.integers(0, len(CANDIDATES)))]
            try:
                jax.apply_geometry(jax_table(geo))
                applied = True
            except JaxInvalidGeometryError:
                applied = False
            if applied:
                port.apply_geometry(geo)
            else:
                with pytest.raises(InvalidGeometryError):
                    port.apply_geometry(geo)
            _same_unit(port, jax)
            for _ in range(3):
                profile = (WHOLE, HALF)[int(rng.integers(0, 2))]
                shape = Shape.parse(TO_JAX[profile])
                if rng.random() < 0.5:
                    assert port.allocate(profile) == jax.allocate(shape)
                else:
                    assert port.release(profile) == jax.release(shape)
                _same_unit(port, jax)

    def test_init_geometry(self):
        unit = SliceUnit(model=STANDIN)
        jax = JaxSliceUnit(generation=JAX_GEN)
        unit.init_geometry()
        jax.init_geometry()
        _same_unit(unit, jax)
        assert unit.geometry_names() == {WHOLE: 1}
        full = SliceUnit(model=H100_80GB)
        full.init_geometry()
        assert full.geometry_names() == {WHOLE: 1}


# ---------------------------------------------------------------------------
# The full H100 table: an oracle independent of the port's topology/
# ---------------------------------------------------------------------------

# NVIDIA MIG User Guide, H100 80GB (SXM5): GPU instance profile, compute
# slices, memory slots it spans, the most instances, the start slots.
# 1g.10gb+me is carved only for a pod that asks for it (or where one
# is used): ``oracle_update`` skips geometries holding it otherwise.
NVIDIA_H100_80GB = {
    "1g.10gb": (1, 1, 7, (0, 1, 2, 3, 4, 5, 6)),
    "1g.10gb+me": (1, 1, 1, (0, 1, 2, 3, 4, 5, 6)),
    "1g.20gb": (1, 2, 4, (0, 2, 4, 6)),
    "2g.20gb": (2, 2, 3, (0, 2, 4)),
    "3g.40gb": (3, 4, 2, (0, 4)),
    "4g.40gb": (4, 4, 1, (0,)),
    "7g.80gb": (7, 8, 1, (0,)),
}
ALL_PLACEMENTS = [(p, s) for p, (_, _, _, starts) in NVIDIA_H100_80GB.items()
                  for s in starts]


def _mask(p: str, start: int) -> int:
    return ((1 << NVIDIA_H100_80GB[p][1]) - 1) << start


def _oracle_sets() -> list[frozenset]:
    """Every set of placements with no two overlapping, within 8 slots
    and 7 compute slices, each profile within its most instances."""
    out = []

    def rec(i, chosen, occ, g):
        if i == len(ALL_PLACEMENTS):
            counts = {}
            for p, _ in chosen:
                counts[p] = counts.get(p, 0) + 1
            if all(c <= NVIDIA_H100_80GB[p][2] for p, c in counts.items()):
                out.append(frozenset(chosen))
            return
        rec(i + 1, chosen, occ, g)
        p, s = ALL_PLACEMENTS[i]
        m = _mask(p, s)
        if not occ & m and m < 1 << 8 and g + NVIDIA_H100_80GB[p][0] <= 7:
            rec(i + 1, chosen + [(p, s)], occ | m,
                g + NVIDIA_H100_80GB[p][0])

    rec(0, [], 0, 0)
    return out


def _counts(placements) -> tuple:
    c: dict[str, int] = {}
    for p, _ in placements:
        c[p] = c.get(p, 0) + 1
    return tuple(sorted(c.items()))


ORACLE_SETS = _oracle_sets()
ORACLE_VALID = {_counts(s) for s in ORACLE_SETS} - {()}
def _grown(g: tuple, q: str) -> tuple:
    d = dict(g)
    d[q] = d.get(q, 0) + 1
    return tuple(sorted(d.items()))


ORACLE_MAXIMAL = sorted(g for g in ORACLE_VALID
                        if not any(_grown(g, q) in ORACLE_VALID
                                   for q in NVIDIA_H100_80GB))


def oracle_update(used: dict, free: dict, lacking: dict,
                  pins: frozenset | None) -> dict | None:
    """The reference's UpdateGeometryFor, rewritten: the geometry to
    carve, or None to keep the current one."""
    def applicable(geo: dict) -> bool:
        if any(geo.get(p, 0) < c for p, c in used.items()):
            return False
        if not pins:
            return True
        key = tuple(sorted(geo.items()))
        return any(_counts(s) == key and pins <= s for s in ORACLE_SETS)

    def score(table: dict) -> int:
        return sum(min(table.get(p, 0), n) for p, n in lacking.items()
                   if n > 0)

    asked = {p for p, n in lacking.items() if n > 0} | set(used)
    best, best_geo = score(free), None
    for key in ORACLE_MAXIMAL:
        geo = dict(key)
        if any(p.endswith("+me") and p not in asked for p in geo) \
                or not applicable(geo):
            continue
        sc = score({p: c - used.get(p, 0) for p, c in geo.items()})
        if sc > best or (sc == best and best_geo is not None
                         and sum(geo.values()) < sum(best_geo.values())):
            best, best_geo = sc, geo
    return best_geo


class TestFullTableOracle:
    def test_the_model_is_nvidias_table(self):
        got = {p.name: (p.compute_slices, p.memory_slices, p.max_count,
                        tuple(p.starts)) for p in H100_80GB.mig_profiles}
        assert got == NVIDIA_H100_80GB
        assert (H100_80GB.compute_slices, H100_80GB.memory_slices) == (7, 8)

    def test_enumerate_geometries_is_the_brute_force(self):
        assert list(enumerate_geometries(H100_80GB)) == ORACLE_MAXIMAL
        # 1g.10gb x 7 leaves a memory slot empty and is still maximal
        assert (("1g.10gb", 7),) in ORACLE_MAXIMAL

    @pytest.mark.parametrize("pins", [True, False])
    @pytest.mark.parametrize("seed", range(6))
    def test_update_geometry_for_is_the_scoring_rule(self, seed, pins):
        rng = np.random.default_rng(100 + seed)
        profiles = sorted(NVIDIA_H100_80GB)
        changed = 0
        for _ in range(60):
            chosen = sorted(ORACLE_SETS[int(rng.integers(0,
                                                         len(ORACLE_SETS)))])
            used: dict[str, int] = {}
            free: dict[str, int] = {}
            pinned, placed_free = [], []
            for p, s in chosen:
                pl = Placement(p, s, NVIDIA_H100_80GB[p][1])
                if rng.random() < 0.5:
                    used[p] = used.get(p, 0) + 1
                    pinned.append(pl)
                else:
                    free[p] = free.get(p, 0) + 1
                    placed_free.append(pl)
            lacking = {p: int(rng.integers(0, 4))
                       for p in rng.choice(profiles, size=int(
                           rng.integers(1, 4)), replace=False)}
            unit = SliceUnit(model=H100_80GB, used=dict(used),
                             free=dict(free),
                             placed_used=pinned if pins else [],
                             placed_free=placed_free if pins else [])
            want = oracle_update(
                used, free, lacking,
                frozenset((pl.profile, pl.start) for pl in pinned)
                if pins else None)
            assert unit.update_geometry_for(lacking) == (want is not None)
            if want is not None:
                changed += 1
                assert unit.geometry_names() == want
                assert {p: c for p, c in unit.used.items() if c} == used
            else:
                assert ({p: c for p, c in unit.free.items() if c}, unit.used) \
                    == (free, used)
        assert changed > 0


# ---------------------------------------------------------------------------
# Nodes, snapshot and planner
# ---------------------------------------------------------------------------


def _bound_names(spec) -> set[str]:
    return {b["name"] for n in spec["nodes"] for b in n["bound"]}


def _jax_summary(snapshot, pending, bound) -> dict:
    """fleet.plan_summary's JAX twin, names mapped."""
    geometries, placed = {}, {}
    for name in sorted(snapshot.nodes()):
        node = snapshot.get_node(name)
        geometries[name] = {
            str(i): dict(sorted((TO_PORT[p], q) for p, q in g.items()))
            for i, g in sorted(node.geometries().items())}
        names = sorted(p.metadata.name for p in node.node_info().pods
                       if p.metadata.name not in bound)
        if names:
            placed[name] = names
    done = {n for names in placed.values() for n in names}
    left = [p for p in pending if p.metadata.name not in done]
    lacking = jax_core.SliceTracker(
        snapshot, jax_sp.SliceProfileCalculator(), left).lacking
    return {"geometries": geometries, "placed": placed,
            "lacking": dict(sorted((TO_PORT[p], q)
                                   for p, q in lacking.items()))}


def _span_counts(ring) -> dict:
    (span,) = [s for s in ring.dump() if s["name"] == "planner.plan"]
    return span["counts"]


def port_plan(spec, build=port_cluster, taker=None,
              native_prescreen: bool = True, planner_cls=None,
              records: list | None = None):
    """``spec`` planned on the port by ``planner_cls`` (the sequential
    GeometryPlanner, JAX's twin here, unless given); the plan's journal
    rows go to ``records`` where one is given."""
    from nos_tpu_torch.obs import journal as port_journal

    taker = taker or sp.SliceSnapshotTaker(PORT_REG)
    snap = taker.take_snapshot(build(spec))
    pending = fleet.build_pending(spec)
    planner = (planner_cls or core.GeometryPlanner)(
        fw.Framework(), sp.SliceProfileCalculator(),
        sp.SlicePartitionCalculator(), native_prescreen=native_prescreen)
    tracer = trace.Tracer()
    journal = port_journal.DecisionJournal(maxlen=1 << 16)
    prev = trace.set_tracer(tracer)
    prev_j = port_journal.set_journal(journal)
    try:
        planned = snap.clone()
        desired = planner.plan(planned, pending)
    finally:
        port_journal.set_journal(prev_j)
        trace.set_tracer(prev)
    if records is not None:
        records.extend((r.category, r.subject, r.attrs)
                       for r in journal.events())
    summary = fleet.plan_summary(planned, pending, _bound_names(spec),
                                 sp.SliceProfileCalculator())
    return snap, planned, desired, _span_counts(tracer.ring), summary


def jax_plan(spec):
    snap = jax_sp.SliceSnapshotTaker(JAX_REG).take_snapshot(jax_cluster(spec))
    pending = jax_pending(spec)
    planner = jax_core.GeometryPlanner(
        jax_fw.Framework(), jax_sp.SliceProfileCalculator(),
        jax_sp.SlicePartitionCalculator(), native_prescreen=False)
    tracer = jax_trace.Tracer()
    prev = jax_trace.set_tracer(tracer)
    try:
        planned = snap.clone()
        desired = planner.plan(planned, pending)
    finally:
        jax_trace.set_tracer(prev)
    summary = _jax_summary(planned, pending, _bound_names(spec))
    return snap, planned, desired, _span_counts(tracer.ring), summary


def partitioning_rows(state, jax: bool) -> dict:
    """A PartitioningState as node -> [(GPU index, [(profile, qty)])]."""
    out = {}
    for name, np_ in state.items():
        rows = []
        for u in np_.units:
            res = []
            for r, q in u.resources.items():
                name_ = port_resource(r) if jax else r
                res.append((name_.rsplit("mig-", 1)[1], q))
            rows.append((u.index, res))
        out[name] = rows
    return out


def assert_same_plan(spec):
    """The port's plan with and without its native screen against JAX's
    Python plan: the same decisions both ways; without the screen the
    same pipeline runs, with it no more (JAX's chip guard and the port's
    slice guards count different units, so the screens' fails are not
    compared here: tests/test_torch_native.py holds them to the
    pipeline)."""
    _, _, jdesired, jcounts, jsummary = jax_plan(spec)
    runs = {}
    for native in (False, True):
        _, _, desired, counts, summary = port_plan(
            spec, native_prescreen=native)
        assert summary == jsummary, native
        assert partitioning_rows(desired, False) == \
            partitioning_rows(jdesired, True), native
        assert {k: counts.get(k, 0) for k in SPAN_COUNTS} == \
            {k: jcounts.get(k, 0) for k in SPAN_COUNTS}, native
        runs[native] = counts
    assert runs[False].get("filter_runs") == jcounts.get("filter_runs")
    assert "prescreen_fails" not in runs[False]
    assert runs[True].get("filter_runs", 0) <= runs[False].get("filter_runs", 0)
    return summary, runs[True]


# the planner cases whose two candidate orders differ: the only ones
# where the JAX snapshot is given the port's weighting
ORDERS_DIFFER = {"small_clusters": [0], "apply": [], "standin_fleet": False}


class TestPlannerParity:
    @pytest.mark.parametrize("seed", range(12))
    def test_small_clusters(self, seed, monkeypatch):
        spec = small_spec(seed, pins=seed % 3 != 0)
        assert jax_orders_as_the_port(monkeypatch, spec) == \
            (seed in ORDERS_DIFFER["small_clusters"])
        summary, _ = assert_same_plan(spec)
        assert "mps-0" not in summary["geometries"]
        snap, planned, *_ = port_plan(spec)
        for name in snap.nodes():
            before = {u.index: dict(u.used) for u in snap.get_node(name).units}
            for u in planned.get_node(name).units:
                assert all(u.geometry_names().get(p, 0) >= c
                           for p, c in before[u.index].items())

    def test_the_standin_fleet_at_bench_size(self, monkeypatch):
        spec = standin_fleet_spec(0)
        assert jax_orders_as_the_port(monkeypatch, spec) == \
            ORDERS_DIFFER["standin_fleet"]
        summary, counts = assert_same_plan(spec)
        assert counts["forks"] >= 1 and summary["placed"]
        assert fleet.plan_digest(summary) == STANDIN_FLEET_DIGEST

    @pytest.mark.parametrize("seed", range(4))
    def test_apply_writes_what_jax_writes(self, seed, monkeypatch):
        spec = small_spec(50 + seed)
        assert jax_orders_as_the_port(monkeypatch, spec) == \
            (seed in ORDERS_DIFFER["apply"])
        api, japi = APIServer(), JaxAPIServer()
        for node in port_cluster(spec).nodes().values():
            api.create(KIND_NODE, node)
        for node in jax_cluster(spec).nodes().values():
            japi.create("Node", node)
        snap, _, desired, _, _ = port_plan(spec)
        jsnap, _, jdesired, _, _ = jax_plan(spec)
        actuator = core.GeometryActuator(
            sp.SlicePartitioner(api), sp.SlicePartitionCalculator(),
            core.QuarantineList(C.MIG_KIND))
        jactuator = jax_core.GeometryActuator(
            jax_sp.SlicePartitioner(japi), jax_sp.SlicePartitionCalculator(),
            kind="slice")
        assert actuator.apply(snap, desired) == jactuator.apply(jsnap,
                                                                jdesired)
        plan = jplan = ""
        for node in api.list(KIND_NODE):
            jnode = japi.get("Node", node.name)
            plan = plan or node.metadata.annotations.get(
                C.spec_plan_annotation(C.MIG_KIND), "")
            jplan = jplan or jnode.metadata.annotations.get(
                JC.spec_plan_annotation("slice"), "")
            got = {k: v.replace(plan, "PLAN") if plan else v
                   for k, v in node.metadata.annotations.items()}
            want = dict(port_annotation(k, v.replace(jplan, "PLAN")
                                        if jplan else v)
                        for k, v in jnode.metadata.annotations.items())
            assert got == want


# seed 0's stand-in fleet plan, which the JAX package's planner makes
STANDIN_FLEET_DIGEST = \
    "74e719879a02b3f37523dfef32f9738a6ab6c99886b3ee5f759151acf9fcc6bd"


class TestMigFleet:
    """The MIG fleet (bench_plan.py's 64 hosts and mix, its 4x4 row as
    2x8 block gangs, in four NVLink domains of 16 nodes) planned by the MIG
    factory's planner, the group pass in front, held by checks that do
    not read the digest: the oracle on every GPU outside a block, the
    blocks' windows, the pass's journal records, no gang lacking beside
    a clean window."""

    @staticmethod
    def _plan():
        from nos_tpu_torch.partitioning.slicepart.group import (
            MultiHostGeometryPlanner)

        spec = fleet.mig_fleet_spec(0)
        records: list = []
        got = port_plan(spec, build=fleet.build_cluster,
                        taker=sp.SliceSnapshotTaker(),
                        planner_cls=MultiHostGeometryPlanner,
                        records=records)
        return spec, records, got

    def test_the_mig_fleet_plan(self):
        spec, records, (snap, planned, _, counts, summary) = self._plan()
        assert len(spec["nodes"]) == 64 and len(spec["pending"]) == 200
        assert {n["kind"] for n in spec["nodes"]} == {C.MIG_KIND}
        assert fleet.plan_digest(summary) == fleet.MIG_FLEET_DIGEST
        assert counts["forks"] >= 1 and not summary["lacking"]
        windows = fleet.block_windows(records)
        members = {n for _, _, names in windows for n in names}
        assert fleet.block_plan_problems(
            spec, windows, summary["geometries"], summary["placed"],
            summary["lacking"]) == []
        # every GPU outside a block, against the independent oracle: a
        # maximal H100 geometry, holding its used instances; the sub-host
        # demand re-carves some of them
        recarved = 0
        for name, gpus in summary["geometries"].items():
            if name in members:
                continue
            before = {u.index: u.used for u in snap.get_node(name).units}
            recarved += any(g != {WHOLE: 1} for g in gpus.values())
            for index, geometry in gpus.items():
                key = tuple(sorted(geometry.items()))
                assert key in ORACLE_MAXIMAL, (name, index, geometry)
                g = sum(NVIDIA_H100_80GB[p][0] * q for p, q in key)
                m = sum(NVIDIA_H100_80GB[p][1] * q for p, q in key)
                assert g <= 7 and m <= 8
                assert all(geometry.get(p, 0) >= c
                           for p, c in before[int(index)].items())
        assert recarved >= 1

    def test_the_group_pass_takes_the_virgin_domain(self):
        """bench_plan.py's 18 block gangs want 9 windows: the pass carves
        all 8 of the virgin domain nvl-2 and the first of nvl-3 (each
        logged and journaled), one shard a gang, and the per-node pass
        re-carves nvl-3's next virgin nodes for the sub-host demand; no
        gang and no profile is left lacking."""
        spec, records, (_, _, _, _, summary) = self._plan()
        windows = fleet.block_windows(records)
        assert [w[1] for w in windows] == ["nvl-2"] * 8 + ["nvl-3"]
        assert [w[2] for w in windows] == [
            [f"gpu-node-{i}", f"gpu-node-{i + 1}"] for i in range(32, 50, 2)]
        gangs = {p["name"] for p in spec["pending"] if p.get("gang")}
        assert 2 * len(windows) == len(gangs) == 18
        placed = {p for pods in summary["placed"].values() for p in pods}
        # the carved shards hold the gangs, so only sub-host pods still
        # lacked room after the pass, and they are placed beside it
        assert placed and not placed & gangs
        assert {n for n, pods in summary["placed"].items()} <= {
            f"gpu-node-{i}" for i in range(50, 64)}
        assert not summary["lacking"]

    def test_a_gang_beside_a_clean_window_is_a_problem(self):
        """``block_plan_problems`` reads a lacking gang beside a clean
        aligned window, a misaligned window and a member the journal
        does not name."""
        spec, records, (_, _, _, _, summary) = self._plan()
        windows = fleet.block_windows(records)
        geometries = summary["geometries"]
        # drop the last carve: its nodes are clean, its 2 gangs lack
        cut = windows[:-1]
        clean = {n: {g: {} for g in range(8)} for n in windows[-1][2]}
        problems = fleet.block_plan_problems(
            spec, cut, {**geometries, **clean},
            {n: p for n, p in summary["placed"].items()
             if n not in windows[-1][2]},
            {**summary["lacking"], fleet.MIG_BLOCK: 2})
        assert len(problems) == 1 and "aligned windows are clean" in \
            problems[0]
        # host indices 1 and 2 of nvl-1
        misaligned = [["2x8", "nvl-1", ["gpu-node-17", "gpu-node-18"]]]
        assert any("not an aligned window" in p for p in
                   fleet.block_plan_problems(spec, misaligned, {}))
        assert any("are not the carved windows'" in p for p in
                   fleet.block_plan_problems(spec, [], geometries))

    def test_the_fleet_spec_maps_the_bench_mix(self):
        """bench_plan.py's mix row for row, its 4x4 a 2x8 block pod in a
        pod group of its own (``gang-<i>``), the nodes in its domains of
        16 hosts."""
        import bench_plan

        spec = fleet.mig_fleet_spec(0)
        counts: dict[str, int] = {}
        for p in spec["pending"]:
            counts[p["profile"]] = counts.get(p["profile"], 0) + 1
        assert counts == {"1g.10gb": 74, "2g.20gb": 54, "3g.40gb": 36,
                          "7g.80gb": 18, "2x8": 18}
        assert [w for _, w in fleet.MIG_POD_MIX] == \
            [w for _, w in bench_plan.POD_MIX]
        assert [p["priority"] for p in spec["pending"][:4]] == [0, 1, 2, 0]
        assert all(p.get("gang") == f"gang-{p['name'].split('-')[1]}"
                   for p in spec["pending"] if p["profile"] == "2x8")
        assert not any(p.get("gang") for p in spec["pending"]
                       if p["profile"] != "2x8")
        assert [(n["domain"], n["host_index"]) for n in spec["nodes"]] == [
            (f"nvl-{i // 16}", i % 16) for i in range(64)]
        assert (len(spec["nodes"]), bench_plan.DOMAINS) == \
            (bench_plan.HOSTS, 4)
        full = [n for n in spec["nodes"] if n["bound"]]
        assert len(full) == bench_plan.FULL_HOSTS == 32 and all(
            n["status"][g] == {"used": {WHOLE: 1}}
            for n in full for g in range(8))
        (pod,) = [p for p in fleet.build_pending(spec)
                  if p.metadata.name == "pending-20"]
        assert pod.metadata.labels[C.LABEL_POD_GROUP] == "gang-20"
        assert pod.spec.containers[0].resources == {
            "nos.nebuly.com/nvlink-block-2x8": 1, C.CPU: 1.0}


# ---------------------------------------------------------------------------
# The candidate order's g/7 weighting, pinned against JAX's order
# ---------------------------------------------------------------------------


class TestCandidateOrder:
    def _orders(self, nodes) -> tuple[list, list]:
        return candidate_orders({"nodes": nodes, "pending": []})

    @staticmethod
    def _node(name, free):
        return {"name": name, "kind": C.MIG_KIND, "gpus": 1,
                "status": {0: {"free": free}}, "bound": []}

    def test_a_3g_weighs_three_sevenths_where_jax_weighs_half(self):
        # a free whole GPU against two free halves: JAX ties them (8
        # chips each) and takes name order; the port counts 7/7 against
        # 6/7 and visits the halves first
        order, jorder = self._orders([self._node("a", {WHOLE: 1}),
                                      self._node("b", {HALF: 2})])
        assert jorder == ["a", "b"]
        assert order == ["b", "a"]

    def test_where_the_weights_agree_the_orders_agree(self):
        nodes = [self._node("a", {WHOLE: 1}), self._node("b", {HALF: 1}),
                 {"name": "c", "kind": C.MIG_KIND, "gpus": 2,
                  "status": {0: {"free": {WHOLE: 1}},
                             1: {"free": {HALF: 2}}}, "bound": []}]
        order, jorder = self._orders(nodes)
        assert order == jorder == ["b", "a", "c"]

    def test_sevenths_are_exact(self):
        assert port_snapshot._gpu_sevenths("nvidia.com/mig-3g.40gb", 2.0) \
            == 6.0
        assert port_snapshot._gpu_sevenths(C.RESOURCE_GPU, 1.0) == 7.0
        assert port_snapshot._gpu_sevenths("nvidia.com/gpu-24gb", 3.0) \
            == 21.0
        assert port_snapshot._gpu_sevenths(C.CPU, 64.0) == 0.0


# ---------------------------------------------------------------------------
# SliceNode, the taker, the partitioner and the initializer
# ---------------------------------------------------------------------------


class TestSliceNode:
    @pytest.mark.parametrize("seed", range(6))
    def test_units_and_allocatable_match_jax(self, seed):
        spec = small_spec(200 + seed, pins=seed % 2 == 0)
        snap = sp.SliceSnapshotTaker(PORT_REG).take_snapshot(
            port_cluster(spec))
        jsnap = jax_sp.SliceSnapshotTaker(JAX_REG).take_snapshot(
            jax_cluster(spec))
        assert sorted(snap.nodes()) == sorted(jsnap.nodes())
        for name in snap.nodes():
            node, jnode = snap.get_node(name), jsnap.get_node(name)
            assert [u.index for u in node.units] == \
                [u.index for u in jnode.units]
            for u, ju in zip(node.units, jnode.units):
                _same_unit(u, ju)
            alloc = {r: q for r, q in node.node_info().allocatable.items()
                     if r.startswith("nvidia.com/mig-")}
            jalloc = {port_resource(r): q for r, q in
                      jnode.node_info().allocatable.items()
                      if r.startswith(JC.RESOURCE_SLICE_PREFIX)}
            assert alloc == jalloc

    def test_a_virgin_node_has_a_unit_per_gpu(self):
        node = factory.make_gpu_node("n", gpus=8, partitioning=C.MIG_KIND)
        units = sp.units_from_node(node)
        assert [u.index for u in units] == list(range(8))
        assert all(not u.used and not u.free for u in units)

    def test_a_hybrid_node_owns_its_leading_half(self):
        node = factory.make_gpu_node(
            "n", gpus=4, partitioning=C.HYBRID_KIND, status_geometry={
                0: {"free": {WHOLE: 1}}, 1: {"used": {HALF: 1}},
                2: {"free": {WHOLE: 1}}, 3: {"free": {"24gb": 2}}})
        units = sp.units_from_node(node)
        assert [u.index for u in units] == [0, 1]
        assert units[1].used == {HALF: 1}
        # the MPS family's report and the stale MIG report on GPU 2 are
        # not the MIG family's
        one = factory.make_gpu_node("m", gpus=1,
                                    partitioning=C.HYBRID_KIND)
        assert [u.index for u in sp.units_from_node(one)] == [0]

    def test_untrusted_placements_are_dropped(self):
        node = factory.make_gpu_node(
            "n", gpus=1, partitioning=C.MIG_KIND,
            status_geometry={0: {"used": {HALF: 1}}})
        key = f"{C.ANNOT_PLACEMENTS_PREFIX}0"
        for value, trusted in (("u|3g.40gb|4|4", True),
                               ("u|3g.40gb|4|2", False),   # wrong size
                               ("u|2g.20gb|0|2", False),   # not the counts
                               ("u|5g.50gb|0|4", False)):  # no such profile
            node.metadata.annotations[key] = value
            (unit,) = sp.units_from_node(node)
            assert bool(unit.placed_used) == trusted, value

    def test_bound_pods_claim_their_instances(self):
        spec = {"nodes": [{"name": "n", "kind": C.MIG_KIND, "gpus": 2,
                           "status": {0: {"free": {HALF: 2}},
                                      1: {"free": {WHOLE: 1}}},
                           "bound": [{"name": "b", "profiles": {WHOLE: 1},
                                      "filler": False}]}], "pending": []}
        (node,) = sp.SliceSnapshotTaker().take_snapshot(
            fleet.build_cluster(spec)).nodes().values()
        assert node.units[1].used == {WHOLE: 1}
        assert not node.add_pod(factory.make_mig_pod(WHOLE))
        assert node.add_pod(factory.make_mig_pod(HALF, 2))
        assert node.units[0].used == {HALF: 2}
        assert not node.update_geometry_for({"1g.10gb": 3})

    def test_the_taker_keeps_mig_and_hybrid_nodes_it_can_read(self):
        state = fleet.build_cluster({"nodes": [
            {"name": n, "kind": k, "gpus": 1, "status": {}, "bound": []}
            for n, k in (("a", C.MIG_KIND), ("b", C.HYBRID_KIND),
                         ("c", C.MPS_KIND))], "pending": []})
        unknown = factory.make_gpu_node("d", partitioning=C.MIG_KIND)
        unknown.metadata.labels[C.LABEL_ACCELERATOR] = "nvidia-b200"
        uncounted = factory.make_gpu_node("e", partitioning=C.MIG_KIND)
        del uncounted.metadata.labels[C.LABEL_GPU_COUNT]
        state.update_node(unknown)
        state.update_node(uncounted)
        taker = sp.SliceSnapshotTaker()
        assert sorted(taker.take_snapshot(state).nodes()) == ["a", "b"]
        assert sorted(taker.take_snapshot(state, exclude={"a"}).nodes()) \
            == ["b"]


class TestPartitioner:
    def test_initializer_carves_every_owned_gpu(self):
        api = APIServer()
        api.create(KIND_NODE, factory.make_gpu_node(
            "n", gpus=8, partitioning=C.MIG_KIND))
        api.create(KIND_NODE, factory.make_gpu_node(
            "h", gpus=8, partitioning=C.HYBRID_KIND))
        init = sp.new_slice_initializer(api)
        for name, gpus in (("n", 8), ("h", 4)):
            assert not sp.is_node_initialized(api.get(KIND_NODE, name))
            init.init_node_partitioning(name)
            node = api.get(KIND_NODE, name)
            assert sp.is_node_initialized(node)
            spec = {k: v for k, v in node.metadata.annotations.items()
                    if k.startswith(C.ANNOT_SPEC_PREFIX)}
            assert spec == {f"{C.ANNOT_SPEC_PREFIX}{i}-7g.80gb": "1"
                            for i in range(gpus)}
            assert node.metadata.annotations[
                C.spec_plan_annotation(C.MIG_KIND)]

    def test_initializer_writes_what_jax_writes_for_one_gpu(self):
        api, japi = APIServer(), JaxAPIServer()
        api.create(KIND_NODE, factory.make_gpu_node(
            "n", model=STANDIN, gpus=1, partitioning=C.MIG_KIND))
        japi.create("Node", jax_factory.make_tpu_node(
            "n", generation=JAX_GEN, partitioning="slice"))
        sp.SliceNodeInitializer(api, PORT_REG).init_node_partitioning("n")
        jax_sp.SliceNodeInitializer(japi, JAX_REG).init_node_partitioning("n")
        annots = api.get(KIND_NODE, "n").metadata.annotations
        jannots = japi.get("Node", "n").metadata.annotations
        plan = annots[C.spec_plan_annotation(C.MIG_KIND)]
        jplan = jannots[JC.spec_plan_annotation("slice")]
        assert {k: v.replace(plan, "P") for k, v in annots.items()} == dict(
            port_annotation(k, v.replace(jplan, "P"))
            for k, v in jannots.items())

    def test_apply_keeps_the_other_family(self):
        api = APIServer()
        node = factory.make_gpu_node("n", gpus=2, partitioning=C.HYBRID_KIND)
        node.metadata.annotations[f"{C.ANNOT_SPEC_PREFIX}1-24gb"] = "2"
        node.metadata.annotations[f"{C.ANNOT_SPEC_PREFIX}0-1g.10gb"] = "7"
        api.create(KIND_NODE, node)
        from nos_tpu_torch.partitioning.state import (
            NodePartitioning, UnitPartitioning)
        sp.SlicePartitioner(api).apply_partitioning(
            "n", "plan-a", NodePartitioning([UnitPartitioning(
                0, {"nvidia.com/mig-3g.40gb": 2, "nvidia.com/gpu-24gb": 1})]))
        annots = api.get(KIND_NODE, "n").metadata.annotations
        assert {k: v for k, v in annots.items()
                if k.startswith(C.ANNOT_SPEC_PREFIX)} == {
            f"{C.ANNOT_SPEC_PREFIX}1-24gb": "2",
            f"{C.ANNOT_SPEC_PREFIX}0-3g.40gb": "2"}
        assert annots[C.spec_plan_annotation(C.MIG_KIND)] == "plan-a"


# ---------------------------------------------------------------------------
# The in-flux guard: compute slices and memory slots
# ---------------------------------------------------------------------------


class TestInFluxGuard:
    def _node_info(self):
        # three bound 1g.20gb pods still hold 3 compute slices and 6 of
        # the 8 memory slots; the card is re-carved to 1g.10gb x 7
        node = factory.make_gpu_node("n", gpus=1, partitioning=C.MIG_KIND,
                                     status_geometry={
                                         0: {"free": {"1g.10gb": 7}}})
        ni = fw.NodeInfo(node)
        for i in range(3):
            ni.add_pod(factory.make_mig_pod("1g.20gb", name=f"held-{i}",
                                            node_name="n"))
        return ni

    def test_three_1g20gb_pods_leave_room_for_one_1g10gb(self):
        ni = self._node_info()
        framework = fw.Framework()
        verdicts = []
        for i in range(4):
            pod = factory.make_mig_pod("1g.10gb", name=f"new-{i}")
            st = framework.run_filter_plugins(fw.CycleState(), pod, ni)
            verdicts.append(st.is_success)
            if st.is_success:
                ni.add_pod(pod)
            else:
                assert "memory slots" in st.message, st.message
        assert verdicts == [True, False, False, False]

    def test_the_guard_counts_the_nodes_model(self):
        assert fw._mig_slots({"nvidia.com/mig-1g.20gb": 3,
                              "nvidia.com/mig-1g.10gb": 1}, H100_80GB) \
            == (4, 7)
        # a profile the model's table lacks holds no memory slot
        assert fw._mig_slots({"nvidia.com/mig-1g.20gb": 3}, STANDIN) == (3, 0)
        assert fw._mig_slots({"nvidia.com/mig-1g.20gb": 3}, None) == (3, 0)

    def test_a_node_of_no_known_model_is_held_to_compute_alone(self):
        ni = self._node_info()
        ni.node.metadata.labels[C.LABEL_ACCELERATOR] = "nvidia-b200"
        framework = fw.Framework()
        passed = 0
        for i in range(5):
            pod = factory.make_mig_pod("1g.10gb", name=f"new-{i}")
            if framework.run_filter_plugins(fw.CycleState(), pod,
                                            ni).is_success:
                ni.add_pod(pod)
                passed += 1
        assert passed == 4

    def test_the_standin_guard_decides_as_jax(self):
        """On the stand-in a memory slot is a chip: the guard refuses
        where JAX's chip count does."""
        rng = np.random.default_rng(7)
        for _ in range(60):
            alloc = dict(((WHOLE, 1),) if rng.random() < 0.5
                         else ((HALF, 2),))
            node = factory.make_gpu_node("n", model=STANDIN, gpus=1,
                                         partitioning=C.MIG_KIND,
                                         status_geometry={0: {"free": alloc}})
            jnode = jax_node({"name": "n", "kind": C.MIG_KIND, "gpus": 1,
                              "status": {0: {"free": alloc}}})
            ni, jni = fw.NodeInfo(node), jax_fw.NodeInfo(jnode)
            framework = fw.Framework()
            for _ in range(int(rng.integers(0, 3))):
                p = (WHOLE, HALF)[int(rng.integers(0, 2))]
                ni.add_pod(factory.make_mig_pod(p))
                jni.add_pod(jax_factory.make_slice_pod(TO_JAX[p]))
            for _ in range(3):
                p = (WHOLE, HALF)[int(rng.integers(0, 2))]
                st = framework.run_filter_plugins(
                    fw.CycleState(), factory.make_mig_pod(p), ni)
                jst = jax_fw.Framework().run_filter_plugins(
                    jax_fw.CycleState(), jax_factory.make_slice_pod(
                        TO_JAX[p]), jni)
                assert st.is_success == jst.is_success
