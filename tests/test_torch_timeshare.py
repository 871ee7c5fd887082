"""The port's MPS strategy (nos_tpu_torch/topology/{timeshare_unit,
annotations,hybrid}.py, nos_tpu_torch/partitioning/timeshare/) against
the JAX package's timeshare strategy on the same inputs, compared
exactly: every table, verdict and rendered value must be equal, not
close.

The JAX side is a TPU generation built here, inside the test, with 80
GB a chip and the v5e's 8-chip 2x4 host block, so that one TPU chip
stands for one GPU of an 8-GPU H100 80GB node; ``nos_tpu/`` is used as
it is.  Names map one to one between the two sides: ``nos.tpu/tpu-<N>gb``
↔ ``nvidia.com/gpu-<N>gb``, ``google.com/tpu`` ↔ ``nvidia.com/gpu``, the
``nos.tpu/...-tpu-`` annotations ↔ ``nos.nebuly.com/...-gpu-``, the
"timeshare"/"slice" kinds ↔ "mps"/"mig".  Random inputs come from numpy
generators seeded per case (the seed is the case's parameter).
"""

from __future__ import annotations

import json

import numpy as np
import pytest

import nos_tpu.api.constants as JC
import nos_tpu.partitioning.state as jax_state
import nos_tpu.partitioning.timeshare as jax_ts
import nos_tpu.topology.annotations as jax_annotations
import nos_tpu.topology.timeshare_unit as jax_unit
from nos_tpu.kube.objects import Node as JaxNode, Pod as JaxPod
from nos_tpu.scheduler.framework import NodeInfo as JaxNodeInfo
from nos_tpu.testing import factory as jax_factory
from nos_tpu.topology import Shape
from nos_tpu.topology.known import V5E, Generation, TopologyRegistry

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.kube.client import APIServer, KIND_CONFIGMAP, KIND_NODE
from nos_tpu_torch.partitioning import timeshare as ts
from nos_tpu_torch.partitioning.state import (
    NodePartitioning, UnitPartitioning,
)
from nos_tpu_torch.scheduler.framework import NodeInfo
from nos_tpu_torch.testing import factory, fleet
from nos_tpu_torch.topology import annotations, hybrid
from nos_tpu_torch.topology.timeshare_unit import TimeshareUnit

# One TPU chip stands for one GPU: 80 GB, 8 to a host.
JAX_GEN = Generation(name="h100-80gb-standin", ndims=2,
                     host_block=Shape.parse("2x4"), hbm_gb_per_chip=80,
                     slice_shapes=V5E.slice_shapes, max_pod=V5E.max_pod)
JAX_REG = TopologyRegistry(generations={JAX_GEN.name: JAX_GEN})
JAX_KIND = {C.MPS_KIND: "timeshare", C.MIG_KIND: "slice",
            C.HYBRID_KIND: "hybrid"}
SHARES = (5, 8, 10, 16, 20, 24, 40, 80)


# ---------------------------------------------------------------------------
# The JAX side of a fleet spec (testing/fleet.py's format)
# ---------------------------------------------------------------------------


def jax_resource(resource: str) -> str:
    if resource == C.RESOURCE_GPU:
        return JC.RESOURCE_TPU
    if resource.startswith(C.RESOURCE_TIMESHARE_PREFIX):
        return JC.RESOURCE_TIMESHARE_PREFIX + \
            resource[len(C.RESOURCE_TIMESHARE_PREFIX):]
    return resource


def port_key(key: str) -> str:
    """A JAX annotation or label key under the port's name."""
    for jax, port in (
            (JC.ANNOT_SPEC_PREFIX, C.ANNOT_SPEC_PREFIX),
            (JC.ANNOT_STATUS_PREFIX, C.ANNOT_STATUS_PREFIX),
            (JC.spec_plan_annotation("timeshare"),
             C.spec_plan_annotation(C.MPS_KIND)),
            (JC.LABEL_DEVICE_PLUGIN_CONFIG, C.LABEL_DEVICE_PLUGIN_CONFIG),
            (JC.LABEL_PARTITIONING, C.LABEL_PARTITIONING)):
        if key.startswith(jax):
            return port + key[len(jax):]
    return key


def jax_node(n: dict) -> JaxNode:
    assert n["gpus"] == JAX_GEN.chips_per_host
    node = jax_factory.make_tpu_node(n["name"], generation=JAX_GEN,
                                     partitioning=JAX_KIND[n["kind"]])
    for index, tables in n["status"].items():
        for status, table in tables.items():
            for profile, qty in table.items():
                node.metadata.annotations[
                    f"{JC.ANNOT_STATUS_PREFIX}{index}-{profile}-{status}"] = \
                    str(qty)
                res = f"{JC.RESOURCE_TIMESHARE_PREFIX}{profile}"
                alloc = node.status.allocatable
                alloc[res] = alloc.get(res, 0.0) + qty
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
                res = {f"{JC.RESOURCE_TIMESHARE_PREFIX}{gb}gb": float(q)
                       for gb, q in b["shares"].items()} | {"cpu": 1.0}
            bound.append(jax_factory.make_pod(
                name=b["name"], node_name=n["name"], resources=res))
        state.update_node(node, bound)
    return state


def jax_pending(spec: dict) -> list[JaxPod]:
    return [jax_factory.make_timeshare_pod(
        p["gb"], p["qty"], name=p["name"], priority=p["priority"],
        creation_timestamp=p["created"]) for p in spec["pending"]]


def partitioning_rows(state) -> dict:
    """A PartitioningState of either package as node -> [(GPU index,
    [(profile, qty)])], in its own order; resources by profile name."""
    out = {}
    for name, np_ in state.items():
        out[name] = [(u.index, [(r.rsplit("-", 1)[1], q)
                                for r, q in u.resources.items()])
                     for u in np_.units]
    return out


def port_config_table(config: dict) -> dict:
    """The port's device-plugin config as {GPU index: {profile: replicas}}."""
    assert config["version"] == "v1"
    mps = config["sharing"]["mps"]
    assert mps["failRequestsGreaterThanOne"] is True
    out: dict[str, dict[str, int]] = {}
    for r in mps["resources"]:
        assert r["name"] == C.RESOURCE_GPU
        assert r["rename"] == f"{C.RESOURCE_TIMESHARE_PREFIX}{r['memoryGB']}gb"
        (index,) = r["devices"]
        out.setdefault(index, {})[f"{r['memoryGB']}gb"] = r["replicas"]
    return out


def jax_config_table(config: dict) -> dict:
    """The JAX config's per-chip table, chips with no share left out (the
    port's list names only GPUs that have shares)."""
    assert config["version"] == "v1"
    chips = config["sharing"]["timeshare"]["chips"]
    return {i: t for i, t in chips.items() if t}


# ---------------------------------------------------------------------------
# TimeshareUnit
# ---------------------------------------------------------------------------


def _random_tables(rng, memory=80):
    used: dict[int, int] = {}
    free: dict[int, int] = {}
    left = memory
    for _ in range(rng.integers(0, 5)):
        gb = int(rng.choice(SHARES))
        if gb > left:
            continue
        table = used if rng.random() < 0.5 else free
        table[gb] = table.get(gb, 0) + 1
        left -= gb
    return used, free


def _random_lacking(rng) -> dict[int, int]:
    return {int(gb): int(rng.integers(1, 6))
            for gb in rng.choice(SHARES, size=rng.integers(1, 4),
                                 replace=False)}


class TestTimeshareUnit:
    @pytest.mark.parametrize("seed", range(8))
    def test_update_geometry_for_matches_jax(self, seed):
        rng = np.random.default_rng(seed)
        for _ in range(40):
            used, free = _random_tables(rng)
            a = TimeshareUnit(memory_gb=80, used=dict(used), free=dict(free))
            b = jax_unit.TimeshareUnit(hbm_gb=80, used=dict(used),
                                       free=dict(free))
            for _ in range(3):
                lacking = _random_lacking(rng)
                assert a.update_geometry_for(lacking) == \
                    b.update_geometry_for(lacking)
                # dict order too: it decides which shares the next
                # sacrifice takes
                assert list(a.free.items()) == list(b.free.items())
                assert a.used == b.used
                assert a.geometry_names() == b.geometry_names()
                assert a.spare_gb == b.spare_gb
                gb = int(rng.choice(SHARES))
                assert a.allocate(gb) == b.allocate(gb)

    @pytest.mark.parametrize("seed", range(4))
    def test_apply_geometry_matches_jax(self, seed):
        rng = np.random.default_rng(100 + seed)
        for _ in range(60):
            used, free = _random_tables(rng)
            geometry = {int(gb): int(rng.integers(0, 4))
                        for gb in rng.choice(SHARES, size=3, replace=False)}
            a = TimeshareUnit(memory_gb=80, used=dict(used), free=dict(free))
            b = jax_unit.TimeshareUnit(hbm_gb=80, used=dict(used),
                                       free=dict(free))
            ok = b.can_apply_geometry(geometry)
            assert a.can_apply_geometry(geometry) == ok
            if ok:
                a.apply_geometry(geometry)
                b.apply_geometry(geometry)
                assert a.free == b.free and a.used == b.used
            else:
                with pytest.raises(ValueError):
                    a.apply_geometry(geometry)
                with pytest.raises(ValueError):
                    b.apply_geometry(geometry)

    def test_a_geometry_that_deletes_used_shares_is_refused(self):
        a = TimeshareUnit(memory_gb=80, used={20: 2}, free={40: 1})
        b = jax_unit.TimeshareUnit(hbm_gb=80, used={20: 2}, free={40: 1})
        for geometry in ({40: 2}, {20: 1, 40: 1}):
            assert not a.can_apply_geometry(geometry)
            assert not b.can_apply_geometry(geometry)
            with pytest.raises(ValueError):
                a.apply_geometry(geometry)
        assert a.used == {20: 2} and a.free == {40: 1}

    def test_an_over_full_card_is_refused(self):
        a = TimeshareUnit(memory_gb=80)
        b = jax_unit.TimeshareUnit(hbm_gb=80)
        for geometry in ({24: 4}, {40: 1, 20: 2, 10: 1}):
            assert not a.can_apply_geometry(geometry)
            assert not b.can_apply_geometry(geometry)
            with pytest.raises(ValueError):
                a.apply_geometry(geometry)
        # 96 GB asked of an 80 GB card: the most that fits, no more
        assert a.update_geometry_for({24: 4}) and a.free == {24: 3}
        assert b.update_geometry_for({24: 4}) and b.free == {24: 3}

    def test_sacrifice_and_restore(self):
        # a free 80gb share is sacrificed for 10gb shares; an unrelated
        # free 20gb share survives the re-carve
        a = TimeshareUnit(memory_gb=80, used={10: 1}, free={20: 1, 40: 1})
        b = jax_unit.TimeshareUnit(hbm_gb=80, used={10: 1},
                                   free={20: 1, 40: 1})
        assert a.update_geometry_for({10: 5}) == b.update_geometry_for({10: 5})
        assert list(a.free.items()) == list(b.free.items())
        assert a.used == {10: 1}


# ---------------------------------------------------------------------------
# Annotations
# ---------------------------------------------------------------------------


def _annotation_pairs(rng):
    """The same random status and spec annotations under both packages'
    names, with corrupt ones among them."""
    port, jax = {}, {}
    for _ in range(12):
        index = int(rng.integers(0, 8))
        profile = f"{int(rng.choice(SHARES))}gb"
        qty = str(int(rng.integers(0, 4))) if rng.random() < 0.85 \
            else str(rng.choice(["banana", "", "1.5", "-x"]))
        if rng.random() < 0.5:
            status = str(rng.choice(["free", "used"]))
            port[f"{C.ANNOT_STATUS_PREFIX}{index}-{profile}-{status}"] = qty
            jax[f"{JC.ANNOT_STATUS_PREFIX}{index}-{profile}-{status}"] = qty
        else:
            port[f"{C.ANNOT_SPEC_PREFIX}{index}-{profile}"] = qty
            jax[f"{JC.ANNOT_SPEC_PREFIX}{index}-{profile}"] = qty
    port["unrelated/key"] = jax["unrelated/key"] = "banana"
    return port, jax


class TestAnnotations:
    @pytest.mark.parametrize("seed", range(6))
    def test_parse_and_compare_match_jax(self, seed):
        rng = np.random.default_rng(200 + seed)
        port, jax = _annotation_pairs(rng)
        assert [(a.index, a.profile, a.quantity)
                for a in annotations.parse_spec_annotations(port)] == \
            [(a.index, a.profile, a.quantity)
             for a in jax_annotations.parse_spec_annotations(jax)]
        assert [(a.index, a.profile, a.status, a.quantity)
                for a in annotations.parse_status_annotations(port)] == \
            [(a.index, a.profile, a.status, a.quantity)
             for a in jax_annotations.parse_status_annotations(jax)]
        assert annotations.spec_matches_status(port) == \
            jax_annotations.spec_matches_status(jax)
        assert annotations.spec_matches_status(port, C.MPS_KIND) == \
            jax_annotations.spec_matches_status(jax, "timeshare")
        p, j = dict(port), dict(jax)
        annotations.strip_spec_annotations(p, C.MPS_KIND)
        jax_annotations.strip_spec_annotations(j, "timeshare")
        assert sorted(p) == sorted(port_key(k) for k in j)
        annotations.strip_status_annotations(p)
        jax_annotations.strip_status_annotations(j)
        assert sorted(p) == sorted(port_key(k) for k in j) == ["unrelated/key"]

    def test_corrupt_quantities_are_skipped_not_raised(self):
        port = {f"{C.ANNOT_STATUS_PREFIX}0-24gb-free": "banana",
                f"{C.ANNOT_STATUS_PREFIX}1-24gb-free": "2",
                f"{C.ANNOT_SPEC_PREFIX}0-24gb": "banana"}
        jax = {port_key_inverse(k): v for k, v in port.items()}
        assert [a.index for a in annotations.parse_status_annotations(port)] \
            == [a.index for a in jax_annotations.parse_status_annotations(jax)] \
            == [1]
        assert annotations.parse_spec_annotations(port) == [] == \
            jax_annotations.parse_spec_annotations(jax)

    @pytest.mark.parametrize("seed", range(4))
    def test_render_round_trips(self, seed):
        rng = np.random.default_rng(300 + seed)
        units, jax_units = [], []
        for i in range(8):
            used, free = _random_tables(rng)
            units.append(TimeshareUnit(80, i, dict(used), dict(free)))
            jax_units.append(jax_unit.TimeshareUnit(80, i, dict(used),
                                                    dict(free)))
        status = annotations.status_from_units(units)
        assert status == {port_key(k): v for k, v in
                          jax_annotations.status_from_units(jax_units).items()}
        geometries = {u.index: u.geometry_names() for u in units}
        spec = annotations.spec_from_geometries(geometries)
        assert spec == {port_key(k): v for k, v in
                        jax_annotations.spec_from_geometries(geometries).items()}
        both = spec | status
        assert annotations.spec_matches_status(both)
        assert {(a.index, a.profile): a.quantity
                for a in annotations.parse_spec_annotations(spec)} == {
            (i, p): q for i, g in geometries.items() for p, q in g.items()
            if q > 0}

    def test_families_split_a_hybrid_node(self):
        annots = {f"{C.ANNOT_SPEC_PREFIX}0-1g.10gb": "2",
                  f"{C.ANNOT_STATUS_PREFIX}0-1g.10gb-free": "1",
                  f"{C.ANNOT_SPEC_PREFIX}4-24gb": "3",
                  f"{C.ANNOT_STATUS_PREFIX}4-24gb-free": "3",
                  f"{C.ANNOT_PLACEMENTS_PREFIX}0": "f|1g.10gb|0|1"}
        assert annotations.spec_matches_status(annots, C.MPS_KIND)
        assert not annotations.spec_matches_status(annots, C.MIG_KIND)
        assert not annotations.spec_matches_status(annots)
        stripped = dict(annots)
        annotations.strip_status_annotations(stripped, C.MPS_KIND)
        assert f"{C.ANNOT_STATUS_PREFIX}4-24gb-free" not in stripped
        assert f"{C.ANNOT_PLACEMENTS_PREFIX}0" in stripped
        annotations.strip_status_annotations(stripped, C.MIG_KIND)
        assert not any(k.startswith(C.ANNOT_STATUS_PREFIX) for k in stripped)
        annotations.strip_spec_annotations(stripped, C.MIG_KIND)
        assert list(stripped) == [f"{C.ANNOT_SPEC_PREFIX}4-24gb"]

    def test_placement_records_round_trip_and_skip_corrupt_ones(self):
        from nos_tpu_torch.topology.packing import Placement

        records = [("u", Placement("3g.40gb", 4, 4)),
                   ("f", Placement("1g.10gb", 0, 1))]
        value = annotations.encode_placement_records(records)
        assert value == "f|1g.10gb|0|1;u|3g.40gb|4|4"
        corrupt = ";".join(["x|1g.10gb|0|1", "u|banana|0|1", "u|1g.10gb|-1|1",
                            "u|1g.10gb|0|0", "u|7g.80gb|4|8", "u|1g.10gb|0",
                            "u|1g.10gb|a|1", ""])
        parsed = annotations.parse_placement_annotations({
            f"{C.ANNOT_PLACEMENTS_PREFIX}2": value + ";" + corrupt,
            f"{C.ANNOT_STATUS_PREFIX}2-24gb-free": "1"})
        assert parsed == {2: sorted(records, key=lambda r: r[0])}

    def test_plan_ids_are_read_per_family(self):
        annots = {C.spec_plan_annotation(C.MPS_KIND): "p1",
                  C.status_plan_annotation(C.MIG_KIND): "p2"}
        assert annotations.spec_plan_id(annots, C.MPS_KIND) == "p1"
        assert annotations.spec_plan_id(annots, C.MIG_KIND) == ""
        assert annotations.status_plan_id(annots) == "p2"


def port_key_inverse(key: str) -> str:
    for jax, port in ((JC.ANNOT_SPEC_PREFIX, C.ANNOT_SPEC_PREFIX),
                      (JC.ANNOT_STATUS_PREFIX, C.ANNOT_STATUS_PREFIX)):
        if key.startswith(port):
            return jax + key[len(port):]
    return key


# ---------------------------------------------------------------------------
# TimeshareNode, the calculators and the snapshot taker
# ---------------------------------------------------------------------------


def _random_node_spec(rng, name: str, kind: str = C.MPS_KIND) -> dict:
    status: dict[int, dict[str, dict[str, int]]] = {}
    bound = []
    for g in range(8):
        used, free = _random_tables(rng)
        tables = {}
        if used:
            tables["used"] = {f"{gb}gb": c for gb, c in used.items()}
            bound.append({"name": f"{name}-bound-{g}",
                          "shares": dict(used), "filler": False})
        if free:
            tables["free"] = {f"{gb}gb": c for gb, c in free.items()}
        if tables:
            status[g] = tables
    if rng.random() < 0.5:
        # bound since the last report: its share still shows as free
        bound.append({"name": f"{name}-late", "shares": {10: 1},
                      "filler": False})
    return {"name": name, "kind": kind, "gpus": 8, "status": status,
            "bound": bound}


def _both_nodes(spec):
    port_state = fleet.build_cluster(spec)
    jax_st = jax_cluster(spec)
    port_snap = ts.TimeshareSnapshotTaker().take_snapshot(port_state)
    jax_snap = jax_ts.TimeshareSnapshotTaker(JAX_REG).take_snapshot(jax_st)
    return port_snap, jax_snap


class TestTimeshareNode:
    @pytest.mark.parametrize("seed", range(6))
    def test_units_geometry_and_allocatable_match_jax(self, seed):
        rng = np.random.default_rng(400 + seed)
        kinds = [C.MPS_KIND, C.HYBRID_KIND, C.MPS_KIND]
        spec = {"nodes": [_random_node_spec(rng, f"n{i}", k)
                          for i, k in enumerate(kinds)], "pending": []}
        port_snap, jax_snap = _both_nodes(spec)
        for name in ("n0", "n1", "n2"):
            p, j = port_snap.get_node(name), jax_snap.get_node(name)
            assert [(u.index, u.used, u.free) for u in p.units] == \
                [(u.index, u.used, u.free) for u in j.units]
            assert p.geometries() == j.geometries()
            assert p.node_info().allocatable == {
                port_resource(k): v
                for k, v in j.node_info().allocatable.items()}
            for _ in range(4):
                lacking = {f"{gb}gb": q for gb, q in _random_lacking(rng).items()}
                assert p.update_geometry_for(lacking) == \
                    j.update_geometry_for(lacking)
                assert p.geometries() == j.geometries()
            pod_gb = int(rng.choice(SHARES))
            assert p.add_pod(factory.make_timeshare_pod(pod_gb, 2)) == \
                j.add_pod(jax_factory.make_timeshare_pod(pod_gb, 2))
            assert [(u.used, u.free) for u in p.clone().units] == \
                [(u.used, u.free) for u in j.clone().units]
        # the hybrid node's MIG half carries no MPS unit
        assert [u.index for u in port_snap.get_node("n1").units] == \
            [4, 5, 6, 7]

    def test_snapshot_taker_skips_other_kinds_and_unknown_nodes(self):
        rng = np.random.default_rng(7)
        spec = {"nodes": [_random_node_spec(rng, "mps-0"),
                          _random_node_spec(rng, "mig-0", C.MIG_KIND),
                          _random_node_spec(rng, "hybrid-0", C.HYBRID_KIND)],
                "pending": []}
        port_snap, jax_snap = _both_nodes(spec)
        assert sorted(port_snap.nodes()) == sorted(jax_snap.nodes()) == [
            "hybrid-0", "mps-0"]
        state = fleet.build_cluster(spec)
        odd = factory.make_gpu_node("no-count", gpus=8)
        del odd.metadata.labels[C.LABEL_GPU_COUNT]
        state.update_node(odd)
        state.update_node(factory.make_gpu_node(
            "unknown", extra_labels={C.LABEL_ACCELERATOR: "nvidia-a100"}))
        snap = ts.TimeshareSnapshotTaker().take_snapshot(
            state, exclude={"mps-0"})
        assert sorted(snap.nodes()) == ["hybrid-0"]

    def test_calculators_match_jax(self):
        rng = np.random.default_rng(11)
        for _ in range(30):
            req = {int(gb): int(rng.integers(0, 3))
                   for gb in rng.choice(SHARES, size=3, replace=False)}
            pod = factory.make_pod(resources={
                f"{C.RESOURCE_TIMESHARE_PREFIX}{gb}gb": q
                for gb, q in req.items()} | {"cpu": 2.0})
            jpod = jax_factory.make_pod(resources={
                f"{JC.RESOURCE_TIMESHARE_PREFIX}{gb}gb": q
                for gb, q in req.items()} | {"cpu": 2.0})
            assert ts.TimeshareProfileCalculator().requested_profiles(pod) \
                == jax_ts.TimeshareProfileCalculator().requested_profiles(jpod)
            res = {f"{C.RESOURCE_TIMESHARE_PREFIX}{gb}gb": float(q)
                   for gb, q in req.items()} | {"memory": 3.0}
            assert ts.TimeshareProfileFilter().extract_profiles(res) == \
                jax_ts.TimeshareProfileFilter().extract_profiles(
                    {jax_resource(k): v for k, v in res.items()})


def port_resource(resource: str) -> str:
    if resource == JC.RESOURCE_TPU:
        return C.RESOURCE_GPU
    if resource.startswith(JC.RESOURCE_TIMESHARE_PREFIX):
        return C.RESOURCE_TIMESHARE_PREFIX + \
            resource[len(JC.RESOURCE_TIMESHARE_PREFIX):]
    return resource


class TestHybridSplit:
    @pytest.mark.parametrize("gpus", [1, 2, 3, 4, 8])
    def test_split_matches_the_jax_block_split(self, gpus):
        """A node of ``gpus`` GPUs against a 1 x ``gpus`` host block:
        the MPS family owns the GPUs the timeshare family owns."""
        import dataclasses

        from nos_tpu.topology.hybrid import timeshare_cells

        gen = dataclasses.replace(JAX_GEN,
                                  host_block=Shape.parse(f"1x{gpus}"))
        for kind in (C.HYBRID_KIND, C.MPS_KIND, C.MIG_KIND):
            assert hybrid.timeshare_gpus({C.LABEL_PARTITIONING: kind},
                                         gpus) == timeshare_cells(
                {JC.LABEL_PARTITIONING: JAX_KIND[kind]}, gen)


# ---------------------------------------------------------------------------
# The partitioner: the device plugin's ConfigMap and the node's label
# ---------------------------------------------------------------------------


def _random_partitionings(rng):
    units, jax_units = [], []
    for i in range(int(rng.integers(1, 9))):
        shares = {int(gb): int(rng.integers(0, 4))
                  for gb in rng.choice(SHARES, size=2, replace=False)}
        units.append(UnitPartitioning(i, {
            f"{C.RESOURCE_TIMESHARE_PREFIX}{gb}gb": q
            for gb, q in shares.items()}))
        jax_units.append(jax_state.UnitPartitioning(i, {
            f"{JC.RESOURCE_TIMESHARE_PREFIX}{gb}gb": q
            for gb, q in shares.items()}))
    return NodePartitioning(units), jax_state.NodePartitioning(jax_units)


class TestPartitioner:
    @pytest.mark.parametrize("seed", range(4))
    def test_plugin_config_matches_jax(self, seed):
        rng = np.random.default_rng(500 + seed)
        for _ in range(10):
            port, jax = _random_partitionings(rng)
            assert port_config_table(ts.to_plugin_config(port)) == \
                jax_config_table(jax_ts.to_plugin_config(jax))

    def test_the_config_renames_the_gpu_resource(self):
        config = ts.to_plugin_config(NodePartitioning([UnitPartitioning(
            0, {f"{C.RESOURCE_TIMESHARE_PREFIX}24gb": 3})]))
        assert config == {"version": "v1", "sharing": {"mps": {
            "failRequestsGreaterThanOne": True, "resources": [{
                "name": "nvidia.com/gpu", "rename": "nvidia.com/gpu-24gb",
                "memoryGB": 24, "replicas": 3, "devices": ["0"]}]}}}

    def test_config_keys(self):
        for node, plan in (("gpu-a", "abc123"), ("gpu-a.example.com", "p")):
            key = ts.config_key(node, plan)
            assert key == jax_ts.config_key(node, plan)
            assert ts.plan_id_from_key(node, key) == plan
        assert not ts.key_belongs_to_node("gpu-a", "gpu-a-2.p")
        assert ts.plan_id_from_key("gpu-a", "gpu-a-2.p") == ""

    def test_apply_writes_what_the_jax_partitioner_writes(self):
        rng = np.random.default_rng(9)
        from nos_tpu.kube.client import APIServer as JaxAPIServer

        api, jax_api = APIServer(), JaxAPIServer()
        for name in ("gpu-a", "gpu-b"):
            api.create(KIND_NODE, factory.make_gpu_node(name))
            jax_api.create("Node", jax_factory.make_tpu_node(
                name, generation=JAX_GEN, partitioning="timeshare"))
        part = ts.TimesharePartitioner(api)
        jax_part = jax_ts.TimesharePartitioner(jax_api)
        for step, (node, plan) in enumerate((("gpu-a", "p1"), ("gpu-b", "p2"),
                                             ("gpu-a", "p3"))):
            port_np, jax_np = _random_partitionings(rng)
            part.apply_partitioning(node, plan, port_np)
            jax_part.apply_partitioning(node, plan, jax_np)
            cm = api.get(KIND_CONFIGMAP, ts.DEVICE_PLUGIN_CM_NAME,
                         ts.DEVICE_PLUGIN_CM_NAMESPACE)
            jax_cm = jax_api.get("ConfigMap", jax_ts.DEVICE_PLUGIN_CM_NAME,
                                 jax_ts.DEVICE_PLUGIN_CM_NAMESPACE)
            assert sorted(cm.data) == sorted(jax_cm.data)
            for k in cm.data:
                assert port_config_table(json.loads(cm.data[k])) == \
                    jax_config_table(json.loads(jax_cm.data[k]))
            for name in ("gpu-a", "gpu-b"):
                n, jn = api.get(KIND_NODE, name), jax_api.get("Node", name)
                assert n.metadata.annotations == {
                    port_key(k): v for k, v in jn.metadata.annotations.items()}
                assert n.metadata.labels.get(C.LABEL_DEVICE_PLUGIN_CONFIG) \
                    == jn.metadata.labels.get(JC.LABEL_DEVICE_PLUGIN_CONFIG)
        # one key per node: gpu-a's p1 went when p3 came
        assert sorted(cm.data) == ["gpu-a.p3", "gpu-b.p2"]

    def test_the_plan_label_is_not_nvidias(self):
        """The plan id goes under the port's own label, which the port's
        timeshare plugin reads; NVIDIA's device plugin reads its label
        as a ConfigMap key, so the port must not write that one."""
        api = APIServer()
        api.create(KIND_NODE, factory.make_gpu_node("gpu-a"))
        port_np, _ = _random_partitionings(np.random.default_rng(3))
        ts.TimesharePartitioner(api).apply_partitioning("gpu-a", "p1", port_np)
        labels = api.get(KIND_NODE, "gpu-a").metadata.labels
        assert C.LABEL_DEVICE_PLUGIN_CONFIG == "nos.nebuly.com/device-plugin.config"
        assert labels[C.LABEL_DEVICE_PLUGIN_CONFIG] == "p1"
        assert "nvidia.com/device-plugin.config" not in labels


class TestNodeInfo:
    def test_add_remove_and_clone_match_jax(self):
        node = factory.make_gpu_node("n", status_geometry={
            0: {"free": {"24gb": 3}}})
        jnode = jax_node({"name": "n", "kind": C.MPS_KIND, "gpus": 8,
                          "status": {0: {"free": {"24gb": 3}}}})
        ni, jni = NodeInfo(node), JaxNodeInfo(jnode)
        pods = [factory.make_timeshare_pod(24, name=f"p{i}") for i in range(2)]
        jpods = [jax_factory.make_timeshare_pod(24, name=f"p{i}")
                 for i in range(2)]
        for p, jp in zip(pods, jpods):
            ni.add_pod(p)
            jni.add_pod(jp)
        c = ni.clone()
        assert ni.remove_pod(pods[0]) == jni.remove_pod(jpods[0]) is True
        assert ni.free() == {port_resource(k): v for k, v in jni.free().items()}
        assert len(c.pods) == 2 and c.node is not ni.node
