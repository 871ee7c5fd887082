"""The port's partitioning core (nos_tpu_torch/partitioning/core/:
snapshot, tracker, sorter, planner, actuator) driving its MPS strategy,
against the JAX package's core driving its timeshare strategy on the
same cluster and backlog, compared exactly: each node's and GPU's
geometry, the PartitioningState, which pods were placed where, what the
unplaced pods still lack, the rendered device-plugin config (plan id
masked), the node annotations the actuator writes, and the planner's
fork, commit and revert counts.  Both planners run without and with
their native Filter screens, each against the other's same mode, with
the same pipeline runs and screen fails as well.

Clusters come from specs in ``nos_tpu_torch/testing/fleet.py``'s format:
small random ones from numpy generators seeded 0-9 (2-4 nodes of 8 GPUs,
one of another kind, 10-40 pending pods), and the fleet itself (32 x 8
H100 80GB, 200 pods) at full size, seeds 0-2.  The JAX side and the
name mapping are ``test_torch_timeshare``'s.
"""

from __future__ import annotations

import fcntl
import json
import pathlib
import tempfile

import numpy as np
import pytest

import nos_tpu.partitioning.core as jax_core
import nos_tpu.partitioning.timeshare as jax_ts
from nos_tpu.kube.client import APIServer as JaxAPIServer
from nos_tpu.obs import trace as jax_trace
from nos_tpu.scheduler.framework import Framework as JaxFramework
from nos_tpu.testing import factory as jax_factory

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.kube.client import APIServer, KIND_CONFIGMAP, KIND_NODE
from nos_tpu_torch.obs import journal, trace
from nos_tpu_torch.partitioning import core, timeshare as ts
from nos_tpu_torch.partitioning.core.snapshot import SnapshotError
from nos_tpu_torch.partitioning.state import PartitioningState
from nos_tpu_torch.scheduler.framework import Framework
from nos_tpu_torch.testing import factory, fleet
from nos_tpu_torch.topology.profile import profile_sort_key

from test_torch_timeshare import (
    JAX_GEN, JAX_REG, SHARES, jax_cluster, jax_config_table, jax_pending,
    partitioning_rows, port_config_table, port_key,
)

SPAN_COUNTS = ("forks", "commits", "reverts")


def small_spec(seed: int) -> dict:
    """2-4 MPS or hybrid nodes of 8 GPUs with random reported shares, the
    bound pods that hold the used ones (and one bound since the last
    report), one MIG node the MPS taker must skip, and 10-40 pending
    pods of random shares, quantities, priorities and creation times,
    one of them larger than any card."""
    from test_torch_timeshare import _random_node_spec

    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(int(rng.integers(2, 5))):
        kind = C.HYBRID_KIND if i == 1 and seed % 2 == 0 else C.MPS_KIND
        nodes.append(_random_node_spec(rng, f"gpu-{i}", kind))
    nodes.append(_random_node_spec(rng, "mig-0", C.MIG_KIND))
    pending = []
    for i in range(int(rng.integers(10, 41))):
        pending.append({"name": f"p{i}", "gb": int(rng.choice(SHARES)),
                        "qty": int(rng.choice([1, 1, 1, 2])),
                        "priority": int(rng.integers(0, 3)),
                        "created": float(rng.integers(0, 100))})
    pending.append({"name": "too-big", "gb": 96, "qty": 1, "priority": 2,
                    "created": 0.0})
    return {"nodes": nodes, "pending": pending}


def _bound_names(spec) -> set[str]:
    return {b["name"] for n in spec["nodes"] for b in n["bound"]}


def _jax_summary(snapshot, pending, bound) -> dict:
    """fleet.plan_summary's JAX twin."""
    geometries, placed = {}, {}
    for name in sorted(snapshot.nodes()):
        node = snapshot.get_node(name)
        geometries[name] = {str(i): dict(sorted(g.items()))
                            for i, g in sorted(node.geometries().items())}
        names = sorted(p.metadata.name for p in node.node_info().pods
                       if p.metadata.name not in bound)
        if names:
            placed[name] = names
    done = {n for names in placed.values() for n in names}
    left = [p for p in pending if p.metadata.name not in done]
    lacking = jax_core.SliceTracker(
        snapshot, jax_ts.TimeshareProfileCalculator(), left).lacking
    return {"geometries": geometries, "placed": placed,
            "lacking": dict(sorted(lacking.items()))}


def _counts(ring) -> dict:
    (span,) = [s for s in ring.dump() if s["name"] == "planner.plan"]
    return span["counts"]


def port_plan(spec, native_prescreen: bool = True):
    """Take the snapshot, plan a clone of it (as the controller does),
    and return (snapshot, planned clone, desired state, span counts,
    summary)."""
    snap = ts.TimeshareSnapshotTaker().take_snapshot(fleet.build_cluster(spec))
    pending = fleet.build_pending(spec)
    planner = core.GeometryPlanner(
        Framework(), ts.TimeshareProfileCalculator(),
        ts.TimesharePartitionCalculator(), native_prescreen=native_prescreen)
    tracer = trace.Tracer()
    prev = trace.set_tracer(tracer)
    try:
        planned = snap.clone()
        desired = planner.plan(planned, pending)
    finally:
        trace.set_tracer(prev)
    summary = fleet.plan_summary(planned, pending, _bound_names(spec))
    return snap, planned, desired, _counts(tracer.ring), summary


def jax_plan(spec, native_prescreen: bool):
    snap = jax_ts.TimeshareSnapshotTaker(JAX_REG).take_snapshot(
        jax_cluster(spec))
    pending = jax_pending(spec)
    planner = jax_core.GeometryPlanner(
        JaxFramework(), jax_ts.TimeshareProfileCalculator(),
        jax_ts.TimesharePartitionCalculator(),
        native_prescreen=native_prescreen)
    tracer = jax_trace.Tracer()
    prev = jax_trace.set_tracer(tracer)
    try:
        planned = snap.clone()
        desired = planner.plan(planned, pending)
    finally:
        jax_trace.set_tracer(prev)
    summary = _jax_summary(planned, pending, _bound_names(spec))
    return snap, planned, desired, _counts(tracer.ring), summary, planner


def assert_same_plan(spec):
    """The port's plan with and without its native screen against JAX's
    with and without its own: the same decisions, and the same pipeline
    runs and screen fails (an MPS share holds no MIG slice and no TPU
    chip, so both screens fail a class on its shares alone)."""
    for native in (False, True):
        _, _, desired, counts, summary = port_plan(spec, native)
        _, _, jdesired, jcounts, jsummary, jplanner = jax_plan(spec, native)
        assert (jplanner._prescreen is not None) == native
        assert summary == jsummary, native
        assert partitioning_rows(desired) == partitioning_rows(jdesired)
        keys = SPAN_COUNTS + ("filter_runs", "prefilter_runs",
                              "prescreen_fails")
        assert {k: counts.get(k, 0) for k in keys} == \
            {k: jcounts.get(k, 0) for k in keys}, native
    return summary, counts


def build_jax_shim(monkeypatch) -> bool:
    """Whether the JAX package's native shim is loaded, building it once
    more when it is not.  At collection every xdist worker runs the
    shim's ``make`` at once (``tests/test_native.py``'s skip marker), and
    the Makefile has each compile to the same ``.tmp`` name and move it:
    a worker whose file was moved away latches the shim as failed for
    the rest of its run.  The latch is cleared here for this test only,
    and the one retry builds under an exclusive lock on a file in the
    temp directory."""
    from nos_tpu.device import native

    if native.fit_batch_available():
        return True
    monkeypatch.setattr(native, "_lib_failed", False)
    monkeypatch.setattr(native, "_lib", None)
    lock = pathlib.Path(tempfile.gettempdir(), "nos_tpu_shim_build.lock")
    with open(lock, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            native.available()
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
    return native.fit_batch_available()


class TestPlannerParity:
    @pytest.fixture(autouse=True)
    def jax_shim(self, monkeypatch):
        # JAX's screen must run for its half of the parity to count
        assert build_jax_shim(monkeypatch), \
            "the JAX package's native shim did not build"

    @pytest.mark.parametrize("seed", range(10))
    def test_small_clusters(self, seed):
        spec = small_spec(seed)
        summary, counts = assert_same_plan(spec)
        # the pod larger than any card is never placed and stays lacking
        assert not any("too-big" in v for v in summary["placed"].values())
        assert summary["lacking"].get("96gb") == 1
        # no used share of the snapshot disappears
        snap, planned, *_ = port_plan(spec)
        for name in snap.nodes():
            before = {u.index: u.used for u in snap.get_node(name).units}
            for u in planned.get_node(name).units:
                assert all(u.geometry_names().get(f"{gb}gb", 0) >= c
                           for gb, c in before[u.index].items())
                assert u.used_gb + sum(gb * c for gb, c in u.free.items()) <= 80

    @pytest.mark.parametrize("seed", range(3))
    def test_the_fleet_at_full_size(self, seed):
        spec = fleet.fleet_spec(seed)
        assert len(spec["nodes"]) == 32 and len(spec["pending"]) == 200
        summary, counts = assert_same_plan(spec)
        assert counts["forks"] >= 1 and not summary["lacking"]
        if seed == 0:
            assert fleet.plan_digest(summary) == fleet.FLEET_DIGEST

    def test_the_fleet_digest_is_the_jax_plans(self):
        spec = fleet.fleet_spec(0)
        *_, jsummary, _ = jax_plan(spec, native_prescreen=False)
        assert fleet.plan_digest(jsummary) == fleet.FLEET_DIGEST

    def test_the_native_prescreen_ran(self, monkeypatch):
        if not build_jax_shim(monkeypatch):
            pytest.fail("the JAX package's native shim did not build: the "
                        "prescreen half of the parity is vacuous")
        *_, jcounts, _, jplanner = jax_plan(fleet.fleet_spec(0), True)
        assert jplanner._prescreen is not None
        assert jcounts.get("prescreen_fails", 0) > 0

    def test_plans_repeat(self):
        spec = small_spec(3)
        assert port_plan(spec)[4] == port_plan(spec)[4]


class TestSorterAndTracker:
    def test_profile_sort_key_orders_shares_as_jax(self):
        from nos_tpu.topology.profile import profile_sort_key as jax_key

        profiles = [f"{gb}gb" for gb in (80, 5, 10, 24, 8, 40, 16, 20, 96)]
        assert [profile_sort_key(p) for p in profiles] == \
            [jax_key(p) for p in profiles]
        assert sorted(profiles, key=profile_sort_key) == \
            sorted(profiles, key=jax_key)
        # a MIG profile sorts by its memory, among the shares
        assert sorted(["40gb", "1g.10gb", "3g.40gb", "24gb"],
                      key=profile_sort_key) == \
            ["1g.10gb", "24gb", "3g.40gb", "40gb"]

    @pytest.mark.parametrize("seed", range(3))
    def test_sorter_matches_jax(self, seed):
        spec = small_spec(20 + seed)
        port = core.ProfileAwareSorter(ts.TimeshareProfileCalculator()).sort(
            fleet.build_pending(spec))
        jax = jax_core.ProfileAwareSorter(
            jax_ts.TimeshareProfileCalculator()).sort(jax_pending(spec))
        assert [p.metadata.name for p in port] == \
            [p.metadata.name for p in jax]

    @pytest.mark.parametrize("seed", range(3))
    def test_tracker_matches_jax(self, seed):
        spec = small_spec(30 + seed)
        snap = ts.TimeshareSnapshotTaker().take_snapshot(
            fleet.build_cluster(spec))
        jsnap = jax_ts.TimeshareSnapshotTaker(JAX_REG).take_snapshot(
            jax_cluster(spec))
        pods, jpods = fleet.build_pending(spec), jax_pending(spec)
        t = core.SliceTracker(snap, ts.TimeshareProfileCalculator(), pods)
        jt = jax_core.SliceTracker(jsnap, jax_ts.TimeshareProfileCalculator(),
                                   jpods)
        assert t.requested == jt.requested and t.lacking == jt.lacking
        for p, jp in zip(pods[::2], jpods[::2]):
            t.remove(p)
            jt.remove(jp)
            assert t.lacking == jt.lacking and t.empty == jt.empty


class TestSnapshot:
    def test_candidate_order_counts_a_share_not_its_gb(self):
        # one free 80gb share against four free 10gb ones: by GB the
        # first has more free, per share the second
        state = fleet.build_cluster({"nodes": [
            {"name": "a", "kind": C.MPS_KIND, "gpus": 1,
             "status": {0: {"free": {"80gb": 1}}}, "bound": []},
            {"name": "b", "kind": C.MPS_KIND, "gpus": 1,
             "status": {0: {"free": {"10gb": 4}}}, "bound": []}],
            "pending": []})
        snap = ts.TimeshareSnapshotTaker().take_snapshot(state)
        assert [n.name for n in snap.get_candidate_nodes()] == ["a", "b"]

    @pytest.mark.parametrize("seed", range(3))
    def test_candidate_order_and_lacking_match_jax(self, seed):
        spec = small_spec(40 + seed)
        state, jstate = fleet.build_cluster(spec), jax_cluster(spec)
        snap = ts.TimeshareSnapshotTaker().take_snapshot(state)
        jsnap = jax_ts.TimeshareSnapshotTaker(JAX_REG).take_snapshot(jstate)
        order = [n.name for n in snap.get_candidate_nodes()]
        assert order == [n.name for n in jsnap.get_candidate_nodes()]
        for p, jp in zip(fleet.build_pending(spec), jax_pending(spec)):
            assert snap.get_lacking_slices(p) == jsnap.get_lacking_slices(jp)

    @pytest.mark.parametrize("seed", range(3))
    def test_the_candidate_memo_follows_writes_as_jax(self, seed):
        """Re-carving the first candidates inside a fork reorders the
        candidates on both sides; the revert restores the first
        order."""
        spec = small_spec(60 + seed)
        snap = ts.TimeshareSnapshotTaker().take_snapshot(
            fleet.build_cluster(spec))
        jsnap = jax_ts.TimeshareSnapshotTaker(JAX_REG).take_snapshot(
            jax_cluster(spec))

        def order():
            names = [n.name for n in snap.get_candidate_nodes()]
            assert names == [n.name for n in jsnap.get_candidate_nodes()]
            return names

        before = order()
        snap.fork()
        jsnap.fork()
        rng = np.random.default_rng(seed)
        for name in before[:2]:
            lacking = {f"{int(gb)}gb": int(rng.integers(1, 9))
                       for gb in rng.choice(SHARES, size=2, replace=False)}
            assert snap.get_node_for_write(name).update_geometry_for(
                lacking) == jsnap.get_node_for_write(
                    name).update_geometry_for(lacking)
            order()
        snap.revert()
        jsnap.revert()
        assert order() == before

    def test_fork_commit_revert(self):
        snap = ts.TimeshareSnapshotTaker().take_snapshot(
            fleet.build_cluster(small_spec(1)))
        name = sorted(snap.nodes())[0]
        before = snap.get_node(name).geometries()
        snap.fork()
        with pytest.raises(SnapshotError):
            snap.fork()
        with pytest.raises(SnapshotError):
            snap.clone()
        node = snap.get_node_for_write(name)
        assert node.update_geometry_for({"5gb": 16})
        assert snap.cow_clones == 1
        snap.revert()
        assert snap.get_node(name).geometries() == before
        with pytest.raises(SnapshotError):
            snap.revert()
        snap.fork()
        snap.get_node_for_write(name).update_geometry_for({"5gb": 16})
        snap.commit()
        assert snap.get_node(name).geometries() != before
        with pytest.raises(SnapshotError):
            snap.add_pod(name, factory.make_timeshare_pod(96))
        with pytest.raises(SnapshotError):
            snap.get_node_for_write("nope")

    def test_the_lister_follows_forks(self):
        snap = ts.TimeshareSnapshotTaker().take_snapshot(
            fleet.build_cluster(small_spec(2)))
        lister = snap.shared_lister()
        name = sorted(snap.nodes())[0]
        original = lister.get(name)
        snap.fork()
        snap.get_node_for_write(name)
        assert lister.get(name) is snap.get_node(name).node_info()
        assert lister.get(name) is not original
        snap.revert()
        assert lister.get(name) is original
        assert len(lister.list()) == len(snap.nodes())


def _mask(text: str, plan_id: str) -> str:
    return text.replace(plan_id, "PLAN") if plan_id else text


class TestActuatorParity:
    def _apis(self, spec, missing=()):
        """The cluster's nodes on a port and a JAX API server; the nodes
        named in ``missing`` are left off the port's."""
        api, jax_api = APIServer(), JaxAPIServer()
        port_state, jax_state = fleet.build_cluster(spec), jax_cluster(spec)
        for node in port_state.nodes().values():
            if node.metadata.name not in missing:
                api.create(KIND_NODE, node)
        for node in jax_state.nodes().values():
            jax_api.create("Node", node)
        return api, jax_api

    @pytest.mark.parametrize("seed", range(4))
    def test_apply_writes_what_jax_writes(self, seed):
        spec = small_spec(50 + seed)
        api, jax_api = self._apis(spec)
        snap, _, desired, _, _ = port_plan(spec)
        jsnap, _, jdesired, _, _, _ = jax_plan(spec, True)
        actuator = core.GeometryActuator(
            ts.TimesharePartitioner(api), ts.TimesharePartitionCalculator(),
            core.QuarantineList(C.MPS_KIND))
        jactuator = jax_core.GeometryActuator(
            jax_ts.TimesharePartitioner(jax_api),
            jax_ts.TimesharePartitionCalculator(), kind="timeshare")
        assert actuator.apply(snap, desired) == jactuator.apply(jsnap, jdesired)
        cms = api.list(KIND_CONFIGMAP)
        jcms = jax_api.list("ConfigMap")
        assert len(cms) == len(jcms) <= 1
        if not cms:
            return
        plan = next(iter(cms[0].data)).rsplit(".", 1)[1]
        jplan = next(iter(jcms[0].data)).rsplit(".", 1)[1]
        data = {_mask(k, plan): port_config_table(json.loads(v))
                for k, v in cms[0].data.items()}
        jdata = {_mask(k, jplan): jax_config_table(json.loads(v))
                 for k, v in jcms[0].data.items()}
        assert data == jdata
        for node in api.list(KIND_NODE):
            jnode = jax_api.get("Node", node.name)
            assert {k: _mask(v, plan)
                    for k, v in node.metadata.annotations.items()} == {
                port_key(k): _mask(v, jplan)
                for k, v in jnode.metadata.annotations.items()}
            assert {k: _mask(v, plan)
                    for k, v in node.metadata.labels.items()
                    if k == C.LABEL_DEVICE_PLUGIN_CONFIG} == {
                port_key(k): _mask(v, jplan)
                for k, v in jnode.metadata.labels.items()
                if k.endswith("device-plugin.config")}

    def test_nothing_to_do_writes_nothing(self):
        spec = small_spec(0)
        api, _ = self._apis(spec)
        snap = ts.TimeshareSnapshotTaker().take_snapshot(
            fleet.build_cluster(spec))
        actuator = core.GeometryActuator(
            ts.TimesharePartitioner(api), ts.TimesharePartitionCalculator(),
            core.QuarantineList(C.MPS_KIND))
        assert not actuator.apply(snap, PartitioningState())
        assert not actuator.apply(snap, actuator.current_state(snap))
        assert api.list(KIND_CONFIGMAP) == []

    def test_a_failing_node_does_not_stop_the_others(self):
        from nos_tpu_torch.exporter.metrics import REGISTRY

        spec = fleet.fleet_spec(0)
        snap, planned, desired, _, _ = port_plan(spec)
        # the first re-carved node is missing from the API server
        api, _ = self._apis(spec, missing=("gpu-node-16",))
        j = journal.DecisionJournal()
        prev = journal.set_journal(j)
        labels = {"kind": C.MPS_KIND}
        before = REGISTRY.value("nos_tpu_actuation_failures_total",
                                labels) or 0
        try:
            actuator = core.GeometryActuator(
                ts.TimesharePartitioner(api),
                ts.TimesharePartitionCalculator(),
                core.QuarantineList(C.MPS_KIND))
            assert actuator.apply(snap, desired)
        finally:
            journal.set_journal(prev)
        assert REGISTRY.value("nos_tpu_actuation_failures_total",
                              labels) == before + 1
        assert [r.subject for r in j.events(journal.ACTUATION_FAILED)] == \
            ["gpu-node-16"]
        actuated = [r.subject for r in j.events(journal.NODE_ACTUATED)]
        assert actuated == [f"gpu-node-{i}" for i in range(17, 22)]
        # the ConfigMap is written before the node, as in the JAX
        # partitioner: the missing node's key is there, its label not
        (cm,) = api.list(KIND_CONFIGMAP)
        assert sorted(k.rsplit(".", 1)[0] for k in cm.data) == \
            ["gpu-node-16"] + actuated


class TestCardNode:
    """The smoke run's part (b): one GPU, four 24 GB pods."""

    def test_three_of_four_24gb_pods_fit_an_80gb_card(self):
        state = fleet.build_cluster({"nodes": [
            {"name": "card", "kind": C.MPS_KIND, "gpus": 1, "status": {},
             "bound": []}], "pending": []})
        pods = [factory.make_timeshare_pod(24, name=f"pod-{i}")
                for i in range(4)]
        snap = ts.TimeshareSnapshotTaker().take_snapshot(state)
        planner = core.GeometryPlanner(
            Framework(), ts.TimeshareProfileCalculator(),
            ts.TimesharePartitionCalculator())
        desired = planner.plan(snap.clone(), pods)
        api = APIServer()
        for node in state.nodes().values():
            api.create(KIND_NODE, node)
        assert core.GeometryActuator(
            ts.TimesharePartitioner(api), ts.TimesharePartitionCalculator(),
            core.QuarantineList(C.MPS_KIND)).apply(snap, desired)
        (cm,) = api.list(KIND_CONFIGMAP)
        (key,) = cm.data
        assert port_config_table(json.loads(cm.data[key])) == \
            {"0": {"24gb": 3}}
        node = api.get(KIND_NODE, "card")
        assert ts.config_key("card", node.metadata.labels[
            C.LABEL_DEVICE_PLUGIN_CONFIG]) == key

        jstate = jax_cluster({"nodes": [
            {"name": "card", "kind": C.MPS_KIND, "gpus": 8, "status": {},
             "bound": []}], "pending": []})
        jpods = [jax_factory.make_timeshare_pod(24, name=f"pod-{i}")
                 for i in range(4)]
        jsnap = jax_ts.TimeshareSnapshotTaker(JAX_REG).take_snapshot(jstate)
        jax_core.GeometryPlanner(
            JaxFramework(), jax_ts.TimeshareProfileCalculator(),
            jax_ts.TimesharePartitionCalculator()).plan(jsnap, jpods)
        # the JAX node has 8 chips: the first carries what the card does
        assert jsnap.get_node("card").geometries()[0] == {"24gb": 3}
        assert JAX_GEN.hbm_gb_per_chip == 80


class TestClusterState:
    @pytest.mark.parametrize("seed", range(3))
    def test_bookkeeping_matches_jax(self, seed):
        import nos_tpu.partitioning.state as jax_state
        from test_torch_timeshare import JAX_KIND, jax_node, port_resource

        from nos_tpu_torch.partitioning.state import ClusterState

        rng = np.random.default_rng(60 + seed)
        state, jstate = ClusterState(), jax_state.ClusterState()
        kinds = (C.MPS_KIND, C.MIG_KIND, C.HYBRID_KIND)
        for _ in range(40):
            op = str(rng.choice(["node", "pod", "delete_pod", "delete_node"]))
            name = f"n{int(rng.integers(0, 4))}"
            pod_name = f"p{int(rng.integers(0, 6))}"
            if op == "node":
                kind = str(rng.choice(kinds))
                spec = {"name": name, "kind": kind, "gpus": 8, "status": {}}
                state.update_node(factory.make_gpu_node(
                    name, partitioning=kind))
                jstate.update_node(jax_node(spec))
            elif op == "pod":
                gb = int(rng.choice(SHARES))
                state.update_pod(factory.make_timeshare_pod(
                    gb, name=pod_name, node_name=name))
                jstate.update_pod(jax_factory.make_timeshare_pod(
                    gb, name=pod_name, node_name=name))
            elif op == "delete_pod":
                state.delete_pod(f"default/{pod_name}")
                jstate.delete_pod(f"default/{pod_name}")
            else:
                state.delete_node(name)
                jstate.delete_node(name)
            assert sorted(state.nodes()) == sorted(jstate.nodes())
            for n in state.nodes():
                assert sorted(p.key for p in state.pods_on(n)) == \
                    sorted(p.key for p in jstate.pods_on(n))
            for kind in kinds:
                assert state.is_partitioning_enabled(kind) == \
                    jstate.is_partitioning_enabled(JAX_KIND[kind])
        infos, jinfos = state.node_infos(), jstate.node_infos()
        for n, ni in infos.items():
            assert ni.requested == {port_resource(k): v for k, v in
                                    jinfos[n].requested.items()}
            ni.node.status.allocatable.clear()
            assert state.nodes()[n].status.allocatable  # a deep copy

    def test_partitioning_equality_matches_jax(self):
        import nos_tpu.partitioning.state as jax_state

        from nos_tpu_torch.partitioning.state import (
            NodePartitioning, UnitPartitioning)

        def both(rows):
            return (NodePartitioning([UnitPartitioning(i, dict(r))
                                      for i, r in rows]),
                    jax_state.NodePartitioning(
                        [jax_state.UnitPartitioning(i, dict(r))
                         for i, r in rows]))

        cases = [[(0, {"a": 1}), (1, {"b": 2})], [(1, {"b": 2}), (0, {"a": 1})],
                 [(0, {"a": 1, "z": 0}), (1, {"b": 2})], [(0, {"a": 2})],
                 [(0, {"a": 1}), (0, {"a": 1})], []]
        pairs = [both(c) for c in cases]
        for a, ja in pairs:
            for b, jb in pairs:
                assert (a == b) == (ja == jb)
                assert PartitioningState(x=a).equal(PartitioningState(x=b)) \
                    == jax_state.PartitioningState(x=ja).equal(
                        jax_state.PartitioningState(x=jb))
            assert PartitioningState(x=a).empty == \
                jax_state.PartitioningState(x=ja).empty


class TestShimRetry:
    """``build_jax_shim``, the prescreen test's retry."""

    def test_a_lost_build_race_is_built_again(self, monkeypatch):
        from nos_tpu.device import native

        # what a worker whose make lost the race holds: the latch set
        monkeypatch.setattr(native, "_lib_failed", True)
        monkeypatch.setattr(native, "_lib", None)
        assert not native.fit_batch_available()
        assert build_jax_shim(monkeypatch)

    def test_a_shim_that_cannot_build_still_fails(self, monkeypatch):
        from nos_tpu.device import native

        monkeypatch.setattr(native, "_lib_failed", True)
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "build_shim", lambda force=False: None)
        assert not build_jax_shim(monkeypatch)
