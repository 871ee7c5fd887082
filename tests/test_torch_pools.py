"""The port's plan pools (nos_tpu_torch/partitioning/core/pools.py) and
``ClusterSnapshot.subset`` against the JAX package's, on the same seeded
clusters.

JAX's side is the MPS stand-in of ``tests/test_torch_timeshare.py`` (an
80 GB TPU generation whose chip stands for one GPU), its nodes given
``nos.tpu/pod-id`` for the port's NVLink domain and ``nos.tpu/host-index``
for its host index.  The JAX package counts free capacity in chips (a
share or a whole chip 1 a unit), the port in sevenths of a GPU (7 a
unit), so a pool's free capacity and a pod's demand are 7 times JAX's
and every comparison the split makes between pools comes out the same.
Counterparts of ``tests/test_parallel_plan.py``'s TestPools, TestSubset
and TestTimeshareEligibility.
"""

from __future__ import annotations

import numpy as np
import pytest

import nos_tpu.api.constants as JC
import nos_tpu.partitioning.timeshare as jax_ts
from nos_tpu.partitioning.core import pools as jax_pools
from nos_tpu.partitioning.core.snapshot import SnapshotError as JaxSnapshotError
from nos_tpu.partitioning.state import ClusterState as JaxClusterState
from nos_tpu.testing import factory as jax_factory
from nos_tpu.topology import V5E
from nos_tpu.topology.known import TopologyRegistry

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.partitioning import timeshare as ts
from nos_tpu_torch.partitioning.core import (
    SnapshotError, partition_pools, split_pods,
)
from nos_tpu_torch.partitioning.slicepart import (
    SliceProfileCalculator, SliceSnapshotTaker,
)
from nos_tpu_torch.partitioning.state import ClusterState
from nos_tpu_torch.testing import factory, fleet
from nos_tpu_torch.topology.known import (
    H100_80GB, GpuModel, GpuModelRegistry,
)

from test_torch_timeshare import (
    JAX_GEN, JAX_REG, SHARES, _random_node_spec, jax_cluster,
)

DOMAINS = ("", "nvl-a", "nvl-b")
CALC = ts.TimeshareProfileCalculator()
JAX_CALC = jax_ts.TimeshareProfileCalculator()


def random_spec(seed: int, gangs: bool = True) -> dict:
    """6-10 MPS nodes of random reported shares over DOMAINS (each node's
    host index its order in its domain), one MIG node the MPS taker
    skips, and 10-40 pending pods of random shares: some pairs in gangs,
    one larger than any card."""
    rng = np.random.default_rng(seed)
    nodes, seen = [], {}
    for i in range(int(rng.integers(6, 11))):
        n = _random_node_spec(rng, f"gpu-{i:02d}")
        n["domain"] = str(rng.choice(DOMAINS))
        if n["domain"]:
            n["host_index"] = seen.get(n["domain"], 0)
            seen[n["domain"]] = n["host_index"] + 1
        nodes.append(n)
    nodes.append(_random_node_spec(rng, "mig-0", C.MIG_KIND))
    pending = []
    for i in range(int(rng.integers(10, 41))):
        p = {"name": f"p{i:02d}", "gb": int(rng.choice(SHARES)),
             "qty": int(rng.choice([1, 1, 1, 2])),
             "priority": int(rng.integers(0, 3)),
             "created": float(rng.integers(0, 100)), "gang": ""}
        pending.append(p)
        if gangs and rng.random() < 0.2:
            pending.append(p | {"name": f"p{i:02d}-mate"})
            p["gang"] = pending[-1]["gang"] = f"g{i}"
    pending.append({"name": "too-big", "gb": 96, "qty": 1, "priority": 2,
                    "created": 0.0, "gang": ""})
    return {"nodes": nodes, "pending": pending}


def label_jax_domains(state, spec: dict):
    """The spec's domains and host indices on a JAX cluster's nodes."""
    nodes = state.nodes()
    for n in spec["nodes"]:
        labels = nodes[n["name"]].metadata.labels
        if n.get("domain"):
            labels[JC.LABEL_POD_ID] = n["domain"]
        else:
            labels.pop(JC.LABEL_POD_ID, None)
        if n.get("host_index") is not None:
            labels[JC.LABEL_HOST_INDEX] = str(n["host_index"])
        else:
            labels.pop(JC.LABEL_HOST_INDEX, None)
    return state


def port_pending(spec: dict) -> list:
    return [factory.make_timeshare_pod(
        p["gb"], p["qty"], name=p["name"], priority=p["priority"],
        creation_timestamp=p["created"],
        labels={C.LABEL_POD_GROUP: p["gang"]} if p.get("gang") else None)
        for p in spec["pending"]]


def jax_pending(spec: dict) -> list:
    return [jax_factory.make_timeshare_pod(
        p["gb"], p["qty"], name=p["name"], priority=p["priority"],
        creation_timestamp=p["created"],
        labels={JC.LABEL_POD_GROUP: p["gang"]} if p.get("gang") else None)
        for p in spec["pending"]]


def snapshots(spec: dict):
    snap = ts.TimeshareSnapshotTaker().take_snapshot(
        fleet.build_cluster(spec))
    jsnap = jax_ts.TimeshareSnapshotTaker(JAX_REG).take_snapshot(
        label_jax_domains(jax_cluster(spec), spec))
    return snap, jsnap


def pool_rows(pools, scale: float = 1.0) -> list:
    """(domain, nodes, free, per-node MIG free) of each pool, in order;
    ``scale`` takes JAX's chips to sevenths."""
    return [(p.domain, p.nodes,
             scale * (p.free_chips if hasattr(p, "free_chips")
                      else p.free_sevenths),
             tuple(scale * f for f in p.node_slice_free)) for p in pools]


def split_rows(pools, by_pool: dict, infeasible: list) -> tuple:
    return ({p.domain: [q.metadata.name for q in by_pool[p.key]]
             for p in pools}, [q.metadata.name for q in infeasible])


# ---------------------------------------------------------------------------
# TestPools
# ---------------------------------------------------------------------------


class TestPools:
    @pytest.mark.parametrize("seed", range(10))
    def test_pools_and_split_are_jax_s(self, seed):
        spec = random_spec(seed)
        snap, jsnap = snapshots(spec)
        pools, jpools = partition_pools(snap), jax_pools.partition_pools(jsnap)
        assert [p.key for p in pools] == sorted(p.key for p in pools)
        assert pool_rows(pools) == pool_rows(jpools, 7.0)
        assert {p.domain for p in pools} <= set(DOMAINS)
        got = split_pods(pools, port_pending(spec), CALC)
        want = jax_pools.split_pods(jpools, jax_pending(spec), JAX_CALC,
                                    JAX_REG)
        assert split_rows(pools, *got) == split_rows(jpools, *want)
        assert "too-big" in split_rows(pools, *got)[1]

    def test_split_is_deterministic(self):
        spec = random_spec(11)
        snap, _ = snapshots(spec)
        pools = partition_pools(snap)
        a = split_rows(pools, *split_pods(pools, port_pending(spec), CALC))
        b = split_rows(pools, *split_pods(pools, port_pending(spec), CALC))
        assert a == b
        assigned = [n for names in a[0].values() for n in names]
        assert len(assigned) == len(set(assigned)) == \
            len(spec["pending"]) - len(a[1])

    def test_split_keeps_gangs_atomic(self):
        """A gang's members land in one pool, interleaved with singles
        that would have scattered them pod by pod."""
        spec = {"nodes": [
            {"name": f"n{d}{h}", "kind": C.MPS_KIND, "gpus": 8,
             "status": {g: {"free": {"80gb": 1}} for g in range(8)},
             "bound": [], "domain": f"nvl-{d}", "host_index": h}
            for d in range(2) for h in range(2)], "pending": []}
        for i, gang in enumerate(["big", "", "big", "", "big", "big"]):
            spec["pending"].append({"name": f"m{i}", "gb": 80, "qty": 1,
                                    "priority": 0, "created": 0.0,
                                    "gang": gang})
        snap, jsnap = snapshots(spec)
        pools, jpools = partition_pools(snap), jax_pools.partition_pools(jsnap)
        got = split_rows(pools, *split_pods(pools, port_pending(spec), CALC))
        want = split_rows(jpools, *jax_pools.split_pods(
            jpools, jax_pending(spec), JAX_CALC, JAX_REG))
        assert got == want
        homes = {d for d, names in got[0].items()
                 if {"m0", "m2", "m4", "m5"} & set(names)}
        assert len(homes) == 1

    def test_split_spreads_by_remaining_capacity(self):
        spec = {"nodes": [
            {"name": f"n{d}{h}", "kind": C.MPS_KIND, "gpus": 8,
             "status": {g: {"free": {"80gb": 1}} for g in range(8)},
             "bound": [], "domain": f"nvl-{d}", "host_index": h}
            for d in range(2) for h in range(2)],
            "pending": [{"name": f"s{i}", "gb": 80, "qty": 8, "priority": 0,
                         "created": 0.0} for i in range(4)]}
        snap, jsnap = snapshots(spec)
        pools, jpools = partition_pools(snap), jax_pools.partition_pools(jsnap)
        got = split_rows(pools, *split_pods(pools, port_pending(spec), CALC))
        want = split_rows(jpools, *jax_pools.split_pods(
            jpools, jax_pending(spec), JAX_CALC, JAX_REG))
        assert got == want
        assert sorted(len(v) for v in got[0].values()) == [2, 2]


class TestMigPools:
    """The MIG family has no exact JAX stand-in for the split's capacity
    screen (a 2x4 host block weighs 8 chips, a 7g.80gb 7 sevenths), so
    the port's rules are held to what they state."""

    def _snap(self, nodes):
        state = ClusterState()
        for name, domain, free in nodes:
            state.update_node(factory.make_gpu_node(
                name, partitioning=C.MIG_KIND, gpus=1, domain=domain,
                status_geometry={0: {"free": free}} if free else None), [])
        return SliceSnapshotTaker().take_snapshot(state)

    def test_split_demotes_a_fragmented_pool(self):
        """A pool where no node has a 7g.80gb's seven slices free in MIG
        instances is demoted for it; a 1g.10gb still goes to the freest
        pool."""
        snap = self._snap([(f"frag{h}", "nvl-0", {"1g.10gb": 3})
                           for h in range(4)]
                          + [("whole", "nvl-1", {"7g.80gb": 1})])
        pools = partition_pools(snap)
        assert pools[0].free_sevenths > pools[1].free_sevenths
        assert pools[0].max_node_slice_free == 3.0
        calc = SliceProfileCalculator()
        by_pool, inf = split_pods(pools, [factory.make_mig_pod(
            "7g.80gb", name="w")], calc)
        assert not inf and by_pool[pools[1].key][0].metadata.name == "w"
        by_pool, _ = split_pods(pools, [factory.make_mig_pod(
            "1g.10gb", name="t")], calc)
        assert by_pool[pools[0].key][0].metadata.name == "t"

    def test_a_profile_off_the_card_s_table_is_infeasible(self):
        snap = self._snap([("a", "nvl-0", {"7g.80gb": 1}),
                           ("b", "nvl-1", {"7g.80gb": 1})])
        pools = partition_pools(snap)
        _, inf = split_pods(pools, [factory.make_mig_pod(
            "5g.50gb", name="x")], SliceProfileCalculator())
        assert [p.metadata.name for p in inf] == ["x"]


# ---------------------------------------------------------------------------
# TestSubset
# ---------------------------------------------------------------------------


class TestSubset:
    def test_subset_shares_objects_but_isolates_forks(self):
        snap, jsnap = snapshots(random_spec(3))
        for s in (snap, jsnap):
            names = sorted(n for n in s.nodes())[:3]
            sub = s.subset(names)
            assert sub.get_node(names[0]) is s.get_node(names[0])
            sub.fork()
            sub.get_node_for_write(names[0]).update_geometry_for({"10gb": 8})
            assert sub.get_node(names[0]) is not s.get_node(names[0])
            sub.revert()
            assert sub.get_node(names[0]) is s.get_node(names[0])
            assert sorted(sub.nodes()) == names

    @pytest.mark.parametrize("jax", [False, True])
    def test_subset_rejects_unknown_and_forked(self, jax):
        snap, jsnap = snapshots(random_spec(4))
        s, err = (jsnap, JaxSnapshotError) if jax else (snap, SnapshotError)
        with pytest.raises(err):
            s.subset(["nope"])
        s.fork()
        with pytest.raises(err):
            s.subset(sorted(s.nodes())[:1])


# ---------------------------------------------------------------------------
# TestTimeshareEligibility
# ---------------------------------------------------------------------------

SMALL = GpuModel(name="test-gpu-16gb", product_patterns=(r"TEST16",),
                 memory_gb=16, sm_count=1)


class TestTimeshareEligibility:
    def test_a_share_skips_a_model_with_too_little_memory(self):
        """A share larger than one card of a model never lands on that
        model's pools, even when they are freer (JAX: a generation's
        per-chip HBM); one no card holds is infeasible everywhere."""
        registry = GpuModelRegistry()
        registry.models[SMALL.name] = SMALL
        state = ClusterState()
        for h in range(4):          # the small cards' pool: freer
            state.update_node(factory.make_gpu_node(
                f"e{h}", model=SMALL, domain="pe", host_index=h,
                status_geometry={g: {"free": {"16gb": 1}}
                                 for g in range(8)}), [])
        state.update_node(factory.make_gpu_node(
            "p0", domain="pp", host_index=0, gpus=1,
            status_geometry={0: {"free": {"80gb": 1}}}), [])
        snap = ts.TimeshareSnapshotTaker(registry).take_snapshot(state)
        pools = partition_pools(snap)
        assert len(pools) == 2

        jreg = TopologyRegistry(generations={V5E.name: V5E,
                                             JAX_GEN.name: JAX_GEN})
        jstate = JaxClusterState()
        for h in range(4):
            jstate.update_node(jax_factory.make_tpu_node(
                f"e{h}", generation=V5E, partitioning="timeshare",
                pod_id="pe", host_index=h,
                status_geometry={"free": {"16gb": 8}}), [])
        jstate.update_node(jax_factory.make_tpu_node(
            "p0", generation=JAX_GEN, partitioning="timeshare",
            pod_id="pp", host_index=0,
            status_geometry={"free": {"80gb": 1}}), [])
        jsnap = jax_ts.TimeshareSnapshotTaker(jreg).take_snapshot(jstate)
        jpools = jax_pools.partition_pools(jsnap)

        for gb, where in ((30, ["pp"]), (8, ["pe"])):
            got = split_rows(pools, *split_pods(
                pools, [factory.make_timeshare_pod(gb, name="big")], CALC,
                registry))
            want = split_rows(jpools, *jax_pools.split_pods(
                jpools, [jax_factory.make_timeshare_pod(gb, name="big")],
                JAX_CALC, jreg))
            assert got == want
            assert [d for d, names in got[0].items() if names] == where
        _, inf = split_pods(pools, [factory.make_timeshare_pod(
            200, name="huge")], CALC, registry)
        assert [p.metadata.name for p in inf] == ["huge"]

    def test_an_unknown_model_is_eligible(self):
        state = ClusterState()
        node = factory.make_gpu_node("u0", domain="x",
                                     status_geometry={0: {"free": {"80gb": 1}}})
        node.metadata.labels[C.LABEL_ACCELERATOR] = "some-future-gpu"
        state.update_node(node, [])
        registry = GpuModelRegistry()
        registry.models["some-future-gpu"] = H100_80GB
        snap = ts.TimeshareSnapshotTaker(registry).take_snapshot(state)
        pools = partition_pools(snap)
        by_pool, inf = split_pods(pools, [factory.make_timeshare_pod(
            500, name="odd")], CALC, GpuModelRegistry())
        assert not inf and by_pool[pools[0].key][0].metadata.name == "odd"
