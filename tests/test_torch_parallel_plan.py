"""The port's ParallelGeometryPlanner (nos_tpu_torch/partitioning/core/
parallel.py) against the JAX package's, on the same seeded clusters, JAX
run with and without its native prescreen; counterparts of
``tests/test_parallel_plan.py``'s TestEquivalence, TestObservability and
TestShardFailure.

JAX's side is the MPS stand-in of ``tests/test_torch_pools.py``.  Each
case compares the desired state, node by node, and the planner's journal
(every committed or reverted node, then the merge record with its pools;
its wall time left out), JAX's kind "timeshare" and accelerator name
read as the port's.  The port's journal is the same at 1 and 4 workers.
The pool-sharded fleet plan of ``chip_smoke.py``'s recovery phase (a)
is JAX's too: ``PARALLEL_FLEET_DIGEST``.
"""

from __future__ import annotations

import numpy as np
import pytest

import nos_tpu.partitioning.core as jax_core
import nos_tpu.partitioning.timeshare as jax_ts
from nos_tpu.obs import journal as jax_journal
from nos_tpu.scheduler.framework import Framework as JaxFramework

import chip_smoke
from nos_tpu_torch.api import constants as C
from nos_tpu_torch.exporter.metrics import REGISTRY
from nos_tpu_torch.obs import journal as port_journal, trace
from nos_tpu_torch.partitioning import timeshare as ts
from nos_tpu_torch.partitioning.core import (
    GeometryPlanner, ParallelGeometryPlanner,
)
from nos_tpu_torch.scheduler.framework import Framework
from nos_tpu_torch.testing import fleet
from nos_tpu_torch.topology import H100_80GB

from test_torch_planner import build_jax_shim
from test_torch_pools import (
    jax_pending, label_jax_domains, port_pending, random_spec,
)
from test_torch_timeshare import JAX_GEN, JAX_REG, jax_cluster

PLANNER_RECORDS = (port_journal.PLAN_NODE_COMMITTED,
                   port_journal.PLAN_NODE_REVERTED,
                   port_journal.PLAN_SHARD_MERGED)


def port_value(value):
    """A JAX value in the port's names: the kind and the accelerator."""
    if isinstance(value, str):
        if value == "timeshare":
            return C.MPS_KIND
        return value.replace(JAX_GEN.name, H100_80GB.name)
    if isinstance(value, dict):
        return {k: port_value(v) for k, v in value.items()}
    if isinstance(value, list):
        return [port_value(v) for v in value]
    return value


def make_port_planner() -> GeometryPlanner:
    return GeometryPlanner(Framework(), ts.TimeshareProfileCalculator(),
                           ts.TimesharePartitionCalculator())


def port_parallel(**kw) -> ParallelGeometryPlanner:
    kw.setdefault("min_shard_hosts", 0)
    return ParallelGeometryPlanner(
        make_port_planner, ts.TimeshareProfileCalculator(), kind=C.MPS_KIND,
        **kw)


def jax_parallel(native: bool, **kw):
    kw.setdefault("min_shard_hosts", 0)

    def make():
        return jax_core.GeometryPlanner(
            JaxFramework(), jax_ts.TimeshareProfileCalculator(),
            jax_ts.TimesharePartitionCalculator(), native_prescreen=native)

    return jax_core.ParallelGeometryPlanner(
        make, jax_ts.TimeshareProfileCalculator(), kind="timeshare",
        registry=JAX_REG, **kw)


def port_run(spec: dict, planner) -> dict:
    journal = port_journal.DecisionJournal(maxlen=1 << 16)
    prev = port_journal.set_journal(journal)
    try:
        snap = ts.TimeshareSnapshotTaker().take_snapshot(
            fleet.build_cluster(spec))
        desired = planner.plan(snap, port_pending(spec))
    finally:
        port_journal.set_journal(prev)
    return fleet.parallel_plan_summary(desired, [
        (r.category, r.subject, r.attrs) for r in journal.events()
        if r.category in PLANNER_RECORDS])


def jax_run(spec: dict, planner) -> dict:
    journal = jax_journal.DecisionJournal(maxlen=1 << 16)
    prev = jax_journal.set_journal(journal)
    try:
        snap = jax_ts.TimeshareSnapshotTaker(JAX_REG).take_snapshot(
            label_jax_domains(jax_cluster(spec), spec))
        desired = planner.plan(snap, jax_pending(spec))
    finally:
        jax_journal.set_journal(prev)
    return port_value(fleet.parallel_plan_summary(desired, [
        (r.category, r.subject, r.attrs) for r in journal.events()
        if r.category in PLANNER_RECORDS]))


def single_pool(spec: dict) -> dict:
    for n in spec["nodes"]:
        n["domain"] = "nvl-0"
    return spec


class TestEquivalence:
    @pytest.mark.parametrize("seed", range(8))
    def test_single_pool_is_the_sequential_planner(self, seed):
        spec = single_pool(random_spec(100 + seed))
        planner = port_parallel()
        got = port_run(spec, planner)
        planner.close()
        assert got == port_run(spec, make_port_planner())
        assert not [r for r in got["journal"]
                    if r[0] == port_journal.PLAN_SHARD_MERGED]

    @pytest.mark.parametrize("seed", range(10))
    def test_multi_pool_plans_are_jax_s(self, seed):
        spec = random_spec(200 + seed)
        planner = port_parallel(max_workers=4)
        got = port_run(spec, planner)
        planner.close()
        for native in (False, True):
            jplanner = jax_parallel(native)
            assert jax_run(spec, jplanner) == got, native
            jplanner.close()
        merged = [r for r in got["journal"]
                  if r[0] == port_journal.PLAN_SHARD_MERGED]
        assert len(merged) == 1 or len({n.get("domain", "")
                                        for n in spec["nodes"][:-1]}) == 1

    @pytest.mark.parametrize("seed", range(4))
    def test_one_and_four_workers_journal_alike(self, seed):
        spec = random_spec(300 + seed)
        runs = []
        for workers in (1, 2, 4):
            planner = port_parallel(max_workers=workers)
            runs.append(port_run(spec, planner))
            planner.close()
        assert runs[0] == runs[1] == runs[2]

    def test_below_min_shard_hosts_stays_sequential(self):
        spec = random_spec(7)
        planner = port_parallel(min_shard_hosts=10_000)
        tracer = trace.Tracer()
        prev = trace.set_tracer(tracer)
        try:
            got = port_run(spec, planner)
        finally:
            trace.set_tracer(prev)
            planner.close()
        assert not [s for s in tracer.ring.dump()
                    if s["name"] == "plan_shard"]
        assert got == port_run(spec, make_port_planner())

    def test_the_fleet_digest_is_jax_s(self, monkeypatch):
        """chip_smoke's phase 13 (a): the MPS fleet in the gang fleet's
        domains, planned by both packages' parallel planners."""
        spec = fleet.domain_fleet_spec(0)
        spec["pending"] = [p | {"gang": ""} for p in spec["pending"]]
        planner = port_parallel(max_workers=2)
        got = port_run(spec, planner)
        planner.close()
        assert fleet.plan_digest(got) == chip_smoke.PARALLEL_FLEET_DIGEST
        native = build_jax_shim(monkeypatch)
        for prescreen in {False, native}:
            jplanner = jax_parallel(prescreen)
            assert jax_run(spec, jplanner) == got, prescreen
            jplanner.close()


class TestObservability:
    def test_shard_spans_journal_and_histogram(self):
        spec = random_spec(11)
        domains = {n.get("domain", "") for n in spec["nodes"]
                   if n["kind"] == C.MPS_KIND}
        tracer = trace.Tracer()
        journal = port_journal.DecisionJournal()
        prev_t, prev_j = trace.set_tracer(tracer), \
            port_journal.set_journal(journal)
        planner = port_parallel(max_workers=4)
        try:
            with trace.span("partitioner.plan_cycle", kind=C.MPS_KIND):
                snap = ts.TimeshareSnapshotTaker().take_snapshot(
                    fleet.build_cluster(spec))
                planner.plan(snap, port_pending(spec))
        finally:
            trace.set_tracer(prev_t)
            port_journal.set_journal(prev_j)
            planner.close()
        spans = tracer.ring.dump()
        shards = [s for s in spans if s["name"] == "plan_shard"]
        assert len(shards) == len(domains) > 1
        (root,) = [s for s in spans if s["name"] == "partitioner.plan_cycle"]
        assert all(s["trace_id"] == root["trace_id"] for s in shards)
        (merged,) = journal.events(port_journal.PLAN_SHARD_MERGED)
        assert merged.attrs["shards"] == len(domains)
        assert merged.trace_id == root["trace_id"]
        assert sorted(planner.last_shard_seconds) == \
            sorted(s["attrs"]["pool"] for s in shards)
        key = f"{H100_80GB.name}|{sorted(domains)[-1]}"
        assert REGISTRY.summary("nos_tpu_plan_shard_seconds",
                                {"pool": key})[0] >= 1
        assert (REGISTRY.value("nos_tpu_plan_shards_total",
                               {"kind": C.MPS_KIND}) or 0) >= len(domains)


class TestShardFailure:
    def test_failed_shard_drains_siblings_and_planner_is_reusable(self):
        class Boom(Exception):
            pass

        def make():
            planner = make_port_planner()
            orig = planner.plan

            def plan(snapshot, pods):
                if "gpu-00" in snapshot.nodes():
                    raise Boom()
                return orig(snapshot, pods)

            planner.plan = plan
            return planner

        par = ParallelGeometryPlanner(make, ts.TimeshareProfileCalculator(),
                                      kind=C.MPS_KIND, min_shard_hosts=0)
        spec = random_spec(42)
        spec["nodes"][0]["domain"] = "nvl-a"
        spec["nodes"][1]["domain"] = "nvl-b"
        snap = ts.TimeshareSnapshotTaker().take_snapshot(
            fleet.build_cluster(spec))
        with pytest.raises(Boom):
            par.plan(snap, port_pending(spec))
        for n in spec["nodes"]:
            if n["name"] == "gpu-00":
                n["name"] = "gpu-zz"
        snap = ts.TimeshareSnapshotTaker().take_snapshot(
            fleet.build_cluster(spec))
        desired = par.plan(snap, port_pending(spec))
        assert len(desired) == len(snap.nodes())
        par.close()


class TestFactoryKnobs:
    @pytest.mark.parametrize("family", [C.MPS_KIND, C.MIG_KIND])
    def test_the_factories_build_the_parallel_planner(self, family):
        from nos_tpu_torch.kube.client import APIServer
        from nos_tpu_torch.partitioning.slicepart import (
            new_slice_partitioner_controller)
        from nos_tpu_torch.partitioning.state import ClusterState

        make = (ts.new_timeshare_partitioner_controller
                if family == C.MPS_KIND else new_slice_partitioner_controller)
        ctl = make(APIServer(), ClusterState(), plan_workers=3,
                   plan_shard_min_hosts=7)
        assert isinstance(ctl._planner, ParallelGeometryPlanner)
        assert ctl._planner._max_workers == 3
        assert ctl._planner._min_shard_hosts == 7
        assert ctl._recovery is None
        default = make(APIServer(), ClusterState())
        assert default._planner._min_shard_hosts == 128
        assert default._planner._max_workers >= 2


class TestMetrics:
    @pytest.mark.parametrize("name", [
        "nos_tpu_plan_shard_seconds", "nos_tpu_plan_shards_total",
        "nos_tpu_node_suspect_total", "nos_tpu_spare_hosts",
        "nos_tpu_spare_promotions_total", "nos_tpu_drain_migrations_total"])
    def test_described_as_in_jax(self, name):
        """The parallel planner's and the recovery plane's metrics carry
        JAX's names and HELP texts."""
        import nos_tpu.partitioning.core  # noqa: F401 — describes JAX's
        from nos_tpu.exporter.metrics import REGISTRY as JAX_REGISTRY

        import nos_tpu_torch.partitioning.core  # noqa: F401

        assert REGISTRY._help[name] == JAX_REGISTRY._help[name]


class TestShardThreads:
    def test_many_shards_on_more_workers_than_cores(self):
        """Eight pools planned on more workers than the host has cores,
        the interpreter switching threads every microsecond: every plan
        equals the one-worker plan, journal included, and the shard
        counter gains exactly one per shard (a lost update would not)."""
        import os
        import sys

        spec = random_spec(17, gangs=False)
        for i, n in enumerate(spec["nodes"][:-1]):
            n["domain"] = f"nvl-{i % 8}"
            n.pop("host_index", None)
        planner = port_parallel(max_workers=1)
        want = port_run(spec, planner)
        planner.close()
        shards = len({n["domain"] for n in spec["nodes"][:-1]})
        workers = 2 * (os.cpu_count() or 4)
        before = REGISTRY.value("nos_tpu_plan_shards_total",
                                {"kind": C.MPS_KIND}) or 0.0
        interval = sys.getswitchinterval()
        planner = port_parallel(max_workers=workers)
        try:
            sys.setswitchinterval(1e-6)
            for _ in range(5):
                assert port_run(spec, planner) == want
        finally:
            sys.setswitchinterval(interval)
            planner.close()
        after = REGISTRY.value("nos_tpu_plan_shards_total",
                               {"kind": C.MPS_KIND})
        assert after - before == 5 * shards
