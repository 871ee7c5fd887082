"""The port's scheduler (nos_tpu_torch/scheduler/{scheduler,cache,
capacityscheduling,gang}.py, cmd/assembly.py's ``build_scheduler``)
against the JAX package's ``build_scheduler``, on the clusters
``tests/test_torch_quota.py`` builds from numpy seeds, compared exactly:

- CapacityScheduling alone: every pending pod's PreFilter verdict,
  Reserve and Unreserve on the ledger, PostFilter's nominated node and
  the pods it evicts (each pod on a fresh twin), and the disruption
  budgets' split of random victim lists;
- ``Scheduler.run_cycle``: after every cycle (and after the kubelet and
  the reconcilers), every pod's node, phase, nomination, conditions and
  labels, the quotas' status and the ledger, the order of every pod
  event (binds, nominations, marks, deletions), and the scheduler's,
  plugin's and reconcilers' journal records, with JAX on its native path
  and again on its Python path;
- the JAX package's three end-to-end quota stories
  (``tests/test_elasticquota.py``'s ``TestEndToEndSchedulingWithQuota``),
  in whole GPUs at JAX's 16 GB a chip, every write compared;
- the smoke's gang loop (phase 12 (b)) on both packages, to
  ``GANG_LOOP_WRITES``;
- chip_smoke's quota fleet (32 x 8 H100 80GB, four quotas, two waves)
  run by both packages to the same summary, ``QUOTA_FLEET_DIGEST``.
"""

from __future__ import annotations

import numpy as np
import pytest

import nos_tpu.api.constants as JC
from nos_tpu.kube.client import KIND_POD as JAX_KIND_POD
from nos_tpu.scheduler.framework import CycleState as JaxCycleState

import chip_smoke
from nos_tpu_torch.api import constants as C
from nos_tpu_torch.cmd.assembly import build_scheduler
from nos_tpu_torch.kube.client import APIServer, KIND_NODE, KIND_POD
from nos_tpu_torch.scheduler.framework import CycleState
from nos_tpu_torch.testing import factory, fleet

from test_torch_planner import build_jax_shim
from test_torch_quota import (
    JAX_MEM, MEM, QuotaTwin, Side, assert_same_waste, cluster_spec,
    port_resources,
)

SEEDS = range(12)


# ---------------------------------------------------------------------------
# CapacityScheduling alone
# ---------------------------------------------------------------------------


def _status(st) -> tuple:
    return (st.code, st.message, st.reason)


def _ledger(side) -> dict:
    return {ns: port_resources(info.used) if side.jax else dict(info.used)
            for ns, info in side.capacity.elastic_quota_infos.items()}


class TestCapacitySchedulingParity:
    @pytest.mark.parametrize("seed", SEEDS)
    def test_pre_filter_reserve_unreserve(self, monkeypatch, seed):
        spec = cluster_spec(seed)
        twin = QuotaTwin(monkeypatch, spec)
        pods = spec["waves"][0] + spec["waves"][1]
        twin.submit(pods)
        for p in pods:
            jpod, pod = twin.both(lambda s: s.api.get(
                "Pod", p["name"], p["namespace"]))
            jst = twin.jside.capacity.pre_filter(
                JaxCycleState(), jpod, twin.jside.sched.snapshot())
            st = twin.side.capacity.pre_filter(
                CycleState(), pod, twin.side.sched.snapshot())
            assert _status(st) == _status(jst), p["name"]
        # Reserve every pod in turn, then Unreserve in reverse
        for p in pods:
            jpod, pod = twin.both(lambda s: s.api.get(
                "Pod", p["name"], p["namespace"]))
            twin.jside.capacity.reserve(JaxCycleState(), jpod, "node-0")
            twin.side.capacity.reserve(CycleState(), pod, "node-0")
            assert _ledger(twin.side) == _ledger(twin.jside)
        for p in reversed(pods):
            jpod, pod = twin.both(lambda s: s.api.get(
                "Pod", p["name"], p["namespace"]))
            twin.jside.capacity.unreserve(JaxCycleState(), jpod, "node-0")
            twin.side.capacity.unreserve(CycleState(), pod, "node-0")
            assert _ledger(twin.side) == _ledger(twin.jside)

    @pytest.mark.parametrize("seed", SEEDS)
    def test_post_filter_nominates_and_evicts_as_jax(self, monkeypatch,
                                                     seed):
        """Each pending pod on a fresh twin whose quotas are labelled:
        PreFilter, then PostFilter; the nominated node, the status and
        the pods deleted must be JAX's."""
        spec = cluster_spec(seed)
        pods = spec["waves"][0] + spec["waves"][1]
        preempted = 0
        for p in pods:
            twin = QuotaTwin(monkeypatch, spec)
            twin.submit([p])
            before = {q.metadata.name for q in twin.side.api.list(KIND_POD)}
            out = []
            for side, state in ((twin.jside, JaxCycleState()),
                                (twin.side, CycleState())):
                pod = side.api.get("Pod", p["name"], p["namespace"])
                fw, lister = side.sched._framework, side.sched.snapshot()
                fw.run_pre_filter_plugins(state, pod, lister)
                nominated, st = side.capacity.post_filter(state, pod, lister)
                left = {q.metadata.name for q in side.api.list("Pod")}
                out.append((nominated, _status(st), sorted(before - left)))
            assert out[1] == out[0], p["name"]
            twin.compare()
            preempted += bool(out[1][2])
        if seed in (2, 7, 8, 9):
            # seeds known to reach the preemption walk's success
            assert preempted, "no pod of the seed preempted anything"

    @pytest.mark.parametrize("seed", SEEDS)
    def test_pdb_split(self, monkeypatch, seed):
        spec = cluster_spec(seed)
        twin = QuotaTwin(monkeypatch, spec)
        rng = np.random.default_rng(seed)
        names = [p["name"] for p in spec["bound"]]
        for _ in range(6):
            pick = [str(n) for n in rng.permutation(names)[
                :int(rng.integers(0, len(names) + 1))]]
            got = []
            for side in (twin.jside, twin.side):
                pods = {q.metadata.name: q for q in side.api.list("Pod")}
                v, nv = side.capacity._split_pdb_violation(
                    [pods[n] for n in pick], None)
                got.append(([q.metadata.name for q in v],
                            [q.metadata.name for q in nv]))
            assert got[1] == got[0]


# ---------------------------------------------------------------------------
# Scheduler.run_cycle
# ---------------------------------------------------------------------------


class TestRunCycleParity:
    @pytest.mark.parametrize("seed", SEEDS)
    @pytest.mark.parametrize("native", [True, False],
                             ids=["jax-native", "jax-python"])
    def test_cycles_write_as_jax(self, monkeypatch, seed, native):
        if native:
            assert build_jax_shim(monkeypatch), \
                "the JAX package's shim did not build"
        spec = cluster_spec(seed)
        twin = QuotaTwin(monkeypatch, spec, jax_native=native)
        twin.submit(spec["waves"][0])
        twin.step()
        twin.submit(spec["waves"][1])
        for _ in range(3):
            twin.step()
        # the run decided something of each kind the seeds are meant to
        # reach
        rows = twin.journals()[1]
        if seed in (0, 1, 2, 3):
            cats = {r[0] for r in rows}
            assert {"pod-bound", "pod-rejected"} <= cats, cats

    @pytest.mark.parametrize("seed", range(4))
    def test_other_knobs_write_as_jax(self, monkeypatch, seed):
        """One preemption a cycle, a full rescan every second cycle, a
        5 s displaced age cap, and displaced stamps on the pending pods
        (some fresh, some expired), against JAX with the same knobs."""
        spec = cluster_spec(seed)
        rng = np.random.default_rng(200 + seed)
        for p in spec["waves"][0] + spec["waves"][1]:
            if rng.random() < 0.4:
                p["displaced"] = f"node-lost@{20_000.0 - rng.choice([1, 60])}"
        twin = QuotaTwin(monkeypatch, spec, preempt_budget_per_cycle=1,
                         full_rescan_every=2, displaced_age_cap_s=5.0)
        twin.submit(spec["waves"][0])
        twin.step(seconds=1.0)
        twin.submit(spec["waves"][1])
        for _ in range(3):
            twin.step(seconds=1.0)

    @pytest.mark.parametrize("seed", range(4))
    def test_a_full_rescan_every_cycle_writes_as_jax(self, monkeypatch,
                                                     seed):
        """FULL_RESCAN_EVERY at 1: every cycle drops the view and
        rebuilds it whole, against JAX with full_rescan_every=1."""
        spec = cluster_spec(seed)
        twin = QuotaTwin(monkeypatch, spec, full_rescan_every=1)
        twin.submit(spec["waves"][0])
        twin.step()
        twin.submit(spec["waves"][1])
        twin.step()
        twin.step()


# ---------------------------------------------------------------------------
# The JAX package's end-to-end quota stories, both sides
# ---------------------------------------------------------------------------


class GpuSide(Side):
    """tests/test_elasticquota.py's quota_cluster: pods ask for whole
    GPUs (JAX: chips) at 16 GB each, on nodes of 8."""

    def res(self, gpus: int, qty: int = 1) -> dict:
        return {JC.RESOURCE_TPU if self.jax else C.RESOURCE_GPU: float(gpus)}

    def create_node(self, n: dict) -> None:
        from nos_tpu.testing import factory as jax_factory

        mem = JAX_MEM if self.jax else MEM
        alloc = {"cpu": 64.0, mem: 128.0} | self.res(8)
        mk = jax_factory.make_node if self.jax else factory.make_node
        self.api.create(KIND_NODE, mk(n["name"], allocatable=alloc))


def _story(monkeypatch, quotas):
    spec = {"nodes": [{"name": "node-0"}], "quotas": quotas, "bound": [],
            "waves": [[], []]}
    return QuotaTwin(monkeypatch, spec, side=GpuSide, gb_per_gpu=16)


def _gpu_pod(name, ns, gpus, priority=0, created=0.0):
    return {"name": name, "namespace": ns, "gb": gpus, "qty": 1,
            "priority": priority, "tier": "", "app": "job",
            "created": created}


def _eq(ns, lo):
    return {"kind": "eq", "name": f"eq-{ns[-1]}", "namespace": ns,
            "namespaces": [ns], "min": lo, "max": 0}


class TestQuotaStories:
    def test_borrow_then_preempt_over_quota_pod(self, monkeypatch):
        twin = _story(monkeypatch, [_eq("ns-a", 64), _eq("ns-b", 64)])
        twin.submit([_gpu_pod(f"b-{i}", "ns-b", 4, created=float(i + 1))
                     for i in range(2)])
        assert twin.step() == 2
        labels = sorted(p.metadata.labels.get(C.LABEL_CAPACITY)
                        for p in twin.side.api.list(KIND_POD))
        assert labels == ["in-quota", "over-quota"]
        twin.submit([_gpu_pod("a-0", "ns-a", 4, created=10.0)])
        assert twin.step() == 1
        left = twin.side.api.list(KIND_POD, namespace="ns-b")
        assert [p.metadata.labels[C.LABEL_CAPACITY] for p in left] == \
            ["in-quota"]
        assert twin.side.api.get(KIND_POD, "a-0", "ns-a").spec.node_name \
            == "node-0"

    def test_same_namespace_priority_preemption(self, monkeypatch):
        twin = _story(monkeypatch, [_eq("ns-a", 64), _eq("ns-b", 64)])
        twin.submit([_gpu_pod("low", "ns-a", 8, priority=0, created=1.0)])
        assert twin.step() == 1
        twin.submit([_gpu_pod("high", "ns-a", 4, priority=100,
                              created=2.0)])
        twin.step()
        assert twin.side.api.try_get(KIND_POD, "low", "ns-a") is None
        twin.step()
        assert twin.side.api.get(KIND_POD, "high", "ns-a").spec.node_name \
            == "node-0"

    def test_no_preemption_of_in_quota_pods(self, monkeypatch):
        twin = _story(monkeypatch, [_eq("ns-a", 32), _eq("ns-b", 96)])
        twin.submit([_gpu_pod("b-0", "ns-b", 6, created=1.0)])
        assert twin.step() == 1
        twin.submit([_gpu_pod("a-0", "ns-a", 4, created=2.0)])
        twin.step()
        assert twin.side.api.try_get(KIND_POD, "b-0", "ns-b") is not None
        assert twin.side.api.get(KIND_POD, "a-0", "ns-a").spec.node_name \
            == ""


class TestHostIndexTie:
    @pytest.mark.parametrize("indices,chosen", [
        ((2, 10), "gpu-node-2"),
        ((None, None), "gpu-node-10"),
        (("x", 10), "gpu-node-2"),
    ], ids=["labelled", "unlabelled", "garbage"])
    def test_a_headroom_tie_breaks_on_the_host_index(self, monkeypatch,
                                                     indices, chosen):
        """Two nodes with one free 24 GB share each: the tie of headroom
        breaks on the numeric host index (an unparsable one counts as
        0), then the name, on both packages; so gpu-node-2 goes before
        gpu-node-10 where both are labelled."""
        nodes = [{"name": name, "shares": {24: 1}}
                 | ({} if idx is None else {"host_index": idx})
                 for name, idx in zip(("gpu-node-10", "gpu-node-2"),
                                      indices[::-1])]
        spec = {"nodes": nodes, "quotas": [], "bound": [],
                "waves": [[], []]}
        twin = QuotaTwin(monkeypatch, spec)
        twin.submit([{"name": "p", "namespace": "default", "gb": 24,
                      "qty": 1, "priority": 0, "tier": "", "app": "job",
                      "created": 1.0}])
        assert twin.cycle() == 1
        got = twin.both(lambda s: s.api.get(KIND_POD, "p", "default")
                        .spec.node_name)
        assert got == (chosen, chosen)


# ---------------------------------------------------------------------------
# chip_smoke's quota fleet
# ---------------------------------------------------------------------------


class TestQuotaFleet:
    def test_the_fleet_runs_as_jax_to_the_pinned_digest(self):
        spec = fleet.quota_fleet_spec(0)
        port = fleet.run_quota_fleet(spec)
        jax = _jax_quota_fleet(spec)
        assert port["summary"] == jax["summary"]
        assert fleet.plan_digest(jax["summary"]) == \
            chip_smoke.QUOTA_FLEET_DIGEST
        # the waterfall: JAX's per pool and category, pinned for the card
        assert_same_waste(port["waste"], jax["waste"])
        assert fleet.plan_digest(fleet.waste_summary(jax["waste"])) == \
            chip_smoke.QUOTA_FLEET_WASTE_DIGEST
        assert port["waste"]["fleet"]["chip_seconds"]["productive"] > 0
        assert port["victims_over_quota"] and not port["victims_in_quota"]
        assert port["preemptions"] > 0 and port["binds"] > 0

    def test_the_smoke_refuses_another_digest(self, monkeypatch):
        monkeypatch.setattr(chip_smoke, "QUOTA_FLEET_DIGEST", "0" * 64)
        with pytest.raises(SystemExit):
            chip_smoke._quota_fleet_runs(runs=1)


def _jax_quota_fleet(spec: dict) -> dict:
    """``fleet.run_quota_fleet`` on the JAX package (the gang fleet's
    domains and PodGroups too)."""
    from nos_tpu.api.elasticquota import (
        CompositeElasticQuota, CompositeElasticQuotaSpec, ElasticQuota,
        ElasticQuotaSpec,
    )
    from nos_tpu.cmd.assembly import build_scheduler as jbuild
    from nos_tpu.controllers.elasticquota import (
        CompositeElasticQuotaReconciler, ElasticQuotaReconciler,
    )
    from nos_tpu.kube.client import APIServer as JaxAPIServer
    from nos_tpu.kube.objects import ObjectMeta
    from nos_tpu.quota import TPUResourceCalculator
    from nos_tpu.testing import factory as jf

    from nos_tpu.api.podgroup import PodGroup, PodGroupSpec

    api = JaxAPIServer()
    calc = TPUResourceCalculator(hbm_gb_per_chip=80)
    now = spec.get("now", fleet.QUOTA_FLEET_NOW)
    sched = jbuild(api, tpu_memory_gb_per_chip=80, clock=lambda: now)
    recs = (ElasticQuotaReconciler(api, calc),
            CompositeElasticQuotaReconciler(api, calc))
    for q in spec["quotas"]:
        lo, hi = {JAX_MEM: q["min"]}, {JAX_MEM: q["max"]}
        meta = ObjectMeta(name=q["name"], namespace=q["namespace"])
        if q["namespaces"] == [q["namespace"]]:
            api.create("ElasticQuota", ElasticQuota(
                metadata=meta, spec=ElasticQuotaSpec(min=lo, max=hi)))
        else:
            api.create("CompositeElasticQuota", CompositeElasticQuota(
                metadata=meta, spec=CompositeElasticQuotaSpec(
                    namespaces=q["namespaces"], min=lo, max=hi)))
    for g in spec.get("groups", ()):
        api.create("PodGroup", PodGroup(
            metadata=ObjectMeta(name=g["name"], namespace=g["namespace"]),
            spec=PodGroupSpec(min_member=g["min"], mesh=g["mesh"])))
    for n in spec["nodes"]:
        alloc = {"cpu": 64.0}
        for table in n["status"].values():
            for profile, qty in table["free"].items():
                res = f"{JC.RESOURCE_TIMESHARE_PREFIX}{profile}"
                alloc[res] = alloc.get(res, 0.0) + qty
        # the port's GPU count as chips: the waste ledger's capacity
        labels = {JC.LABEL_CHIP_COUNT: str(n["gpus"])}
        if "domain" in n:
            # the gang fleet: the port's whole GPUs as chips, its NVLink
            # domain as a TPU pod
            alloc[JC.RESOURCE_TPU] = float(n["gpus"])
            if n["domain"]:
                labels[JC.LABEL_POD_ID] = n["domain"]
            if "host_index" in n:
                labels[JC.LABEL_HOST_INDEX] = str(n["host_index"])
        api.create("Node", jf.make_node(n["name"], labels=labels,
                                        allocatable=alloc))

    def create(p):
        labels = {JC.LABEL_TIER: p["tier"]} if p["tier"] else {}
        if p.get("gang"):
            labels[JC.LABEL_POD_GROUP] = p["gang"]
        api.create("Pod", jf.make_timeshare_pod(
            p["gb"], 1, name=p["name"], namespace=p["namespace"],
            priority=p["priority"], creation_timestamp=p["created"],
            labels=labels))

    def reconcile():
        for r in recs:
            r.reconcile_all()

    def pods():
        return [(p.metadata.name, p.spec.node_name,
                 p.metadata.labels.get(JC.LABEL_CAPACITY), p.status.phase)
                for p in api.list(JAX_KIND_POD)]

    def quotas():
        return {q.metadata.name: port_resources(q.status.used)
                for kind in ("ElasticQuota", "CompositeElasticQuota")
                for q in api.list(kind)}

    def groups():
        return {f"{g.metadata.namespace}/{g.metadata.name}":
                [g.status.phase, g.status.scheduled]
                for g in api.list("PodGroup")}

    from nos_tpu.obs import scoped
    from nos_tpu.obs.ledger import ChipSecondLedger

    ledger_now = [0.0]
    ledger = ChipSecondLedger(clock=lambda: ledger_now[0])
    with scoped(ledger=ledger):
        out = fleet.drive_quota_fleet(spec, create, sched.run_cycle,
                                      lambda: jf.admit_all(api), reconcile,
                                      pods, quotas,
                                      groups if "groups" in spec else None,
                                      ledger_now=ledger_now)
    out["waste"] = ledger.report()
    return out


# ---------------------------------------------------------------------------
# chip_smoke's quota phase (b): the card's loop, its host half on the CPU
# ---------------------------------------------------------------------------

SMOKE_DEVICE = {"model": "nvidia-h100-80gb-hbm3",
                "memory_bytes": 85_000_000_000, "uuid": "GPU-0",
                "uuids": ["GPU-0"]}


def _fresh_journal(monkeypatch) -> None:
    from nos_tpu_torch.obs import journal as port_journal

    monkeypatch.setattr(port_journal, "_journal",
                        port_journal.DecisionJournal())


def _injected_clock():
    now = [1_000.0]

    def advance():
        now[0] += 0.05

    return (lambda: now[0]), advance


def _as_port_object(obj):
    """A JAX node, pod or quota as the port's object of the same state,
    keys and resources under the port's names, for chip_smoke's
    recorder."""
    from nos_tpu_torch.api.elasticquota import (
        ElasticQuota, ElasticQuotaStatus,
    )
    from nos_tpu_torch.kube.objects import ObjectMeta, PodCondition

    from test_torch_controller import node_key
    from test_torch_timeshare import port_resource

    meta = obj.metadata
    if hasattr(obj.status, "allocatable"):
        return factory.make_node(
            meta.name,
            annotations={node_key(k): v for k, v in meta.annotations.items()},
            allocatable={port_resource(r): q
                         for r, q in obj.status.allocatable.items()})
    if hasattr(obj.status, "scheduled"):
        pg = factory.make_pod_group(meta.name, obj.spec.min_member,
                                    obj.spec.mesh, meta.namespace)
        pg.status.phase = obj.status.phase
        pg.status.scheduled = obj.status.scheduled
        return pg
    if hasattr(obj.status, "used"):
        return ElasticQuota(
            metadata=ObjectMeta(name=meta.name, namespace=meta.namespace),
            status=ElasticQuotaStatus(used=port_resources(obj.status.used)))
    from test_torch_quota import to_port

    pod = factory.make_pod(
        name=meta.name, namespace=meta.namespace,
        node_name=obj.spec.node_name, phase=obj.status.phase,
        labels={to_port(k): v for k, v in meta.labels.items()})
    pod.status.conditions = [PodCondition(c.type, c.status, c.reason,
                                          c.message)
                             for c in obj.status.conditions]
    return pod


class _JaxCardLoop:
    """The smoke's card loop on the JAX package: the 80 GB stand-in
    generation cut to one chip a host (one GPU), its MPS (timeshare)
    controller, chip agent, build_scheduler, reconcilers bound to their
    watches and webhooks, the ElasticQuotas ``quotas``, stepped as
    ``_CardLoop.step`` is, recorded through chip_smoke's recorder; on an
    in-memory server, or on ``api`` (the JAX package's REST client) with
    ``watch`` feeding the recorder."""

    def __init__(self, monkeypatch, clock, advance, quotas, api=None,
                 watch=None) -> None:
        import dataclasses

        import nos_tpu.partitioning.timeshare as jax_ts
        import nos_tpu.partitioning.timeshare.factory as jax_ts_factory
        from nos_tpu.api.elasticquota import (
            ElasticQuota, ElasticQuotaSpec, install_quota_webhooks,
        )
        from nos_tpu.cmd.assembly import build_scheduler as jbuild
        from nos_tpu.controllers.chipagent import ChipAgent
        from nos_tpu.controllers.elasticquota import (
            CompositeElasticQuotaReconciler, ElasticQuotaReconciler,
        )
        from nos_tpu.controllers.node_controller import NodeController
        from nos_tpu.controllers.pod_controller import PodController
        from nos_tpu.kube.client import APIServer as JaxAPIServer
        from nos_tpu.kube.objects import ObjectMeta
        from nos_tpu.obs import journal as jax_journal, ledger as jax_ledger
        from nos_tpu.partitioning.state import ClusterState
        from nos_tpu.quota import TPUResourceCalculator
        from nos_tpu.testing import factory as jf
        from nos_tpu.topology import Shape
        from nos_tpu.topology.known import TopologyRegistry

        from test_torch_timeshare import JAX_GEN

        gen = dataclasses.replace(JAX_GEN, name="h100-80gb-standin-1gpu",
                                  host_block=Shape.parse("1x1"))
        monkeypatch.setattr(jax_ts_factory, "TimeshareSnapshotTaker",
                            lambda: jax_ts.TimeshareSnapshotTaker(
                                TopologyRegistry(
                                    generations={gen.name: gen})))
        monkeypatch.setattr(jax_journal, "_journal",
                            jax_journal.DecisionJournal(clock=clock))
        monkeypatch.setattr(jax_ledger, "_ledger",
                            jax_ledger.ChipSecondLedger(clock=clock))
        self.clock, self.advance = clock, advance
        self.jf = jf
        api = JaxAPIServer() if api is None else api
        state = ClusterState()
        self.api = api
        NodeController(api, state).bind()
        PodController(api, state).bind()
        self.controller = jax_ts.new_timeshare_partitioner_controller(
            api, state, batch_timeout_s=chip_smoke.CARD_BATCH_TIMEOUT_S,
            batch_idle_s=chip_smoke.CARD_BATCH_IDLE_S, clock=clock)
        self.controller.bind()
        api.create("Node", jf.make_tpu_node(chip_smoke.CARD_NODE,
                                            generation=gen,
                                            partitioning="timeshare"))
        self.agent = ChipAgent(api, chip_smoke.CARD_NODE)
        self.agent.start()
        self.sched = jbuild(api, tpu_memory_gb_per_chip=80, clock=clock)
        install_quota_webhooks(api)
        calc = TPUResourceCalculator(hbm_gb_per_chip=80)
        ElasticQuotaReconciler(api, calc).bind()
        CompositeElasticQuotaReconciler(api, calc).bind()
        recorder = chip_smoke._Recorder(C.MPS_KIND)
        self.writes = recorder.writes
        for kind in ("Node", "Pod", "ElasticQuota", "PodGroup"):
            (watch or api.watch)(
                kind, lambda e, o: recorder(e, _as_port_object(o)))
        for ns, lo, hi in quotas:
            api.create("ElasticQuota", ElasticQuota(
                metadata=ObjectMeta(name=ns, namespace=ns),
                spec=ElasticQuotaSpec(min={JAX_MEM: lo},
                                      max={JAX_MEM: hi} if hi else {})))

    def step(self) -> None:
        self.advance()
        self.sched.run_cycle()
        self.controller.process_if_ready()
        self.agent.tick()

    def run_until(self, done) -> None:
        for _ in range(200):
            if done():
                return
            self.step()
        raise AssertionError("the JAX loop did not get there")

    def running(self) -> list[str]:
        return sorted(p.metadata.name for p in self.api.list("Pod")
                      if p.status.phase == "Running")

    def names(self) -> set[str]:
        return {p.metadata.name for p in self.api.list("Pod")}

    def create(self, name: str, ns: str, gang: str = "") -> None:
        labels = {JC.LABEL_POD_GROUP: gang} if gang else {}
        self.api.create("Pod", self.jf.make_timeshare_pod(
            chip_smoke.CARD_SHARE_GB, name=name, namespace=ns,
            creation_timestamp=self.clock(), labels=labels))

    def create_group(self, name: str, ns: str, min_member: int) -> None:
        from nos_tpu.api.podgroup import PodGroup, PodGroupSpec
        from nos_tpu.kube.objects import ObjectMeta

        self.api.create("PodGroup", PodGroup(
            metadata=ObjectMeta(name=name, namespace=ns),
            spec=PodGroupSpec(min_member=min_member)))


def _jax_quota_loop(monkeypatch, clock, advance) -> tuple[dict, list]:
    """The smoke's quota loop on the JAX package, step for step.
    Returns the writes and the pods team-b's pod evicted."""
    loop = _JaxCardLoop(monkeypatch, clock, advance,
                        chip_smoke.QUOTA_CARD_QUOTAS)
    for name in chip_smoke.QUOTA_TEAM_A:
        loop.create(name, "team-a")
    loop.run_until(lambda: loop.running() == list(chip_smoke.QUOTA_TEAM_A))
    before = loop.names()
    loop.create(chip_smoke.QUOTA_PREEMPTOR, "team-b")
    loop.step()
    gone = sorted(before - loop.names())
    loop.run_until(lambda: chip_smoke.QUOTA_PREEMPTOR in loop.running())
    loop.sched.close()
    return loop.writes, gone


def _jax_gang_loop(monkeypatch, clock, advance) -> tuple[dict, list]:
    """The smoke's gang loop on the JAX package, step for step.  Returns
    the writes and the pods GANG_B evicted."""
    loop = _JaxCardLoop(monkeypatch, clock, advance,
                        chip_smoke.GANG_CARD_QUOTAS)
    a_ns, a_group, (first, second) = chip_smoke.GANG_A
    b_ns, b_group, b_pods = chip_smoke.GANG_B
    loop.create_group(a_group, a_ns, 2)
    loop.create(first, a_ns, a_group)
    for _ in range(chip_smoke.GANG_WAIT_CYCLES):
        advance()
        assert loop.sched.run_cycle() == 0
    loop.create(second, a_ns, a_group)
    loop.run_until(lambda: loop.running() == [first, second])
    before = loop.names()
    loop.create_group(b_group, b_ns, 2)
    for name in b_pods:
        loop.create(name, b_ns, b_group)
    loop.step()
    gone = sorted(before - loop.names())
    loop.run_until(lambda: all(n in loop.running() for n in b_pods))
    loop.sched.close()
    return loop.writes, gone


class TestSmokeQuota:
    def test_the_card_loop_writes_what_the_smoke_pins(self, monkeypatch):
        """Phase (b)'s loop on real time.monotonic with the smoke's
        windows, its children left out: the labels, the victim, the
        rebind with no new plan, every write pinned."""
        _fresh_journal(monkeypatch)
        loop, card = chip_smoke._quota_loop(SMOKE_DEVICE)
        assert card["labels"] == chip_smoke.QUOTA_LABELS
        assert card["team_a_used"] == {MEM: 72.0}
        grants = chip_smoke._grants(loop, SMOKE_DEVICE,
                                    list(chip_smoke.QUOTA_TEAM_A))
        assert [g["env"] for g in grants] == [{
            "NOS_TPU_VISIBLE_CHIPS": "GPU-0",
            "NOS_TPU_TIMESHARE_GB": "24"}] * 3
        preempt = chip_smoke._quota_preempt(loop)
        assert preempt["evicted"] == [chip_smoke.QUOTA_VICTIM]
        assert preempt["rebound_at"] >= preempt["evicted_at"]
        assert loop.writes == chip_smoke.QUOTA_LOOP_WRITES
        loop.sched.close()

    def test_the_loop_writes_the_same_on_an_injected_clock(self,
                                                           monkeypatch):
        _fresh_journal(monkeypatch)
        clock, advance = _injected_clock()
        loop, _ = chip_smoke._quota_loop(SMOKE_DEVICE, clock=clock,
                                         wall=clock, advance=advance,
                                         poll_s=0.0)
        chip_smoke._quota_preempt(loop, advance=advance, poll_s=0.0)
        assert loop.writes == chip_smoke.QUOTA_LOOP_WRITES

    def test_the_jax_loop_writes_the_pinned_record(self, monkeypatch):
        """The same loop on the JAX package, step for step: its writes
        are the pinned record, and its victim QUOTA_VICTIM."""
        _fresh_journal(monkeypatch)
        clock, advance = _injected_clock()
        writes, gone = _jax_quota_loop(monkeypatch, clock, advance)
        assert gone == [chip_smoke.QUOTA_VICTIM]
        assert writes == chip_smoke.QUOTA_LOOP_WRITES

    def test_the_smoke_refuses_another_victim(self, monkeypatch):
        _fresh_journal(monkeypatch)
        monkeypatch.setattr(chip_smoke, "QUOTA_VICTIM", "team-a-1")
        loop, _ = chip_smoke._quota_loop(SMOKE_DEVICE)
        with pytest.raises(SystemExit):
            chip_smoke._quota_preempt(loop)


# ---------------------------------------------------------------------------
# The cache and the gauges
# ---------------------------------------------------------------------------


class TestSmokeGang:
    def test_the_card_loop_writes_what_the_smoke_pins(self, monkeypatch):
        """Phase (b)'s gang loop on real time.monotonic with the smoke's
        windows, its children left out: GANG_A waits, binds whole in one
        cycle, and is evicted whole by GANG_B, which binds whole on a
        later cycle; every write pinned."""
        _fresh_journal(monkeypatch)
        loop, card = chip_smoke._gang_loop(SMOKE_DEVICE)
        assert card["labels"] == {"ga-0": "in-quota", "ga-1": "over-quota"}
        grants = chip_smoke._grants(loop, SMOKE_DEVICE,
                                    list(chip_smoke.GANG_A[2]))
        assert [g["env"] for g in grants] == [{
            "NOS_TPU_VISIBLE_CHIPS": "GPU-0",
            "NOS_TPU_TIMESHARE_GB": "24"}] * 2
        preempt = chip_smoke._gang_preempt(loop)
        assert preempt["evicted"] == list(chip_smoke.GANG_A[2])
        assert preempt["rebind_cycle"] > preempt["evict_cycle"]
        assert loop.writes == chip_smoke.GANG_LOOP_WRITES
        loop.sched.close()

    def test_the_loop_writes_the_same_on_an_injected_clock(self,
                                                           monkeypatch):
        _fresh_journal(monkeypatch)
        clock, advance = _injected_clock()
        loop, _ = chip_smoke._gang_loop(SMOKE_DEVICE, clock=clock,
                                        wall=clock, advance=advance,
                                        poll_s=0.0)
        chip_smoke._gang_preempt(loop, advance=advance, poll_s=0.0)
        assert loop.writes == chip_smoke.GANG_LOOP_WRITES

    def test_the_jax_loop_writes_the_pinned_record(self, monkeypatch):
        """The same loop on the JAX package, step for step: its writes
        are the pinned record, and GANG_B evicts GANG_A whole."""
        _fresh_journal(monkeypatch)
        clock, advance = _injected_clock()
        writes, gone = _jax_gang_loop(monkeypatch, clock, advance)
        assert gone == sorted(chip_smoke.GANG_A[2])
        assert writes == chip_smoke.GANG_LOOP_WRITES

    def test_the_smoke_refuses_a_member_bound_alone(self, monkeypatch):
        """A PodGroup asking for one member lets the first bind alone,
        which the smoke must refuse."""
        _fresh_journal(monkeypatch)
        from nos_tpu_torch.testing import factory as f

        monkeypatch.setattr(f, "make_pod_group",
                            lambda name, min_member, mesh="",
                            namespace="default": f.PodGroup(
                                metadata=f.ObjectMeta(name=name,
                                                      namespace=namespace),
                                spec=f.PodGroupSpec(min_member=1)))
        with pytest.raises(SystemExit):
            chip_smoke._gang_loop(SMOKE_DEVICE)


class TestSchedulerCache:
    @pytest.mark.parametrize("seed", range(4))
    def test_views_match_jax(self, seed):
        """Random node and pod events on both packages' API servers:
        after each, the dirty set, the view epoch, the pending pods and
        the snapshot's pods and requests agree."""
        from nos_tpu.kube.client import APIServer as JaxAPIServer
        from nos_tpu.scheduler.cache import SchedulerCache as JaxCache
        from nos_tpu.testing import factory as jf

        from nos_tpu_torch.scheduler.cache import SchedulerCache

        rng = np.random.default_rng(seed)
        api, japi = APIServer(), JaxAPIServer()
        cache, jcache = SchedulerCache(api), JaxCache(japi)

        def views():
            out = []
            for c in (jcache, cache):
                snap = c.snapshot()
                out.append((
                    c.drain_dirty(), c.view_epoch(),
                    sorted(p.key for p in c.pending_pods()),
                    {ni.name: (sorted(p.key for p in ni.pods),
                               port_resources(ni.requested))
                     for ni in snap.list()}))
            return out

        jviews, views_ = views()
        assert views_ == jviews
        nodes = [f"n{i}" for i in range(3)]
        for step in range(40):
            op = int(rng.integers(0, 5))
            name = f"p{int(rng.integers(0, 8))}"
            node = str(rng.choice(nodes + [""]))
            for a, mk, mkn, ts, group in (
                    (japi, jf.make_pod, jf.make_node,
                     JC.RESOURCE_TIMESHARE_PREFIX, JC.LABEL_POD_GROUP),
                    (api, factory.make_pod, factory.make_node,
                     C.RESOURCE_TIMESHARE_PREFIX, C.LABEL_POD_GROUP)):
                if op == 0 and a.try_get("Node", nodes[step % 3]) is None:
                    a.create("Node", mkn(nodes[step % 3], allocatable={
                        f"{ts}8gb": 4.0}))
                elif op == 1 and a.try_get("Pod", name, "default") is None:
                    a.create("Pod", mk(name, node_name=node, resources={
                        f"{ts}8gb": 1.0}, labels={group: "g"}
                        if name == "p7" else {}))
                elif op == 2 and a.try_get("Pod", name, "default"):
                    a.patch("Pod", name, "default",
                            mutate=lambda p: setattr(p.status, "phase",
                                                     "Running"))
                elif op == 3 and a.try_get("Pod", name, "default"):
                    a.delete("Pod", name, "default")
                elif op == 4 and a.try_get("Pod", name, "default"):
                    a.patch("Pod", name, "default",
                            mutate=lambda p, n=node: setattr(
                                p.spec, "node_name", n))
            jviews, views_ = views()
            assert views_ == jviews, step
        cache.close()
        jcache.close()


class TestPendingGauges:
    def test_gauges_count_the_pending_pods_by_class(self, monkeypatch):
        from nos_tpu_torch.exporter.metrics import REGISTRY

        api = APIServer()
        api.create(KIND_NODE, factory.make_gpu_node(
            "n", status_geometry={0: {"free": {"24gb": 1}}}))
        sched = build_scheduler(api, clock=lambda: 100.0)
        for i, gb in enumerate((24, 24, 40)):
            api.create(KIND_POD, factory.make_timeshare_pod(
                gb, name=f"p{i}", creation_timestamp=10.0 + i))
        assert sched.run_cycle() == 1
        assert REGISTRY.value("nos_tpu_schedule_pending_pods",
                              {"class": "ts-24"}) == 1.0
        assert REGISTRY.value("nos_tpu_schedule_pending_pods",
                              {"class": "ts-40"}) == 1.0
        assert REGISTRY.value("nos_tpu_schedule_pending_age_seconds",
                              {"class": "ts-40"}) == 88.0
        api.delete(KIND_POD, "p2", "default")
        sched.run_cycle()
        assert REGISTRY.value("nos_tpu_schedule_pending_pods",
                              {"class": "ts-40"}) == 0.0
        count, total, _ = REGISTRY.summary(
            "nos_tpu_schedule_latency_seconds", {"class": "ts-24"})
        assert count >= 1 and total >= 90.0
        sched.close()
