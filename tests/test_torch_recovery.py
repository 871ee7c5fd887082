"""The port's recovery plane (nos_tpu_torch/partitioning/core/failure.py,
the controller's recovery hooks, scheduler/framework.py's SpareGuard and
MigrationDrainGuard, the factories' knobs) against the JAX package's, on
the same objects, compared exactly.

JAX's side is its timeshare family on the 80 GB stand-in generation of
``tests/test_torch_timeshare.py``: ``nos.tpu/pod-id`` stands for the
port's ``nos.nebuly.com/nvlink-domain``, ``nos.tpu/host-index`` for
``nos.nebuly.com/host-index``, ``nos.tpu/spare`` for
``nos.nebuly.com/spare``, the "timeshare" kind for "mps".  Both
schedulers break a tie of headroom by the host index and then the name.

- counterparts of ``tests/test_recovery.py``'s TestHoldGuards,
  TestFailureDetector, TestSparePromotion and TestDrainMigrate, each
  story run on both packages to the same writes and records;
- 12 random clusters with spares, kills, wedged agents and maintenance
  stamps through both packages' controllers, agents and schedulers,
  every write and record compared after every poll;
- the recovery fleet (``testing/fleet.py``) on both, to
  ``chip_smoke.RECOVERY_FLEET_DIGEST``;
- chip_smoke's card loop of phase 13 (c) against JAX's loop on the
  one-GPU stand-in, for the MPS family, in memory and over
  ``tests/k8s_stub.py`` (each package on its own REST client, recorded
  through the stub's commit log, to ``RECOVERY_LOOP_WRITES``), and the
  same story through the MIG family on the MIG stand-in;
- off means off: with the recovery knobs at 0 the factories build no
  policy and a cluster with a stray migration drain is healed once.
"""

from __future__ import annotations

import time

import numpy as np
import pytest

import nos_tpu.api.constants as JC
import nos_tpu.partitioning.timeshare as jax_ts
import nos_tpu.partitioning.timeshare.factory as jax_ts_factory
from nos_tpu.api.podgroup import PodGroup as JaxPodGroup
from nos_tpu.api.podgroup import PodGroupSpec as JaxPodGroupSpec
from nos_tpu.cmd.assembly import build_scheduler as jax_build_scheduler
from nos_tpu.controllers.chipagent import ChipAgent as JaxChipAgent
from nos_tpu.controllers.node_controller import (
    NodeController as JaxNodeController,
)
from nos_tpu.controllers.pod_controller import PodController as JaxPodController
from nos_tpu.exporter.metrics import REGISTRY as JAX_REGISTRY
from nos_tpu.kube.client import APIServer as JaxAPIServer
from nos_tpu.kube.client import NotFound as JaxNotFound
from nos_tpu.kube.objects import ObjectMeta as JaxMeta
from nos_tpu.obs import journal as jax_journal, ledger as jax_ledger
from nos_tpu.partitioning.core import failure as jax_failure
from nos_tpu.partitioning.core.quarantine import (
    QuarantineList as JaxQuarantineList,
)
from nos_tpu.partitioning.state import ClusterState as JaxClusterState
from nos_tpu.testing import factory as jax_factory

import chip_smoke
from test_torch_controller import ledger_holds
from test_torch_quota import (
    assert_same_waste, jax_evidence, mapped, without_plan_ids,
)
from nos_tpu_torch.api import constants as C
from nos_tpu_torch.cmd.assembly import build_scheduler
from nos_tpu_torch.controllers.chipagent import ChipAgent
from nos_tpu_torch.controllers.node_controller import NodeController
from nos_tpu_torch.controllers.pod_controller import PodController
from nos_tpu_torch.exporter.metrics import REGISTRY
from nos_tpu_torch.kube.client import (
    APIServer, KIND_NODE, KIND_POD, NotFound,
)
from nos_tpu_torch.obs import journal as port_journal
from nos_tpu_torch.obs import ledger as port_ledger
from nos_tpu_torch.partitioning import timeshare as ts
from nos_tpu_torch.partitioning.core import (
    REASON_SUSPECT, QuarantineList, SelfHealingPolicy,
    heal_stray_migration_drains, is_warm_spare,
)
from nos_tpu_torch.partitioning.state import ClusterState
from nos_tpu_torch.testing import factory, fleet

from test_torch_timeshare import JAX_GEN, JAX_REG

JAX_KIND = "timeshare"
KIND = C.MPS_KIND
# JAX label and annotation keys the recovery plane writes or reads
KEYS = {
    JC.LABEL_POD_ID: C.LABEL_NVLINK_DOMAIN,
    JC.LABEL_HOST_INDEX: C.LABEL_HOST_INDEX,
    JC.LABEL_SPARE: C.LABEL_SPARE,
    JC.ANNOT_DEFRAG_DRAIN: C.ANNOT_DEFRAG_DRAIN,
    JC.ANNOT_MIGRATE: C.ANNOT_MIGRATE,
    JC.ANNOT_MAINTENANCE: C.ANNOT_MAINTENANCE,
    JC.ANNOT_DISPLACED: C.ANNOT_DISPLACED,
    JC.LABEL_POD_GROUP: C.LABEL_POD_GROUP,
    JC.heartbeat_annotation(JAX_KIND): C.heartbeat_annotation(KIND),
}


# the JAX package's family names and the port's
KINDS = {JAX_KIND: KIND, "slice": C.MIG_KIND}


def port_value(value):
    """A JAX value (a record's attribute, a drain) in the port's names."""
    if isinstance(value, str):
        if value in KINDS:
            return KINDS[value]
        for jax, port in KINDS.items():
            value = value.replace(f"migrate:{jax}:", f"migrate:{port}:")
        return value
    if isinstance(value, dict):
        return {k: port_value(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [port_value(v) for v in value]
    return value


def jax_records(journal, categories) -> list:
    return [[r.category, port_value(r.subject),
             port_value(dict(sorted(r.attrs.items())))]
            for r in journal.events() if r.category in categories]


def port_records(journal, categories) -> list:
    return [[r.category, r.subject, dict(sorted(r.attrs.items()))]
            for r in journal.events() if r.category in categories]


def _counter(name: str, jax: bool) -> float:
    if jax:
        return JAX_REGISTRY.snapshot().get(name, {}).get(
            f"kind={JAX_KIND}", 0.0)
    return REGISTRY.value(name, {"kind": KIND}) or 0.0


def jax_standin(monkeypatch, clock) -> None:
    """The JAX side's stand-in: the timeshare factory's snapshot taker
    on the 80 GB generation's registry and a fresh ledger on
    ``clock``."""
    monkeypatch.setattr(jax_ts_factory, "TimeshareSnapshotTaker",
                        lambda: jax_ts.TimeshareSnapshotTaker(JAX_REG))
    monkeypatch.setattr(jax_ledger, "_ledger",
                        jax_ledger.ChipSecondLedger(clock=clock))


def jax_node(name: str, domain: str = "", host_index=None,
             spare: bool = False, gen=JAX_GEN):
    extra = {JC.LABEL_SPARE: JC.SPARE_WARM} if spare else None
    node = jax_factory.make_tpu_node(
        name, generation=gen, partitioning=JAX_KIND, pod_id=domain,
        host_index=0 if host_index is None else host_index,
        extra_labels=extra)
    if not domain:
        node.metadata.labels.pop(JC.LABEL_POD_ID)
    if host_index is None:
        node.metadata.labels.pop(JC.LABEL_HOST_INDEX)
    return node


# ---------------------------------------------------------------------------
# The recovery fleet on the JAX package
# ---------------------------------------------------------------------------


class JaxRecoveryOps:
    """``fleet.drive_recovery_fleet``'s ops on the JAX package: node and
    pod controllers, the timeshare partitioner controller from its
    factory with the recovery plane on, a ChipAgent a node and
    ``build_scheduler`` at 80 GB a chip, on one virtual clock."""

    def __init__(self, monkeypatch, recovery: bool = True) -> None:
        self.now = [0.0]
        clock = lambda: self.now[0]  # noqa: E731
        jax_standin(monkeypatch, clock)
        self.journal = jax_journal.DecisionJournal(maxlen=1 << 18,
                                                   clock=clock)
        monkeypatch.setattr(jax_journal, "_journal", self.journal)
        self.api = JaxAPIServer()
        state = JaxClusterState()
        JaxNodeController(self.api, state).bind()
        JaxPodController(self.api, state).bind()
        self.controller = jax_ts.new_timeshare_partitioner_controller(
            self.api, state, batch_timeout_s=fleet.RECOVERY_BATCH_TIMEOUT_S,
            batch_idle_s=fleet.RECOVERY_BATCH_IDLE_S,
            spare_hosts_per_pool=1 if recovery else 0,
            node_suspect_after_s=fleet.RECOVERY_SUSPECT_AFTER_S if recovery
            else 0.0,
            migrate_grace_s=fleet.RECOVERY_GRACE_S, clock=clock)
        self.controller.bind()
        self.sched = jax_build_scheduler(self.api, tpu_memory_gb_per_chip=80,
                                         clock=clock)
        self._agents: dict = {}
        self.drain0 = _counter("nos_tpu_drain_migrations_total", True)

    def add_node(self, n: dict) -> None:
        self.api.create("Node", jax_node(n["name"], n["domain"],
                                         n["host_index"],
                                         n.get("spare", False)))
        agent = JaxChipAgent(self.api, n["name"])
        agent.start()
        self._agents[n["name"]] = agent

    def kill(self, name: str) -> None:
        self._agents.pop(name, None)
        for pod in self.api.pods_on_node(name):
            try:
                self.api.delete("Pod", pod.metadata.name,
                                pod.metadata.namespace)
            except JaxNotFound:
                pass
        self.api.delete("Node", name)

    def create_group(self, name: str, members: int) -> None:
        self.api.create("PodGroup", JaxPodGroup(
            metadata=JaxMeta(name=name, namespace=fleet.RECOVERY_NAMESPACE),
            spec=JaxPodGroupSpec(min_member=members)))

    def delete_group(self, name: str) -> None:
        self.api.delete("PodGroup", name, fleet.RECOVERY_NAMESPACE)

    def create_pod(self, p: dict) -> None:
        labels = {JC.LABEL_POD_GROUP: p["gang"]} if p["gang"] else None
        annots = {JC.ANNOT_DISPLACED: p["displaced"]} if p["displaced"] \
            else None
        self.api.create("Pod", jax_factory.make_timeshare_pod(
            p["gb"], name=p["name"], namespace=fleet.RECOVERY_NAMESPACE,
            priority=p["priority"], creation_timestamp=p["created"],
            labels=labels, annotations=annots))

    def delete_pod(self, name: str) -> None:
        try:
            self.api.delete("Pod", name, fleet.RECOVERY_NAMESPACE)
        except JaxNotFound:
            pass

    def cycle(self) -> None:
        self.sched.run_cycle()

    def poll(self) -> None:
        self.controller.process_if_ready()

    def agents(self) -> list[str]:
        return list(self._agents)

    def tick(self, names: list[str]) -> None:
        for name in names:
            self._agents[name].tick()

    def pods(self) -> list[tuple[str, str, str]]:
        return sorted((p.metadata.name, p.spec.node_name, p.status.phase)
                      for p in self.api.list("Pod"))

    def nodes(self) -> dict[str, tuple[str, str, bool]]:
        return {n.metadata.name: (
                    n.metadata.labels.get(JC.LABEL_POD_ID, ""),
                    n.metadata.labels.get(JC.LABEL_HOST_INDEX, ""),
                    JC.is_warm_spare_labels(n.metadata.labels))
                for n in self.api.list("Node")}

    def records(self) -> list:
        return jax_records(self.journal, fleet.RECOVERY_RECORDS)

    def drain_migrations(self) -> float:
        return _counter("nos_tpu_drain_migrations_total", True) \
            - self.drain0


def run_jax_recovery_fleet(monkeypatch, spec: dict) -> dict:
    """The recovery run on the JAX package, with its ledger's report as
    ``waste``."""
    ops = JaxRecoveryOps(monkeypatch)
    try:
        out = fleet.drive_recovery_fleet(spec, ops)
    finally:
        ops.sched.close()
    out["waste"] = jax_ledger.get_ledger().report()
    return out


# ---------------------------------------------------------------------------
# The policy on both packages, one operation at a time
# ---------------------------------------------------------------------------

RECORDS = (port_journal.QUARANTINED, port_journal.QUARANTINE_RELEASED,
           port_journal.SPARE_PROMOTED, port_journal.JOB_DISPLACED)
NODE_LABELS = (C.LABEL_NVLINK_DOMAIN, C.LABEL_HOST_INDEX, C.LABEL_SPARE)
NODE_ANNOTS = (C.ANNOT_DEFRAG_DRAIN, C.ANNOT_MAINTENANCE,
               C.heartbeat_annotation(KIND))
POD_ANNOTS = (C.ANNOT_MIGRATE, C.ANNOT_DISPLACED)
TO_JAX = {port: jax for jax, port in KEYS.items()}


def jax_value(value: str) -> str:
    for jax, port in KINDS.items():
        value = value.replace(f"migrate:{port}:", f"migrate:{jax}:")
    return value


class PolicyTwin:
    """A SelfHealingPolicy on each package over an API server of its own,
    on one clock; every operation goes to both, ``step`` polls both and
    compares the nodes' recovery labels and annotations, the pods' nodes,
    phases and stamps, the quarantines and the journal records."""

    def __init__(self, monkeypatch, spares: int = 1,
                 suspect_after: float = 5.0, grace: float = 3.0,
                 kinds=(JAX_KIND, KIND)) -> None:
        self.now = [0.0]
        clock = lambda: self.now[0]  # noqa: E731
        self.jax_journal = jax_journal.DecisionJournal(clock=clock)
        self.journal = port_journal.DecisionJournal(clock=clock)
        monkeypatch.setattr(jax_journal, "_journal", self.jax_journal)
        monkeypatch.setattr(port_journal, "_journal", self.journal)
        monkeypatch.setattr(jax_ledger, "_ledger",
                            jax_ledger.ChipSecondLedger(clock=clock))
        monkeypatch.setattr(port_ledger, "_ledger",
                            port_ledger.ChipSecondLedger(clock=clock))
        self.japi, self.api = JaxAPIServer(), APIServer()
        self.jq = JaxQuarantineList(kind=kinds[0], clock=clock)
        self.q = QuarantineList(kind=kinds[1], clock=clock)
        self.knobs = dict(spare_hosts_per_pool=spares,
                          suspect_after_s=suspect_after,
                          migrate_grace_s=grace, clock=clock)
        self.jpolicy = jax_failure.SelfHealingPolicy(
            self.japi, kinds[0], self.jq, **self.knobs)
        self.policy = SelfHealingPolicy(self.api, kinds[1], self.q,
                                        **self.knobs)
        for i in range(2):
            self.add_node(f"h{i}", "pod-0", i)
        for s in range(spares):
            self.add_node(f"spare{s}", "pod-0", 100 + s, spare=True,
                          heartbeat="")

    # -- operations on both ---------------------------------------------
    def add_node(self, name: str, domain: str = "pod-0", host_index=0,
                 spare: bool = False, heartbeat: str = "1",
                 kind: str = KIND) -> None:
        jnode = jax_node(name, domain, host_index, spare)
        node = factory.make_gpu_node(name, domain=domain,
                                     host_index=host_index, spare=spare)
        if kind == C.HYBRID_KIND:
            jnode.metadata.labels[JC.LABEL_PARTITIONING] = "hybrid"
            node.metadata.labels[C.LABEL_PARTITIONING] = C.HYBRID_KIND
        if heartbeat:
            jnode.metadata.annotations[
                JC.heartbeat_annotation(JAX_KIND)] = heartbeat
            node.metadata.annotations[C.heartbeat_annotation(KIND)] = \
                heartbeat
        self.japi.create("Node", jnode)
        self.api.create(KIND_NODE, node)

    def annotate(self, name: str, key: str, value: str | None) -> None:
        """Set (None: remove) a node annotation, the port's key."""
        for api, k, v in ((self.japi, TO_JAX[key],
                           None if value is None else jax_value(value)),
                          (self.api, key, value)):
            def mutate(n, k=k, v=v):
                if v is None:
                    n.metadata.annotations.pop(k, None)
                else:
                    n.metadata.annotations[k] = v
            api.patch("Node", name, mutate=mutate)

    def delete_node(self, name: str) -> None:
        self.japi.delete("Node", name)
        self.api.delete(KIND_NODE, name)

    def create_pod(self, name: str, node: str, gang: str = "",
                   annotations: dict | None = None,
                   namespace: str = "work") -> None:
        annotations = annotations or {}
        self.japi.create("Pod", jax_factory.make_timeshare_pod(
            24, name=name, namespace=namespace, node_name=node,
            phase="Running",
            labels={JC.LABEL_POD_GROUP: gang} if gang else None,
            annotations={TO_JAX[k]: v for k, v in annotations.items()}))
        self.api.create(KIND_POD, factory.make_timeshare_pod(
            24, name=name, namespace=namespace, node_name=node,
            phase="Running",
            labels={C.LABEL_POD_GROUP: gang} if gang else None,
            annotations=dict(annotations)))

    def step(self, seconds: float = 0.0) -> None:
        self.now[0] += seconds
        self.jpolicy.step({n.metadata.name: n
                           for n in self.japi.list("Node")})
        self.policy.step({n.metadata.name: n
                          for n in self.api.list(KIND_NODE)})
        self.compare()

    # -- reading ----------------------------------------------------------
    def node(self, name: str):
        return self.api.get(KIND_NODE, name)

    def pod(self, name: str, namespace: str = "work"):
        return self.api.try_get(KIND_POD, name, namespace)

    def view(self, jax: bool) -> dict:
        api = self.japi if jax else self.api

        def keep(table: dict, keys) -> dict:
            if jax:
                return {KEYS[k]: port_value(v) for k, v in table.items()
                        if k in KEYS and KEYS[k] in keys}
            return {k: v for k, v in table.items() if k in keys}

        return {
            "nodes": {n.metadata.name: (keep(n.metadata.labels, NODE_LABELS),
                                        keep(n.metadata.annotations,
                                             NODE_ANNOTS))
                      for n in api.list("Node")},
            "pods": {p.key: (p.spec.node_name, p.status.phase,
                             keep(p.metadata.annotations, POD_ANNOTS))
                     for p in api.list("Pod")},
            "quarantine": {n: r for n, (r, _) in
                           (self.jq if jax else self.q).items().items()},
            "records": (jax_records(self.jax_journal, RECORDS) if jax
                        else port_records(self.journal, RECORDS)),
            "holds": ledger_holds(
                (jax_ledger if jax else port_ledger).get_ledger(),
                lambda v: v, KINDS if jax else {}),
        }

    def compare(self) -> None:
        assert self.view(jax=False) == self.view(jax=True)

    def records(self, category: str) -> list:
        return [r for r in port_records(self.journal, RECORDS)
                if r[0] == category]


@pytest.fixture
def twin(monkeypatch):
    return lambda **kw: PolicyTwin(monkeypatch, **kw)


# ---------------------------------------------------------------------------
# SpareGuard and MigrationDrainGuard in both schedulers
# ---------------------------------------------------------------------------


class SchedTwin:
    """Both packages' ``build_scheduler`` (80 GB a GPU) over one node or
    two, each advertising ``shares`` 24 GB shares."""

    def __init__(self, nodes: dict[str, dict]) -> None:
        self.japi, self.api = JaxAPIServer(), APIServer()
        self.jjournal = jax_journal.DecisionJournal()
        self.pjournal = port_journal.DecisionJournal()
        for name, n in nodes.items():
            jnode = jax_node(name, "pod-0", 0, n.get("spare", False))
            node = factory.make_gpu_node(name, domain="pod-0",
                                         spare=n.get("spare", False))
            for obj, prefix in ((jnode, JC.RESOURCE_TIMESHARE_PREFIX),
                                (node, C.RESOURCE_TIMESHARE_PREFIX)):
                obj.status.allocatable[f"{prefix}24gb"] = float(n["shares"])
            if n.get("drain"):
                jnode.metadata.annotations[JC.ANNOT_DEFRAG_DRAIN] = \
                    jax_value(n["drain"])
                node.metadata.annotations[C.ANNOT_DEFRAG_DRAIN] = n["drain"]
            self.japi.create("Node", jnode)
            self.api.create(KIND_NODE, node)
        self.jsched = jax_build_scheduler(self.japi, tpu_memory_gb_per_chip=80,
                                          clock=lambda: 10.0)
        self.sched = build_scheduler(self.api, clock=lambda: 10.0)

    def cycle(self, monkeypatch, *pods: str) -> dict[str, str]:
        for name in pods:
            self.japi.create("Pod", jax_factory.make_timeshare_pod(
                24, name=name, creation_timestamp=1.0))
            self.api.create(KIND_POD, factory.make_timeshare_pod(
                24, name=name, creation_timestamp=1.0))
        monkeypatch.setattr(jax_journal, "_journal", self.jjournal)
        monkeypatch.setattr(port_journal, "_journal", self.pjournal)
        assert self.jsched.run_cycle() == self.sched.run_cycle()
        got = {p.metadata.name: p.spec.node_name
               for p in self.api.list(KIND_POD)}
        assert got == {p.metadata.name: p.spec.node_name
                       for p in self.japi.list("Pod")}
        rows = [r for r in port_records(self.pjournal,
                                        (port_journal.POD_REJECTED,))]
        jrows = [r for r in jax_records(self.jjournal,
                                        (port_journal.POD_REJECTED,))]
        assert [r[2].get("nodes") for r in rows] == \
            [mapped(r[2].get("nodes")) for r in jrows]
        return got

    def relabel(self, name: str) -> None:
        self.japi.patch("Node", name, mutate=lambda n:
                        n.metadata.labels.pop(JC.LABEL_SPARE, None))
        self.api.patch(KIND_NODE, name, mutate=lambda n:
                       n.metadata.labels.pop(C.LABEL_SPARE, None))

    def close(self) -> None:
        self.jsched.close()
        self.sched.close()


class TestHoldGuards:
    """The guards in both schedulers, verdict messages compared, and the
    warm spare outside both waste waterfalls."""

    def test_spare_excluded_from_waste_waterfall(self, monkeypatch):
        """A warm spare is reserve, not capacity: its GPUs are in no
        waterfall pool, and its SpareGuard rejections strand nothing.
        The live node's free GPUs, which the third pod's class was
        rejected on, read frag_stranded; both packages agree."""
        now = [0.0]
        for mod in (jax_ledger, port_ledger):
            monkeypatch.setattr(mod, "_ledger", mod.ChipSecondLedger(
                clock=lambda: now[0]))
        t = SchedTwin({"live": {"shares": 2},
                       "spare": {"shares": 2, "spare": True}})
        now[0] = 1.0
        assert t.cycle(monkeypatch, "p", "q", "r") == {
            "p": "live", "q": "live", "r": ""}
        now[0] = 3.0
        t.cycle(monkeypatch)
        t.close()
        report = port_ledger.get_ledger().report()
        assert_same_waste(report, jax_ledger.get_ledger().report())
        pool = report["pools"]["pod-0"]
        assert pool["capacity_chips"] == 8.0
        assert pool["chip_seconds"] == {"productive": 2 * 0.6,
                                        "frag_stranded": 2 * 7.4}

    def test_pod_never_binds_to_warm_spare(self, monkeypatch):
        t = SchedTwin({"spare": {"shares": 2, "spare": True}})
        assert t.cycle(monkeypatch, "p") == {"p": ""}
        assert "node held as warm spare" in str(
            t.pjournal.events(port_journal.POD_REJECTED)[-1].attrs)
        t.relabel("spare")              # the promotion
        assert t.cycle(monkeypatch) == {"p": "spare"}
        t.close()

    def test_migration_drained_node_hard_rejected(self, monkeypatch):
        t = SchedTwin({"dying": {"shares": 2,
                                 "drain": "migrate:mps:node-suspect"}})
        assert t.cycle(monkeypatch, "p") == {"p": ""}
        assert "node draining for migration" in str(
            t.pjournal.events(port_journal.POD_REJECTED)[-1].attrs)
        t.close()

    def test_defrag_drain_stays_a_soft_avoidance(self, monkeypatch):
        """A defrag proposal's drain rejects nothing: alone, the node
        still takes the pod; beside another that fits, the score key
        sends the pod there, though it has more headroom."""
        t = SchedTwin({"defragged": {"shares": 2, "drain": "dfrg-mps-7"}})
        assert t.cycle(monkeypatch, "p") == {"p": "defragged"}
        t.close()
        t = SchedTwin({"a-drained": {"shares": 1, "drain": "dfrg-mps-7"},
                       "b-roomy": {"shares": 3}})
        assert t.cycle(monkeypatch, "p") == {"p": "b-roomy"}
        t.close()

    def test_the_guards_sit_in_jax_s_order(self):
        sched = build_scheduler(APIServer())
        names = [type(p).__name__ for p in sched._framework._plugins] \
            if hasattr(sched._framework, "_plugins") else None
        jsched = jax_build_scheduler(JaxAPIServer())
        jnames = [type(p).__name__ for p in jsched._framework._plugins] \
            if hasattr(jsched._framework, "_plugins") else None
        assert names == jnames == [
            "NodeResourcesFit", "SpareGuard", "MigrationDrainGuard",
            "TopologyFilter", "CapacityScheduling"]
        sched.close()
        jsched.close()


# ---------------------------------------------------------------------------
# The failure detector
# ---------------------------------------------------------------------------


class TestFailureDetector:
    def test_frozen_heartbeat_suspects_and_resume_releases(self, twin):
        t = twin()
        t.step()                        # the baseline
        t.step(4.0)
        assert not t.q.is_quarantined("h0")
        t.step(2.0)                     # past suspect_after_s, frozen
        assert t.q.reason("h0") == t.q.reason("h1") == REASON_SUSPECT
        t.annotate("h0", C.heartbeat_annotation(KIND), "2")
        t.step()
        assert not t.q.is_quarantined("h0") and t.q.is_quarantined("h1")
        assert _counter("nos_tpu_node_suspect_total", False) >= 2

    def test_node_without_heartbeat_is_never_suspected(self, twin):
        t = twin()
        t.add_node("mute", "pod-0", 5, heartbeat="")
        t.step()
        t.step(100.0)
        assert not t.q.is_quarantined("mute")

    def test_the_mig_agent_beats(self):
        """The MIG agent's every report moves its heartbeat."""
        from nos_tpu_torch.controllers.sliceagent import SliceAgent
        from nos_tpu_torch.device.fake import FakeGpuRuntime, FakePodResources
        from nos_tpu_torch.topology import H100_80GB

        api = APIServer()
        api.create(KIND_NODE, factory.make_gpu_node(
            "n", gpus=1, partitioning=C.MIG_KIND))
        a = SliceAgent(api, "n", FakeGpuRuntime(H100_80GB, 1),
                       FakePodResources())
        a.start()
        key = C.heartbeat_annotation(C.MIG_KIND)
        beats = [api.get(KIND_NODE, "n").metadata.annotations[key]]
        for _ in range(2):
            a.tick()
            beats.append(api.get(KIND_NODE, "n").metadata.annotations[key])
        assert len(set(beats)) == 3

    def test_the_mps_agent_beats_once_a_config_is_applied(self,
                                                          monkeypatch):
        """The MPS reporter reports, and beats, once the plugin applied a
        config (as JAX's): a virgin node gives no signal and is never
        suspected; after its first plan every tick moves the beat."""
        t = RecoveryTwin(monkeypatch, [
            {"name": "h0", "domain": "nvl-0", "host_index": 0}])
        key = C.heartbeat_annotation(KIND)
        t.tick(10.0)
        assert key not in t.ops.api.get(KIND_NODE, "h0").metadata.annotations
        assert not t.ops.controller.quarantine.names()
        t.both(lambda o: o.create_pod({
            "name": "p", "gb": 40, "priority": 0, "created": 1.0,
            "gang": "", "displaced": ""}))
        beats = []
        for _ in range(4):
            t.tick()
            beats.append(t.ops.api.get(
                KIND_NODE, "h0").metadata.annotations.get(key))
        assert None not in beats[-2:] and beats[-1] != beats[-2]
        t.close()

    def test_the_controller_leaves_a_suspect_to_the_detector(self, monkeypatch):
        """A wedged agent's spec equals its status trivially: the
        controller's sweep must not release a suspect on a caught-up
        report (JAX's rule, the same quarantine set on both)."""
        t = RecoveryTwin(monkeypatch, [
            {"name": "h0", "domain": "nvl-0", "host_index": 0}])
        for o in (t.ops, t.jops):
            o.controller.quarantine.quarantine("h0", "heartbeat-suspect")
        t.tick()
        assert t.ops.controller.quarantine.reason("h0") == REASON_SUSPECT
        t.close()


# ---------------------------------------------------------------------------
# Warm spares
# ---------------------------------------------------------------------------


class TestSparePromotion:
    def test_vanished_host_promotes_a_spare_into_its_index(self, twin):
        t = twin()
        t.step()
        t.delete_node("h0")
        t.step()
        spare = t.node("spare0")
        assert not is_warm_spare(spare)
        assert spare.metadata.labels[C.LABEL_HOST_INDEX] == "0"
        (rec,) = t.records(port_journal.SPARE_PROMOTED)
        assert rec[1] == "spare0" and rec[2]["replaced"] == "h0" \
            and rec[2]["host_index"] == 0 and rec[2]["kind"] == KIND

    def test_one_vacancy_consumes_one_spare(self, twin):
        t = twin(spares=2)
        t.step()
        t.delete_node("h0")
        for _ in range(3):
            t.step()
        promoted = [n for n in t.api.list(KIND_NODE)
                    if n.metadata.name.startswith("spare")
                    and not is_warm_spare(n)]
        assert len(promoted) == 1

    def test_unhealthy_spare_is_not_promoted(self, twin):
        t = twin(spares=2)
        t.step()
        for q in (t.q, t.jq):
            q.quarantine("spare0", "heartbeat-suspect")
        t.delete_node("h0")
        t.step()
        assert is_warm_spare(t.node("spare0"))
        assert t.node("spare1").metadata.labels[C.LABEL_HOST_INDEX] == "0"
        assert REGISTRY.value("nos_tpu_spare_hosts",
                              {"pool": "pod-0"}) == 0.0
        for q in (t.q, t.jq):
            q.unquarantine("spare0")
        t.annotate("spare0", C.ANNOT_MAINTENANCE, "planned")
        t.delete_node("h1")
        t.step()
        assert is_warm_spare(t.node("spare0"))

    def test_hybrid_pool_promotion_is_the_mig_family_s(self, monkeypatch):
        """Both families' policies see a hybrid node; one (MIG, JAX's
        slice) promotes, or two spares could take one vacated index."""
        clock = [0.0]
        monkeypatch.setattr(port_journal, "_journal",
                            port_journal.DecisionJournal())
        api = APIServer()
        policies = [SelfHealingPolicy(
            api, kind, QuarantineList(kind=kind, clock=lambda: clock[0]),
            spare_hosts_per_pool=1, clock=lambda: clock[0])
            for kind in (C.MIG_KIND, C.MPS_KIND)]
        for i in range(2):
            node = factory.make_gpu_node(f"y{i}", domain="pod-9",
                                         host_index=i,
                                         partitioning=C.HYBRID_KIND)
            api.create(KIND_NODE, node)
        for s in range(2):
            api.create(KIND_NODE, factory.make_gpu_node(
                f"yspare{s}", domain="pod-9", host_index=200 + s,
                partitioning=C.HYBRID_KIND, spare=True))
        nodes = lambda: {n.metadata.name: n  # noqa: E731
                         for n in api.list(KIND_NODE)}
        for p in policies:
            p.step(nodes())
        api.delete(KIND_NODE, "y0")
        for p in policies:
            p.step(nodes())
        promoted = [n for n in api.list(KIND_NODE)
                    if n.metadata.name.startswith("yspare")
                    and not is_warm_spare(n)]
        assert len(promoted) == 1
        assert promoted[0].metadata.labels[C.LABEL_HOST_INDEX] == "0"
        assert [r.attrs["kind"] for r in port_journal._journal.events(
            port_journal.SPARE_PROMOTED)] == [C.MIG_KIND]

    def test_restart_lost_vacancy_inferred_from_index_gap(self, twin):
        t = twin()
        t.add_node("h2", "pod-0", 2)
        t.delete_node("h1")             # dies while nobody watches
        t.step()                        # the first poll of a fresh policy
        spare = t.node("spare0")
        assert not is_warm_spare(spare)
        assert spare.metadata.labels[C.LABEL_HOST_INDEX] == "1"

    def test_intact_pool_first_poll_promotes_nothing(self, twin):
        t = twin()
        t.step()
        assert is_warm_spare(t.node("spare0"))
        t.delete_node("h1")             # the highest index
        t.jpolicy = jax_failure.SelfHealingPolicy(
            t.japi, JAX_KIND, t.jq, **t.knobs)
        t.policy = SelfHealingPolicy(t.api, KIND, t.q, **t.knobs)
        t.step()
        assert is_warm_spare(t.node("spare0"))

    def test_quarantined_but_present_host_is_not_replaced(self, twin):
        t = twin()
        t.step()
        for q in (t.q, t.jq):
            q.quarantine("h0", "heartbeat-suspect")
        t.step()
        assert is_warm_spare(t.node("spare0"))

    def test_spare_gauge_tracks_inventory(self, twin):
        t = twin()
        t.step()
        assert REGISTRY.value("nos_tpu_spare_hosts", {"pool": "pod-0"}) == 1.0
        t.delete_node("h0")
        t.step()
        assert REGISTRY.value("nos_tpu_spare_hosts", {"pool": "pod-0"}) == 0.0
        assert JAX_REGISTRY.snapshot()["nos_tpu_spare_hosts"][
            "pool=pod-0"] == 0.0


# ---------------------------------------------------------------------------
# Drain-then-migrate
# ---------------------------------------------------------------------------


class TestDrainMigrate:
    @staticmethod
    def _suspect_h0(t: PolicyTwin) -> None:
        t.step()
        t.step(6.0)

    def test_suspect_node_drains_stamps_and_evicts_after_grace(self, twin):
        t = twin(spares=0, grace=3.0)
        t.create_pod("r0", "h0")
        self._suspect_h0(t)
        assert t.node("h0").metadata.annotations[
            C.ANNOT_DEFRAG_DRAIN] == "migrate:mps:node-suspect"
        assert t.pod("r0").metadata.annotations[C.ANNOT_MIGRATE] == \
            "node-suspect"
        (rec,) = t.records(port_journal.JOB_DISPLACED)
        assert rec[1] == "work/r0" and rec[2]["cause"] == "node-suspect"
        assert t.pod("r0") is not None          # inside the grace
        t.step(3.5)
        assert t.pod("r0") is None
        assert _counter("nos_tpu_drain_migrations_total", False) >= 1

    def test_a_gang_is_displaced_and_evicted_whole(self, twin):
        t = twin(spares=0, grace=3.0)
        t.create_pod("g-0", "h0", gang="g")
        t.create_pod("g-1", "h1", gang="g")
        t.create_pod("solo", "h1")
        t.annotate("h1", C.heartbeat_annotation(KIND), "2")
        t.step()
        t.step(4.0)
        t.annotate("h1", C.heartbeat_annotation(KIND), "3")
        t.step(2.0)                     # h0 suspect, h1 alive
        assert [r[1] for r in t.records(port_journal.JOB_DISPLACED)] == \
            ["work/g"]
        t.annotate("h1", C.heartbeat_annotation(KIND), "4")
        t.step(3.5)
        assert t.pod("g-0") is None and t.pod("g-1") is None
        assert t.pod("solo") is not None

    def test_recovered_node_heals_drain_and_unstamps(self, twin):
        t = twin(spares=0, grace=300.0)
        t.create_pod("r0", "h0")
        self._suspect_h0(t)
        t.annotate("h0", C.heartbeat_annotation(KIND), "2")
        t.step()
        assert not t.q.is_quarantined("h0")
        assert C.ANNOT_DEFRAG_DRAIN not in t.node("h0").metadata.annotations
        assert C.ANNOT_MIGRATE not in t.pod("r0").metadata.annotations

    def test_other_family_migration_is_never_retracted(self, monkeypatch):
        """Exclusive ownership: the MIG policy neither begins over nor
        retracts the MPS family's drain on a hybrid node (JAX: slice
        over timeshare)."""
        t = PolicyTwin(monkeypatch, spares=0, grace=300.0,
                       kinds=("slice", C.MIG_KIND))
        # the nodes beat for the MIG family too
        for name in ("h0", "h1"):
            for api, key in ((t.japi, JC.heartbeat_annotation("slice")),
                             (t.api, C.heartbeat_annotation(C.MIG_KIND))):
                api.patch("Node", name, mutate=lambda n, k=key:
                          n.metadata.annotations.update({k: "1"}))
                api.patch("Node", name, mutate=lambda n, api=api:
                          n.metadata.labels.update({
                              (JC if api is t.japi else C)
                              .LABEL_PARTITIONING: "hybrid"}))
        t.annotate("h0", C.ANNOT_DEFRAG_DRAIN, "migrate:mps:node-suspect")
        t.create_pod("r0", "h0", annotations={C.ANNOT_MIGRATE: "node-suspect"})
        t.step()
        t.step(6.0)
        assert t.node("h0").metadata.annotations[C.ANNOT_DEFRAG_DRAIN] == \
            "migrate:mps:node-suspect"
        for api, key in ((t.japi, JC.heartbeat_annotation("slice")),
                         (t.api, C.heartbeat_annotation(C.MIG_KIND))):
            api.patch("Node", "h0", mutate=lambda n, k=key:
                      n.metadata.annotations.update({k: "2"}))
        t.step()
        assert t.node("h0").metadata.annotations[C.ANNOT_DEFRAG_DRAIN] == \
            "migrate:mps:node-suspect"
        assert t.pod("r0").metadata.annotations[C.ANNOT_MIGRATE] == \
            "node-suspect"
        assert t.records(port_journal.JOB_DISPLACED) == []

    def test_stray_drain_of_recovered_node_is_healed(self, twin):
        t = twin(spares=0, grace=300.0)
        t.annotate("h0", C.ANNOT_DEFRAG_DRAIN, "migrate:mps:node-suspect")
        t.create_pod("r0", "h0", annotations={C.ANNOT_MIGRATE: "node-suspect"})
        t.step()                        # first sight: held
        assert C.ANNOT_DEFRAG_DRAIN in t.node("h0").metadata.annotations
        t.annotate("h0", C.heartbeat_annotation(KIND), "2")
        t.step(1.0)                     # moved: retracted
        assert C.ANNOT_DEFRAG_DRAIN not in t.node("h0").metadata.annotations
        assert C.ANNOT_MIGRATE not in t.pod("r0").metadata.annotations

    def test_stray_drain_of_still_dead_node_is_adopted(self, twin):
        t = twin(spares=0, grace=300.0)
        t.annotate("h0", C.ANNOT_DEFRAG_DRAIN, "migrate:mps:node-suspect")
        t.create_pod("r0", "h0", annotations={C.ANNOT_MIGRATE: "node-suspect"})
        self._suspect_h0(t)
        assert t.node("h0").metadata.annotations[C.ANNOT_DEFRAG_DRAIN] == \
            "migrate:mps:node-suspect"
        assert t.records(port_journal.JOB_DISPLACED) == []

    def test_straggler_eviction_fires_once_per_pod(self, twin, monkeypatch):
        import nos_tpu.scheduler.gang as jax_gang_mod
        import nos_tpu_torch.scheduler.gang as gang_mod

        calls = {True: [], False: []}
        for mod, jax in ((jax_gang_mod, True), (gang_mod, False)):
            monkeypatch.setattr(
                mod, "evict_gang", lambda api, pod, jax=jax:
                (calls[jax].append(pod.key), [pod.key])[1])
        t = twin(spares=0, grace=3.0)
        t.create_pod("r0", "h0")
        self._suspect_h0(t)
        for _ in range(4):
            t.step(2.0)
        assert calls[False] == calls[True] == ["work/r0"]

    def test_other_family_drain_defers_begin_inside_the_write(self, twin):
        t = twin(spares=0, grace=300.0)
        t.annotate("h0", C.ANNOT_DEFRAG_DRAIN, "migrate:mig:maintenance")
        t.create_pod("r0", "h0")
        self._suspect_h0(t)
        assert t.node("h0").metadata.annotations[C.ANNOT_DEFRAG_DRAIN] == \
            "migrate:mig:maintenance"
        assert C.ANNOT_MIGRATE not in t.pod("r0").metadata.annotations
        assert t.records(port_journal.JOB_DISPLACED) == []

    def test_maintenance_annotation_drains_without_suspicion(self, twin):
        t = twin(spares=0, grace=300.0)
        t.annotate("h1", C.ANNOT_MAINTENANCE, "planned-reboot")
        t.step()
        assert t.node("h1").metadata.annotations[C.ANNOT_DEFRAG_DRAIN] == \
            "migrate:mps:maintenance"
        assert not t.q.is_quarantined("h1")
        t.annotate("h1", C.ANNOT_MAINTENANCE, None)
        t.step()
        assert C.ANNOT_DEFRAG_DRAIN not in t.node("h1").metadata.annotations

    def test_disabled_plane_heals_a_predecessor_s_stray_once(self):
        """heal_stray_migration_drains on both packages: the family's own
        drain and stamps go, the other family's drain stays."""
        sides = []
        for jax in (True, False):
            api = JaxAPIServer() if jax else APIServer()
            mk = (lambda n, **kw: jax_node(n, "pod-0", 0)) if jax else \
                (lambda n, **kw: factory.make_gpu_node(n, domain="pod-0"))
            K, drain = (JC, "timeshare") if jax else (C, KIND)
            other = "slice" if jax else C.MIG_KIND
            for name, owner in (("h0", drain), ("h1", other)):
                node = mk(name)
                node.metadata.annotations[K.ANNOT_DEFRAG_DRAIN] = \
                    K.migration_drain_value(owner, "maintenance")
                api.create("Node", node)
            api.create("Pod", (jax_factory if jax else factory)
                       .make_timeshare_pod(24, name="r0", namespace="work",
                                           node_name="h0", phase="Running",
                                           annotations={K.ANNOT_MIGRATE:
                                                        "maintenance"}))
            heal = (jax_failure.heal_stray_migration_drains if jax
                    else heal_stray_migration_drains)
            healed = heal(api, drain)
            sides.append((healed,
                          {n.metadata.name: port_value(
                              n.metadata.annotations.get(
                                  K.ANNOT_DEFRAG_DRAIN, ""))
                           for n in api.list("Node")},
                          api.get("Pod", "r0", "work").metadata.annotations
                          .get(K.ANNOT_MIGRATE)))
        assert sides[0] == sides[1] == (
            1, {"h0": "", "h1": "migrate:mig:maintenance"}, None)


# ---------------------------------------------------------------------------
# Both packages' loops with the recovery plane: random clusters
# ---------------------------------------------------------------------------

LOOP_RECORDS = fleet.RECOVERY_RECORDS + (
    port_journal.PLAN_CYCLE, port_journal.HANDSHAKE_WAIT)


class RecoveryTwin:
    """``fleet.PortRecoveryOps`` and ``JaxRecoveryOps`` on one clock, each
    journal installed; ``tick`` runs a scheduler cycle, a controller poll
    and the agents' ticks on both, then compares every node's labels,
    annotations (keys mapped, plan ids masked in order of appearance)
    and allocatable, the device plugin's ConfigMap, every pod's node,
    phase and recovery stamps, the quarantine and the journal."""

    @staticmethod
    def build(monkeypatch, recovery: bool = True):
        jops = JaxRecoveryOps(monkeypatch, recovery)
        ops = fleet.PortRecoveryOps(recovery)
        ops.now = jops.now
        monkeypatch.setattr(port_journal, "_journal", ops.journal)
        monkeypatch.setattr(port_ledger, "_ledger", port_ledger.ChipSecondLedger(
            clock=lambda: jops.now[0]))
        return ops, jops

    def __init__(self, monkeypatch, nodes: list[dict],
                 recovery: bool = True) -> None:
        from test_torch_controller import PlanMask

        self.ops, self.jops = self.build(monkeypatch, recovery)
        self.now = self.jops.now
        self.masks = {True: PlanMask(), False: PlanMask()}
        self.wedged: set[str] = set()
        for n in nodes:
            self.both(lambda o: o.add_node(n))
        self.compare()

    def both(self, fn) -> tuple:
        return fn(self.jops), fn(self.ops)

    def tick(self, seconds: float = 1.0) -> None:
        self.now[0] += seconds
        self.both(lambda o: o.cycle())
        self.compare()
        self.both(lambda o: o.poll())
        self.compare()
        self.both(lambda o: o.tick(sorted(n for n in o.agents()
                                          if n not in self.wedged)))
        self.compare()

    def annotate(self, name: str, key: str, value: str | None) -> None:
        for api, k, v in ((self.jops.api, TO_JAX[key],
                           None if value is None else jax_value(value)),
                          (self.ops.api, key, value)):
            def mutate(n, k=k, v=v):
                if v is None:
                    n.metadata.annotations.pop(k, None)
                else:
                    n.metadata.annotations[k] = v
            api.patch("Node", name, mutate=mutate)

    def view(self, jax: bool) -> dict:
        from test_torch_controller import node_key
        from test_torch_timeshare import (
            jax_config_table, port_config_table, port_resource)

        o = self.jops if jax else self.ops
        mask = self.masks[jax]
        K = JC if jax else C
        kind = JAX_KIND if jax else KIND
        nodes = sorted(o.api.list("Node"), key=lambda n: n.metadata.name)
        for n in nodes:
            mask.learn(n.metadata.annotations.get(
                K.spec_plan_annotation(kind), ""))
        cm = o.api.try_get("ConfigMap", (jax_ts if jax else ts)
                           .DEVICE_PLUGIN_CM_NAME,
                           (jax_ts if jax else ts).DEVICE_PLUGIN_CM_NAMESPACE)
        data = cm.data if cm is not None else {}
        for k in sorted(data, key=lambda k: k.rsplit(".", 1)[0]):
            mask.learn(k.rsplit(".", 1)[1])

        def key(k):
            return (KEYS.get(k) or node_key(k)) if jax else k

        def value(v):
            return mask(port_value(v) if jax else v)

        import json as _json
        table = jax_config_table if jax else port_config_table
        return {
            "nodes": {n.metadata.name: (
                {key(k): value(v) for k, v in n.metadata.labels.items()
                 if key(k) in NODE_LABELS + (C.LABEL_DEVICE_PLUGIN_CONFIG,)},
                {key(k): value(v) for k, v in n.metadata.annotations.items()},
                {port_resource(r) if jax else r: q
                 for r, q in n.status.allocatable.items()})
                for n in nodes},
            "config": {mask(k): table(_json.loads(v))
                       for k, v in data.items()},
            "pods": {p.metadata.name: (
                p.spec.node_name, p.status.phase,
                {key(k): port_value(v) if jax else v
                 for k, v in p.metadata.annotations.items()
                 if key(k) in POD_ANNOTS})
                for p in o.api.list("Pod")},
            "quarantine": {n: r for n, (r, _) in
                           o.controller.quarantine.items().items()},
            "journal": (jax_records(o.journal, LOOP_RECORDS) if jax
                        else port_records(o.journal, LOOP_RECORDS)),
            "holds": ledger_holds(
                (jax_ledger if jax else port_ledger).get_ledger(), mask,
                KINDS if jax else {}),
        }

    def compare(self) -> None:
        assert self.view(False) == self.view(True)
        # the waterfalls after every step, plan ids masked on both sides
        reports = []
        for jax in (False, True):
            mask = self.masks[jax]
            report = (jax_ledger if jax else port_ledger).get_ledger() \
                .report()
            for pool in report["pools"].values():
                pool["evidence"] = {
                    cat: {k: (KINDS.get(v, mask(v)) if isinstance(v, str)
                              else v) for k, v in ev.items()}
                    for cat, ev in pool["evidence"].items()}
            reports.append(report)
        assert_same_waste(*reports, evidence=None)

    def close(self) -> None:
        self.both(lambda o: o.sched.close())


def random_nodes(rng) -> list[dict]:
    """Two NVLink domains of 2-3 nodes, 0-2 unlabelled nodes, and a warm
    spare in each domain."""
    nodes = []
    for d in ("nvl-0", "nvl-1"):
        for i in range(int(rng.integers(2, 4))):
            nodes.append({"name": f"{d}-h{i}", "domain": d,
                          "host_index": i})
        nodes.append({"name": f"{d}-spare", "domain": d,
                      "host_index": 100, "spare": True})
    for i in range(int(rng.integers(0, 3))):
        nodes.append({"name": f"loose-{i}", "domain": "",
                      "host_index": None})
    return nodes


def drive_random(t: RecoveryTwin, rng, ticks: int = 40) -> dict:
    """A random story: pods (some in gangs of two) arriving and
    finishing, kills, wedged agents that recover or die, maintenance
    stamps set and lifted; the workload controller recreates a killed
    or evicted pod with the displaced stamp.  Returns what happened."""
    from nos_tpu_torch.utils.pod_util import displaced_value

    jobs: dict[str, dict] = {}
    seq = 0
    happened = {"kills": 0, "wedges": 0, "maintenance": 0}
    for tick in range(ticks):
        r = rng.random()
        live = {n for n, _, _ in t.ops.pods()}
        nodes = t.ops.nodes()
        active = sorted(n for n, (d, _, spare) in nodes.items()
                        if not spare)
        if r < 0.35 or tick < 4:
            seq += 1
            name = f"j{seq}"
            gang = rng.random() < 0.25
            gb = int(rng.choice([10, 20, 40, 80]))
            job = {"name": name, "gb": gb, "created": t.now[0] + seq * 1e-3,
                   "pods": [f"{name}-{i}" for i in range(2 if gang else 1)],
                   "priority": int(rng.integers(0, 3))}
            jobs[name] = job
            if gang:
                t.both(lambda o: o.create_group(name, 2))
            for p in job["pods"]:
                t.both(lambda o, p=p: o.create_pod({
                    "name": p, "gb": gb, "priority": job["priority"],
                    "created": job["created"],
                    "gang": name if gang else "", "displaced": ""}))
        elif r < 0.5 and jobs:
            name = sorted(jobs)[int(rng.integers(0, len(jobs)))]
            job = jobs.pop(name)
            for p in job["pods"]:
                t.both(lambda o, p=p: o.delete_pod(p))
            if len(job["pods"]) > 1:
                t.both(lambda o: o.delete_group(name))
        elif r < 0.58 and active:
            victim = active[int(rng.integers(0, len(active)))]
            t.wedged.discard(victim)
            t.both(lambda o: o.kill(victim))
            happened["kills"] += 1
        elif r < 0.68 and active:
            victim = active[int(rng.integers(0, len(active)))]
            if victim in t.wedged:
                t.wedged.discard(victim)
            else:
                t.wedged.add(victim)
                happened["wedges"] += 1
        elif r < 0.75 and active:
            victim = active[int(rng.integers(0, len(active)))]
            stamped = C.ANNOT_MAINTENANCE in t.ops.api.get(
                KIND_NODE, victim).metadata.annotations
            t.annotate(victim, C.ANNOT_MAINTENANCE,
                       None if stamped else "planned")
            happened["maintenance"] += 1
        t.compare()
        # the workload controller: a live job's missing pods come back
        for job in jobs.values():
            for p in job["pods"]:
                if p not in live or p in {n for n, _, _ in t.ops.pods()}:
                    continue
                stamp = displaced_value(C.DISPLACED_NODE_LOSS, t.now[0])
                t.both(lambda o, p=p, job=job: o.create_pod({
                    "name": p, "gb": job["gb"],
                    "priority": job["priority"], "created": job["created"],
                    "gang": job["name"] if len(job["pods"]) > 1 else "",
                    "displaced": stamp}))
        t.tick(float(rng.choice([0.5, 1.0, 2.0])))
    return happened


class TestRandomClusters:
    @pytest.mark.parametrize("seed", range(12))
    def test_every_write_is_jax_s(self, seed, monkeypatch):
        rng = np.random.default_rng(7000 + seed)
        t = RecoveryTwin(monkeypatch, random_nodes(rng))
        happened = drive_random(t, rng)
        t.close()
        assert sum(happened.values()) > 0


class TestRecoveryFleet:
    def test_the_fleet_is_jax_s(self, monkeypatch):
        """The recovery fleet on both packages to one summary, pinned as
        chip_smoke's RECOVERY_FLEET_DIGEST; every mechanism ran, and no
        displaced job was left unbound."""
        spec = fleet.recovery_fleet_spec(0)
        jout = run_jax_recovery_fleet(monkeypatch, spec)
        out = fleet.run_recovery_fleet(spec)
        assert out["summary"] == jout["summary"]
        assert fleet.plan_digest(out["summary"]) == \
            chip_smoke.RECOVERY_FLEET_DIGEST
        # the waterfall: JAX's per pool and category, pinned for the card
        assert_same_waste(
            out["waste"], jout["waste"],
            evidence=lambda e: without_plan_ids(jax_evidence(e)),
            port_evidence=without_plan_ids)
        assert fleet.plan_digest(fleet.waste_summary(jout["waste"])) == \
            chip_smoke.RECOVERY_FLEET_WASTE_DIGEST
        # bench_nodeloss.py's gate against the no-recovery baseline
        base = out["baseline"]
        assert base["promotions"] == base["suspicions"] == 0
        assert 0 < out["lost_gpu_seconds"] <= \
            fleet.RECOVERY_LOST_HALVING * base["lost_gpu_seconds"]
        assert out["lost_ratio"] == \
            out["lost_gpu_seconds"] / base["lost_gpu_seconds"]
        assert base["displaced_episodes"] > 0
        assert port_ledger.conservation_ok(base["waste"])
        assert out["never_rebound"] == 0 and out["displaced_episodes"] > 3
        assert out["suspicions"] >= 1 and out["promotions"] >= 3
        assert out["migrations"] >= 1 and out["straggler_evictions"] >= 1
        assert out["rebind_p90_s"] < 15.0
        nodes = out["summary"]["nodes"]
        # each promoted spare holds a vacated index; the rest stay warm
        promoted = [int(idx) for n, (d, idx, spare) in nodes.items()
                    if n.startswith("spare") and not spare]
        assert len(promoted) == out["promotions"]
        assert all(idx < fleet.RECOVERY_SPARE_INDEX for idx in promoted)


class TestOffMeansOff:
    @pytest.mark.parametrize("family", [C.MPS_KIND, C.MIG_KIND])
    def test_no_knob_builds_no_policy(self, family):
        from nos_tpu_torch.partitioning.slicepart import (
            new_slice_partitioner_controller)

        make = (ts.new_timeshare_partitioner_controller
                if family == C.MPS_KIND else new_slice_partitioner_controller)
        assert make(APIServer(), ClusterState())._recovery is None
        for kw in ({"spare_hosts_per_pool": 1},
                   {"node_suspect_after_s": 2.0}):
            ctl = make(APIServer(), ClusterState(), **kw)
            assert isinstance(ctl._recovery, SelfHealingPolicy)
            assert ctl._recovery._kind == family

    def test_a_quiet_loop_decides_alike_on_and_off(self, monkeypatch):
        """No failure, no spare: the plane built and armed writes and
        journals exactly what the loop without it does (both packages)."""
        runs = []
        for recovery in (False, True):
            rng = np.random.default_rng(5)
            nodes = [{"name": f"h{i}", "domain": "nvl-0", "host_index": i}
                     for i in range(3)]
            t = RecoveryTwin(monkeypatch, nodes, recovery=recovery)
            for tick in range(12):
                if tick < 6:
                    gb = int(rng.choice([20, 40, 80]))
                    t.both(lambda o, tick=tick: o.create_pod({
                        "name": f"p{tick}", "gb": gb, "priority": 0,
                        "created": float(tick), "gang": "",
                        "displaced": ""}))
                t.tick()
            runs.append(t.view(False))
            t.close()
        assert runs[0] == runs[1]

    def test_the_first_poll_heals_a_predecessor_s_drain(self, monkeypatch):
        """A controller without the plane retracts the MPS family's
        migration drain a predecessor left, once, on both packages."""
        t = RecoveryTwin(monkeypatch, [
            {"name": "h0", "domain": "nvl-0", "host_index": 0}],
            recovery=False)
        t.annotate("h0", C.ANNOT_DEFRAG_DRAIN, "migrate:mps:maintenance")
        t.compare()
        t.tick()
        assert C.ANNOT_DEFRAG_DRAIN not in t.ops.api.get(
            KIND_NODE, "h0").metadata.annotations
        t.annotate("h0", C.ANNOT_DEFRAG_DRAIN, "migrate:mps:maintenance")
        t.tick()                        # once: a later drain stays
        assert C.ANNOT_DEFRAG_DRAIN in t.ops.api.get(
            KIND_NODE, "h0").metadata.annotations
        t.close()

    def test_spares_and_drains_stay_out_of_the_plan(self, monkeypatch):
        """The controller leaves warm spares and migrating nodes out of
        its snapshot: a pod that only they could hold plans nothing."""
        t = RecoveryTwin(monkeypatch, [
            {"name": "s0", "domain": "nvl-0", "host_index": 100,
             "spare": True},
            {"name": "m0", "domain": "nvl-0", "host_index": 0}])
        t.annotate("m0", C.ANNOT_MAINTENANCE, "planned")
        t.tick()
        t.both(lambda o: o.create_pod({
            "name": "p", "gb": 80, "priority": 0, "created": 1.0,
            "gang": "", "displaced": ""}))
        for _ in range(4):
            t.tick()
        assert t.ops.pods() == [("p", "", "Pending")]
        assert not [r for r in port_records(t.ops.journal,
                                            (port_journal.PLAN_CYCLE,))]
        t.close()


# ---------------------------------------------------------------------------
# chip_smoke's phase 13 (c): the card loop, on both packages
# ---------------------------------------------------------------------------

SMOKE_DEVICE = {"model": "nvidia-h100-80gb-hbm3", "memory_bytes": 85e9,
                "uuids": ["GPU-0"]}


def _recovery_port_object(orig):
    """test_torch_scheduler's JAX-to-port object converter, with the
    recovery plane's names: a node's drain in the port's family names, a
    pod's migrate and displaced stamps under the port's keys."""
    def convert(obj):
        out = orig(obj)
        annots = obj.metadata.annotations
        if hasattr(obj.status, "allocatable"):
            drain = annots.get(JC.ANNOT_DEFRAG_DRAIN)
            out.metadata.annotations.pop(JC.ANNOT_DEFRAG_DRAIN, None)
            if drain:
                out.metadata.annotations[C.ANNOT_DEFRAG_DRAIN] = \
                    port_value(drain)
        elif hasattr(obj.spec, "node_name"):
            for k in (JC.ANNOT_MIGRATE, JC.ANNOT_DISPLACED):
                if annots.get(k):
                    out.metadata.annotations[KEYS[k]] = annots[k]
        return out
    return convert


def _jax_recovery_loop(monkeypatch, clock, advance,
                       rest: bool = False) -> tuple[dict, dict]:
    """chip_smoke's _recovery_start and _recovery_migrate on the JAX
    package's loop (the one-GPU stand-in, the timeshare family with the
    recovery plane at the smoke's knobs), step for step: in memory, or
    (``rest``) on the JAX package's REST client over a stub of its own,
    recorded through the stub's commit log as the smoke records.
    Returns the writes and the rejections' verdicts while the node was
    drained."""
    import contextlib
    import functools

    import nos_tpu.kube.k8s_codec as jcodec
    import test_torch_scheduler as tts
    from nos_tpu.kube.rest import KubeClient as JaxKubeClient
    from nos_tpu.kube.rest import KubeConfig as JaxKubeConfig
    from nos_tpu.utils.pod_util import displaced_value as jax_displaced

    from k8s_stub import StubApiServer

    monkeypatch.setattr(tts, "_as_port_object",
                        _recovery_port_object(tts._as_port_object))
    monkeypatch.setattr(
        jax_ts, "new_timeshare_partitioner_controller", functools.partial(
            jax_ts.new_timeshare_partitioner_controller,
            node_suspect_after_s=chip_smoke.RECOVERY_SUSPECT_AFTER_S,
            migrate_grace_s=chip_smoke.RECOVERY_GRACE_S))
    with contextlib.ExitStack() as stack:
        api = watch = None
        if rest:
            stub = stack.enter_context(StubApiServer())
            api = JaxKubeClient(JaxKubeConfig(server=stub.url))
            stack.callback(api.close)
            tap = chip_smoke._StubTap(stub, decode=jcodec.from_k8s)
            watch = tap.watch
        loop = tts._JaxCardLoop(monkeypatch, clock, advance, quotas=(),
                                api=api, watch=watch)
        stack.callback(loop.sched.close)
        writes, verdicts = _jax_recovery_story(loop, clock, jax_displaced,
                                               rest)
        if rest:
            assert not tap.errors
    return writes, verdicts


def _jax_recovery_story(loop, clock, jax_displaced, rest: bool):
    frozen = [False]

    def step() -> None:
        loop.advance()
        loop.sched.run_cycle()
        loop.controller.process_if_ready()
        if not frozen[0]:
            loop.agent.tick()
        if rest:
            time.sleep(chip_smoke.CARD_POLL_S)

    def until(done) -> None:
        for _ in range(400):
            if done():
                return
            step()
        raise AssertionError("the JAX loop did not get there")

    def create(name: str, annotations=None) -> None:
        loop.api.create("Pod", jax_factory.make_timeshare_pod(
            chip_smoke.RECOVERY_GB, name=name, creation_timestamp=clock(),
            annotations=annotations))

    def pods() -> dict:
        return {p.metadata.name: p for p in loop.api.list("Pod")}

    job, batch, node = (chip_smoke.RECOVERY_JOB, chip_smoke.RECOVERY_BATCH,
                        chip_smoke.CARD_NODE)
    quarantine = loop.controller.quarantine
    create(job)
    until(lambda: loop.running() == [job])
    create(batch)
    until(lambda: pods()[batch].is_unschedulable())
    frozen[0] = True
    until(lambda: quarantine.reason(node) == "heartbeat-suspect")
    assert pods()[job].metadata.annotations[JC.ANNOT_MIGRATE] == \
        "node-suspect"
    # the job's child leaves at its checkpoint: the kubelet reports the
    # pod Succeeded, its controller deletes it and makes it anew
    loop.api.patch("Pod", job, "default", mutate=lambda p: setattr(
        p.status, "phase", "Succeeded"))
    loop.api.delete("Pod", job, "default")
    create(job, {JC.ANNOT_DISPLACED: jax_displaced(
        JC.DISPLACED_DRAIN_MIGRATE, clock())})
    n = len(jax_journal._journal.events("pod-rejected"))

    def verdicts() -> dict:
        return {r.subject: r.attrs.get("nodes", {}).get(node, "")
                for r in jax_journal._journal.events("pod-rejected")[n:]}

    until(lambda: len(verdicts()) == 2)
    got = verdicts()
    frozen[0] = False
    until(lambda: not quarantine.is_quarantined(node)
          and not JC.is_migration_drain(
              loop.api.get("Node", node).metadata.annotations))
    until(lambda: bool(pods()[job].spec.node_name))
    assert not pods()[batch].spec.node_name
    until(lambda: job in loop.running())
    return loop.writes, got


class TestSmokeRecovery:
    def _port(self, monkeypatch, injected: bool, polls: int = 0,
              rest: bool = False):
        """The smoke's loop, in memory or over the REST stub as the smoke
        runs it; the checkpoint lands after ``polls`` polls of ``landed``
        (a child's start takes thousands of loop passes on the card) and
        the child leaves at once."""
        import contextlib

        from test_torch_scheduler import _fresh_journal, _injected_clock

        from k8s_stub import StubApiServer
        from nos_tpu_torch.kube.rest import KubeClient, KubeConfig

        _fresh_journal(monkeypatch)
        asked, left = [0], []

        def landed() -> bool:
            asked[0] += 1
            return asked[0] > polls

        def leave() -> bool:
            left.append(1)
            return True

        with contextlib.ExitStack() as stack:
            kw = {}
            if rest:
                stub = stack.enter_context(StubApiServer())
                client = KubeClient(KubeConfig(server=stub.url))
                stack.callback(client.close)
                tap = chip_smoke._StubTap(stub)
                kw = {"api": client, "watch": tap.watch}
            if injected:
                clock, advance = _injected_clock()
                loop, card = chip_smoke._recovery_start(
                    SMOKE_DEVICE, clock=clock, wall=clock, advance=advance,
                    poll_s=0.0, **kw)
                stack.callback(loop.sched.close)
                moved = chip_smoke._recovery_migrate(
                    loop, landed, leave, advance=advance, poll_s=0.0)
            else:
                loop, card = chip_smoke._recovery_start(SMOKE_DEVICE, **kw)
                stack.callback(loop.sched.close)
                moved = chip_smoke._recovery_migrate(loop, landed, leave)
            if rest:
                assert not tap.errors
        return loop, moved, left

    @pytest.mark.parametrize("injected", [False, True],
                             ids=["monotonic", "injected"])
    def test_the_card_loop_writes_what_the_smoke_pins(self, monkeypatch,
                                                      injected):
        """Phase 13 (c)'s loop in memory with its children left out (the
        checkpoint taken as landed, the child leaving at once):
        suspected, drained, the job stamped, left, deleted and
        recreated, both pods refused while drained, the node released
        and the job bound before the batch pod; every write as the JAX
        package's loop writes them."""
        from test_torch_scheduler import _fresh_journal, _injected_clock

        loop, moved, left = self._port(monkeypatch, injected,
                                       polls=5000 if injected else 0)
        assert left
        assert moved["frozen"] <= moved["suspected"] <= moved["stamped"] \
            <= moved["left"] <= moved["deleted"] <= moved["resumed"] \
            <= moved["released"] <= moved["rebound"]
        _fresh_journal(monkeypatch)
        clock, advance = _injected_clock()
        writes, _ = _jax_recovery_loop(monkeypatch, clock, advance)
        assert loop.writes == writes

    @pytest.mark.parametrize("injected", [False, True],
                             ids=["monotonic", "injected"])
    def test_the_loop_over_rest_writes_what_the_smoke_pins(
            self, monkeypatch, injected):
        """The same story over the REST stub, as the card runs it: what
        the stub commits is RECOVERY_LOOP_WRITES."""
        loop, moved, left = self._port(monkeypatch, injected,
                                       polls=50 if injected else 0,
                                       rest=True)
        assert left
        assert moved["stamped"] <= moved["left"] <= moved["deleted"] \
            <= moved["released"] <= moved["rebound"]
        assert loop.writes == chip_smoke.RECOVERY_LOOP_WRITES

    def test_the_jax_loop_writes_the_pinned_record(self, monkeypatch):
        """The JAX package's loop on its own REST client over the stub
        commits RECOVERY_LOOP_WRITES."""
        from test_torch_scheduler import _fresh_journal, _injected_clock

        _fresh_journal(monkeypatch)
        clock, advance = _injected_clock()
        writes, verdicts = _jax_recovery_loop(monkeypatch, clock, advance,
                                              rest=True)
        assert writes == chip_smoke.RECOVERY_LOOP_WRITES
        assert all(chip_smoke.RECOVERY_DRAINED in v
                   for v in verdicts.values()) and len(verdicts) == 2

    def test_the_smoke_refuses_a_job_left_on_the_drained_node(
            self, monkeypatch):
        """Without MigrationDrainGuard the recreated job would bind back
        onto the drained node: the smoke must refuse that."""
        import nos_tpu_torch.cmd.assembly as assembly

        monkeypatch.setattr(assembly, "MigrationDrainGuard",
                            assembly.NodeResourcesFit)
        with pytest.raises(SystemExit):
            self._port(monkeypatch, True)

    def test_the_smoke_refuses_a_child_evicted_before_it_left(
            self, monkeypatch):
        """A child that never leaves is evicted after the grace: the
        smoke must refuse that."""
        from test_torch_scheduler import _fresh_journal, _injected_clock

        _fresh_journal(monkeypatch)
        clock, advance = _injected_clock()

        def fast():                 # the grace passes in a few passes
            for _ in range(100):
                advance()

        loop, _ = chip_smoke._recovery_start(
            SMOKE_DEVICE, clock=clock, wall=clock, advance=advance,
            poll_s=0.0)
        try:
            with pytest.raises(SystemExit):
                chip_smoke._recovery_migrate(loop, lambda: True,
                                             lambda: False, advance=fast,
                                             poll_s=0.0)
        finally:
            loop.sched.close()


class TestMigRecovery:
    def test_the_card_story_through_the_mig_family(self, monkeypatch):
        """Phase 13 (c)'s story on one H100 of the MIG stand-in
        (``tests/test_torch_sliceagent.py``'s Twin, JAX's v5e cut to {2x4,
        2x2}): a 7g.80gb job and a 7g.80gb batch pod, the agent frozen,
        the node suspected and drained, the job stamped and evicted,
        recreated displaced and refused while drained; the agent resumes
        and the job binds before the batch pod.  Every write compared
        after every step, both schedulers from ``build_scheduler``."""
        import functools

        import nos_tpu.partitioning.slicepart.factory as jax_sp_factory
        import test_torch_sliceagent as tsa

        knobs = dict(node_suspect_after_s=5.0, migrate_grace_s=3.0)
        monkeypatch.setattr(
            jax_sp_factory, "new_slice_partitioner_controller",
            functools.partial(jax_sp_factory.new_slice_partitioner_controller,
                              **knobs))
        monkeypatch.setattr(
            tsa.sp, "new_slice_partitioner_controller",
            functools.partial(tsa.sp.new_slice_partitioner_controller,
                              **knobs))
        orig = tsa.port_annotation

        def annotation(key, value):
            if key == JC.ANNOT_DEFRAG_DRAIN:
                return C.ANNOT_DEFRAG_DRAIN, port_value(value)
            return orig(key, value)

        monkeypatch.setattr(tsa, "port_annotation", annotation)
        t = tsa.Twin(monkeypatch)
        t.jsched = jax_build_scheduler(t.japi, clock=lambda: t.now[0])
        t.tick()
        t.demand("rj", tsa.WHOLE)
        t.tick()
        t.demand("bq", tsa.WHOLE)
        assert t.pod("rj").status.phase == "Running"
        assert not t.pod("bq").spec.node_name
        # the agent freezes: polls without ticks
        t.process()
        t.advance(6.0)
        t.process()
        assert t.pc.quarantine.reason("host-0") == REASON_SUSPECT
        assert t.node().metadata.annotations[C.ANNOT_DEFRAG_DRAIN] == \
            "migrate:mig:node-suspect"
        for pod in (t.pod("rj"), t.japi.get("Pod", "rj", "default")):
            assert pod.metadata.annotations.get(
                C.ANNOT_MIGRATE, pod.metadata.annotations.get(
                    JC.ANNOT_MIGRATE)) == "node-suspect"
        t.advance(3.5)
        t.process()
        assert t.api.try_get(KIND_POD, "rj", "default") is None
        from nos_tpu.utils.pod_util import displaced_value as jd
        from nos_tpu_torch.utils.pod_util import displaced_value

        t.japi.create("Pod", jax_factory.make_slice_pod(
            tsa.TO_JAX[tsa.WHOLE], 1, name="rj", annotations={
                JC.ANNOT_DISPLACED: jd(JC.DISPLACED_DRAIN_MIGRATE,
                                       t.now[0])}))
        t.api.create(KIND_POD, factory.make_mig_pod(
            tsa.WHOLE, 1, name="rj", annotations={
                C.ANNOT_DISPLACED: displaced_value(
                    C.DISPLACED_DRAIN_MIGRATE, t.now[0])}))
        t.compare()
        assert t.schedule() == 0        # both refused while drained
        t.tick()                        # the agent reports again
        t.advance(1.0)
        t.process()
        assert not t.pc.quarantine.is_quarantined("host-0")
        assert C.ANNOT_DEFRAG_DRAIN not in t.node().metadata.annotations
        assert t.schedule() == 1
        assert t.pod("rj").spec.node_name == "host-0"
        assert not t.pod("bq").spec.node_name
        t.tick()
        assert t.pod("rj").status.phase == "Running"
        t.jsched.close()
        t.sched.close()
