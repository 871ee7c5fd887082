"""The port's partitioner controller and MPS node side
(nos_tpu_torch/controllers/, partitioning/timeshare/factory.py,
device/timeshare_plugin.py, testing/bind.py) against the JAX package's
controller, chip agent and scheduler, driven through one event sequence
under one injected clock and compared exactly after every step.

Both sides run the loop of ``tests/test_e2e_timeshare.py``'s ``Harness``:
node and pod controllers feeding a ``ClusterState``, the MPS (timeshare)
partitioner controller from its factory, one chip agent per node, and a
binder: ``Scheduler.run_cycle`` on the JAX side, ``bind_pending`` on the
port's.  The JAX side runs on the 80 GB, 8-chip TPU generation that
``test_torch_timeshare.py`` builds (one chip stands for one GPU), its
factory's snapshot taker given that generation's registry; ``nos_tpu/``
is used as it is.  Every scenario keeps at most one node that fits each
pod when it binds (asserted before each bind), so that the two binders
cannot choose differently.

Compared after every step: ``process_if_ready``'s return, the node
annotations and the labels the loop wrote (keys mapped, plan ids masked
in order of appearance), the ConfigMap as a GPU -> share -> replicas
table, the advertised allocatable, the pods' phases and nodes, the
quarantine set with its reasons, the controller's journal records, and
the counters ``nos_tpu_plans_total``,
``nos_tpu_plan_deadline_exceeded_total``,
``nos_tpu_replan_epoch_deferred_total`` and
``nos_tpu_actuation_breaker_open_total`` (deltas).
"""

from __future__ import annotations

import json

import pytest

import nos_tpu.api.constants as JC
import nos_tpu.partitioning.timeshare as jax_ts
import nos_tpu.partitioning.timeshare.factory as jax_ts_factory
from nos_tpu.controllers.chipagent import ChipAgent as JaxChipAgent
from nos_tpu.controllers.node_controller import (
    NodeController as JaxNodeController,
)
from nos_tpu.controllers.pod_controller import PodController as JaxPodController
from nos_tpu.exporter.metrics import REGISTRY as JAX_REGISTRY
from nos_tpu.kube.client import APIServer as JaxAPIServer
from nos_tpu.obs import journal as jax_journal, ledger as jax_ledger
from nos_tpu.partitioning.state import ClusterState as JaxClusterState
from nos_tpu.scheduler.framework import Framework as JaxFramework
from nos_tpu.scheduler.scheduler import Scheduler as JaxScheduler
from nos_tpu.testing import factory as jax_factory

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.controllers.chipagent import ChipAgent
from nos_tpu_torch.controllers.node_controller import NodeController
from nos_tpu_torch.controllers.pod_controller import PodController
from nos_tpu_torch.exporter.metrics import REGISTRY
from nos_tpu_torch.kube.client import (
    APIServer, KIND_CONFIGMAP, KIND_NODE, KIND_POD,
)
from nos_tpu_torch.kube.objects import PENDING, RUNNING
from nos_tpu_torch.obs import journal as port_journal
from nos_tpu_torch.partitioning import timeshare as ts
from nos_tpu_torch.partitioning.core import (
    REASON_ACTUATION, REASON_PLAN_DEADLINE,
)
from nos_tpu_torch.partitioning.state import ClusterState
from nos_tpu_torch.scheduler.framework import CycleState, Framework
from nos_tpu_torch.testing import factory
from nos_tpu_torch.testing.bind import _node_infos, bind_pending
from nos_tpu_torch.topology.annotations import (
    parse_status_annotations, spec_plan_id, status_plan_id,
)

from test_torch_timeshare import (
    JAX_GEN, JAX_REG, jax_config_table, port_config_table, port_key,
    port_resource,
)

BATCH_TIMEOUT_S = 60.0
BATCH_IDLE_S = 10.0
DEADLINE_S = 3 * BATCH_TIMEOUT_S
JAX_KIND = "timeshare"
COUNTERS = ("nos_tpu_plans_total", "nos_tpu_plan_deadline_exceeded_total",
            "nos_tpu_replan_epoch_deferred_total",
            "nos_tpu_actuation_breaker_open_total")
JOURNALED = (port_journal.PLAN_CYCLE, port_journal.HANDSHAKE_WAIT,
             port_journal.QUARANTINED, port_journal.QUARANTINE_RELEASED)
# the node-side keys test_torch_timeshare's port_key does not map
NODE_KEYS = {
    JC.status_plan_annotation(JAX_KIND): C.status_plan_annotation(C.MPS_KIND),
    JC.heartbeat_annotation(JAX_KIND): C.heartbeat_annotation(C.MPS_KIND),
    JC.ANNOT_PLUGIN_GENERATION: C.ANNOT_PLUGIN_GENERATION,
    JC.ANNOT_PLUGIN_APPLIED_CONFIG: C.ANNOT_PLUGIN_APPLIED_CONFIG,
}


def node_key(key: str) -> str:
    """A JAX node annotation or label key under the port's name."""
    return NODE_KEYS.get(key) or port_key(key)


class PlanMask:
    """Plan ids as "<plan N>", numbered in the order they appear."""

    def __init__(self) -> None:
        self.ids: dict[str, str] = {}

    def learn(self, plan_id: str) -> None:
        if plan_id and plan_id not in self.ids:
            self.ids[plan_id] = f"<plan {len(self.ids)}>"

    def __call__(self, value: str) -> str:
        for plan_id, token in self.ids.items():
            value = value.replace(plan_id, token)
        return value


def _counter(name: str, jax: bool) -> float:
    if jax:
        return JAX_REGISTRY.snapshot().get(name, {}).get(
            f"kind={JAX_KIND}", 0.0)
    return REGISTRY.value(name, {"kind": C.MPS_KIND}) or 0.0


class Twin:
    """The JAX loop and the port's, side by side, on one clock."""

    def __init__(self, monkeypatch, nodes=("ts-0",)) -> None:
        self.now = [0.0]
        clock = lambda: self.now[0]  # noqa: E731
        monkeypatch.setattr(jax_ts_factory, "TimeshareSnapshotTaker",
                            lambda: jax_ts.TimeshareSnapshotTaker(JAX_REG))
        self.jax_journal = jax_journal.DecisionJournal(clock=clock)
        self.journal = port_journal.DecisionJournal(clock=clock)
        monkeypatch.setattr(jax_journal, "_journal", self.jax_journal)
        monkeypatch.setattr(port_journal, "_journal", self.journal)
        # the JAX controller and quarantine stamp holds in the ledger
        monkeypatch.setattr(jax_ledger, "_ledger",
                            jax_ledger.ChipSecondLedger(clock=clock))

        self.japi, self.jstate = JaxAPIServer(), JaxClusterState()
        JaxNodeController(self.japi, self.jstate).bind()
        JaxPodController(self.japi, self.jstate).bind()
        self.jpc = jax_ts.new_timeshare_partitioner_controller(
            self.japi, self.jstate, batch_timeout_s=BATCH_TIMEOUT_S,
            batch_idle_s=BATCH_IDLE_S, clock=clock)
        self.jpc.bind()

        self.api, self.state = APIServer(), ClusterState()
        NodeController(self.api, self.state).bind()
        PodController(self.api, self.state).bind()
        self.pc = ts.new_timeshare_partitioner_controller(
            self.api, self.state, batch_timeout_s=BATCH_TIMEOUT_S,
            batch_idle_s=BATCH_IDLE_S, clock=clock)
        self.pc.bind()

        self.jagents, self.agents, self.labels0 = {}, {}, {}
        for i, name in enumerate(nodes):
            jnode = jax_factory.make_tpu_node(
                name, generation=JAX_GEN, partitioning=JAX_KIND,
                host_index=i)
            node = factory.make_gpu_node(name)
            self.labels0[name] = (set(jnode.metadata.labels),
                                  set(node.metadata.labels))
            self.japi.create("Node", jnode)
            self.api.create(KIND_NODE, node)
            self.jagents[name] = JaxChipAgent(self.japi, name)
            self.agents[name] = ChipAgent(self.api, name)
            self.jagents[name].start()
            self.agents[name].start()
        self.jsched = JaxScheduler(self.japi, JaxFramework())
        self.framework = Framework()
        self.counters0 = {(n, j): _counter(n, j) for n in COUNTERS
                          for j in (True, False)}
        self.jmask, self.mask = PlanMask(), PlanMask()
        self.compare()

    # -- the loop's steps, each compared --------------------------------
    def advance(self, seconds: float) -> None:
        self.now[0] += seconds

    def create(self, name: str, gb: int, qty: int = 1) -> None:
        self.japi.create("Pod", jax_factory.make_timeshare_pod(
            gb, qty, name=name))
        self.api.create(KIND_POD, factory.make_timeshare_pod(
            gb, qty, name=name))
        self.compare()

    def schedule(self) -> int:
        self.assert_unique_fits()
        bound = self.jsched.run_cycle()
        assert bind_pending(self.api, self.framework) == bound
        self.compare()
        return bound

    def demand(self, name: str, gb: int, qty: int = 1) -> None:
        self.create(name, gb, qty)
        self.schedule()

    def process(self) -> bool:
        ran = self.jpc.process_if_ready()
        assert self.pc.process_if_ready() == ran
        self.compare()
        return ran

    def plan_cycle(self) -> bool:
        self.advance(BATCH_TIMEOUT_S + 1.0)
        return self.process()

    def tick(self, *names: str) -> None:
        for name in names or sorted(self.agents):
            self.jagents[name].tick()
            self.agents[name].tick()
            self.compare()

    # -- reading ----------------------------------------------------------
    def node(self, name: str):
        return self.api.get(KIND_NODE, name)

    def pod(self, name: str):
        return self.api.get(KIND_POD, name, "default")

    def spec_plan(self, name: str) -> str:
        return spec_plan_id(self.node(name).metadata.annotations,
                            family=C.MPS_KIND)

    def planned_nodes(self) -> list[str]:
        """Nodes with an open handshake (spec plan != status plan)."""
        out = []
        for n in self.api.list(KIND_NODE):
            annots = n.metadata.annotations
            spec = spec_plan_id(annots, family=C.MPS_KIND)
            if spec and status_plan_id(annots, family=C.MPS_KIND) != spec:
                out.append(n.name)
        return sorted(out)

    def config(self) -> dict[str, dict]:
        cm = self.api.try_get(KIND_CONFIGMAP, ts.DEVICE_PLUGIN_CM_NAME,
                              ts.DEVICE_PLUGIN_CM_NAMESPACE)
        return {} if cm is None else {k: json.loads(v)
                                      for k, v in cm.data.items()}

    def assert_unique_fits(self) -> None:
        """At most one node fits each pod as the binder reaches it (the
        binder's own walk: name order, each bind booked)."""
        nodes = _node_infos(self.api)
        for pod in sorted((p for p in self.api.pods_by_phase(PENDING)
                           if not p.spec.node_name),
                          key=lambda p: p.metadata.name):
            fits = [ni for ni in nodes if self.framework.run_filter_plugins(
                CycleState(), pod, ni).is_success]
            assert len(fits) <= 1, (pod.metadata.name,
                                    [ni.name for ni in fits])
            if fits:
                fits[0].add_pod(pod)

    # -- the comparison ---------------------------------------------------
    def _view(self, jax: bool) -> dict:
        api = self.japi if jax else self.api
        mask = self.jmask if jax else self.mask
        key = node_key if jax else (lambda k: k)
        kind = JAX_KIND if jax else C.MPS_KIND
        nodes = sorted(api.list("Node"), key=lambda n: n.metadata.name)
        cm = api.try_get(
            "ConfigMap",
            jax_ts.DEVICE_PLUGIN_CM_NAME if jax else ts.DEVICE_PLUGIN_CM_NAME,
            jax_ts.DEVICE_PLUGIN_CM_NAMESPACE if jax
            else ts.DEVICE_PLUGIN_CM_NAMESPACE)
        data = cm.data if cm is not None else {}
        for n in nodes:
            mask.learn(n.metadata.annotations.get(
                (JC if jax else C).spec_plan_annotation(kind), ""))
        for k in sorted(data, key=lambda k: k.rsplit(".", 1)[0]):
            mask.learn(k.rsplit(".", 1)[1])
        table = jax_config_table if jax else port_config_table
        out = {
            "nodes": {
                n.metadata.name: {
                    "annotations": {key(k): mask(v) for k, v in
                                    n.metadata.annotations.items()},
                    "labels": {key(k): mask(v) for k, v in
                               n.metadata.labels.items()
                               if k not in self.labels0[n.metadata.name][
                                   0 if jax else 1]},
                    "allocatable": {port_resource(r): q for r, q in
                                    n.status.allocatable.items()},
                    "capacity": {port_resource(r): q for r, q in
                                 n.status.capacity.items()},
                } for n in nodes},
            "config": {mask(k): table(json.loads(v))
                       for k, v in data.items()},
            "pods": {p.metadata.name: (p.status.phase, p.spec.node_name)
                     for p in api.list("Pod")},
            "quarantine": {name: reason for name, (reason, _) in
                           (self.jpc if jax else self.pc)
                           .quarantine.items().items()},
            "counters": {name: _counter(name, jax)
                         - self.counters0[(name, jax)] for name in COUNTERS},
            "journal": [
                (r.category, C.MPS_KIND if r.subject == kind else r.subject,
                 {a: (C.MPS_KIND if v == kind else v)
                  for a, v in r.attrs.items()})
                for r in (self.jax_journal if jax else self.journal).events()
                if r.category in JOURNALED],
        }
        return out

    def compare(self) -> None:
        assert self._view(jax=False) == self._view(jax=True)


@pytest.fixture
def twin(monkeypatch):
    return lambda **kw: Twin(monkeypatch, **kw)


# ---------------------------------------------------------------------------
# tests/test_e2e_timeshare.py's loop on both sides
# ---------------------------------------------------------------------------


class TestEndToEnd:
    def test_fractional_sharing_end_to_end(self, twin):
        t = twin()
        for i in range(4):
            t.create(f"infer-{i}", 8)
        assert t.schedule() == 0                 # nothing advertised yet
        t.advance(BATCH_IDLE_S + 1.0)
        assert t.process()

        keys = list(t.config())
        assert len(keys) == 1 and keys[0].startswith("ts-0.")
        label = t.node("ts-0").metadata.labels[C.LABEL_DEVICE_PLUGIN_CONFIG]
        assert keys[0] == f"ts-0.{label}" and len(label) <= 63
        assert "nvidia.com/device-plugin.config" not in \
            t.node("ts-0").metadata.labels

        # the handshake holds the next batch until the agent reports
        t.advance(BATCH_TIMEOUT_S + 1.0)
        t.create("late", 4)
        t.schedule()
        assert not t.process()

        t.tick()
        node = t.node("ts-0")
        assert node.status.allocatable.get("nvidia.com/gpu-8gb") == 4.0
        assert status_plan_id(node.metadata.annotations,
                              family=C.MPS_KIND) == label

        assert t.schedule() == 4
        t.tick()                                 # admits the bound pods
        for i in range(4):
            pod = t.pod(f"infer-{i}")
            assert (pod.spec.node_name, pod.status.phase) == ("ts-0", RUNNING)
        status = parse_status_annotations(t.node("ts-0").metadata.annotations)
        assert sum(a.quantity for a in status if a.status == "used") == 4

    def test_repartition_sacrifices_free_profiles(self, twin):
        t = twin()
        t.demand("first", 8)
        t.advance(BATCH_IDLE_S + 1.0)
        assert t.process()
        t.tick()
        assert t.schedule() == 1

        t.advance(BATCH_TIMEOUT_S + 1.0)
        t.demand("big", 16)
        t.advance(BATCH_IDLE_S + 1.0)
        assert t.process()
        t.tick()
        assert t.schedule() == 1
        assert t.pod("big").spec.node_name == "ts-0"
        t.tick()
        # the used 8gb share stays advertised
        assert t.node("ts-0").status.allocatable.get("nvidia.com/gpu-8gb",
                                                     0) >= 1


# ---------------------------------------------------------------------------
# tests/test_chaos.py's handshake and rescan cases, on the MPS path
# ---------------------------------------------------------------------------


class TestHandshakeDeadline:
    def test_dead_agent_is_quarantined_and_survivors_replan(self, twin):
        t = twin(nodes=("host-0", "host-1"))
        q = t.pc.quarantine
        t.demand("want-a", 24)
        assert t.plan_cycle()
        (dead,) = t.planned_nodes()
        alive = next(n for n in t.agents if n != dead)
        dead_plan, alive_plan = t.spec_plan(dead), t.spec_plan(alive)

        # new demand: the open handshake only arms the deadline...
        t.demand("want-b", 24)
        assert not t.plan_cycle()
        assert not q.is_quarantined(dead)

        # ...and past it the laggard is quarantined and the same poll
        # replans the survivor
        t.advance(DEADLINE_S + 1.0)
        assert t.plan_cycle()
        assert q.items()[dead][0] == REASON_PLAN_DEADLINE
        assert t.spec_plan(alive) and t.spec_plan(alive) != alive_plan
        assert alive in t.planned_nodes()
        assert t.spec_plan(dead) == dead_plan
        assert REGISTRY.value("nos_tpu_plan_deadline_exceeded_total",
                              {"kind": C.MPS_KIND}) >= 1

        # the agent comes back and reports: released on the next poll
        t.tick(dead)
        assert dead not in t.planned_nodes()
        t.process()
        assert not q.is_quarantined(dead)
        assert REGISTRY.value("nos_tpu_quarantined_nodes",
                              {"kind": C.MPS_KIND}) == 0.0

    def test_demand_survives_total_quarantine(self, twin):
        t = twin(nodes=("host-0",))
        t.demand("a", 24)
        assert t.plan_cycle()                    # the agent never ticks
        t.demand("b", 8)
        assert not t.plan_cycle()                # arms the deadline
        t.advance(DEADLINE_S + 1.0)
        # quarantined, so the snapshot is empty: the batch is kept
        assert not t.process()
        assert t.pc.quarantine.is_quarantined("host-0")

        # the agent reports; with no new pod event, the restored batch
        # replans the node once its idle window (restarted at the
        # restore) has passed, well before a rescan is due
        old = t.spec_plan("host-0")
        t.tick("host-0")
        t.advance(BATCH_IDLE_S + 1.0)
        assert t.process()
        assert not t.pc.quarantine.is_quarantined("host-0")
        assert t.spec_plan("host-0") != old

    def test_deadline_rearms_per_plan(self, twin):
        t = twin(nodes=("host-0",))
        t.demand("a", 24)
        assert t.plan_cycle()
        assert t.planned_nodes() == ["host-0"]
        t.demand("b", 8)
        assert not t.plan_cycle()                # arms plan A's deadline
        t.advance(1.5 * BATCH_TIMEOUT_S)
        t.tick("host-0")                         # reports plan A
        assert t.plan_cycle()                    # plan B
        t.demand("c", 16)
        assert not t.plan_cycle()                # arms plan B's deadline
        t.advance(1.5 * BATCH_TIMEOUT_S)
        t.process()
        assert not t.pc.quarantine.is_quarantined("host-0")
        t.advance(2.0 * BATCH_TIMEOUT_S)
        t.process()
        assert t.pc.quarantine.is_quarantined("host-0")

    def test_handshake_wait_journal_records_transitions_only(self, twin):
        t = twin(nodes=("host-0", "host-1"))
        t.demand("want-a", 24)
        assert t.plan_cycle()                    # the agents are dead
        lagging = t.planned_nodes()
        t.demand("want-b", 24)
        assert not t.plan_cycle()
        waits = t.journal.events(category=port_journal.HANDSHAKE_WAIT)
        assert waits[-1].attrs == {"lagging": lagging,
                                   "lagging_count": len(lagging)}
        n_waits = len(waits)
        # a second blocked poll is not a new decision
        assert not t.plan_cycle()
        assert len(t.journal.events(
            category=port_journal.HANDSHAKE_WAIT)) == n_waits
        # past the deadline the laggards stop blocking: the same poll
        # journals the empty set
        t.advance(DEADLINE_S + 1.0)
        t.process()
        waits = t.journal.events(category=port_journal.HANDSHAKE_WAIT)
        assert waits[-1].attrs == {"lagging": [], "lagging_count": 0}
        for name in lagging:
            assert t.pc.quarantine.is_quarantined(name)


class TestRescanBackstop:
    def test_lost_trigger_is_replanned_by_rescan(self, twin):
        t = twin(nodes=("host-0",))
        before = t.spec_plan("host-0")
        t.demand("a", 24)
        # the trigger is lost: the batch goes unplanned
        t.jpc._batcher.drain()
        t.pc._batcher.drain()
        assert not t.pc._batcher.ready()
        assert t.plan_cycle()                    # the rescan plans anyway
        assert t.spec_plan("host-0") not in ("", before)

    def test_a_repeated_no_fit_is_not_a_new_trigger(self, twin):
        """A pod already marked unschedulable is not marked again, so a
        second binder pass writes nothing and the idle window runs from
        the first mark."""
        t = twin(nodes=("host-0",))
        t.demand("a", 24)
        t.advance(BATCH_IDLE_S - 1.0)
        t.schedule()
        t.advance(2.0)
        assert t.process()

    def test_rescan_is_idle_without_pending_demand(self, twin):
        t = twin(nodes=("host-0",))
        t.advance(10 * BATCH_TIMEOUT_S)
        assert not t.process()

    def test_rescan_defers_to_an_accumulating_batch(self, twin):
        t = twin(nodes=("host-0",))
        t.advance(10 * BATCH_TIMEOUT_S)         # a rescan long overdue
        t.demand("a", 24)                        # the batch starts filling
        t.advance(1.0)                           # inside the idle window
        assert not t.process()
        t.advance(BATCH_IDLE_S + 1.0)
        assert t.process()


# ---------------------------------------------------------------------------
# The actuator's breaker, through the controller
# ---------------------------------------------------------------------------


class _Failing:
    """A partitioner whose apply raises while ``failing`` is set."""

    def __init__(self, inner) -> None:
        self.inner = inner
        self.failing = True

    def apply_partitioning(self, node_name, plan_id, partitioning):
        if self.failing:
            raise RuntimeError(f"apply refused on {node_name}")
        return self.inner.apply_partitioning(node_name, plan_id,
                                             partitioning)


class TestActuationBreaker:
    def test_failures_open_the_breaker_and_a_probe_releases_it(self, twin):
        t = twin(nodes=("host-0",))
        parts = [_Failing(t.jpc._actuator._partitioner),
                 _Failing(t.pc._actuator._partitioner)]
        t.jpc._actuator._partitioner, t.pc._actuator._partitioner = parts
        t.demand("a", 24)
        # three failed applies in a row open the breaker
        for streak in range(3):
            assert t.plan_cycle()
            assert t.pc.quarantine.is_quarantined("host-0") == (streak == 2)
        assert t.pc.quarantine.items()["host-0"][0] == REASON_ACTUATION
        assert t.spec_plan("host-0") == ""
        # inside the cool-down nothing is plannable
        assert not t.plan_cycle()
        # after it, a half-open probe: one more failure reopens at once
        t.advance(DEADLINE_S)
        assert t.process()
        assert t.pc.quarantine.items()["host-0"][0] == REASON_ACTUATION
        # healed: the next probe's apply lands and clears the breaker
        for p in parts:
            p.failing = False
        t.advance(DEADLINE_S + 1.0)
        assert t.process()
        assert not t.pc.quarantine.is_quarantined("host-0")
        assert t.planned_nodes() == ["host-0"]
        t.tick("host-0")
        assert t.planned_nodes() == []
        assert t.schedule() == 1


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 9 (b) loop, its host half on the CPU
# ---------------------------------------------------------------------------


class TestSmokeLoop:
    def test_the_card_loop_closes_the_handshake_and_rebinds(self, monkeypatch):
        """The loop the smoke drives on the card, up to the children and
        after them, with the card discovery would report; on real
        time.monotonic with the smoke's windows (about 2.5 s)."""
        import chip_smoke

        monkeypatch.setattr(port_journal, "_journal",
                            port_journal.DecisionJournal())
        device = {"model": "nvidia-h100-80gb-hbm3",
                  "memory_bytes": 85_000_000_000, "uuid": "GPU-0",
                  "uuids": ["GPU-0"]}
        loop, card, grants = chip_smoke._card_loop(device)
        assert card["plan_cycles"] == 2
        assert card["running"] == ["train-0", "train-1", "train-2"]
        assert card["unschedulable"] == "train-3"
        assert card["advertised"] == {"nvidia.com/gpu-24gb": 3.0}
        assert grants == [{"pod": f"train-{i}", "gpu": 0, "env": {
            "NOS_TPU_VISIBLE_CHIPS": "GPU-0", "NOS_TPU_TIMESHARE_GB": "24"}}
            for i in range(3)]
        assert card["actuation_latency_ms"] >= 0
        assert chip_smoke._card_release(loop) == {
            "succeeded": card["running"], "rebound": "train-3",
            "free_used_after_children": ("3", None)}
        assert loop.cycles == 2
        assert set(loop.bound_ms) == {f"train-{i}" for i in range(4)}
