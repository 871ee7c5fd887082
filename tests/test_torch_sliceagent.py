"""The port's MIG node side (nos_tpu_torch/controllers/sliceagent/,
controllers/kubelet.py's KubeletSim, device/plugin.py, the API server's
``locked()``) and the whole MIG loop, against the
JAX package's slice agent and loop on the stand-in of
``test_torch_slicepart`` (JAX v5e restricted to {2x4, 2x2} ↔ H100 80GB
restricted to {7g.80gb, 3g.40gb}), and the full H100 table where no JAX
counterpart exists.

The loop comparison (``Twin``) runs ``tests/test_e2e_slice.py``'s
``Harness`` on both sides under one injected clock: node controller with
the virgin-node initializer, pod controller, the MIG (slice) partitioner
controller from its factory, a slice agent on each side's fake runtime
(one GPU ↔ one host block) with the kubelet simulator, and
``Scheduler.run_cycle`` (the port's from ``build_scheduler``).  After
every step it compares the node's annotations
(keys and profiles mapped, placement records mapped, plan ids masked in
order of appearance), its allocatable and capacity (a GPU ↔ the host's
8 chips), the pods' phases and nodes, the fake runtimes' devices and
create and delete calls, the quarantine, the controller's journal
records and its counters.  The JAX side keeps its own candidate
weighting: in every scenario here its order is the port's g/7 order.

Agent faults the stand-in cannot reach (a create failing part-way
through, a plan that cannot be placed around the used instances) run on
the full table, beside the JAX package's own scenario on its fake
runtime.  The smoke run's mig phase runs here too: its loop on the fake
runtime, whose writes it pins as ``chip_smoke.MIG_LOOP_WRITES``, and its
reporter over the fake NVML library.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest

import nos_tpu.api.constants as JC
import nos_tpu.partitioning.slicepart as jax_sp
import nos_tpu.partitioning.slicepart.factory as jax_sp_factory
from nos_tpu.controllers.kubelet import KubeletSim as JaxKubeletSim
from nos_tpu.controllers.node_controller import (
    NodeController as JaxNodeController,
)
from nos_tpu.controllers.pod_controller import PodController as JaxPodController
from nos_tpu.controllers.sliceagent.agent import SliceAgent as JaxSliceAgent
from nos_tpu.controllers.sliceagent.plan import (
    SliceState as JaxSliceState, new_config_plan as jax_new_config_plan,
)
from nos_tpu.controllers.sliceagent.shared import SharedState as JaxShared
from nos_tpu.device.fake import (
    FakePodResources as JaxFakePodResources, FakeTpuRuntime,
)
from nos_tpu.device.plugin import DevicePluginClient as JaxPluginClient
from nos_tpu.device.tpuclient import SliceDeviceClient as JaxDeviceClient
from nos_tpu.exporter.metrics import REGISTRY as JAX_REGISTRY
from nos_tpu.kube.client import APIServer as JaxAPIServer
from nos_tpu.obs import journal as jax_journal, ledger as jax_ledger
from nos_tpu.partitioning.state import ClusterState as JaxClusterState
from nos_tpu.scheduler.framework import Framework as JaxFramework
from nos_tpu.scheduler.scheduler import Scheduler as JaxScheduler
from nos_tpu.testing import factory as jax_factory
from nos_tpu.topology import (
    Device as JaxDevice, DeviceList as JaxDeviceList, Shape as JaxShape,
)

import chip_smoke
from nos_tpu_torch.api import constants as C
from nos_tpu_torch.cmd.assembly import build_scheduler
from nos_tpu_torch.controllers.kubelet import KubeletSim
from nos_tpu_torch.controllers.node_controller import NodeController
from nos_tpu_torch.controllers.pod_controller import PodController
from nos_tpu_torch.controllers.sliceagent import SharedState, SliceAgent
from nos_tpu_torch.controllers.sliceagent.plan import (
    SliceState, new_config_plan,
)
from nos_tpu_torch.device import nvml as port_nvml
from nos_tpu_torch.device.fake import FakeGpuRuntime, FakePodResources
from nos_tpu_torch.device.gpuclient import SliceDeviceClient
from nos_tpu_torch.device.plugin import DevicePluginClient
from nos_tpu_torch.exporter.metrics import REGISTRY
from nos_tpu_torch.kube.client import APIServer, KIND_NODE, KIND_POD
from nos_tpu_torch.kube.objects import RUNNING
from nos_tpu_torch.obs import journal as port_journal
from nos_tpu_torch.partitioning import slicepart as sp
from nos_tpu_torch.partitioning.core import REASON_PLAN_DEADLINE
from nos_tpu_torch.partitioning.state import ClusterState
from nos_tpu_torch.testing import factory
from nos_tpu_torch.testing.nvml import (UNKNOWN, FakeGpu, FakeNvmlLibrary,
                                        profile_rows)
from nos_tpu_torch.topology import H100_80GB, Device, DeviceList
from nos_tpu_torch.topology.annotations import (
    parse_status_annotations, spec_matches_status, spec_plan_id,
    status_plan_id, strip_spec_annotations,
)

from test_torch_controller import PlanMask
from test_torch_slicepart import (
    HALF, JAX_GEN, JAX_REG, PORT_REG, STANDIN, TO_JAX, TO_PORT, WHOLE,
    port_annotation, port_resource,
)

BATCH_TIMEOUT_S = 60.0
BATCH_IDLE_S = 10.0
DEADLINE_S = 3 * BATCH_TIMEOUT_S
COUNTERS = ("nos_tpu_plans_total", "nos_tpu_plan_deadline_exceeded_total",
            "nos_tpu_replan_epoch_deferred_total",
            "nos_tpu_actuation_breaker_open_total")
JOURNALED = (port_journal.PLAN_CYCLE, port_journal.HANDSHAKE_WAIT,
             port_journal.QUARANTINED, port_journal.QUARANTINE_RELEASED)


def _counter(name: str, jax: bool) -> float:
    if jax:
        return JAX_REGISTRY.snapshot().get(name, {}).get("kind=slice", 0.0)
    return REGISTRY.value(name, {"kind": C.MIG_KIND}) or 0.0


def _jax_device(d: Device) -> JaxDevice:
    profile = d.resource_name.rsplit("mig-", 1)[1]
    return JaxDevice(f"{JC.RESOURCE_SLICE_PREFIX}{TO_JAX[profile]}",
                     d.device_id, d.status, d.unit_index)


# ---------------------------------------------------------------------------
# Plan, shared state, plugin, kubelet simulator
# ---------------------------------------------------------------------------


def _plan_rows(plan, jax: bool) -> tuple:
    name = (lambda s: TO_PORT[s.name]) if jax else (lambda p: p)
    return ([(d.unit_index, d.device_ids) for d in plan.deletes],
            [(c.unit_index, name(c.shape if jax else c.profile), c.quantity)
             for c in plan.creates])


class TestConfigPlan:
    @pytest.mark.parametrize("seed", range(6))
    def test_plans_match_jax(self, seed):
        rng = np.random.default_rng(seed)
        for _ in range(30):
            devices = DeviceList()
            n = 0
            for unit in range(int(rng.integers(1, 4))):
                for _ in range(int(rng.integers(0, 3))):
                    profile = (WHOLE, HALF)[int(rng.integers(0, 2))]
                    n += 1
                    devices.append(Device(
                        f"nvidia.com/mig-{profile}", f"d{n}",
                        "used" if rng.random() < 0.4 else "free", unit))
            spec = {u: {p: int(rng.integers(0, 3)) for p in (WHOLE, HALF)
                        if rng.random() < 0.7}
                    for u in range(int(rng.integers(0, 4)))}
            plan = new_config_plan(SliceState.from_devices(devices), spec)
            jplan = jax_new_config_plan(
                JaxSliceState.from_devices(JaxDeviceList(
                    _jax_device(d) for d in devices)),
                {u: {TO_JAX[p]: q for p, q in t.items()}
                 for u, t in spec.items()})
            assert _plan_rows(plan, False) == _plan_rows(jplan, True)
            assert plan.empty == jplan.empty
            assert (plan.signature()[0], [r[1:] for r in plan.signature()[1]]
                    ) == (jplan.signature()[0], [
                        (TO_PORT[s], q) for _, s, q in jplan.signature()[1]])

    def test_used_devices_are_never_deleted_and_creates_widen(self):
        devices = DeviceList([
            Device("nvidia.com/mig-3g.40gb", "a", "used", 0),
            Device("nvidia.com/mig-3g.40gb", "b", "free", 0),
            Device("nvidia.com/mig-7g.80gb", "c", "free", 1)])
        plan = new_config_plan(SliceState.from_devices(devices), {
            0: {"3g.40gb": 1, "2g.20gb": 1, "1g.10gb": 2},
            1: {"7g.80gb": 1}})
        assert [(d.unit_index, d.device_ids) for d in plan.deletes] == \
            [(0, ("b",))]
        assert [(c.unit_index, c.profile, c.quantity)
                for c in plan.creates] == [(0, "1g.10gb", 2),
                                           (0, "2g.20gb", 1)]


class TestSharedState:
    def test_matches_jax(self):
        port, jax = SharedState(), JaxShared()
        steps = [("on_report_done",), ("on_apply_done",),
                 ("record_applied", (1,)), ("record_infeasible", (2,)),
                 ("record_infeasible", (3,)), ("clear_infeasible",),
                 ("record_infeasible", (4,)), ("record_applied", (5,))]
        for step in steps:
            getattr(port, step[0])(*step[1:])
            getattr(jax, step[0])(*step[1:])
            assert port.at_least_one_report_since_last_apply == \
                jax.at_least_one_report_since_last_apply
            for sig in [(1,), (2,), (3,), (4,), (5,)]:
                assert port.is_duplicate(sig) == jax.is_duplicate(sig)
                assert port.is_infeasible(sig) == jax.is_infeasible(sig)
        port.last_parsed_plan_id = jax.last_parsed_plan_id = "p"
        assert port.last_parsed_plan_id == "p"
        assert set(port.__guarded_by__) == {
            "_report_since_apply", "_last_parsed_plan_id",
            "_last_applied_signature", "_infeasible_signatures"}


class TestDevicePlugin:
    def test_refresh_matches_jax(self):
        api, japi = APIServer(), JaxAPIServer()
        api.create(KIND_NODE, factory.make_gpu_node(
            "n", model=STANDIN, gpus=1, partitioning=C.MIG_KIND,
            status_geometry={0: {"free": {HALF: 2}}}))
        japi.create("Node", jax_factory.make_tpu_node(
            "n", generation=JAX_GEN, status_geometry={"free": {"2x2": 2}}))
        runtime, jruntime = FakeGpuRuntime(STANDIN), FakeTpuRuntime(JAX_GEN)
        plugin = DevicePluginClient(api, "n", runtime)
        jplugin = JaxPluginClient(japi, "n", jruntime)
        for creates in ([WHOLE], [], [HALF]):
            for d in runtime.list_devices():
                runtime.delete_slice(d.device_id)
            for d in jruntime.list_devices():
                jruntime.delete_slice(d.device_id)
            if creates:
                runtime.create_slices(0, creates)
                jruntime.create_slices(0, [JaxShape.parse(TO_JAX[p])
                                           for p in creates])
            assert plugin.refresh() == jplugin.refresh()
            node, jnode = api.get(KIND_NODE, "n"), japi.get("Node", "n")
            for table, jtable in (
                    (node.status.allocatable, jnode.status.allocatable),
                    (node.status.capacity, jnode.status.capacity)):
                assert {r: q for r, q in table.items() if "mig-" in r} == {
                    port_resource(r): q for r, q in jtable.items()
                    if r.startswith(JC.RESOURCE_SLICE_PREFIX)}
            assert node.metadata.annotations[C.ANNOT_PLUGIN_GENERATION] == \
                jnode.metadata.annotations[JC.ANNOT_PLUGIN_GENERATION]


class TestAPIServerLock:
    def test_locked_is_the_stores_reentrant_lock(self):
        api = APIServer()
        held = threading.Event()
        release = threading.Event()

        def holder():
            with api.locked():
                held.set()
                release.wait(5)

        t = threading.Thread(target=holder)
        t.start()
        held.wait(5)
        got = []
        writer = threading.Thread(target=lambda: got.append(
            api.create(KIND_NODE, factory.make_node("n"))))
        writer.start()
        writer.join(0.2)
        assert not got                 # the write waits for the lock
        release.set()
        writer.join(5)
        t.join(5)
        assert got
        with api.locked(), api.locked():     # reentrant
            api.get(KIND_NODE, "n")


def _kubelet_pair(profiles: list[str]):
    """A one-GPU MIG node on each side with ``profiles`` carved, a
    kubelet simulator bound to it."""
    api, japi = APIServer(), JaxAPIServer()
    api.create(KIND_NODE, factory.make_gpu_node(
        "n", model=STANDIN, gpus=1, partitioning=C.MIG_KIND))
    japi.create("Node", jax_factory.make_tpu_node("n", generation=JAX_GEN))
    runtime, jruntime = FakeGpuRuntime(STANDIN), FakeTpuRuntime(JAX_GEN)
    res, jres = FakePodResources(), JaxFakePodResources()
    if profiles:
        runtime.create_slices(0, profiles)
        jruntime.create_slices(0, [JaxShape.parse(TO_JAX[p])
                                   for p in profiles])
    sim = KubeletSim(api, "n", SliceDeviceClient(runtime, res), res)
    jsim = JaxKubeletSim(japi, "n", JaxDeviceClient(jruntime, jres), jres)
    sim.bind()
    jsim.bind()
    return (api, runtime, res, sim), (japi, jruntime, jres, jsim)


class TestKubeletSim:
    def _view(self, side, jax: bool):
        api, runtime, res, _ = side
        pods = {p.metadata.name: (p.status.phase, p.spec.node_name)
                for p in api.list("Pod")}
        devices = {d.device_id: d.resource_name
                   for d in runtime.list_devices()}
        alloc = {k: sorted(port_resource(devices[i]) if jax else devices[i]
                           for i in res._used[k])
                 for k in res.allocated_pod_keys()}
        return pods, alloc

    def test_admission_waits_for_free_devices_as_jax(self):
        port, jax = _kubelet_pair([HALF, HALF])
        steps = [("create", "a", HALF), ("create", "b", WHOLE),
                 ("create", "c", HALF), ("create", "d", HALF),
                 ("sweep",), ("delete", "a"), ("sweep",),
                 ("create", "e", HALF), ("sweep",)]
        for step in steps:
            for side, jax_side in ((port, False), (jax, True)):
                api = side[0]
                if step[0] == "create":
                    make = (jax_factory.make_slice_pod if jax_side
                            else factory.make_mig_pod)
                    profile = TO_JAX[step[2]] if jax_side else step[2]
                    api.create("Pod", make(profile, name=step[1],
                                           node_name="n"))
                elif step[0] == "delete":
                    api.delete("Pod", step[1], "default")
                else:
                    side[3].sweep()
            assert self._view(port, False) == self._view(jax, True), step
        pods, alloc = self._view(port, False)
        assert pods["b"][0] == "Pending"         # no 7g.80gb carved
        assert sorted(alloc) == ["default/c", "default/d"]

    def test_a_restarted_kubelet_records_running_pods_again(self):
        (api, runtime, res, sim), _ = _kubelet_pair([WHOLE])
        api.create(KIND_POD, factory.make_mig_pod(WHOLE, name="a",
                                                  node_name="n"))
        assert api.get(KIND_POD, "a", "default").status.phase == RUNNING
        sim.unbind()
        fresh = FakePodResources()
        again = KubeletSim(api, "n", SliceDeviceClient(runtime, fresh), fresh)
        assert again.sweep() == 0
        assert fresh.used_device_ids() == {runtime.list_devices()[0].device_id}

    def test_a_sweep_releases_the_devices_of_pods_deleted_unwatched(self):
        (api, runtime, res, sim), _ = _kubelet_pair([HALF, HALF])
        for name in ("a", "b"):
            api.create(KIND_POD, factory.make_mig_pod(HALF, name=name,
                                                      node_name="n"))
        assert sorted(res.allocated_pod_keys()) == ["default/a", "default/b"]
        sim.unbind()
        api.delete(KIND_POD, "a", "default")
        assert sorted(res.allocated_pod_keys()) == ["default/a", "default/b"]
        assert sim.sweep() == 0
        assert res.allocated_pod_keys() == ["default/b"]
        assert len(res.used_device_ids()) == 1


# ---------------------------------------------------------------------------
# The MIG loop on both sides
# ---------------------------------------------------------------------------


class Twin:
    """tests/test_e2e_slice.py's Harness on both sides, one clock."""

    def __init__(self, monkeypatch, nodes=("host-0",),
                 runtime=lambda: FakeGpuRuntime(STANDIN, 1)) -> None:
        self.now = [0.0]
        clock = lambda: self.now[0]  # noqa: E731
        monkeypatch.setattr(jax_sp_factory, "SliceSnapshotTaker",
                            lambda: jax_sp.SliceSnapshotTaker(JAX_REG))
        monkeypatch.setattr(sp.factory, "SliceSnapshotTaker",
                            lambda: sp.SliceSnapshotTaker(PORT_REG))
        self.jax_journal = jax_journal.DecisionJournal(clock=clock)
        self.journal = port_journal.DecisionJournal(clock=clock)
        monkeypatch.setattr(jax_journal, "_journal", self.jax_journal)
        monkeypatch.setattr(port_journal, "_journal", self.journal)
        monkeypatch.setattr(jax_ledger, "_ledger",
                            jax_ledger.ChipSecondLedger(clock=clock))

        self.japi, jstate = JaxAPIServer(), JaxClusterState()
        JaxNodeController(self.japi, jstate, jax_sp.SliceNodeInitializer(
            self.japi, JAX_REG)).bind()
        JaxPodController(self.japi, jstate).bind()
        self.jpc = jax_sp_factory.new_slice_partitioner_controller(
            self.japi, jstate, batch_timeout_s=BATCH_TIMEOUT_S,
            batch_idle_s=BATCH_IDLE_S, clock=clock)
        self.jpc.bind()

        self.api, state = APIServer(), ClusterState()
        NodeController(self.api, state,
                       sp.SliceNodeInitializer(self.api, PORT_REG)).bind()
        PodController(self.api, state).bind()
        self.pc = sp.new_slice_partitioner_controller(
            self.api, state, batch_timeout_s=BATCH_TIMEOUT_S,
            batch_idle_s=BATCH_IDLE_S, clock=clock)
        self.pc.bind()

        self.jagents, self.agents = {}, {}
        self.jruntimes, self.runtimes = {}, {}
        self.jres, self.res = {}, {}
        for i, name in enumerate(nodes):
            self.japi.create("Node", jax_factory.make_tpu_node(
                name, generation=JAX_GEN, host_index=i))
            self.api.create(KIND_NODE, factory.make_gpu_node(
                name, model=STANDIN, gpus=1, partitioning=C.MIG_KIND))
            self.jruntimes[name] = FakeTpuRuntime(JAX_GEN)
            self.runtimes[name] = runtime()
            self.jres[name] = JaxFakePodResources()
            self.res[name] = FakePodResources()
            self.jagents[name] = JaxSliceAgent(
                self.japi, name, self.jruntimes[name], self.jres[name])
            self.agents[name] = SliceAgent(
                self.api, name, self.runtimes[name], self.res[name])
            self.jagents[name].start()
            self.agents[name].start()
        self.jsched = JaxScheduler(self.japi, JaxFramework(), clock=clock)
        self.sched = build_scheduler(self.api, clock=clock)
        self.counters0 = {(n, j): _counter(n, j) for n in COUNTERS
                          for j in (True, False)}
        self.jmask, self.mask = PlanMask(), PlanMask()
        self.compare()

    # -- the loop's steps, each compared --------------------------------
    def advance(self, seconds: float) -> None:
        self.now[0] += seconds

    def create(self, name: str, profile: str, qty: int = 1, **kw) -> None:
        self.japi.create("Pod", jax_factory.make_slice_pod(
            TO_JAX[profile], qty, name=name, **kw))
        self.api.create(KIND_POD, factory.make_mig_pod(profile, qty,
                                                       name=name, **kw))
        self.compare()

    def schedule(self) -> int:
        bound = self.jsched.run_cycle()
        assert self.sched.run_cycle() == bound
        self.compare()
        return bound

    def demand(self, name: str, profile: str, qty: int = 1) -> None:
        self.create(name, profile, qty)
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
            assert self.agents[name].tick() == self.jagents[name].tick()
            self.compare()

    def set_fail_creates(self, value: bool) -> None:
        for rt in (*self.runtimes.values(), *self.jruntimes.values()):
            rt.fail_creates = value

    # -- reading ----------------------------------------------------------
    def node(self, name: str = "host-0"):
        return self.api.get(KIND_NODE, name)

    def pod(self, name: str):
        return self.api.get(KIND_POD, name, "default")

    def spec_plan(self, name: str) -> str:
        return spec_plan_id(self.node(name).metadata.annotations,
                            family=C.MIG_KIND)

    def planned_nodes(self) -> list[str]:
        out = []
        for n in self.api.list(KIND_NODE):
            annots = n.metadata.annotations
            spec = spec_plan_id(annots, family=C.MIG_KIND)
            if spec and status_plan_id(annots, family=C.MIG_KIND) != spec:
                out.append(n.name)
        return sorted(out)

    # -- the comparison ---------------------------------------------------
    def _view(self, jax: bool) -> dict:
        api = self.japi if jax else self.api
        mask = self.jmask if jax else self.mask
        kind = "slice" if jax else C.MIG_KIND
        spec_key = (JC if jax else C).spec_plan_annotation(kind)
        nodes = sorted(api.list("Node"), key=lambda n: n.metadata.name)
        for n in nodes:
            mask.learn(n.metadata.annotations.get(spec_key, ""))

        def annotation(k, v):
            return port_annotation(k, v) if jax else (k, v)

        def quantities(table):
            out = {}
            for r, q in table.items():
                if jax and r == JC.RESOURCE_TPU:
                    out[C.RESOURCE_GPU] = q / 8
                else:
                    out[port_resource(r) if jax else r] = q
            return out

        runtimes = self.jruntimes if jax else self.runtimes
        return {
            "nodes": {n.metadata.name: {
                "annotations": dict(annotation(k, mask(v)) for k, v in
                                    n.metadata.annotations.items()),
                "allocatable": quantities(n.status.allocatable),
                "capacity": quantities(n.status.capacity)}
                for n in nodes},
            "pods": {p.metadata.name: (p.status.phase, p.spec.node_name)
                     for p in api.list("Pod")},
            "devices": {name: (sorted(port_resource(d.resource_name) if jax
                                      else d.resource_name
                                      for d in rt.list_devices()),
                               rt.create_calls, rt.delete_calls)
                        for name, rt in runtimes.items()},
            "quarantine": {name: reason for name, (reason, _) in
                           (self.jpc if jax else self.pc)
                           .quarantine.items().items()},
            "counters": {name: _counter(name, jax)
                         - self.counters0[(name, jax)] for name in COUNTERS},
            "journal": [
                (r.category, C.MIG_KIND if r.subject == kind else r.subject,
                 {a: (C.MIG_KIND if v == kind else v)
                  for a, v in r.attrs.items()})
                for r in (self.jax_journal if jax else self.journal).events()
                if r.category in JOURNALED],
        }

    def compare(self) -> None:
        assert self._view(jax=False) == self._view(jax=True)


@pytest.fixture
def twin(monkeypatch):
    return lambda **kw: Twin(monkeypatch, **kw)


def _spec(t: Twin, name: str = "host-0") -> dict:
    from nos_tpu_torch.topology.annotations import parse_spec_annotations

    return {(a.index, a.profile): a.quantity for a in
            parse_spec_annotations(t.node(name).metadata.annotations)}


class TestEndToEnd:
    def test_node_bootstrap_initializes_virgin_host(self, twin):
        t = twin()
        assert _spec(t) == {(0, WHOLE): 1}
        t.tick()
        node = t.node()
        assert spec_matches_status(node.metadata.annotations,
                                   family=C.MIG_KIND)
        assert node.status.allocatable.get(f"nvidia.com/mig-{WHOLE}") == 1.0
        assert [(a.profile, a.status, a.quantity) for a in
                parse_status_annotations(node.metadata.annotations)] == \
            [(WHOLE, "free", 1)]

    def test_pending_pod_triggers_repartition_and_schedules(self, twin):
        t = twin()
        t.tick()
        t.create("train-1", HALF)
        assert t.schedule() == 0
        t.advance(BATCH_IDLE_S + 1.0)
        assert t.process()
        assert _spec(t) == {(0, HALF): 2}
        # the handshake holds the next batch until the agent reports
        t.advance(BATCH_TIMEOUT_S + 1.0)
        t.create("train-2", HALF)
        t.schedule()
        assert not t.process()
        t.tick()
        assert spec_matches_status(t.node().metadata.annotations,
                                   family=C.MIG_KIND)
        assert t.schedule() == 2
        t.tick()
        for name in ("train-1", "train-2"):
            assert (t.pod(name).spec.node_name, t.pod(name).status.phase) \
                == ("host-0", RUNNING)

    def test_actuator_retries_after_create_failure(self, twin):
        t = twin()
        t.set_fail_creates(True)
        t.tick()
        assert not t.runtimes["host-0"].list_devices()
        t.set_fail_creates(False)
        t.tick()
        assert len(t.runtimes["host-0"].list_devices()) == 1
        assert spec_matches_status(t.node().metadata.annotations,
                                   family=C.MIG_KIND)

    def test_repartition_preserves_used_devices(self, twin):
        t = twin()
        t.tick()
        t.create("holder", WHOLE)
        assert t.schedule() == 1
        (dev,) = t.runtimes["host-0"].list_devices()
        t.tick()
        t.create("want-half", HALF)
        assert t.schedule() == 0
        t.advance(BATCH_IDLE_S + 1.0)
        t.process()
        t.tick()
        assert dev.device_id in t.runtimes["host-0"].list_devices().ids()
        status = {(a.profile, a.status): a.quantity for a in
                  parse_status_annotations(t.node().metadata.annotations)}
        assert status == {(WHOLE, "used"): 1}

    def test_a_freed_whole_gpu_is_recarved(self, twin):
        t = twin()
        t.tick()
        t.demand("holder", WHOLE)
        t.tick()
        t.demand("want-half", HALF)
        t.advance(BATCH_IDLE_S + 1.0)
        t.process()
        t.tick()
        t.api.delete(KIND_POD, "holder", "default")
        t.japi.delete("Pod", "holder", "default")
        t.compare()
        t.tick()
        assert t.plan_cycle()                    # the rescan
        t.tick()
        assert t.schedule() == 1
        t.tick()
        assert t.pod("want-half").status.phase == RUNNING


class _NvmlOverFake(chip_smoke._Counted):
    """``NvmlGpuRuntime`` over the fake NVML library (one stand-in GPU in
    MIG mode), counted as the fake runtime counts; ``fail_creates``
    makes the library refuse every GPU instance create."""

    def __init__(self) -> None:
        self.lib = FakeNvmlLibrary([FakeGpu(mig=True)],
                                   profiles=profile_rows(STANDIN))
        super().__init__(port_nvml.NvmlGpuRuntime(STANDIN, lib=self.lib))

    @property
    def fail_creates(self) -> bool:
        return self.CREATE in self.lib.fail

    @fail_creates.setter
    def fail_creates(self, value: bool) -> None:
        if value:
            self.lib.fail[self.CREATE] = UNKNOWN
        else:
            self.lib.fail.pop(self.CREATE, None)

    CREATE = "nvmlDeviceCreateGpuInstanceWithPlacement"


class TestEndToEndOnNvml(TestEndToEnd):
    """TestEndToEnd with the port's agent on ``NvmlGpuRuntime`` over the
    fake NVML library, beside the JAX loop on its fake runtime: the same
    writes, devices and create and delete calls after every step."""

    @pytest.fixture
    def twin(self, monkeypatch):
        return lambda **kw: Twin(monkeypatch, runtime=_NvmlOverFake, **kw)


class TestHandshakeDeadline:
    def test_dead_agent_is_quarantined_and_survivors_replan(self, twin):
        t = twin(nodes=("host-0", "host-1"))
        t.tick()
        q = t.pc.quarantine
        t.demand("want-a", HALF)
        assert t.plan_cycle()
        (dead,) = t.planned_nodes()
        dead_plan = t.spec_plan(dead)
        t.demand("want-b", HALF)
        t.demand("want-c", HALF)
        t.demand("want-d", HALF)
        assert not t.plan_cycle()                # arms the deadline
        t.advance(DEADLINE_S + 1.0)
        assert t.plan_cycle()
        assert q.items()[dead][0] == REASON_PLAN_DEADLINE
        assert t.spec_plan(dead) == dead_plan
        t.tick(dead)
        t.process()
        assert not q.is_quarantined(dead)

    def test_lost_trigger_is_replanned_by_rescan(self, twin):
        t = twin()
        t.tick()
        before = t.spec_plan("host-0")
        t.demand("a", HALF)
        t.jpc._batcher.drain()
        t.pc._batcher.drain()
        assert t.plan_cycle()
        assert t.spec_plan("host-0") not in ("", before)

    def test_rescan_is_idle_without_pending_demand(self, twin):
        t = twin()
        t.tick()
        t.advance(10 * BATCH_TIMEOUT_S)
        assert not t.process()


# ---------------------------------------------------------------------------
# Agent faults on the full table
# ---------------------------------------------------------------------------


class _Node:
    """One H100 node, its agent on the fake runtime, no controller: the
    tests write the spec themselves."""

    def __init__(self, **runtime_kw) -> None:
        self.api = APIServer()
        self.api.create(KIND_NODE, factory.make_gpu_node(
            "n", gpus=1, partitioning=C.MIG_KIND))
        self.runtime = FakeGpuRuntime(H100_80GB, 1, **runtime_kw)
        self.res = FakePodResources()
        self.agent = SliceAgent(self.api, "n", self.runtime, self.res)
        self.agent.start()

    def write_spec(self, plan_id: str, **geometry: int) -> None:
        def mutate(node):
            strip_spec_annotations(node.metadata.annotations,
                                   family=C.MIG_KIND)
            for profile, qty in geometry.items():
                node.metadata.annotations[
                    f"{C.ANNOT_SPEC_PREFIX}0-{profile.replace('_', '.')}"] = \
                    str(qty)
            node.metadata.annotations[C.spec_plan_annotation(C.MIG_KIND)] = \
                plan_id
        self.api.patch(KIND_NODE, "n", mutate=mutate)

    def profiles(self) -> list[str]:
        return sorted(d.resource_name.rsplit("-", 1)[1]
                      for d in self.runtime.list_devices())


class TestAgentFaults:
    def test_a_failed_joint_create_is_undone_and_retried(self):
        h = _Node(fail_after=2)
        h.write_spec("p1", **{"3g_40gb": 1, "2g_20gb": 1, "1g_10gb": 2})
        assert not h.agent.tick()
        # the create failed part-way: the two it made are gone
        assert h.profiles() == [] and h.runtime.create_calls == 1
        h.runtime.fail_after = None
        assert h.agent.tick()
        assert h.profiles() == ["1g.10gb", "1g.10gb", "2g.20gb", "3g.40gb"]
        assert spec_matches_status(h.api.get(KIND_NODE, "n").metadata
                                   .annotations, family=C.MIG_KIND)
        # the creates went in one call per GPU: the packer placed them
        # jointly
        assert h.runtime.create_calls == 2

    def test_an_unplaceable_plan_waits_for_a_new_plan_id(self):
        """The JAX package's scenario (test_placement_aware.py), on an
        H100: two used 1g.10gb at slots 0 and 1 leave no room for a
        4g.40gb, whose only start is slot 0."""
        h = _Node()
        h.write_spec("setup", **{"1g_10gb": 7})
        h.agent.tick()
        h.api.create(KIND_POD, factory.make_mig_pod("1g.10gb", 2,
                                                    name="pinner",
                                                    node_name="n"))
        h.agent.tick()
        used = h.res.used_device_ids()
        assert sorted(pl.start for d, pl in h.runtime.placements().items()
                      if d in used) == [0, 1]
        labels = {"node": "n"}
        before = REGISTRY.value("nos_tpu_placement_infeasible_total",
                                labels) or 0
        h.write_spec("doomed", **{"4g_40gb": 1, "1g_10gb": 3})
        calls = h.runtime.create_calls
        h.agent.tick()                    # attempted once
        assert h.runtime.create_calls == calls + 1
        h.agent.tick()                    # remembered: no retry
        h.agent.tick()
        assert h.runtime.create_calls == calls + 1
        assert REGISTRY.value("nos_tpu_placement_infeasible_total",
                              labels) == before + 1
        h.write_spec("good", **{"1g_10gb": 7})
        h.agent.tick()
        assert h.runtime.create_calls == calls + 2
        assert h.profiles() == ["1g.10gb"] * 7
        # the JAX agent on its fake runtime behaves alike
        jcalls = self._jax_doomed_plan_calls()
        assert jcalls == [1, 1, 1, 2]

    @staticmethod
    def _jax_doomed_plan_calls() -> list[int]:
        from test_e2e_slice import Harness
        from test_placement_aware import TestActuatorInfeasibleHandling

        h = Harness()
        TestActuatorInfeasibleHandling()._pin_awkward_used(h)
        calls0 = h.runtime.create_calls

        def spec(geometry, plan):
            def mutate(node):
                from nos_tpu.topology.annotations import (
                    strip_spec_annotations as jax_strip)
                jax_strip(node.metadata.annotations, family="slice")
                node.metadata.annotations.update(
                    {f"{JC.ANNOT_SPEC_PREFIX}0-{p}": str(q)
                     for p, q in geometry.items()})
                node.metadata.annotations[
                    JC.spec_plan_annotation("slice")] = plan
            h.api.patch("Node", "host-0", mutate=mutate)

        out = []
        spec({"1x2": 2, "2x2": 1}, "doomed-plan")
        for _ in range(3):
            h.agent.tick()
            out.append(h.runtime.create_calls - calls0)
        spec({"1x2": 4}, "good-plan")
        h.agent.tick()
        out.append(h.runtime.create_calls - calls0)
        return out

    def test_startup_cleanup_keeps_used_devices_as_jax(self):
        runtime, jruntime = FakeGpuRuntime(STANDIN), FakeTpuRuntime(JAX_GEN)
        kept = runtime.create_slices(0, [HALF, HALF])
        jkept = jruntime.create_slices(0, [JaxShape.parse("2x2")] * 2)
        res, jres = FakePodResources(), JaxFakePodResources()
        res.allocate("default/a", {kept[0]})
        jres.allocate("default/a", {jkept[0]})
        api, japi = APIServer(), JaxAPIServer()
        api.create(KIND_NODE, factory.make_gpu_node(
            "n", model=STANDIN, gpus=1, partitioning=C.MIG_KIND))
        japi.create("Node", jax_factory.make_tpu_node("n",
                                                      generation=JAX_GEN))
        agent = SliceAgent(api, "n", runtime, res)
        jagent = JaxSliceAgent(japi, "n", jruntime, jres)
        agent.start()
        jagent.start()
        assert runtime.list_devices().ids() == [kept[0]]
        assert len(jruntime.list_devices()) == 1
        annots = api.get(KIND_NODE, "n").metadata.annotations
        jannots = japi.get("Node", "n").metadata.annotations
        assert annots == dict(port_annotation(k, v)
                              for k, v in jannots.items())
        assert annots[C.ANNOT_PLUGIN_GENERATION] == "1"

    def test_the_reporter_records_placements_and_the_plan_id(self):
        h = _Node()
        h.write_spec("p", **{"3g_40gb": 2})
        h.agent.tick()
        annots = h.api.get(KIND_NODE, "n").metadata.annotations
        assert annots[f"{C.ANNOT_PLACEMENTS_PREFIX}0"] == \
            "f|3g.40gb|0|4;f|3g.40gb|4|4"
        assert status_plan_id(annots, family=C.MIG_KIND) == "p"
        assert annots[C.heartbeat_annotation(C.MIG_KIND)] == "3"


# ---------------------------------------------------------------------------
# chip_smoke.py's mig phase, its host parts on the CPU
# ---------------------------------------------------------------------------


class TestSmokeMig:
    def test_the_loop_writes_what_the_smoke_pins(self, monkeypatch):
        """Part (c) on real time.monotonic with the smoke's windows
        (about 2.5 s): every write must be MIG_LOOP_WRITES."""
        monkeypatch.setattr(port_journal, "_journal",
                            port_journal.DecisionJournal())
        fields, writes = chip_smoke._mig_loop()
        assert writes == chip_smoke.MIG_LOOP_WRITES
        assert fields["runtime"] == "FakeGpuRuntime"
        assert fields["plan_cycles"] == 2
        assert fields["running"] == ["mig-0", "mig-1", "mig-3", "mig-4"]
        assert fields["unschedulable_until_release"] == "mig-4"
        assert (fields["create_calls"],
                fields["delete_calls"]) == (2, 1)
        assert set(fields["bound_ms"]) == {f"mig-{i}" for i in range(5)}

    def test_the_loop_writes_the_same_on_an_injected_clock(self, monkeypatch):
        monkeypatch.setattr(port_journal, "_journal",
                            port_journal.DecisionJournal())
        now = [0.0]

        def advance():
            now[0] += 0.05

        _, writes = chip_smoke._mig_loop(clock=lambda: now[0],
                                         advance=advance, poll_s=0.0)
        assert writes == chip_smoke.MIG_LOOP_WRITES

    def _nvml(self, monkeypatch, gpus):
        lib = FakeNvmlLibrary(gpus)
        real = port_nvml.NvmlGpuRuntime
        monkeypatch.setattr(port_nvml, "NvmlGpuRuntime",
                            lambda model=None: real(model, lib=lib))
        return lib

    def test_the_reporter_on_a_card_with_mig_off(self, monkeypatch):
        lib = self._nvml(monkeypatch, [FakeGpu()])
        got = chip_smoke._mig_reporter_on_card(
            {"model": H100_80GB.name})
        assert got["mig_modes"] == ["disabled"] and got["mig_devices"] == 0
        assert set(got["annotations"]) == {
            C.heartbeat_annotation(C.MIG_KIND)}
        assert not [c for c in lib.calls if "Create" in c or "Destroy" in c]
        assert lib.open == 0

    def test_the_reporter_on_a_card_in_mig_mode(self, monkeypatch):
        lib = self._nvml(monkeypatch, [FakeGpu(mig=True, instances=[
            ("MIG-a", 2, 0, 4), ("MIG-b", 1, 4, 2), ("MIG-c", 0, 6, 1)])])
        got = chip_smoke._mig_reporter_on_card({"model": H100_80GB.name})
        assert got["mig_modes"] == ["enabled"] and got["mig_devices"] == 3
        annots = got["annotations"]
        assert annots[f"{C.ANNOT_PLACEMENTS_PREFIX}0"] == \
            "f|1g.10gb|6|1;f|2g.20gb|4|2;f|3g.40gb|0|4"
        assert {a.profile for a in parse_status_annotations(annots)} == \
            {"1g.10gb", "2g.20gb", "3g.40gb"}
        assert lib.open == 0

    def test_the_phase_refuses_other_writes(self, monkeypatch):
        monkeypatch.setattr(chip_smoke, "MIG_LOOP_WRITES", {})
        monkeypatch.setattr(chip_smoke, "_mig_fleet_plans", lambda: {})
        monkeypatch.setattr(chip_smoke, "_mig_reporter_on_card",
                            lambda device: {})
        monkeypatch.setattr(chip_smoke, "_mig_loop",
                            lambda: ({}, {"n": ["x"]}))
        with pytest.raises(SystemExit):
            chip_smoke.phase_mig({}, "H100, 700 W")
