"""The port's NVLink blocks (ROADMAP item 7.2: ``topology/profile.py``'s
block profiles, ``partitioning/slicepart/{node,group}.py``,
``scheduler/gang.py``'s windows, ``scheduler/scheduler.py``'s lease,
drain preemption, backfill and window terms) against the JAX package's
multi-host slices, on the same objects, cycle by cycle.

The mapping: a v5e host (one 2x4 block of 8 chips) is an 8-GPU H100
node in MIG mode, in NVLink domain "pod-a" at the same host index; a
JAX pod of one sub-host slice asks for its chips' count of 7g.80gb
instances (one GPU each: 2x4 -> 8, 2x2 -> 4, 1x2 -> 2); a multi-host
slice S is the block "(S.chips / 8)x8" (4x4 -> 2x8, 4x8 -> 4x8, 8x8 ->
8x8).  ``google.com/tpu`` is ``nvidia.com/gpu``.  Each case runs both
packages' scheduler (and, where JAX's test runs them, the partitioner
and the node agents on their fake runtimes) and compares after every
cycle: every pod's node and phase (so evictions, in order), the lease
annotation on every node, the ledger's drain holds, the scheduler's
journal records by kind and subject, and each block member node.

The cases are JAX's ``tests/test_multihost.py`` (all five) and
``tests/test_gang.py::TestDrainPreemption`` (all eight), then
``gang_slice_windows`` and ``_score_key`` on fleets drawn from numpy
seeds and by hypothesis, with the window terms and without.
"""

from __future__ import annotations

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings, strategies as st

import nos_tpu.api.constants as JC
import nos_tpu.obs.journal as jax_journal
import nos_tpu.obs.ledger as jax_ledger
from nos_tpu.api.pdb import (
    PodDisruptionBudget as JaxPDB, PodDisruptionBudgetSpec as JaxPDBSpec,
)
from nos_tpu.api.podgroup import PodGroup as JaxPodGroup
from nos_tpu.api.podgroup import PodGroupSpec as JaxPodGroupSpec
from nos_tpu.controllers.node_controller import (
    NodeController as JaxNodeController,
)
from nos_tpu.controllers.pod_controller import (
    PodController as JaxPodController,
)
from nos_tpu.controllers.sliceagent.agent import SliceAgent as JaxSliceAgent
from nos_tpu.device.fake import (
    FakePodResources as JaxFakePodResources, FakeTpuRuntime,
)
from nos_tpu.kube.client import APIServer as JaxAPIServer
from nos_tpu.kube.objects import ObjectMeta as JaxMeta
from nos_tpu.partitioning import slicepart as jax_sp
from nos_tpu.partitioning.slicepart import factory as jax_sp_factory
from nos_tpu.partitioning.slicepart import group as jax_group
from nos_tpu.partitioning.slicepart.node import SliceNode as JaxSliceNode
from nos_tpu.partitioning.state import ClusterState as JaxClusterState
from nos_tpu.scheduler import gang as jax_gang
from nos_tpu.scheduler.framework import (
    Framework as JaxFramework, NodeInfo as JaxNodeInfo,
    NodeResourcesFit as JaxFit,
)
from nos_tpu.scheduler.scheduler import Scheduler as JaxScheduler
from nos_tpu.testing import factory as jax_factory
from nos_tpu.topology import V5E
from nos_tpu.topology.annotations import (
    parse_spec_annotations as jax_parse_spec,
)

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.api.pdb import (
    PodDisruptionBudget, PodDisruptionBudgetSpec,
)
from nos_tpu_torch.controllers.node_controller import NodeController
from nos_tpu_torch.controllers.pod_controller import PodController
from nos_tpu_torch.controllers.sliceagent.agent import SliceAgent
from nos_tpu_torch.device.fake import FakeGpuRuntime, FakePodResources
from nos_tpu_torch.kube.client import (
    APIServer, KIND_NODE, KIND_POD, KIND_POD_DISRUPTION_BUDGET,
    KIND_POD_GROUP,
)
from nos_tpu_torch.kube.objects import ObjectMeta, RUNNING
from nos_tpu_torch.obs import journal, ledger
from nos_tpu_torch.partitioning import slicepart as sp
from nos_tpu_torch.partitioning.slicepart import group
from nos_tpu_torch.partitioning.slicepart.node import SliceNode
from nos_tpu_torch.partitioning.state import ClusterState
from nos_tpu_torch.quota import GPUResourceCalculator
from nos_tpu_torch.scheduler import gang
from nos_tpu_torch.scheduler.capacityscheduling import CapacityScheduling
from nos_tpu_torch.scheduler.framework import (
    Framework, NodeInfo, NodeResourcesFit,
)
from nos_tpu_torch.scheduler.scheduler import Scheduler
from nos_tpu_torch.testing import factory
from nos_tpu_torch.topology import profile as P
from nos_tpu_torch.topology.annotations import parse_spec_annotations
from nos_tpu_torch.topology.known import H100_80GB, GpuModelRegistry

# JAX's sub-host shapes as (MIG profile, instances); its multi-host
# shapes as blocks
SUBHOST = {"2x4": ("7g.80gb", 8), "2x2": ("7g.80gb", 4),
           "1x2": ("7g.80gb", 2), "1x1": ("7g.80gb", 1)}
BLOCKS = {"4x4": "2x8", "4x8": "4x8", "8x8": "8x8"}
# the port's label and annotation keys as JAX spells them
TO_JAX_KEY = {C.LABEL_POD_GROUP: JC.LABEL_POD_GROUP,
              C.ANNOT_JOB_PROGRESS: JC.ANNOT_JOB_PROGRESS}
# the scheduler's journal categories, compared record by record
SCHED_KINDS = ("pod-bound", "gang-admitted", "gang-rejected",
               "pod-nominated", "preemption")


def port_resources(shape: str, qty: int = 1) -> dict:
    if shape in BLOCKS:
        return {P.slice_resource_name(BLOCKS[shape]): qty, C.CPU: 1.0}
    profile, n = SUBHOST[shape]
    return {P.slice_resource_name(profile): n * qty, C.CPU: 1.0}


def port_status(table: dict[str, dict[str, int]]) -> dict:
    """A JAX host's status geometry as the port's, GPU by GPU: each GPU
    holds one 7g.80gb, free unless a used chip of the JAX table covers
    it."""
    used = sum(SUBHOST[s][1] * q for s, q in table.get("used", {}).items())
    return {g: {("used" if g < used else "free"): {"7g.80gb": 1}}
            for g in range(8)}


class Twin:
    """One fleet on both packages: ``hosts`` v5e hosts of TPU pod
    "pod-a" and as many 8-GPU H100 MIG nodes of NVLink domain "pod-a",
    each side's scheduler built with ``knobs``; with ``loop`` the node
    and pod controllers, the partitioner (on the twin's clock) and a
    node agent per node on its fake runtime, as JAX's ``Harness`` in
    tests/test_multihost.py."""

    def __init__(self, monkeypatch, hosts: int, loop: bool = False,
                 status: dict | None = None, **knobs) -> None:
        self.now = [0.0]
        clock = lambda: self.now[0]  # noqa: E731
        self.jj = jax_journal.DecisionJournal(maxlen=1 << 14, clock=clock)
        self.pj = journal.DecisionJournal(maxlen=1 << 14, clock=clock)
        monkeypatch.setattr(jax_journal, "_journal", self.jj)
        monkeypatch.setattr(journal, "_journal", self.pj)
        self.jledger = jax_ledger.ChipSecondLedger(clock=clock)
        self.pledger = ledger.ChipSecondLedger(clock=clock)
        monkeypatch.setattr(jax_ledger, "_ledger", self.jledger)
        monkeypatch.setattr(ledger, "_ledger", self.pledger)
        self.japi, self.api = JaxAPIServer(), APIServer()
        self.jagents, self.agents = [], []
        self.pod_res: list[FakePodResources] = []
        if loop:
            jstate, state = JaxClusterState(), ClusterState()
            JaxNodeController(self.japi, jstate,
                              jax_sp.SliceNodeInitializer(self.japi)).bind()
            JaxPodController(self.japi, jstate).bind()
            self.jpc = jax_sp_factory.new_slice_partitioner_controller(
                self.japi, jstate, batch_idle_s=10.0, clock=clock)
            self.jpc.bind()
            NodeController(self.api, state,
                           sp.SliceNodeInitializer(self.api)).bind()
            PodController(self.api, state).bind()
            self.pc = sp.new_slice_partitioner_controller(
                self.api, state, batch_idle_s=10.0, clock=clock)
            self.pc.bind()
        for i in range(hosts):
            name = f"host-{i}"
            self.japi.create("Node", jax_factory.make_tpu_node(
                name, pod_id="pod-a", host_index=i,
                status_geometry=status))
            self.api.create(KIND_NODE, factory.make_gpu_node(
                name, gpus=8, partitioning=C.MIG_KIND, domain="pod-a",
                host_index=i,
                status_geometry=port_status(status) if status else None))
            if loop:
                ja = JaxSliceAgent(self.japi, name, FakeTpuRuntime(V5E),
                                   JaxFakePodResources())
                res = FakePodResources()
                pa = SliceAgent(self.api, name, FakeGpuRuntime(num_gpus=8),
                                res)
                self.pod_res.append(res)
                for a in (ja, pa):
                    a.start()
                    a.tick()
                self.jagents.append(ja)
                self.agents.append(pa)
        self.jsched = JaxScheduler(
            self.japi, JaxFramework([JaxFit(),
                                     jax_gang.TopologyFilter(self.japi)]),
            clock=clock, **knobs)
        self.sched = Scheduler(
            self.api, Framework([NodeResourcesFit(),
                                 gang.TopologyFilter(self.api)]),
            CapacityScheduling(GPUResourceCalculator()), clock=clock,
            **knobs)
        self.compare()

    # -- objects ----------------------------------------------------------
    def pod(self, name: str, shape: str, qty: int = 1, **kw) -> None:
        jkw = dict(kw)
        for field in ("labels", "annotations"):
            if field in jkw:
                jkw[field] = {TO_JAX_KEY.get(k, k): v
                              for k, v in jkw[field].items()}
        self.japi.create("Pod", jax_factory.make_slice_pod(
            shape, qty, name=name, **jkw))
        self.api.create(KIND_POD, factory.make_pod(
            name=name, resources=port_resources(shape, qty), **kw))

    def group(self, name: str, members: int) -> None:
        self.japi.create("PodGroup", JaxPodGroup(
            metadata=JaxMeta(name=name, namespace="default"),
            spec=JaxPodGroupSpec(min_member=members)))
        self.api.create(KIND_POD_GROUP, factory.make_pod_group(name, members))

    def gang(self, name: str, members: int, shape: str) -> None:
        self.group(name, members)
        for i in range(members):
            self.pod(f"{name}-{i}", shape,
                     labels={C.LABEL_POD_GROUP: name})

    def pdb(self, name: str, min_available: int, selector: dict) -> None:
        self.japi.create("PodDisruptionBudget", JaxPDB(
            metadata=JaxMeta(name=name, namespace="default"),
            spec=JaxPDBSpec(min_available=min_available,
                            selector=selector)))
        self.api.create(KIND_POD_DISRUPTION_BUDGET, PodDisruptionBudget(
            metadata=ObjectMeta(name=name, namespace="default"),
            spec=PodDisruptionBudgetSpec(min_available=min_available,
                                         selector=selector)))

    def delete(self, name: str) -> None:
        self.japi.delete("Pod", name, "default")
        self.api.delete(KIND_POD, name, "default")

    # -- the loop -----------------------------------------------------------
    def cycle(self) -> int:
        bound = self.jsched.run_cycle()
        assert self.sched.run_cycle() == bound
        self.compare()
        return bound

    def converge(self, cycles: int = 4) -> int:
        bound = 0
        for _ in range(cycles):
            bound += self.cycle()
            self.now[0] += 11.0
            assert self.pc.process_if_ready() == self.jpc.process_if_ready()
            self.tick()
        return bound

    def tick(self) -> None:
        for ja, pa in zip(self.jagents, self.agents):
            ja.tick()
            pa.tick()
        self.compare()

    # -- reading --------------------------------------------------------------
    def side(self, jax: bool) -> dict:
        api = self.japi if jax else self.api
        lease_key = JC.ANNOT_GANG_LEASE if jax else C.ANNOT_GANG_LEASE
        pods = {p.metadata.name: (p.spec.node_name, p.status.phase)
                for p in api.list("Pod")}
        leases = {n.metadata.name: n.metadata.annotations.get(lease_key, "")
                  for n in api.list("Node")}
        led = self.jledger if jax else self.pledger
        holds = {n: sorted(h) for n, h in led.holds().items()}
        records = (self.jj if jax else self.pj).events()
        sched = [(r.category, r.subject) for r in records
                 if r.category in SCHED_KINDS]
        return {"pods": pods, "leases": leases, "holds": holds,
                "journal": sched, "members": self.members(jax)}

    def members(self, jax: bool) -> dict[str, str]:
        """Block member nodes: node -> its block (JAX's shape mapped)."""
        out = {}
        for n in (self.japi if jax else self.api).list("Node"):
            parse = jax_parse_spec if jax else parse_spec_annotations
            for a in parse(n.metadata.annotations):
                profile = BLOCKS.get(a.profile) if jax else (
                    a.profile if P.is_block_profile(a.profile) else None)
                if profile is not None and a.quantity:
                    out[n.metadata.name] = profile
        return out

    def compare(self) -> None:
        assert self.side(False) == self.side(True)

    def node_of(self, pod: str) -> str:
        return self.api.get(KIND_POD, pod, "default").spec.node_name

    def exists(self, pod: str) -> bool:
        return self.api.try_get(KIND_POD, pod, "default") is not None

    def index_of(self, pod: str) -> int:
        node = self.api.get(KIND_NODE, self.node_of(pod))
        return int(node.metadata.labels[C.LABEL_HOST_INDEX])


# ---------------------------------------------------------------------------
# The block profile, the model's blocks and the window helper
# ---------------------------------------------------------------------------


class TestBlockProfile:
    @pytest.mark.parametrize("profile,dims", [
        ("2x8", (2, 8)), ("4x8", (4, 8)), ("32x8", (32, 8)),
        ("2x1", (2, 1)), ("1x8", None), ("0x8", None), ("2x0", None),
        ("2x8x1", None), ("1g.10gb", None), ("24gb", None)])
    def test_block_dims(self, profile, dims):
        assert P.block_dims(profile) == dims
        assert P.is_block_profile(profile) == (dims is not None)

    @pytest.mark.parametrize("shape", sorted(BLOCKS))
    def test_the_mapping_keeps_every_chip(self, shape):
        from nos_tpu.topology.shape import Shape as JaxShape

        chips = JaxShape.parse(shape).chips
        profile = BLOCKS[shape]
        assert P.block_gpus(profile) == chips
        assert H100_80GB.hosts_for(profile) == V5E.hosts_for(
            JaxShape.parse(shape))
        res = P.slice_resource_name(profile)
        assert res == f"nos.nebuly.com/nvlink-block-{profile}"
        assert P.profile_from_resource(res) == profile
        assert P.is_block_resource(res) and P.is_slice_resource(res)
        assert P.extract_slice_requests({res: 1}) == {profile: 1}

    def test_the_window_sizes_are_v5e_s(self):
        from nos_tpu.scheduler.scheduler import _window_sizes_of
        from nos_tpu_torch.scheduler.scheduler import (
            _window_sizes_of as port_sizes,
        )

        assert port_sizes(H100_80GB) == _window_sizes_of(V5E)

    def test_overrides_restrict_the_blocks(self, tmp_path):
        f = tmp_path / "models.json"
        f.write_text('{"nvidia-h100-80gb-hbm3": '
                     '{"block_node_counts": [2, 4]}}')
        reg = GpuModelRegistry()
        reg.load_overrides(str(f))
        model = reg.get("nvidia-h100-80gb-hbm3")
        assert model.offers_block("4x8") and not model.offers_block("8x8")
        assert model.profile_names() == H100_80GB.profile_names()
        f.write_text('{"nvidia-h100-80gb-hbm3": {"block_node_counts": [3]}}')
        with pytest.raises(ValueError, match="block node counts"):
            GpuModelRegistry().load_overrides(str(f))


class TestAlignedWindows:
    @pytest.mark.parametrize("indices,size", [
        ((0, 1, 2, 3, 5), 2), ((0, 1, 2, 3, 4, 5, 6, 7), 4),
        ((1, 2, 3, 4), 2), ((0, 2, 3, 4, 5, 6, 7), 4), ((), 2),
        ((0, 1, 2, 3, 4, 5, 6, 7, 8, 9), 8)])
    def test_as_jax(self, indices, size):
        jnodes, pnodes = [], []
        for i in indices:
            jn = jax_factory.make_tpu_node(f"h{i}", pod_id="p", host_index=i)
            jnodes.append(JaxSliceNode(jn, JaxNodeInfo(node=jn)))
            pn = factory.make_gpu_node(f"h{i}", gpus=8,
                                       partitioning=C.MIG_KIND, domain="p",
                                       host_index=i)
            pnodes.append(SliceNode(pn, NodeInfo(node=pn)))
        assert [[n.name for n in w]
                for w in group.aligned_windows(pnodes, size)] == \
            [[n.name for n in w]
             for w in jax_group.aligned_windows(jnodes, size)]


# ---------------------------------------------------------------------------
# tests/test_multihost.py
# ---------------------------------------------------------------------------


class TestMultihost:
    def test_aligned_windows_helper(self):
        nodes = []
        for i in (0, 1, 2, 3, 5):
            n = factory.make_gpu_node(f"h{i}", gpus=8,
                                      partitioning=C.MIG_KIND, domain="p",
                                      host_index=i)
            nodes.append(SliceNode(n, NodeInfo(node=n)))
        names = [[n.name for n in w] for w in group.aligned_windows(nodes, 2)]
        assert names == [["h0", "h1"], ["h2", "h3"]]

    def test_baseline_reshape(self, monkeypatch):
        """BASELINE config #3 on both: 8 nodes -> 4 whole-node singles
        and two 2x8 blocks under pending pressure."""
        t = Twin(monkeypatch, 8, loop=True)
        for i in range(4):
            t.pod(f"single-{i}", "2x4")
        t.gang("job-a", 2, "4x4")
        t.gang("job-b", 2, "4x4")
        assert t.converge() == 8
        for name, (node, phase) in t.side(False)["pods"].items():
            assert phase == RUNNING, name
        for job in ("job-a", "job-b"):
            idxs = sorted(t.index_of(f"{job}-{i}") for i in range(2))
            assert idxs[1] == idxs[0] + 1 and idxs[0] % 2 == 0, (job, idxs)
        node = t.api.get(KIND_NODE, t.node_of("job-a-0"))
        spec = {(a.index, a.profile): a.quantity
                for a in parse_spec_annotations(node.metadata.annotations)}
        assert spec == {(0, "2x8"): 1}
        assert node.status.allocatable[
            "nos.nebuly.com/nvlink-block-2x8"] == 1.0

    def test_reclaim_free_block_for_small_pods(self, monkeypatch):
        t = Twin(monkeypatch, 2, loop=True)
        t.gang("big", 2, "4x4")
        assert t.converge() == 2
        for i in range(2):
            t.delete(f"big-{i}")
        t.tick()
        for i in range(4):
            t.pod(f"small-{i}", "2x2")
        assert t.converge() == 4
        assert t.side(False)["members"] == {}

    def test_used_shards_never_destroyed(self, monkeypatch):
        t = Twin(monkeypatch, 2, loop=True)
        t.gang("big", 2, "4x4")
        assert t.converge() == 2
        for i, (ja, pa) in enumerate(zip(t.jagents, t.agents)):
            (jdev,) = ja.runtime.list_devices()
            (pdev,) = pa.runtime.list_devices()
            assert pdev.resource_name == \
                "nos.nebuly.com/nvlink-block-2x8"
            ja.pod_resources.allocate(f"default/big-{i}", {jdev.device_id})
            t.pod_res[i].allocate(f"default/big-{i}", {pdev.device_id})
        t.tick()
        for i in range(4):
            t.pod(f"small-{i}", "2x2")
        t.converge()
        for pa in t.agents:
            assert [d.resource_name for d in pa.runtime.list_devices()] \
                == ["nos.nebuly.com/nvlink-block-2x8"]
        for i in range(4):
            assert t.node_of(f"small-{i}") == ""

    def test_gang_rejects_misaligned_window(self, monkeypatch):
        t = Twin(monkeypatch, 4, loop=True)
        t.pod("holder", "2x4")
        assert t.converge(1) >= 1
        holder = t.node_of("holder")
        t.gang("big", 2, "4x4")
        assert t.converge() == 2
        idxs = sorted(t.index_of(f"big-{i}") for i in range(2))
        assert idxs[0] % 2 == 0 and idxs[1] == idxs[0] + 1
        assert holder not in {t.node_of(f"big-{i}") for i in range(2)}


# ---------------------------------------------------------------------------
# tests/test_gang.py::TestDrainPreemption
# ---------------------------------------------------------------------------

WHOLE_FREE = {"free": {"2x4": 1}}


class TestDrainPreemption:
    def _stuck_gang(self, t: Twin) -> None:
        t.gang("big", 4, "4x8")

    def test_straggler_evicted_after_threshold(self, monkeypatch):
        t = Twin(monkeypatch, 4, status=WHOLE_FREE,
                 drain_preempt_after_cycles=3)
        t.pod("straggler", "2x4", node_name="host-1", phase=RUNNING)
        self._stuck_gang(t)
        for _ in range(4):
            t.cycle()
            assert t.exists("straggler")
        t.cycle()
        assert not t.exists("straggler")
        # the window's freed GPUs carry the drain hold while the lease
        # stands
        assert t.side(False)["holds"] == {
            f"host-{h}": ["drain"] for h in range(4)}
        assert set(t.side(False)["leases"].values()) == {"default/big"}

    def test_too_busy_window_not_preempted(self, monkeypatch):
        t = Twin(monkeypatch, 4, status=WHOLE_FREE,
                 drain_preempt_after_cycles=2,
                 drain_preempt_max_busy_fraction=0.25)
        for h in (0, 1):
            t.pod(f"busy-{h}", "2x4", node_name=f"host-{h}", phase=RUNNING)
        self._stuck_gang(t)
        for _ in range(6):
            t.cycle()
        assert t.exists("busy-0") and t.exists("busy-1")

    def test_pdb_protected_straggler_reprieved(self, monkeypatch):
        t = Twin(monkeypatch, 4, status=WHOLE_FREE,
                 drain_preempt_after_cycles=2)
        t.pod("protected", "2x4", node_name="host-1", phase=RUNNING,
              labels={"app": "serving"})
        t.pdb("pdb", 1, {"app": "serving"})
        self._stuck_gang(t)
        for _ in range(6):
            t.cycle()
        assert t.exists("protected")

    def test_near_done_straggler_spared(self, monkeypatch):
        t = Twin(monkeypatch, 4, status=WHOLE_FREE,
                 drain_preempt_after_cycles=3,
                 drain_preempt_max_busy_fraction=0.5)
        t.pod("nearly-done", "2x4", node_name="host-1", phase=RUNNING,
              annotations={C.ANNOT_JOB_PROGRESS: "0.9"})
        t.pod("fresh", "2x4", node_name="host-2", phase=RUNNING,
              annotations={C.ANNOT_JOB_PROGRESS: "0.1"})
        self._stuck_gang(t)
        for _ in range(6):
            t.cycle()
        assert t.exists("nearly-done") and not t.exists("fresh")

    def test_gang_straggler_spared_by_mates_progress(self, monkeypatch):
        t = Twin(monkeypatch, 4, status=WHOLE_FREE,
                 drain_preempt_after_cycles=3,
                 drain_preempt_max_busy_fraction=0.8)
        t.group("straggler-gang", 2)
        t.pod("sg-0", "2x4", node_name="host-1", phase=RUNNING,
              labels={C.LABEL_POD_GROUP: "straggler-gang"},
              annotations={C.ANNOT_JOB_PROGRESS: "0.9"})
        t.pod("sg-1", "2x4", node_name="host-2", phase=RUNNING,
              labels={C.LABEL_POD_GROUP: "straggler-gang"})
        t.pod("inf-pod", "2x4", node_name="host-3", phase=RUNNING,
              annotations={C.ANNOT_JOB_PROGRESS: "inf"})
        self._stuck_gang(t)
        for _ in range(6):
            t.cycle()
        assert t.exists("sg-0") and t.exists("sg-1")
        assert not t.exists("inf-pod")

    def test_progress_fn_injection(self, monkeypatch):
        t = Twin(monkeypatch, 4, status=WHOLE_FREE,
                 drain_preempt_after_cycles=3,
                 drain_preempt_progress_fn=lambda p: 0.95)
        t.pod("s", "2x4", node_name="host-1", phase=RUNNING)
        self._stuck_gang(t)
        for _ in range(8):
            t.cycle()
        assert t.exists("s")

    def test_duration_aware_backfill(self, monkeypatch):
        durations = {"straggler": 20.0, "short": 5.0, "long": 60.0}
        t = Twin(monkeypatch, 4, status={"free": {"1x2": 4}},
                 backfill_remaining_fn=lambda p: durations.get(
                     p.metadata.name),
                 backfill_duration_fn=lambda p: durations.get(
                     p.metadata.name))
        t.pod("straggler", "1x2", node_name="host-1", phase=RUNNING)
        self._stuck_gang(t)
        t.cycle()
        assert t.sched._reserved_hosts == t.jsched._reserved_hosts != set()
        for name in ("short", "long", "unknown"):
            t.pod(name, "1x2")
        t.cycle()
        assert t.node_of("short")
        assert not t.node_of("long") and not t.node_of("unknown")
        pod = t.api.get(KIND_POD, "long", "default")
        record = [r for r in t.pj.events("pod-rejected")
                  if r.subject == "default/long"][-1]
        assert "Backfill: job would outlive the drain window" in \
            record.attrs["reason_counts"]
        assert pod.status.conditions[0].message == "no fit"

    def test_disabled_by_default(self, monkeypatch):
        t = Twin(monkeypatch, 4, status=WHOLE_FREE)
        assert t.sched._drain_after is None
        t.pod("s", "2x4", node_name="host-1", phase=RUNNING)
        self._stuck_gang(t)
        for _ in range(10):
            t.cycle()
        assert t.exists("s")


# ---------------------------------------------------------------------------
# gang_slice_windows and the score on drawn fleets
# ---------------------------------------------------------------------------


def _drawn_fleet(rng, n_domains: int, mixed: bool):
    """Both packages' nodes: per domain up to 9 hosts at shuffled
    indices, some busy with a whole-host single; with ``mixed`` a
    4-chip v6e host (a 4-GPU node) joins some domain."""
    jnodes, pnodes, busy = [], [], []
    for d in range(n_domains):
        count = int(rng.integers(1, 10))
        indices = sorted(rng.choice(12, size=count, replace=False).tolist())
        for i in indices:
            name = f"d{d}-h{i}"
            jnodes.append(jax_factory.make_tpu_node(
                name, pod_id=f"dom-{d}", host_index=i,
                status_geometry=WHOLE_FREE))
            pnodes.append(factory.make_gpu_node(
                name, gpus=8, partitioning=C.MIG_KIND, domain=f"dom-{d}",
                host_index=i, status_geometry=port_status(WHOLE_FREE)))
            if rng.integers(3) == 0:
                busy.append(name)
    if mixed:
        from nos_tpu.topology import V6E

        jnodes.append(jax_factory.make_tpu_node(
            "odd", generation=V6E, pod_id="dom-0", host_index=13))
        pnodes.append(factory.make_gpu_node(
            "odd", gpus=4, partitioning=C.MIG_KIND, domain="dom-0",
            host_index=13))
    return jnodes, pnodes, busy


class TestGangSliceWindows:
    @pytest.mark.parametrize("seed", range(6))
    @pytest.mark.parametrize("shape", ["4x4", "4x8", "8x8", "2x2"])
    def test_windows_as_jax(self, seed, shape):
        rng = np.random.default_rng(2700 + seed)
        jnodes, pnodes, _ = _drawn_fleet(rng, 3, mixed=seed % 2 == 1)
        japi, api = JaxAPIServer(), APIServer()
        for jn, pn in zip(jnodes, pnodes):
            japi.create("Node", jn)
            api.create(KIND_NODE, pn)
        jm = [jax_factory.make_slice_pod(shape, 1, name=f"m{i}")
              for i in range(2)]
        pm = [factory.make_pod(name=f"m{i}",
                               resources=port_resources(shape))
              for i in range(2)]
        want = jax_gang.gang_slice_windows(japi, jm)
        got = gang.gang_slice_windows(api, pm)
        if shape in BLOCKS:
            assert got == want
        else:
            # a sub-host slice needs no window on either side
            assert got == [] and all(h is None for _, h in want) \
                or want == []

    def test_the_topology_filter_pins_the_window(self):
        from nos_tpu.scheduler.framework import CycleState as JaxCycleState
        from nos_tpu_torch.scheduler.framework import CycleState

        japi, api = JaxAPIServer(), APIServer()
        jn = jax_factory.make_tpu_node("h3", pod_id="p", host_index=3)
        pn = factory.make_gpu_node("h3", gpus=8, partitioning=C.MIG_KIND,
                                   domain="p", host_index=3)
        jpod = jax_factory.make_slice_pod(
            "4x4", 1, name="m", labels={JC.LABEL_POD_GROUP: "g"})
        ppod = factory.make_pod(name="m", resources=port_resources("4x4"),
                                labels={C.LABEL_POD_GROUP: "g"})
        hosts = frozenset({"h0", "h1"})
        jst = JaxCycleState({jax_gang.GANG_POD_ID_KEY: "p",
                             jax_gang.GANG_HOST_SET_KEY: hosts})
        pst = CycleState({gang.GANG_DOMAIN_KEY: "p",
                          gang.GANG_HOST_SET_KEY: hosts})
        jv = jax_gang.TopologyFilter(japi).filter(
            jst, jpod, JaxNodeInfo(node=jn))
        pv = gang.TopologyFilter(api).filter(pst, ppod, NodeInfo(node=pn))
        assert (pv.is_success, pv.message) == (
            jv.is_success, jv.message.replace("slice hosts", "block nodes"))
        assert not pv.is_success


def _score_sides(jnodes, pnodes, busy):
    """Both packages' cycle views of the fleet, the busy nodes each
    holding one bound whole-node single."""
    japi, api = JaxAPIServer(), APIServer()
    for jn, pn in zip(jnodes, pnodes):
        japi.create("Node", jn)
        api.create(KIND_NODE, pn)
    for name in busy:
        japi.create("Pod", jax_factory.make_slice_pod(
            "1x1", 1, name=f"b-{name}", node_name=name, phase=RUNNING))
        api.create(KIND_POD, factory.make_pod(
            name=f"b-{name}", resources=port_resources("1x1"),
            node_name=name, phase=RUNNING))
    jsched = JaxScheduler(japi, JaxFramework([JaxFit()]))
    sched = Scheduler(api, Framework([NodeResourcesFit()]),
                      CapacityScheduling(GPUResourceCalculator()))
    return jsched, sched


def _argmins(jsched, sched, windows: bool):
    jl, pl = jsched._cycle_lister(), sched._cycle_lister()
    jpod = jax_factory.make_slice_pod("1x1", 1, name="probe")
    ppod = factory.make_pod(name="probe", resources=port_resources("1x1"))
    jnis = jl.list()
    pnis = [pl.get(ni.name) for ni in jnis]
    want = min(jnis, key=jsched._score_key(jpod, jl if windows else None))
    got = min(pnis, key=sched._score_key(ppod, pl if windows else None))
    return want.name, got.name


class TestScoreKey:
    @pytest.mark.parametrize("windows", [True, False],
                             ids=["window-terms", "no-window-terms"])
    @pytest.mark.parametrize("seed", range(5))
    def test_the_argmin_is_jax_s(self, seed, windows):
        rng = np.random.default_rng(2800 + seed)
        jnodes, pnodes, busy = _drawn_fleet(rng, 2, mixed=False)
        want, got = _argmins(*_score_sides(jnodes, pnodes, busy), windows)
        assert got == want

    @settings(max_examples=40, deadline=None,
              suppress_health_check=[HealthCheck.too_slow])
    @given(data=st.data())
    @pytest.mark.parametrize("windows", [True, False],
                             ids=["window-terms", "no-window-terms"])
    def test_hypothesis_fleet(self, data, windows):
        seed = data.draw(st.integers(0, 2**31 - 1))
        domains = data.draw(st.integers(1, 3))
        rng = np.random.default_rng(seed)
        jnodes, pnodes, busy = _drawn_fleet(rng, domains, mixed=False)
        jsched, sched = _score_sides(jnodes, pnodes, busy)
        want, got = _argmins(jsched, sched, windows)
        assert got == want
        # the native argmin reads the same window terms
        pl = sched._cycle_lister()
        nis = pl.list()
        if len(nis) > 1:
            ppod = factory.make_pod(name="probe",
                                    resources=port_resources("1x1"))
            assert sched._native_choose(ppod, nis) is \
                min(nis, key=sched._score_key(ppod, pl))


# ---------------------------------------------------------------------------
# chip_smoke.py's block phase on the host
# ---------------------------------------------------------------------------

SMOKE_DEVICE = {"uuid": "GPU-11111111-2222-4333-8444-555555555555",
                "model": "nvidia-h100-80gb-hbm3"}


class TestSmokeBlockLoop:
    def test_the_loop_leases_drains_and_binds(self):
        import chip_smoke

        now = [0.0]

        def advance():
            now[0] += 0.3

        loop, card = chip_smoke._block_loop(SMOKE_DEVICE,
                                            clock=lambda: now[0],
                                            advance=advance)
        assert card["lease_first_cycle"] == {
            "h100-block-0": "default/blk", "h100-block-1": "default/blk"}
        assert card["evict_cycle"] == chip_smoke.BLOCK_DRAIN_AFTER + 2
        assert sorted(card["bound"].values()) == ["h100-block-0",
                                                  "h100-block-1"]
        assert "busy" in loop.pods() and "straggler" not in loop.pods()

    def test_the_grant_names_the_card_whole(self):
        import chip_smoke
        from nos_tpu_torch.device import workload_env

        loop, _ = chip_smoke._block_loop(SMOKE_DEVICE)
        member = next(n for n in chip_smoke.BLOCK_GANG[2]
                      if loop.pods()[n].spec.node_name == "h100-block-0")
        grant = chip_smoke._block_grant(loop, member)
        env = dict(grant)
        applied = workload_env.apply(env)
        assert applied["CUDA_VISIBLE_DEVICES"] == SMOKE_DEVICE["uuid"]
        assert workload_env.granted_device_ids(grant) == \
            [SMOKE_DEVICE["uuid"]]
        assert workload_env.memory_fraction(env) is None

    def test_the_story_decides_as_jax(self, monkeypatch):
        """The smoke's story on the twin (8-GPU nodes and v5e hosts, the
        block 2x8 and the slice 4x4): the same lease, eviction and bind
        cycles on both packages, and the window [0, 1] taken."""
        t = Twin(monkeypatch, 4, loop=True, drain_preempt_after_cycles=2,
                 drain_preempt_max_busy_fraction=0.5)
        t.converge(1)
        for name, host, progress in (("straggler", 1, "0.1"),
                                     ("busy", 2, "0.9")):
            t.pod(name, "2x4", node_name=f"host-{host}",
                  annotations={C.ANNOT_JOB_PROGRESS: progress})
        t.tick()
        t.gang("blk", 2, "4x4")
        assert t.converge(8) == 2
        assert not t.exists("straggler") and t.exists("busy")
        assert sorted(t.node_of(f"blk-{i}") for i in range(2)) == \
            ["host-0", "host-1"]


class TestBlockGrant:
    def test_the_plugin_grants_the_node_whole(self):
        """The device plugin's Allocate for a block member names every
        GPU of its node by UUID; a MIG grant still names one instance."""
        from nos_tpu_torch.device.deviceplugin import DevicePluginManager

        uuids = [f"GPU-00000000-0000-4000-8000-{i:012x}" for i in range(2)]
        rt = FakeGpuRuntime(num_gpus=2, gpu_uuids=uuids)
        (did,) = rt.create_slices(0, ["2x2"])
        manager = DevicePluginManager(rt)
        envs = manager._slice_allocate_envs(
            "nos.nebuly.com/nvlink-block-2x2", [did])
        assert envs == {"NOS_TPU_SLICE_IDS": did,
                        "NOS_TPU_VISIBLE_CHIPS_nvlink_block_2x2":
                            ",".join(uuids)}

    def test_no_uuid_no_visibility(self):
        from nos_tpu_torch.device.deviceplugin import block_allocate_envs

        res = "nos.nebuly.com/nvlink-block-2x1"
        assert block_allocate_envs(res, ["d"], []) == \
            {"NOS_TPU_SLICE_IDS": "d"}
        assert block_allocate_envs(res, ["d"], ["MIG-x"]) == \
            {"NOS_TPU_SLICE_IDS": "d"}


# ---------------------------------------------------------------------------
# The group pass at fleet size: bench_plan's and bench_fleet's 4x4 rows
# ---------------------------------------------------------------------------


def _bench_layout(kind: str):
    """The layout of a JAX bench's multi-host rows, under this file's
    mapping: (node, domain, host index, full) rows, half of each domain's
    hosts full and half virgin, and (pod, pod group, priority) for each
    of the bench's 4x4 pods, named and labelled as the bench names and
    labels them.  ``plan``: bench_plan.py's 64 hosts in 4 domains of 16
    and its 200-pod mix; ``fleet``: bench_fleet.py's v5e pools (8 of 64
    hosts, the v5e share of its 1024) and their part of its batch."""
    import bench_fleet
    import bench_plan

    if kind == "plan":
        per = bench_plan.HOSTS // bench_plan.DOMAINS
        nodes = [(f"host-{i}", f"pod-{i // per}", i % per,
                  i < bench_plan.FULL_HOSTS)
                 for i in range(bench_plan.HOSTS)]
        mix, want, name, group = (bench_plan.POD_MIX,
                                  bench_plan.PENDING_PODS,
                                  "pending-{}", "gang-{}")
    else:
        pools = dict((g, n) for _, g, n in bench_fleet.FLEET)["v5e"]
        per = 1024 // bench_fleet.POOLS
        nodes = [(f"v5e-{p}-h{h}", f"v5e-pod-{p}", h, h < per // 2)
                 for p in range(pools) for h in range(per)]
        mix, want, name, group = (bench_fleet.BATCH_MIX["v5e"],
                                  40 * per * pools // 64,
                                  "fleet-v5e-{}", "fleet-gang-{}")
    rows = [s for s, w in mix for _ in range(w)]
    pods = [(name.format(i), group.format(i), i % 3) for i in range(want)
            if rows[i % len(rows)] == "4x4"]
    return nodes, pods


def _bench_nodes(kind: str):
    """Each layout node on both packages with its filler where full:
    (JAX node, JAX filler or None, port node, port filler or None)."""
    from nos_tpu.kube.objects import RUNNING as JAX_RUNNING

    out = []
    for name, domain, index, full in _bench_layout(kind)[0]:
        table = {"used" if full else "free": {"2x4": 1}}
        jnode = jax_factory.make_tpu_node(name, pod_id=domain,
                                          host_index=index,
                                          status_geometry=table)
        node = factory.make_gpu_node(name, gpus=8, partitioning=C.MIG_KIND,
                                     domain=domain, host_index=index,
                                     status_geometry=port_status(table))
        jfill = fill = None
        if full:
            jfill = jax_factory.make_pod(
                name=f"filler-{name}", node_name=name, phase=JAX_RUNNING,
                resources=dict(jnode.status.allocatable))
            fill = factory.make_pod(
                name=f"filler-{name}", node_name=name, phase=RUNNING,
                resources=dict(node.status.allocatable))
        out.append((jnode, jfill, node, fill))
    return out


class _CarveLog:
    """JAX's group pass logs its carves ("group pass: carved S across
    [nodes]") where the port journals them: the log lines, as the
    port's (block, nodes) rows."""

    def __init__(self) -> None:
        import logging

        self.rows: list = []
        self._logger = logging.getLogger(jax_group.__name__)
        self._handler = logging.Handler()
        self._handler.emit = self._emit
        self._level = self._logger.level

    def _emit(self, record) -> None:
        if record.msg.startswith("group pass: carved"):
            shape, nodes = record.args
            self.rows.append((BLOCKS[shape], list(nodes)))

    def __enter__(self) -> "_CarveLog":
        import logging

        self._logger.addHandler(self._handler)
        self._logger.setLevel(logging.INFO)
        return self

    def __exit__(self, *exc) -> None:
        self._logger.removeHandler(self._handler)
        self._logger.setLevel(self._level)


def _plan_both(kind: str, workers: int) -> dict:
    """The layout's 4x4 rows planned by both packages' parallel planner
    over the MultiHostGeometryPlanner at ``workers``: per package the
    block windows carved ((block, nodes), sorted), the block members of
    the desired state (node -> block), the committed nodes and the merge
    record."""
    import nos_tpu.partitioning.core as jax_core

    from nos_tpu_torch.partitioning.core import ParallelGeometryPlanner

    jstate, state = JaxClusterState(), ClusterState()
    for jnode, jfill, node, fill in _bench_nodes(kind):
        jstate.update_node(jnode, [jfill] if jfill else [])
        state.update_node(node, [fill] if fill else [])
    rows = _bench_layout(kind)[1]
    jpods = [jax_factory.make_slice_pod(
        "4x4", 1, name=n, labels={JC.LABEL_POD_GROUP: g}, priority=pr)
        for n, g, pr in rows]
    pods = [factory.make_pod(
        name=n, resources=port_resources("4x4"),
        labels={C.LABEL_POD_GROUP: g}, priority=pr) for n, g, pr in rows]
    jplanner = jax_core.ParallelGeometryPlanner(
        lambda: jax_group.MultiHostGeometryPlanner(
            JaxFramework(), jax_sp.SliceProfileCalculator(),
            jax_sp.SlicePartitionCalculator()),
        jax_sp.SliceProfileCalculator(), kind="slice",
        max_workers=workers, min_shard_hosts=0, clock=lambda: 0.0)
    planner = ParallelGeometryPlanner(
        lambda: group.MultiHostGeometryPlanner(
            Framework(), sp.SliceProfileCalculator(),
            sp.SlicePartitionCalculator()),
        sp.SliceProfileCalculator(), kind=C.MIG_KIND, max_workers=workers,
        min_shard_hosts=0, clock=lambda: 0.0)
    jj = jax_journal.DecisionJournal(maxlen=1 << 16)
    pj = journal.DecisionJournal(maxlen=1 << 16)
    prev_j, prev_p = jax_journal.set_journal(jj), journal.set_journal(pj)
    try:
        with _CarveLog() as log:
            jdesired = jplanner.plan(
                jax_sp.SliceSnapshotTaker().take_snapshot(jstate), jpods)
        desired = planner.plan(
            sp.SliceSnapshotTaker().take_snapshot(state), pods)
    finally:
        jax_journal.set_journal(prev_j)
        journal.set_journal(prev_p)
        jplanner.close()
        planner.close()

    def members(state, jax: bool) -> dict:
        out = {}
        for name, np_ in state.items():
            for u in np_.units:
                for res in u.resources:
                    key = res.rsplit("-", 1)[1]
                    if jax and key in BLOCKS:
                        out[name] = BLOCKS[key]
                    elif not jax and P.is_block_profile(key):
                        out[name] = key
        return dict(sorted(out.items()))

    def merged(records) -> list:
        return [{k: v for k, v in r.attrs.items()
                 if k not in ("wall_ms", "pools")}
                for r in records if r.category == journal.PLAN_SHARD_MERGED]

    carved = [(r.subject, list(r.attrs["nodes"])) for r in pj.events()
              if r.category == journal.PLAN_BLOCK_CARVED]
    return {
        "jax": {"windows": sorted(log.rows),
                "members": members(jdesired, True),
                "committed": sorted(r.subject for r in jj.events()
                                    if r.category == "plan-node-committed"),
                "merged": merged(jj.events())},
        "port": {"windows": sorted(carved),
                 "members": members(desired, False),
                 "committed": sorted(r.subject for r in pj.events()
                                     if r.category == "plan-node-committed"),
                 "merged": merged(pj.events())},
        "domains": {r.subject + ":" + ",".join(r.attrs["nodes"]):
                    r.attrs["domain"] for r in pj.events()
                    if r.category == journal.PLAN_BLOCK_CARVED},
        "pods": len(rows)}


def _jax_text(value):
    """A JAX string in the port's names: a slice resource of a multi-host
    shape its block resource."""
    if isinstance(value, dict):
        return {_jax_text(k): _jax_text(v) for k, v in value.items()}
    if not isinstance(value, str):
        return value
    for shape, block in BLOCKS.items():
        value = value.replace(f"{JC.RESOURCE_SLICE_PREFIX}{shape}",
                              P.slice_resource_name(block))
    return value


class TestGroupPassAtFleetSize:
    """bench_plan.py's and bench_fleet.py's 4x4 rows alone on their
    layouts, planned by both packages' group pass at 1 and 4 workers,
    then a few scheduler cycles with bench_fleet.py's 8x8 residents."""

    @pytest.mark.parametrize("workers", [1, 4])
    @pytest.mark.parametrize("kind", ["plan", "fleet"])
    def test_the_same_windows_members_and_records(self, kind, workers):
        got = _plan_both(kind, workers)
        assert got["port"] == got["jax"]
        windows = got["port"]["windows"]
        # every 4x4 pod is its own gang of one shard: a window a pair
        assert 2 * len(windows) >= got["pods"] > 0
        nodes = {n: (d, i) for n, d, i, _ in _bench_layout(kind)[0]}
        for block, names in windows:
            assert block == "2x8"
            (domain,) = {nodes[n][0] for n in names}
            index = [nodes[n][1] for n in names]
            assert index[0] % 2 == 0 and index == [index[0], index[0] + 1]
            assert got["domains"][f"{block}:{','.join(names)}"] == domain

    @pytest.mark.parametrize("kind", ["plan", "fleet"])
    def test_one_and_four_workers_carve_alike(self, kind):
        assert _plan_both(kind, 1)["port"] == _plan_both(kind, 4)["port"]

    def test_the_residents_are_rejected_as_jax(self):
        """bench_fleet.py's eight v5e 8x8 residents (no pod group, as it
        makes them) through three cycles of both schedulers over its
        layout: every record the same, the rejections node class by
        node class (full nodes lack cpu and the block, virgin ones the
        block)."""
        kind = "fleet"
        from nos_tpu.cmd.assembly import build_scheduler as jax_build

        from nos_tpu_torch.cmd.assembly import build_scheduler

        japi, api = JaxAPIServer(), APIServer()
        for jnode, jfill, node, fill in _bench_nodes(kind):
            japi.create("Node", jnode)
            api.create(KIND_NODE, node)
            if fill:
                japi.create("Pod", jfill)
                api.create(KIND_POD, fill)
        for k in range(8):
            japi.create("Pod", jax_factory.make_slice_pod(
                "8x8", 1, name=f"resident-v5e-{k}"))
            api.create(KIND_POD, factory.make_pod(
                name=f"resident-v5e-{k}", resources=port_resources("8x8")))
        jj = jax_journal.DecisionJournal(maxlen=1 << 16)
        pj = journal.DecisionJournal(maxlen=1 << 16)
        prev_j, prev_p = jax_journal.set_journal(jj), journal.set_journal(pj)
        jsched = jax_build(japi, clock=lambda: 0.0)
        sched = build_scheduler(api, clock=lambda: 0.0)
        try:
            for _ in range(3):
                assert sched.run_cycle() == jsched.run_cycle() == 0
        finally:
            jax_journal.set_journal(prev_j)
            journal.set_journal(prev_p)
            jsched.close()
            sched.close()
        want = [(r.category, r.subject, _jax_text(r.attrs))
                for r in jj.events()]
        got = [(r.category, r.subject, r.attrs) for r in pj.events()]
        assert got == want
        rejected = [a for c, _, a in got if c == journal.POD_REJECTED]
        assert len(rejected) == 3 * 8
        res = P.slice_resource_name("8x8")
        full = sum(f for *_, f in _bench_layout(kind)[0])
        assert rejected[0]["reason_counts"] == {
            f"NodeResourcesFit: insufficient cpu, {res}": full,
            f"NodeResourcesFit: insufficient {res}": full}
