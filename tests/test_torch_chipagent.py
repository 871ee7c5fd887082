"""The port's MPS node side (nos_tpu_torch/device/timeshare_plugin.py,
controllers/chipagent/, controllers/kubelet.py's admit_bound_pods)
against the JAX package's timeshare plugin, chip agent and admission on
the same writes, compared exactly: the node's annotations (keys mapped
as in test_torch_controller.py, plan ids equal on both sides here),
its allocatable and capacity, the pods' phases, and the plugin's
config table.  Also the rest of ``tests/test_e2e_timeshare.py``'s six
cases on the port: the config's round trip, used shares surviving a
re-carve, the two families' status annotations on a hybrid node, and
the agent refusing a MIG node.
"""

from __future__ import annotations

import logging

import numpy as np
import pytest

import nos_tpu.api.constants as JC
import nos_tpu.partitioning.timeshare as jax_ts
import nos_tpu.partitioning.state as jax_state
import nos_tpu.topology.annotations as jax_annotations
from nos_tpu.controllers.chipagent import ChipAgent as JaxChipAgent
from nos_tpu.controllers.kubelet import admit_bound_pods as jax_admit
from nos_tpu.kube.client import APIServer as JaxAPIServer
from nos_tpu.scheduler.framework import NodeInfo as JaxNodeInfo
from nos_tpu.testing import factory as jax_factory

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.controllers.chipagent import ChipAgent
from nos_tpu_torch.controllers.kubelet import admit_bound_pods
from nos_tpu_torch.kube.client import APIServer, KIND_NODE, KIND_POD
from nos_tpu_torch.kube.objects import PENDING, RUNNING
from nos_tpu_torch.partitioning import timeshare as ts
from nos_tpu_torch.partitioning.state import (
    NodePartitioning, UnitPartitioning,
)
from nos_tpu_torch.scheduler.framework import NodeInfo
from nos_tpu_torch.testing import factory
from nos_tpu_torch.topology import annotations

from test_torch_controller import node_key
from test_torch_timeshare import (
    JAX_GEN, JAX_REG, _random_partitionings, jax_config_table,
    port_resource,
)


def _units(table: dict[int, dict[int, int]]):
    """{GPU index: {GB: replicas}} as a NodePartitioning of each side."""
    port = NodePartitioning([UnitPartitioning(i, {
        f"{C.RESOURCE_TIMESHARE_PREFIX}{gb}gb": q for gb, q in t.items()})
        for i, t in table.items()])
    jax = jax_state.NodePartitioning([jax_state.UnitPartitioning(i, {
        f"{JC.RESOURCE_TIMESHARE_PREFIX}{gb}gb": q for gb, q in t.items()})
        for i, t in table.items()])
    return port, jax


class NodeSide:
    """One MPS node on each side, its agent, and writes made to both."""

    def __init__(self, name: str = "ts-0", kind: str = C.MPS_KIND) -> None:
        jax_kind = {C.MPS_KIND: "timeshare", C.HYBRID_KIND: "hybrid"}[kind]
        self.name = name
        self.japi, self.api = JaxAPIServer(), APIServer()
        self.japi.create("Node", jax_factory.make_tpu_node(
            name, generation=JAX_GEN, partitioning=jax_kind))
        self.api.create(KIND_NODE, factory.make_gpu_node(
            name, partitioning=kind))
        self.jagent = JaxChipAgent(self.japi, name)
        self.agent = ChipAgent(self.api, name)
        self.jagent.start()
        self.agent.start()
        self.compare()

    def apply(self, plan_id: str, table: dict[int, dict[int, int]]) -> None:
        port, jax = _units(table)
        ts.TimesharePartitioner(self.api).apply_partitioning(
            self.name, plan_id, port)
        jax_ts.TimesharePartitioner(self.japi).apply_partitioning(
            self.name, plan_id, jax)

    def bound_pod(self, name: str, gb: int, qty: int = 1) -> None:
        self.japi.create("Pod", jax_factory.make_timeshare_pod(
            gb, qty, name=name, node_name=self.name))
        self.api.create(KIND_POD, factory.make_timeshare_pod(
            gb, qty, name=name, node_name=self.name))

    def tick(self) -> None:
        self.jagent.tick()
        self.agent.tick()
        self.compare()

    def node(self):
        return self.api.get(KIND_NODE, self.name)

    def compare(self) -> None:
        jn, n = self.japi.get("Node", self.name), self.node()
        assert n.metadata.annotations == {
            node_key(k): v for k, v in jn.metadata.annotations.items()}
        assert n.metadata.labels.get(C.LABEL_DEVICE_PLUGIN_CONFIG) == \
            jn.metadata.labels.get(JC.LABEL_DEVICE_PLUGIN_CONFIG)
        for field in ("allocatable", "capacity"):
            assert getattr(n.status, field) == {
                port_resource(r): q
                for r, q in getattr(jn.status, field).items()}
        assert {p.metadata.name: p.status.phase
                for p in self.api.list(KIND_POD)} == {
            p.metadata.name: p.status.phase for p in self.japi.list("Pod")}


class TestPlugin:
    def test_it_applies_the_labelled_config(self):
        side = NodeSide()
        side.apply("p1", {0: {24: 3}})
        assert side.agent.plugin.tick()
        assert side.jagent.plugin.tick()
        side.compare()
        node = side.node()
        assert node.status.allocatable["nvidia.com/gpu-24gb"] == 3.0
        assert node.metadata.annotations[C.ANNOT_PLUGIN_APPLIED_CONFIG] \
            == "ts-0.p1"
        assert node.metadata.annotations[C.ANNOT_PLUGIN_GENERATION] == "1"
        # applied: a second tick changes nothing
        assert not side.agent.plugin.tick()
        assert not side.jagent.plugin.tick()

    def test_a_new_plan_replaces_every_share(self):
        side = NodeSide()
        side.apply("p1", {0: {24: 3}, 1: {10: 2}})
        side.tick()
        side.apply("p2", {0: {40: 2}})
        side.tick()
        node = side.node()
        assert {r: q for r, q in node.status.allocatable.items()
                if r.startswith(C.RESOURCE_TIMESHARE_PREFIX)} == {
            "nvidia.com/gpu-40gb": 2.0}
        assert node.metadata.annotations[C.ANNOT_PLUGIN_GENERATION] == "2"

    def test_a_missing_key_logs_and_changes_nothing(self, caplog):
        side = NodeSide()
        for api, label in ((side.api, C.LABEL_DEVICE_PLUGIN_CONFIG),
                           (side.japi, JC.LABEL_DEVICE_PLUGIN_CONFIG)):
            api.patch("Node", "ts-0", mutate=lambda n, lb=label:
                      n.metadata.labels.__setitem__(lb, "absent"))
        before = side.node()
        with caplog.at_level(logging.WARNING):
            assert not side.agent.plugin.tick()
            assert not side.jagent.plugin.tick()
        assert [r.getMessage() for r in caplog.records
                if r.name.startswith("nos_tpu_torch")] == [
            "timeshare plugin: config key ts-0.absent not found"]
        side.tick()          # and with the ConfigMap present, other keys
        side.apply("p1", {0: {24: 1}})
        for api, label in ((side.api, C.LABEL_DEVICE_PLUGIN_CONFIG),
                           (side.japi, JC.LABEL_DEVICE_PLUGIN_CONFIG)):
            api.patch("Node", "ts-0", mutate=lambda n, lb=label:
                      n.metadata.labels.__setitem__(lb, "absent"))
        side.tick()
        after = side.node()
        assert after.status == before.status
        assert C.ANNOT_PLUGIN_APPLIED_CONFIG not in after.metadata.annotations
        assert C.status_plan_annotation(C.MPS_KIND) not in \
            after.metadata.annotations

    @pytest.mark.parametrize("seed", range(3))
    def test_gpu_config_is_the_jax_chip_config(self, seed):
        rng = np.random.default_rng(700 + seed)
        side = NodeSide()
        for step in range(4):
            port, jax = _random_partitionings(rng)
            plan = f"p{step}"
            ts.TimesharePartitioner(side.api).apply_partitioning(
                "ts-0", plan, port)
            jax_ts.TimesharePartitioner(side.japi).apply_partitioning(
                "ts-0", plan, jax)
            key = ts.config_key("ts-0", plan)
            chips = side.jagent.plugin.chip_config(key)
            assert side.agent.plugin.gpu_config(key) == {
                i: t for i, t in chips.items() if t}
            side.tick()

    def test_config_render_roundtrip(self):
        """test_e2e_timeshare's render round trip, read back through the
        plugin."""
        side = NodeSide()
        side.apply("p1", {0: {8: 2}, 3: {4: 1}})
        assert side.agent.plugin.gpu_config("ts-0.p1") == {
            0: {"8gb": 2}, 3: {"4gb": 1}}
        assert jax_config_table(jax_ts.to_plugin_config(_units(
            {0: {8: 2}, 3: {4: 1}})[1])) == {"0": {"8gb": 2}, "3": {"4gb": 1}}


class TestReporter:
    def test_used_shares_go_to_gpus_in_index_order(self):
        side = NodeSide()
        side.apply("p1", {0: {24: 2, 8: 1}, 1: {24: 2}, 2: {8: 3}})
        side.tick()
        for i, gb in enumerate((24, 24, 24, 8, 8)):
            side.bound_pod(f"p{i}", gb)
        side.tick()                              # admits, then reports
        annots = side.node().metadata.annotations
        used = {k: v for k, v in annots.items() if k.endswith("-used")}
        assert used == {f"{C.ANNOT_STATUS_PREFIX}0-24gb-used": "2",
                        f"{C.ANNOT_STATUS_PREFIX}0-8gb-used": "1",
                        f"{C.ANNOT_STATUS_PREFIX}1-24gb-used": "1",
                        f"{C.ANNOT_STATUS_PREFIX}2-8gb-used": "1"}
        assert annots[C.status_plan_annotation(C.MPS_KIND)] == "p1"
        # finished pods free their shares, and the rest pack down
        # to the lowest GPU again
        for api in (side.api, side.japi):
            for name in ("p0", "p3"):
                api.patch("Pod", name, "default", mutate=lambda p:
                          setattr(p.status, "phase", "Succeeded"))
        side.tick()
        annots = side.node().metadata.annotations
        assert annots[f"{C.ANNOT_STATUS_PREFIX}0-24gb-used"] == "2"
        assert annots[f"{C.ANNOT_STATUS_PREFIX}1-24gb-free"] == "2"

    def test_nothing_is_reported_before_the_plugin_applies(self):
        side = NodeSide()
        side.tick()
        assert not any(k.startswith(C.ANNOT_STATUS_PREFIX)
                       for k in side.node().metadata.annotations)

    def test_heartbeat_counts_the_reports(self):
        side = NodeSide()
        side.tick()                      # nothing applied: no report
        side.apply("p1", {0: {24: 1}})
        side.tick()
        side.tick()
        assert side.node().metadata.annotations[
            C.heartbeat_annotation(C.MPS_KIND)] == "2"

    def test_hybrid_node_keeps_the_mig_family(self):
        side = NodeSide(kind=C.HYBRID_KIND)
        mig = f"{C.ANNOT_STATUS_PREFIX}0-1g.10gb-free"
        side.api.patch(KIND_NODE, "ts-0", mutate=lambda n:
                       n.metadata.annotations.__setitem__(mig, "1"))
        side.apply("p1", {4: {24: 1}})
        side.agent.tick()
        assert side.node().metadata.annotations[mig] == "1"
        assert side.node().metadata.annotations[
            f"{C.ANNOT_STATUS_PREFIX}4-24gb-free"] == "1"


class TestAgent:
    @pytest.mark.parametrize("kind,starts", [
        (C.MPS_KIND, True), (C.HYBRID_KIND, True), (C.MIG_KIND, False),
        ("", False)])
    def test_it_refuses_a_node_not_of_the_mps_family(self, kind, starts):
        jax_kind = {C.MPS_KIND: "timeshare", C.HYBRID_KIND: "hybrid",
                    C.MIG_KIND: "slice", "": ""}[kind]
        results = []
        for api, make, agent in (
                (APIServer(), lambda: factory.make_gpu_node(
                    "n", partitioning=kind), ChipAgent),
                (JaxAPIServer(), lambda: jax_factory.make_tpu_node(
                    "n", generation=JAX_GEN, partitioning=jax_kind),
                 JaxChipAgent)):
            api.create("Node", make())
            try:
                agent(api, "n").start()
                results.append(True)
            except RuntimeError:
                results.append(False)
        assert results == [starts, starts]

    def test_a_tick_admits_before_it_reports(self):
        side = NodeSide()
        side.apply("p1", {0: {24: 3}})
        side.tick()
        side.bound_pod("a", 24)
        side.tick()
        assert side.api.get(KIND_POD, "a", "default").status.phase == RUNNING
        assert side.node().metadata.annotations[
            f"{C.ANNOT_STATUS_PREFIX}0-24gb-used"] == "1"


class TestAdmission:
    def test_admits_bound_pending_pods_as_jax_does(self):
        api, japi = APIServer(), JaxAPIServer()
        for a, make_node in ((api, lambda: factory.make_gpu_node("n")),
                             (japi, lambda: jax_factory.make_tpu_node(
                                 "n", generation=JAX_GEN))):
            a.create("Node", make_node())
        for name, node in (("a", "n"), ("b", ""), ("c", "other")):
            api.create(KIND_POD, factory.make_timeshare_pod(
                24, name=name, node_name=node))
            japi.create("Pod", jax_factory.make_timeshare_pod(
                24, name=name, node_name=node))
        api.create(KIND_POD, factory.make_pod(
            name="mig", node_name="n",
            resources={"nvidia.com/mig-1g.10gb": 1}))
        japi.create("Pod", jax_factory.make_slice_pod(
            "1x1", 1, name="mig", node_name="n"))
        # the port always leaves MIG pods to the MIG node's admission,
        # as the JAX MPS agent's skip_slice_pods=True does
        assert admit_bound_pods(api, "n") == \
            jax_admit(japi, "n", skip_slice_pods=True) == 1
        assert {p.metadata.name: p.status.phase for p in api.list(KIND_POD)} \
            == {p.metadata.name: p.status.phase for p in japi.list("Pod")}
        assert api.get(KIND_POD, "mig", "default").status.phase == PENDING
        assert admit_bound_pods(api, "n") == \
            jax_admit(japi, "n", skip_slice_pods=True) == 0

    def test_declines_any_other_substrate(self):
        class Other:
            def list(self, *a, **kw):
                raise AssertionError("read")
        assert admit_bound_pods(Other(), "n") == 0


# ---------------------------------------------------------------------------
# The rest of tests/test_e2e_timeshare.py's cases
# ---------------------------------------------------------------------------


class TestE2ECases:
    def test_timeshare_node_respects_used_profiles(self):
        geometry = {"used": {"8gb": 1}, "free": {"8gb": 1}}
        node = factory.make_gpu_node("ts-1", status_geometry={0: geometry})
        jnode = jax_factory.make_tpu_node(
            "ts-1", generation=JAX_GEN, partitioning="timeshare",
            status_geometry=geometry)
        tn = ts.TimeshareNode(node, NodeInfo(node=node))
        jtn = jax_ts.TimeshareNode(jnode, JaxNodeInfo(node=jnode),
                                   registry=JAX_REG)
        assert tn.update_geometry_for({"16gb": 8}) == \
            jtn.update_geometry_for({"16gb": 8})
        assert tn.geometries() == jtn.geometries()
        assert sum(u.used.get(8, 0) for u in tn.units) == 1

    def test_hybrid_status_annotations_coexist(self):
        annots = {f"{C.ANNOT_STATUS_PREFIX}0-1g.10gb-free": "1",
                  f"{C.ANNOT_STATUS_PREFIX}1-8gb-used": "2"}
        jannots = {f"{JC.ANNOT_STATUS_PREFIX}0-2x2-free": "1",
                   f"{JC.ANNOT_STATUS_PREFIX}1-8gb-used": "2"}
        for family, jfamily in ((C.MPS_KIND, "timeshare"),
                                (C.MIG_KIND, "slice")):
            a, ja = dict(annots), dict(jannots)
            annotations.strip_status_annotations(a, family=family)
            jax_annotations.strip_status_annotations(ja, family=jfamily)
            assert [k.rsplit("-", 2)[0][-1] for k in a] == \
                [k.rsplit("-", 2)[0][-1] for k in ja]
            kept = "1g.10gb" if family == C.MPS_KIND else "8gb"
            assert list(a) == [k for k in annots if kept in k]
