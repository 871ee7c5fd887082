"""The port's gang path (nos_tpu_torch/scheduler/{gang,scheduler}.py,
api/podgroup.py, topology/shape.py, cmd/assembly.py's TopologyFilter)
against the JAX package's, on the same objects built from plain specs
and numpy seeds.  No floats are computed on either side: every
comparison is exact.

JAX's side is its timeshare stand-in as ``tests/test_torch_quota.py``
builds it (``QuotaTwin``): ``nos.tpu/pod-id`` stands for the port's
``nos.nebuly.com/nvlink-domain``, ``nos.tpu/chip-count`` for
``nvidia.com/gpu.count``, ``google.com/tpu`` chips for whole
``nvidia.com/gpu``s, ``nos.tpu/pod-group`` for
``nos.nebuly.com/pod-group``.  The JAX scheduler runs with its default
knobs, on its native path and again on its Python path
(``set_jax_python_path``).  After every cycle (and after the kubelet and
the reconcilers) the twin compares every pod's node, phase, nomination,
conditions and labels, each PodGroup's status, the quotas' status and
the ledger, the order of every pod event (binds, marks, deletions), and
the journal records, gang admissions and rejections among them.

- ``TopologyFilter`` and ``requested_mesh_chips`` against JAX's, an
  unparseable mesh included;
- counterparts of ``tests/test_gang.py``'s TestGangAdmission,
  TestTopologyPinning, TestGangRegressions, TestGangPreemption and
  TestQuotaHeadOfLine, in whole GPUs at JAX's 16 GB a chip (and shares
  at 80 GB a GPU for the head-of-line stories), each run to the same
  writes;
- random clusters mixing gangs, singles, quotas and a disruption budget
  over two or three NVLink domains;
- chip_smoke's gang fleet run by both packages to the same summary,
  ``GANG_FLEET_DIGEST``.
"""

from __future__ import annotations

import numpy as np
import pytest

import nos_tpu.api.constants as JC
from nos_tpu.api.podgroup import PodGroup as JaxPodGroup
from nos_tpu.api.podgroup import PodGroupSpec as JaxPodGroupSpec
from nos_tpu.kube.client import APIServer as JaxAPIServer
from nos_tpu.kube.objects import ObjectMeta as JaxMeta
from nos_tpu.scheduler import gang as jax_gang
from nos_tpu.scheduler.framework import (
    CycleState as JaxCycleState, NodeInfo as JaxNodeInfo,
    SharedLister as JaxSharedLister, Status as JaxStatus,
)
from nos_tpu.testing import factory as jax_factory

import chip_smoke
from nos_tpu_torch.api import constants as C
from nos_tpu_torch.kube.client import (
    APIServer, KIND_NODE, KIND_POD, KIND_POD_GROUP,
)
from nos_tpu_torch.scheduler import gang
from nos_tpu_torch.scheduler.framework import (
    CycleState, NodeInfo, SharedLister, Status,
)
from nos_tpu_torch.testing import factory, fleet
from nos_tpu_torch.topology.shape import Shape

from test_torch_planner import build_jax_shim
from test_torch_quota import QuotaTwin, assert_same_waste, cluster_spec
from test_torch_scheduler import _jax_quota_fleet

PATHS = pytest.mark.parametrize("native", [True, False],
                                ids=["jax-native", "jax-python"])


def jax_message(msg: str) -> str:
    """A JAX TopologyFilter message in the port's words."""
    return msg.replace("TPU pod", "NVLink domain").replace(
        " chips <", " GPUs <")


# ---------------------------------------------------------------------------
# TopologyFilter and the mesh
# ---------------------------------------------------------------------------

MESHES = ["", "4x8", "2x2x4", "8x16", "1", "0x2", "2xx2", "banana"]


class TestMesh:
    @pytest.mark.parametrize("mesh", MESHES)
    def test_requested_mesh_chips_as_jax(self, mesh):
        pg = factory.make_pod_group("g", 2, mesh)
        jpg = JaxPodGroup(metadata=JaxMeta(name="g", namespace="default"),
                          spec=JaxPodGroupSpec(min_member=2, mesh=mesh))
        assert gang.requested_mesh_chips(pg) == \
            jax_gang.requested_mesh_chips(jpg)
        assert gang.requested_mesh_chips(None) is None

    @pytest.mark.parametrize("bad", ["0x2", "2xx2", "", "x", "-1x4"])
    def test_shape_parse_errors_as_jax(self, bad):
        from nos_tpu.topology.shape import Shape as JaxShape

        with pytest.raises(ValueError):
            JaxShape.parse(bad)
        with pytest.raises(ValueError):
            Shape.parse(bad)

    @pytest.mark.parametrize("good", ["4x8", "2x2x4", "16", "8X16"])
    def test_shape_chips_as_jax(self, good):
        from nos_tpu.topology.shape import Shape as JaxShape

        assert Shape.parse(good).chips == JaxShape.parse(good).chips


# (name, domain, GPUs) of the filter's nodes: two labelled domains of 16
# and 24 GPUs and two unlabelled nodes
FILTER_NODES = (("n0", "nvl-0", 8), ("n1", "nvl-0", 8), ("n2", "nvl-1", 8),
                ("n3", "nvl-1", 8), ("n4", "nvl-1", 8), ("n5", "", 8),
                ("n6", "", 4))


def _filter_sides(mesh: str):
    """Both packages' TopologyFilter on FILTER_NODES, with a PodGroup
    "g" of ``mesh`` and a member of it and a single."""
    out = []
    for jax in (True, False):
        api = JaxAPIServer() if jax else APIServer()
        infos = []
        for name, domain, gpus in FILTER_NODES:
            if jax:
                labels = {JC.LABEL_CHIP_COUNT: str(gpus)}
                if domain:
                    labels[JC.LABEL_POD_ID] = domain
                node = jax_factory.make_node(
                    name, labels=labels,
                    allocatable={JC.RESOURCE_TPU: float(gpus)})
                infos.append(JaxNodeInfo(node=node))
            else:
                node = factory.make_gpu_node(name, gpus=gpus, domain=domain)
                infos.append(NodeInfo(node=node))
        if jax:
            api.create("PodGroup", JaxPodGroup(
                metadata=JaxMeta(name="g", namespace="default"),
                spec=JaxPodGroupSpec(min_member=2, mesh=mesh)))
            member = jax_factory.make_pod(
                name="m", labels={JC.LABEL_POD_GROUP: "g"},
                resources={JC.RESOURCE_TPU: 1.0})
            single = jax_factory.make_pod(name="s")
            out.append((jax_gang.TopologyFilter(api), infos, member, single,
                        JaxSharedLister(infos), JaxCycleState,
                        jax_gang.GANG_POD_ID_KEY))
        else:
            api.create(KIND_POD_GROUP, factory.make_pod_group("g", 2, mesh))
            member = factory.make_pod(name="m",
                                      labels={C.LABEL_POD_GROUP: "g"},
                                      resources={C.RESOURCE_GPU: 1.0})
            single = factory.make_pod(name="s")
            out.append((gang.TopologyFilter(api), infos, member, single,
                        SharedLister(infos), CycleState,
                        gang.GANG_DOMAIN_KEY))
    return out


def _verdicts(side, pin) -> list:
    plugin, infos, member, single, lister, state_cls, key = side
    rows = []
    for pod in (member, single):
        state = state_cls() if pin is False else state_cls({key: pin})
        st = plugin.pre_filter(state, pod, lister)
        rows.append(("pre", st.is_success))
        for ni in infos:
            st = plugin.filter(state, pod, ni)
            rows.append((ni.name, st.is_success, st.message))
    return rows


class TestTopologyFilter:
    @pytest.mark.parametrize("mesh", ["", "2x4", "4x4", "3x8", "4x8",
                                      "2xx2"])
    @pytest.mark.parametrize("pin", [False, "nvl-0", "nvl-1", "", "nvl-9"],
                             ids=["unpinned", "nvl-0", "nvl-1",
                                  "unlabelled", "absent"])
    def test_verdicts_as_jax(self, mesh, pin):
        jside, side = _filter_sides(mesh)
        want = [(r[0], r[1], jax_message(r[2])) if len(r) == 3 else r
                for r in _verdicts(jside, pin)]
        assert _verdicts(side, pin) == want
        # a single is never rejected
        assert all(r[1] for r in _verdicts(side, pin)[len(FILTER_NODES) + 1:])

    def test_the_domain_totals_are_read_once(self):
        plugin, infos, member, _, lister, _, _ = _filter_sides("4x8")[1]
        state = CycleState()
        plugin.pre_filter(state, member, lister)
        totals = dict(state["topo-domain-gpu-counts"])
        assert totals == {"nvl-0": 16, "nvl-1": 24}
        assert state["topo-mesh-gpus"] == 32
        # a second PreFilter on a smaller view keeps the stashed totals
        plugin.pre_filter(state, member, SharedLister(infos[:1]))
        assert state["topo-domain-gpu-counts"] == totals
        # unlabelled nodes are never held to the mesh
        assert plugin.filter(state, member, infos[5]).is_success
        assert not plugin.filter(state, member, infos[0]).is_success


# ---------------------------------------------------------------------------
# The JAX package's gang stories, both sides
# ---------------------------------------------------------------------------


def _node(name: str, domain: str = "", gpus: int = 8) -> dict:
    return {"name": name, "domain": domain, "gpus": gpus}


def _pod(name: str, ns: str = "default", whole: int = 8, gang_: str = "",
         priority: int = 0, created: float = 0.0, node: str = "",
         gb: int = 0, qty: int = 1, tier: str = "") -> dict:
    return {"name": name, "namespace": ns, "whole": 0 if gb else whole,
            "gb": gb, "qty": qty, "gang": gang_, "priority": priority,
            "created": created, "node": node, "tier": tier, "app": "job"}


def _group(name: str, min_member: int, mesh: str = "",
           ns: str = "default") -> dict:
    return {"name": name, "namespace": ns, "min": min_member, "mesh": mesh}


def _eq(ns: str, lo: float, hi: float = 0) -> dict:
    return {"kind": "eq", "name": f"eq-{ns}", "namespace": ns,
            "namespaces": [ns], "min": lo, "max": hi}


def _cluster(domains: dict[str, int], gpus: int = 8) -> list[dict]:
    """tests/test_gang.py's make_cluster: ``domains`` {domain: nodes}."""
    nodes, i = [], 0
    for domain, n in domains.items():
        for _ in range(n):
            nodes.append(_node(f"host-{i}", domain, gpus))
            i += 1
    return nodes


def _twin(monkeypatch, native: bool, nodes, quotas=(), groups=(),
          bound=(), gb_per_gpu: int = 16, **sched_kw) -> QuotaTwin:
    if native:
        assert build_jax_shim(monkeypatch), \
            "the JAX package's shim did not build"
    spec = {"nodes": list(nodes), "quotas": list(quotas),
            "groups": list(groups), "bound": list(bound),
            "waves": [[], []]}
    return QuotaTwin(monkeypatch, spec, jax_native=native,
                     gb_per_gpu=gb_per_gpu, **sched_kw)


def _node_of(twin, name: str, ns: str = "default") -> str:
    return twin.side.api.get(KIND_POD, name, ns).spec.node_name


def _group_status(twin, name: str, ns: str = "default") -> tuple:
    g = twin.side.api.get(KIND_POD_GROUP, name, ns)
    return g.status.phase, g.status.scheduled


def _domain_of(twin, node: str) -> str:
    return twin.side.api.get(KIND_NODE, node).metadata.labels.get(
        C.LABEL_NVLINK_DOMAIN, "")


def _gang_rows(twin, category: str) -> list:
    return [r for r in twin.journals()[1] if r[0] == category]


@PATHS
class TestGangAdmission:
    def test_a_gang_binds_atomically(self, monkeypatch, native):
        twin = _twin(monkeypatch, native, _cluster({"nvl-a": 4}),
                     groups=[_group("train", 4)])
        twin.submit([_pod(f"w-{i}", gang_="train", created=float(i + 1))
                     for i in range(4)])
        assert twin.step() == 4
        assert len({_node_of(twin, f"w-{i}") for i in range(4)}) == 4
        assert _group_status(twin, "train") == ("Scheduled", 4)
        (row,) = _gang_rows(twin, "gang-admitted")
        assert row[1] == "default/train" and row[2]["bound"] == 4 \
            and row[2]["members_total"] == 4

    def test_it_waits_for_min_member(self, monkeypatch, native):
        twin = _twin(monkeypatch, native, _cluster({"nvl-a": 4}),
                     groups=[_group("train", 4)])
        twin.submit([_pod(f"w-{i}", gang_="train", created=float(i + 1))
                     for i in range(3)])
        assert twin.step() == 0
        conds = twin.side.api.get(KIND_POD, "w-0",
                                  "default").status.conditions
        assert conds[0].message == "pod group waiting for members (3/4)"
        twin.submit([_pod("w-3", gang_="train", created=4.0)])
        assert twin.step() == 4

    def test_no_partial_binding_when_the_gang_cannot_fit(self, monkeypatch,
                                                         native):
        twin = _twin(monkeypatch, native, _cluster({"nvl-a": 2}),
                     groups=[_group("train", 3)])
        twin.submit([_pod(f"w-{i}", gang_="train", created=float(i + 1))
                     for i in range(3)])
        assert twin.step() == 0
        assert all(not _node_of(twin, f"w-{i}") for i in range(3))
        (row,) = _gang_rows(twin, "gang-rejected")
        assert row[2]["message"] == "gang does not fit as a whole"

    def test_a_reserve_failure_rejects_the_whole_gang(self, monkeypatch,
                                                      native):
        twin = _twin(monkeypatch, native, _cluster({"nvl-a": 4}),
                     groups=[_group("train", 4)])
        for side, status in ((twin.jside, JaxStatus), (twin.side, Status)):
            monkeypatch.setattr(
                side.sched._framework, "run_reserve_plugins",
                lambda state, pod, node, status=status:
                status.unschedulable("reserve ledger full"))
        twin.submit([_pod(f"w-{i}", gang_="train", created=float(i + 1))
                     for i in range(4)])
        assert twin.step() == 0
        (row,) = _gang_rows(twin, "gang-rejected")
        assert "reserve failed" in row[2]["message"]
        assert not _gang_rows(twin, "gang-admitted")

    def test_schedule_gang_outside_a_cycle(self, monkeypatch, native):
        """The entry point called directly builds its own view and
        decides as JAX's."""
        twin = _twin(monkeypatch, native, _cluster({"nvl-a": 2}),
                     groups=[_group("train", 2)])
        twin.submit([_pod(f"w-{i}", gang_="train", created=float(i + 1))
                     for i in range(2)])
        got = twin.both(lambda s: s.sched.schedule_gang(
            [s.api.get("Pod", f"w-{i}", "default") for i in range(2)]))
        assert got == (2, 2)
        twin.compare()

    def test_schedule_one_places_a_member_alone(self, monkeypatch, native):
        """A member given to the single-pod entry point is placed alone,
        its verdicts unmemoised and its domain's size still held to the
        mesh, as JAX does."""
        twin = _twin(monkeypatch, native,
                     _cluster({"nvl-a": 1, "nvl-b": 4}),
                     groups=[_group("train", 2, mesh="2x8")])
        twin.submit([_pod("w-0", gang_="train", created=1.0)])
        got = twin.both(lambda s: s.sched.schedule_one(
            s.api.get("Pod", "w-0", "default")))
        assert got[0] == got[1] and _domain_of(twin, got[1]) == "nvl-b"
        twin.compare()

    def test_mixed_gang_and_singles(self, monkeypatch, native):
        twin = _twin(monkeypatch, native, _cluster({"nvl-a": 3}),
                     groups=[_group("train", 2)])
        twin.submit([_pod("w-0", gang_="train", created=1.0),
                     _pod("w-1", gang_="train", created=2.0),
                     _pod("single", created=3.0)])
        assert twin.step() == 3


@PATHS
class TestTopologyPinning:
    def test_the_gang_lands_in_one_domain(self, monkeypatch, native):
        # nvl-a has free nodes but only nvl-b holds the whole gang
        twin = _twin(monkeypatch, native,
                     _cluster({"nvl-a": 2, "nvl-b": 4}),
                     groups=[_group("train", 3)])
        twin.submit([_pod(f"w-{i}", gang_="train", created=float(i + 1))
                     for i in range(3)])
        assert twin.step() == 3
        assert {_domain_of(twin, _node_of(twin, f"w-{i}"))
                for i in range(3)} == {"nvl-b"}

    def test_the_best_fit_domain_wins(self, monkeypatch, native):
        """Both domains hold the gang; the one with less free whole-GPU
        capacity takes it, keeping the larger whole."""
        twin = _twin(monkeypatch, native,
                     _cluster({"nvl-a": 4, "nvl-b": 2}),
                     groups=[_group("train", 2)])
        twin.submit([_pod(f"w-{i}", gang_="train", created=float(i + 1))
                     for i in range(2)])
        assert twin.step() == 2
        assert {_domain_of(twin, _node_of(twin, f"w-{i}"))
                for i in range(2)} == {"nvl-b"}

    def test_a_mesh_larger_than_the_domain_is_refused(self, monkeypatch,
                                                      native):
        # mesh 4x8 = 32 GPUs; nvl-a has 2 nodes x 8 = 16
        twin = _twin(monkeypatch, native, _cluster({"nvl-a": 2}),
                     groups=[_group("train", 2, mesh="4x8")])
        twin.submit([_pod(f"w-{i}", gang_="train", created=float(i + 1))
                     for i in range(2)])
        assert twin.step() == 0

    def test_the_mesh_fits_the_domain(self, monkeypatch, native):
        twin = _twin(monkeypatch, native, _cluster({"nvl-b": 4}),
                     groups=[_group("train", 4, mesh="4x8")])
        twin.submit([_pod(f"w-{i}", gang_="train", created=float(i + 1))
                     for i in range(4)])
        assert twin.step() == 4

    def test_the_mesh_pins_to_the_domain_large_enough(self, monkeypatch,
                                                      native):
        """Best fit would take nvl-a (16 GPUs); a 3x8 mesh keeps the gang
        out of it, into nvl-b (32 GPUs)."""
        twin = _twin(monkeypatch, native,
                     _cluster({"nvl-a": 2, "nvl-b": 4}),
                     groups=[_group("train", 2, mesh="3x8")])
        twin.submit([_pod(f"w-{i}", gang_="train", created=float(i + 1))
                     for i in range(2)])
        assert twin.step() == 2
        assert {_domain_of(twin, _node_of(twin, f"w-{i}"))
                for i in range(2)} == {"nvl-b"}

    def test_an_unparseable_mesh_is_no_requirement(self, monkeypatch,
                                                   native):
        twin = _twin(monkeypatch, native, _cluster({"nvl-a": 2}),
                     groups=[_group("train", 2, mesh="2xx2")])
        twin.submit([_pod(f"w-{i}", gang_="train", created=float(i + 1))
                     for i in range(2)])
        assert twin.step() == 2


@PATHS
class TestGangRegressions:
    def test_a_gang_cannot_pass_its_quota_max_together(self, monkeypatch,
                                                       native):
        """Each member alone fits under max, the gang does not: nothing
        binds (members see their mates' usage)."""
        twin = _twin(monkeypatch, native, _cluster({"nvl-a": 2}),
                     quotas=[_eq("ns-a", 256, 128)],
                     groups=[_group("big", 2, ns="ns-a")])
        twin.submit([_pod(f"w-{i}", "ns-a", gang_="big",
                          created=float(i + 1)) for i in range(2)])
        assert twin.step() == 0
        assert all(not _node_of(twin, f"w-{i}", "ns-a") for i in range(2))

    def test_a_gang_never_spans_labelled_and_unlabelled_nodes(
            self, monkeypatch, native):
        nodes = _cluster({"nvl-a": 2, "nvl-b": 2}) + [_node("bare-0")]
        twin = _twin(monkeypatch, native, nodes,
                     groups=[_group("train", 3)])
        twin.submit([_pod(f"w-{i}", gang_="train", created=float(i + 1))
                     for i in range(3)])
        # no single domain holds three whole nodes
        assert twin.step() == 0

    def test_the_unlabelled_nodes_are_a_domain(self, monkeypatch, native):
        nodes = _cluster({"nvl-a": 1}) + [_node("bare-0"), _node("bare-1")]
        twin = _twin(monkeypatch, native, nodes,
                     groups=[_group("train", 2)])
        twin.submit([_pod(f"w-{i}", gang_="train", created=float(i + 1))
                     for i in range(2)])
        assert twin.step() == 2
        assert {_node_of(twin, f"w-{i}") for i in range(2)} == \
            {"bare-0", "bare-1"}

    def test_a_recreated_member_of_a_running_gang_schedules(
            self, monkeypatch, native):
        twin = _twin(monkeypatch, native, _cluster({"nvl-a": 4}),
                     groups=[_group("train", 4)])
        twin.submit([_pod(f"w-{i}", gang_="train", created=float(i + 1))
                     for i in range(4)])
        assert twin.step() == 4
        twin.both(lambda s: s.api.delete(KIND_POD, "w-3", "default"))
        twin.submit([_pod("w-3b", gang_="train", created=5.0)])
        assert twin.step() == 1
        assert _node_of(twin, "w-3b")
        assert _group_status(twin, "train") == ("Scheduled", 4)


def _preemption_twin(monkeypatch, native, a_min, b_min, b_chips=8):
    """tests/test_gang.py's preemption cluster: two 8-GPU nodes in one
    domain, ns-a and ns-b quotas, and ns-b's two-member gang filling
    (or, at ``b_chips`` 6, nearly filling) both nodes, Running."""
    twin = _twin(monkeypatch, native, _cluster({"nvl-a": 2}),
                 quotas=[_eq("ns-a", a_min), _eq("ns-b", b_min)],
                 groups=[_group("borrower", 2, ns="ns-b")])
    twin.submit([_pod(f"b-{i}", "ns-b", whole=b_chips, gang_="borrower",
                      created=float(i + 1)) for i in range(2)])
    assert twin.step() == 2
    assert _group_status(twin, "borrower", "ns-b") == ("Scheduled", 2)
    return twin


@PATHS
class TestGangPreemption:
    def test_a_single_preemptor_evicts_the_whole_gang(self, monkeypatch,
                                                      native):
        twin = _preemption_twin(monkeypatch, native, 128, 128)
        twin.submit([_pod("a-0", "ns-a", created=10.0)])
        twin.step()
        assert twin.side.api.list(KIND_POD, namespace="ns-b") == []
        # the satellite: the victim gang's PodGroup is reset on both sides
        assert _group_status(twin, "borrower", "ns-b") == ("Pending", 0)
        twin.step()
        assert _node_of(twin, "a-0", "ns-a")

    def test_the_gang_s_whole_demand_preempts(self, monkeypatch, native):
        """Each claimant member fits beside the victims (2 free GPUs a
        node), the gang does not: its aggregate claim must drive the
        eviction."""
        twin = _preemption_twin(monkeypatch, native, 256, 96, b_chips=6)
        twin.both(lambda s: s.create_pod_group(
            _group("claimant", 8, ns="ns-a")))
        twin.submit([_pod(f"a-{i}", "ns-a", whole=2, gang_="claimant",
                          created=float(10 + i)) for i in range(8)])
        twin.step()
        assert twin.side.api.list(KIND_POD, namespace="ns-b") == []
        (row,) = _gang_rows(twin, "gang-rejected")
        assert row[2]["message"] == \
            "gang does not fit as a whole (evicted over-quota victims, " \
            "retrying)"
        assert twin.step() == 8

    def test_an_infeasible_gang_evicts_nothing(self, monkeypatch, native):
        twin = _preemption_twin(monkeypatch, native, 384, 128)
        twin.both(lambda s: s.create_pod_group(
            _group("claimant", 3, ns="ns-a")))
        twin.submit([_pod(f"a-{i}", "ns-a", gang_="claimant",
                          created=float(10 + i)) for i in range(3)])
        for _ in range(3):
            twin.step()
            assert len(twin.side.api.list(KIND_POD, namespace="ns-b")) == 2

    def test_a_gang_preemptor_evicts_an_over_quota_gang(self, monkeypatch,
                                                        native):
        twin = _preemption_twin(monkeypatch, native, 256, 128)
        twin.both(lambda s: s.create_pod_group(
            _group("claimant", 2, ns="ns-a")))
        twin.submit([_pod(f"a-{i}", "ns-a", gang_="claimant",
                          created=float(10 + i)) for i in range(2)])
        twin.step()
        assert twin.side.api.list(KIND_POD, namespace="ns-b") == []
        assert _group_status(twin, "borrower", "ns-b") == ("Pending", 0)
        assert twin.step() == 2
        assert _group_status(twin, "claimant", "ns-a") == ("Scheduled", 2)

    def test_a_spent_budget_evicts_nothing(self, monkeypatch, native):
        """With no preemption budget the claimant gang is rejected and
        nothing is evicted, on both sides."""
        twin = _twin(monkeypatch, native, _cluster({"nvl-a": 2}),
                     quotas=[_eq("ns-a", 256), _eq("ns-b", 128)],
                     groups=[_group("borrower", 2, ns="ns-b"),
                             _group("claimant", 2, ns="ns-a")],
                     preempt_budget_per_cycle=0)
        twin.submit([_pod(f"b-{i}", "ns-b", gang_="borrower",
                          created=float(i + 1)) for i in range(2)])
        assert twin.step() == 2
        twin.submit([_pod(f"a-{i}", "ns-a", gang_="claimant",
                          created=float(10 + i)) for i in range(2)])
        twin.step()
        assert len(twin.side.api.list(KIND_POD, namespace="ns-b")) == 2
        (row,) = _gang_rows(twin, "gang-rejected")
        assert row[2]["message"] == "gang does not fit as a whole"


def _share_node(name: str, domain: str, gb: int, qty: int) -> dict:
    return {"name": name, "domain": domain, "shares": {gb: qty}}


@PATHS
class TestQuotaHeadOfLine:
    """tests/test_gang.py's head-of-line stories in 64 GB shares (JAX's
    2x2 slice at 16 GB a chip), and the same with gang claimants, whose
    claim is judged on the whole gang's request."""

    def _twin(self, monkeypatch, native, hosts, quotas, groups=()):
        return _twin(monkeypatch, native,
                     [_share_node(f"host-{h}", "nvl-a", 64, 2)
                      for h in range(hosts)],
                     quotas=quotas, groups=groups, gb_per_gpu=80,
                     bound=[_pod("occ", "team", gb=64, node="host-0",
                                 created=0.5)])

    def test_a_lower_priority_single_defers_behind_the_claim(
            self, monkeypatch, native):
        twin = self._twin(monkeypatch, native, 2,
                          [_eq("team", 32, 128), _eq("lender", 96)])
        twin.submit([_pod("big", "team", gb=64, qty=2, priority=10,
                          created=1.0),
                     _pod("small", "team", gb=64, created=2.0)])
        twin.step()
        small = twin.side.api.get(KIND_POD, "small", "team")
        assert not small.spec.node_name
        assert small.metadata.labels[C.LABEL_UNSCHEDULABLE_CLASS] == \
            "quota-hol"
        twin.submit([_pod("other", "free-ns", gb=64, created=3.0)])
        twin.step()
        assert _node_of(twin, "other", "free-ns")

    def test_a_gang_claimant_defers_the_single(self, monkeypatch, native):
        twin = self._twin(monkeypatch, native, 2,
                          [_eq("team", 32, 128), _eq("lender", 96)],
                          groups=[_group("big", 2, ns="team")])
        twin.submit([_pod(f"big-{i}", "team", gb=64, gang_="big",
                          priority=10, created=1.0 + i) for i in range(2)]
                    + [_pod("small", "team", gb=64, created=3.0)])
        twin.step()
        small = twin.side.api.get(KIND_POD, "small", "team")
        assert small.metadata.labels[C.LABEL_UNSCHEDULABLE_CLASS] == \
            "quota-hol"
        assert [r[1] for r in _gang_rows(twin, "gang-rejected")] == \
            ["team/big"]

    def test_an_unsatisfiable_claimant_blocks_nothing(self, monkeypatch,
                                                      native):
        twin = self._twin(monkeypatch, native, 1, [_eq("team", 64, 64)])
        twin.both(lambda s: s.api.delete(KIND_POD, "occ", "team"))
        twin.submit([_pod("impossible", "team", gb=64, qty=2, priority=10,
                          created=1.0),
                     _pod("small", "team", gb=64, created=2.0)])
        twin.step()
        assert not _node_of(twin, "impossible", "team")
        assert _node_of(twin, "small", "team")

    def test_a_gang_unsatisfiable_only_whole_blocks_nothing(
            self, monkeypatch, native):
        """Each member alone passes the namespace's max, the gang does
        not: judged whole, it claims nothing and the single binds."""
        twin = self._twin(monkeypatch, native, 1, [_eq("team", 64, 64)],
                          groups=[_group("big", 2, ns="team")])
        twin.both(lambda s: s.api.delete(KIND_POD, "occ", "team"))
        twin.submit([_pod(f"big-{i}", "team", gb=64, gang_="big",
                          priority=10, created=1.0 + i) for i in range(2)]
                    + [_pod("small", "team", gb=64, created=3.0)])
        twin.step()
        assert not _node_of(twin, "big-0", "team")
        assert _node_of(twin, "small", "team")

    def test_equal_priority_is_not_deferred(self, monkeypatch, native):
        twin = self._twin(monkeypatch, native, 1, [_eq("team", 64, 64)])
        twin.both(lambda s: s.api.delete(KIND_POD, "occ", "team"))
        twin.submit([_pod("big", "team", gb=64, qty=2, created=1.0),
                     _pod("peer", "team", gb=64, created=2.0)])
        twin.step()
        assert _node_of(twin, "peer", "team")


# ---------------------------------------------------------------------------
# Random clusters: gangs, singles, quotas and a budget over the domains
# ---------------------------------------------------------------------------


def gang_cluster_spec(seed: int) -> dict:
    """``cluster_spec(seed)``'s nodes, quotas, Running pods, waves and
    budget, with: every node in one of two or three NVLink domains (one
    of them maybe the unlabelled ""), advertising 2-8 whole GPUs; one or
    two more nodes of whole GPUs only; some Running pods of a namespace
    made a Running gang; two to four pending gangs of 2-3 members
    (shares or whole GPUs, one priority and tier each) spread over the
    waves, each PodGroup's min_member its size, or one more (it waits
    until a late member arrives) or one less, and its mesh none, a size
    some domains lack, or unparseable."""
    spec = cluster_spec(seed)
    rng = np.random.default_rng(1_000 + seed)
    domains = ["nvl-0", "nvl-1", ""][:int(rng.integers(2, 4))]
    for _ in range(int(rng.integers(1, 3))):
        spec["nodes"].append({"name": f"node-{len(spec['nodes'])}",
                              "shares": {}})
    for n in spec["nodes"]:
        n["domain"] = str(rng.choice(domains))
        n["gpus"] = int(rng.integers(2, 9))
    namespaces = ["ns-a", "ns-b", "ns-c", "ns-d", "free"]
    groups, late = [], []
    by_ns: dict[str, list[dict]] = {}
    for p in spec["bound"]:
        by_ns.setdefault(p["namespace"], []).append(p)
    for ns, pods in sorted(by_ns.items()):
        if len(pods) >= 2 and rng.random() < 0.6:
            members = pods[:int(rng.integers(2, len(pods) + 1))]
            for p in members:
                p["gang"] = f"run-{ns}"
            groups.append({"name": f"run-{ns}", "namespace": ns,
                           "min": len(members), "mesh": ""})
    times = iter(10_000 + rng.permutation(1_000))
    for k in range(int(rng.integers(2, 5))):
        ns = str(rng.choice(namespaces))
        size = int(rng.integers(2, 4))
        whole = int(rng.integers(1, 5)) if rng.random() < 0.5 else 0
        gb = int(rng.choice([8, 16, 24, 40]))
        priority, tier = int(rng.integers(0, 4)), str(
            rng.choice(["", "batch"]))
        name = f"g{k}"
        members = [{"name": f"{name}-{i}", "namespace": ns, "gb": gb,
                    "qty": 1, "whole": whole, "gang": name,
                    "priority": priority, "tier": tier, "app": "job",
                    "created": float(next(times)), "node": "",
                    "never": False} for i in range(size)]
        roll = rng.random()
        need = size + 1 if roll < 0.2 else size - 1 if roll < 0.35 else size
        mesh = str(rng.choice(["", "", "2x4", "4x8", "2xx2"]))
        groups.append({"name": name, "namespace": ns, "min": need,
                       "mesh": mesh})
        spec["waves"][int(rng.integers(0, 2))].extend(members)
        if need > size:
            late.append(dict(members[-1], name=f"{name}-late",
                             created=float(next(times))))
    spec["groups"] = groups
    spec["late"] = late
    return spec


class TestRandomClusters:
    @pytest.mark.parametrize("seed", range(12))
    @PATHS
    def test_cycles_write_as_jax(self, monkeypatch, seed, native):
        if native:
            assert build_jax_shim(monkeypatch), \
                "the JAX package's shim did not build"
        spec = gang_cluster_spec(seed)
        twin = QuotaTwin(monkeypatch, spec, jax_native=native)
        twin.submit(spec["waves"][0])
        twin.step()
        twin.submit(spec["waves"][1])
        twin.step()
        twin.step()
        twin.submit(spec["late"])
        twin.step()
        twin.step()
        # every pending gang member was decided: bound or marked; no
        # gang is bound in part, and a bound gang sits in one domain
        api = twin.side.api
        domain = {n.metadata.name: n.metadata.labels.get(
            C.LABEL_NVLINK_DOMAIN, "") for n in api.list(KIND_NODE)}
        for g in spec["groups"]:
            pods = api.list(KIND_POD, namespace=g["namespace"],
                            label_selector={C.LABEL_POD_GROUP: g["name"]})
            bound = [p for p in pods if p.spec.node_name]
            if g["name"].startswith("run-"):
                continue
            assert all(p.spec.node_name or p.status.conditions
                       for p in pods), g
            assert len(bound) in (0, len(pods)), g
            assert len({domain[p.spec.node_name] for p in bound}) <= 1, g

    def test_the_seeds_reach_every_gang_decision(self, monkeypatch):
        """Over the twelve seeds, both packages admit gangs, reject
        them, make gangs wait for members and evict whole gangs."""
        seen: set[str] = set()
        for seed in range(12):
            spec = gang_cluster_spec(seed)
            twin = QuotaTwin(monkeypatch, spec, jax_native=False)
            twin.submit(spec["waves"][0])
            twin.step()
            twin.submit(spec["waves"][1])
            twin.step()
            twin.step()
            for cat, subject, attrs in twin.journals()[1]:
                if cat.startswith("gang-"):
                    seen.add(cat)
                    if "waiting for members" in attrs["message"]:
                        seen.add("waiting")
                if cat == "preemption" and any(
                        v.split("/")[1].startswith(("g", "run-"))
                        for v in attrs["victims"]):
                    seen.add("gang-victim")
        assert seen >= {"gang-admitted", "gang-rejected", "waiting",
                        "gang-victim"}, seen


# ---------------------------------------------------------------------------
# chip_smoke's gang fleet
# ---------------------------------------------------------------------------


class TestGangFleet:
    def test_the_fleet_runs_as_jax_to_the_pinned_digest(self):
        spec = fleet.gang_fleet_spec(0)
        port = fleet.run_quota_fleet(spec)
        jax = _jax_quota_fleet(spec)
        assert port["summary"] == jax["summary"]
        assert fleet.plan_digest(jax["summary"]) == \
            chip_smoke.GANG_FLEET_DIGEST
        assert_same_waste(port["waste"], jax["waste"])
        assert fleet.plan_digest(fleet.waste_summary(jax["waste"])) == \
            chip_smoke.GANG_FLEET_WASTE_DIGEST
        assert port["gangs_admitted"] > 0 and port["gangs_rejected"] > 0
        assert not port["partial"] and not port["spanning"]
        assert port["gang_preemptions"] > 0 and not port["victims_other"]

    def test_the_spec_keeps_the_quota_fleet(self):
        gspec, qspec = fleet.gang_fleet_spec(0), fleet.quota_fleet_spec(0)
        assert gspec["quotas"] == qspec["quotas"]
        assert gspec["waves"][:2] == qspec["waves"]
        assert [{k: v for k, v in n.items()
                 if k not in ("domain", "host_index")}
                for n in gspec["nodes"]] == qspec["nodes"]
        domains = [n.get("domain", "") for n in gspec["nodes"]]
        assert domains == ["nvl-0"] * 16 + ["nvl-1"] * 12 + [""] * 4
        indices = [n.get("host_index") for n in gspec["nodes"]]
        assert indices == list(range(16)) + list(range(12)) + [None] * 4

    def test_the_smoke_refuses_another_digest(self, monkeypatch):
        monkeypatch.setattr(chip_smoke, "GANG_FLEET_DIGEST", "0" * 64)
        with pytest.raises(SystemExit):
            chip_smoke._gang_fleet_runs(runs=1)


# ---------------------------------------------------------------------------
# Block gangs (the JAX package's multi-host slice path; the full stories
# are in tests/test_torch_multihost.py)
# ---------------------------------------------------------------------------


class TestBlockGangs:
    @pytest.mark.parametrize("request_", [
        {C.RESOURCE_GPU: 8}, {"nvidia.com/mig-3g.40gb": 1},
        {"nvidia.com/gpu-24gb": 1}], ids=["whole", "mig", "mps"])
    def test_a_gang_with_no_block_takes_the_domain_branch(self, request_):
        api = APIServer()
        for i in range(4):
            api.create(KIND_NODE, factory.make_gpu_node(
                f"n{i}", partitioning=C.MIG_KIND, domain="d",
                host_index=i))
        members = [factory.make_pod(name=f"m{i}", resources=request_)
                   for i in range(2)]
        assert gang.gang_slice_windows(api, members) == []

    def test_two_block_profiles_are_no_window(self):
        api = APIServer()
        api.create(KIND_NODE, factory.make_gpu_node(
            "n0", partitioning=C.MIG_KIND, domain="d", host_index=0))
        members = [factory.make_pod(name="a", resources={
                       "nos.nebuly.com/nvlink-block-2x8": 1}),
                   factory.make_pod(name="b", resources={
                       "nos.nebuly.com/nvlink-block-4x8": 1})]
        assert gang.gang_slice_windows(api, members) == []

    def test_a_stale_lease_is_cleared_at_startup(self):
        """A predecessor's lease left on a node is swept by the first
        cycle, on both packages."""
        from nos_tpu.scheduler.framework import Framework as JaxFramework
        from nos_tpu.scheduler.scheduler import Scheduler as JaxScheduler
        from nos_tpu_torch.quota import GPUResourceCalculator
        from nos_tpu_torch.scheduler.capacityscheduling import (
            CapacityScheduling,
        )
        from nos_tpu_torch.scheduler.framework import Framework
        from nos_tpu_torch.scheduler.scheduler import Scheduler

        japi, api = JaxAPIServer(), APIServer()
        jn = jax_factory.make_tpu_node("n0", pod_id="d", host_index=0)
        jn.metadata.annotations[JC.ANNOT_GANG_LEASE] = "default/gone"
        pn = factory.make_gpu_node("n0", partitioning=C.MIG_KIND,
                                   domain="d", host_index=0)
        pn.metadata.annotations[C.ANNOT_GANG_LEASE] = "default/gone"
        japi.create("Node", jn)
        api.create(KIND_NODE, pn)
        JaxScheduler(japi, JaxFramework([])).run_cycle()
        Scheduler(api, Framework([]),
                  CapacityScheduling(GPUResourceCalculator())).run_cycle()
        assert JC.ANNOT_GANG_LEASE not in japi.get(
            "Node", "n0").metadata.annotations
        assert C.ANNOT_GANG_LEASE not in api.get(
            KIND_NODE, "n0").metadata.annotations
