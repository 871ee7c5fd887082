"""The port's defragmenter (nos_tpu_torch/partitioning/core/defrag.py,
topology/windows.py, the MIG controller's defrag step) against the JAX
package's, on the MIG stand-in of ``tests/test_torch_slicepart.py``: JAX
v5e restricted to {2x4, 2x2} ↔ H100 80GB restricted to {7g.80gb,
3g.40gb}, one JAX host block a one-GPU node, a 2x2 a 3g.40gb.

The two weigh capacity differently: the port counts sevenths of a GPU
(a 3g.40gb 3, a 7g.80gb 7), JAX chips (a 2x2 4, a 2x4 8).  So a payback
differs, and every story compares decisions instead: which windows are
proposed, applied and rejected and why, the victims, the shrinks, the
drain annotations and ledger holds, and the pods left.  Where the
weighting alone flips a verdict (two free 3g.40gb against a pending
7g.80gb: 6/7 of a GPU does not cover it, two free 2x2 cover a 2x4),
``TestWeighting`` pins the difference and gives JAX the port's
weighting only there (``jax_weighs_as_the_port``).

- ``tests/test_defrag.py``'s TestDefragProposer stories, on both;
- TestConservationDuringDefrag: ``attribute_free_chips`` and a ledger
  through drain churn, on the same numpy-drawn inputs, to the same
  categories, takes and reports;
- TestFragCulpritRanking: the culprit's ranking by stranded
  GPU-seconds and the ``obs waste`` join of a defrag proposal;
- ``aligned_index_windows`` against JAX's on hypothesis-drawn index
  sets and sizes, and the snapshot fork the what-if takes, reverted on
  every path;
- the defrag fleet (``testing/fleet.py``), bench_defrag.py's 2-host
  gang class in it as 2x1 block gangs under drain preemption, on both
  packages to ``DEFRAG_FLEET_DIGEST`` and ``DEFRAG_FLEET_WASTE_DIGEST``:
  the JAX side on the stand-in with the 4x4 (``JAX_FLEET_REG``), weighed
  as the port throughout (``jax_fleet_weighs_as_the_port``).
"""

from __future__ import annotations

import types

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import nos_tpu.api.constants as JC
import nos_tpu.partitioning.core.defrag as jax_defrag
import nos_tpu.partitioning.slicepart as jax_sp
import nos_tpu.scheduler.scheduler as jax_scheduler
from nos_tpu.kube.client import APIServer as JaxAPIServer
from nos_tpu.obs import journal as jax_journal, ledger as jax_ledger
from nos_tpu.obs import scoped as jax_scoped
from nos_tpu.partitioning.core import DefragProposer as JaxDefragProposer
from nos_tpu.partitioning.state import ClusterState as JaxClusterState
from nos_tpu.testing import factory as jax_factory
from nos_tpu.topology.windows import (
    aligned_index_windows as jax_aligned_index_windows,
)

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.kube.client import APIServer, KIND_NODE
from nos_tpu_torch.obs import journal as port_journal, ledger as port_ledger
from nos_tpu_torch.obs import scoped as port_scoped
from nos_tpu_torch.partitioning import slicepart as sp
from nos_tpu_torch.partitioning.core import DefragProposer
from nos_tpu_torch.partitioning.core import defrag as port_defrag
from nos_tpu_torch.partitioning.core import snapshot as port_snapshot
from nos_tpu_torch.partitioning.state import ClusterState
from nos_tpu_torch.scheduler import scheduler as port_scheduler
from nos_tpu_torch.testing import factory
from nos_tpu_torch.topology.windows import aligned_index_windows

from test_torch_slicepart import (
    HALF, JAX_GEN, JAX_REG, PORT_REG, STANDIN, TO_JAX, WHOLE,
)

# the stand-in's shapes in the port's sevenths of a GPU: a 2x4 a GPU, a
# 2x2 a 3g.40gb, a 4x4 the defrag fleet's 2x1 block of two one-GPU nodes
FLEET_SEVENTHS = {"2x4": 7, "2x2": 3, "4x4": 14}
DEFRAG_RECORDS = (port_journal.DEFRAG_PROPOSED, port_journal.DEFRAG_APPLIED,
                  port_journal.DEFRAG_REJECTED, port_journal.GANG_RESIZED)
# the capacity figures each package gives in its own weighting
WEIGHED = ("unlocked_chips", "cost_chips", "payback")


def _jax_node(name, idx, free=None, used=None):
    geometry = {}
    if free:
        geometry["free"] = {TO_JAX[p]: q for p, q in free.items()}
    if used:
        geometry["used"] = {TO_JAX[p]: q for p, q in used.items()}
    return jax_factory.make_tpu_node(name, generation=JAX_GEN,
                                     host_index=idx,
                                     status_geometry=geometry)


def _port_node(name, idx, free=None, used=None):
    table = {}
    if free:
        table["free"] = dict(free)
    if used:
        table["used"] = dict(used)
    return factory.make_gpu_node(name, model=STANDIN, gpus=1,
                                 partitioning=C.MIG_KIND, domain="nvl-0",
                                 host_index=idx, status_geometry={0: table})


JAX = types.SimpleNamespace(
    jax=True, C=JC, kind="slice", api=JaxAPIServer, node=_jax_node,
    pod=lambda profile, **kw: jax_factory.make_slice_pod(TO_JAX[profile], 1,
                                                         **kw),
    state=JaxClusterState,
    taker=lambda: jax_sp.SliceSnapshotTaker(JAX_REG),
    calc=jax_sp.SliceProfileCalculator, proposer=JaxDefragProposer,
    journal=jax_journal, ledger=jax_ledger, scoped=jax_scoped)
PORT = types.SimpleNamespace(
    jax=False, C=C, kind=C.MIG_KIND, api=APIServer, node=_port_node,
    pod=lambda profile, **kw: factory.make_mig_pod(profile, 1, **kw),
    state=ClusterState, taker=lambda: sp.SliceSnapshotTaker(PORT_REG),
    calc=sp.SliceProfileCalculator, proposer=DefragProposer,
    journal=port_journal, ledger=port_ledger, scoped=port_scoped)


def _subject(pk, value):
    """A proposal id in the port's kind, a JAX class in the port's
    profile names."""
    if not isinstance(value, str):
        return value
    if value.startswith(f"dfrg-{pk.kind}-"):
        return f"dfrg-{C.MIG_KIND}-" + value.rsplit("-", 1)[1]
    if pk.jax:
        for shape, profile in (("2x4", WHOLE), ("2x2", HALF), ("4x4", "2x1")):
            value = value.replace(shape, profile)
    return value


class Harness:
    """``tests/test_defrag.py``'s DefragHarness on one package: fragged
    one-GPU nodes (a pair of halves, one held by a movable filler) and a
    pending whole-GPU pod no carve can place."""

    def __init__(self, pk, n_fragged=3, progress=0.2, pending=WHOLE,
                 serving_on=None, elastic=None):
        self.pk = pk
        c = pk.C
        self.api = pk.api()
        self.now = [0.0]
        self.nodes_with_pods = []
        for i in range(n_fragged):
            name = f"h{i}"
            node = pk.node(name, i, free={HALF: 1}, used={HALF: 1})
            annotations = {}
            if progress is not None:
                annotations[c.ANNOT_JOB_PROGRESS] = str(progress)
            labels = {}
            if elastic is not None:
                labels[c.LABEL_POD_GROUP] = "eg"
                lo, hi = elastic
                annotations.update({c.ANNOT_ELASTIC: c.ELASTIC_DP,
                                    c.ANNOT_MIN_REPLICAS: str(lo),
                                    c.ANNOT_MAX_REPLICAS: str(hi)})
            pod = pk.pod(HALF, name=f"{name}-filler-0", node_name=name,
                         phase="Running", annotations=annotations,
                         labels=labels)
            if serving_on == name:
                pod.metadata.labels[c.LABEL_TIER] = c.TIER_SERVING
            self.nodes_with_pods.append((node, [pod]))
            self.api.create("Node", node)
            self.api.create("Pod", pod)
        self.pending = pk.pod(pending, name="big")
        self.pending.mark_unschedulable("no fit")
        self.api.create("Pod", self.pending)
        self.ledger = pk.ledger.ChipSecondLedger(clock=lambda: self.now[0])
        self.journal = pk.journal.DecisionJournal(clock=lambda: self.now[0])

    def snapshot(self):
        state = self.pk.state()
        for node, pods in self.nodes_with_pods:
            state.update_node(node, pods)
        return self.pk.taker().take_snapshot(state)

    def proposer(self, **kw):
        kw.setdefault("interval_s", 5.0)
        kw.setdefault("payback_min", 1.0)
        return self.pk.proposer(self.api, self.pk.kind, self.pk.calc(),
                                clock=lambda: self.now[0], **kw)

    def step(self, proposer, pending=None, dt=10.0):
        with self.pk.scoped(journal=self.journal, ledger=self.ledger):
            self.now[0] += dt
            return _subject(self.pk, proposer.step(
                self.snapshot(), pending or [self.pending]))

    def run(self, proposer, steps=2):
        return [a for a in (self.step(proposer) for _ in range(steps)) if a]

    def add_pod(self, profile, name, node):
        self.api.create("Pod", self.pk.pod(profile, name=name,
                                           node_name=node, phase="Running"))

    # -- what the story left ----------------------------------------------
    def records(self) -> list:
        return [(r.category, _subject(self.pk, r.subject),
                 {k: _subject(self.pk, v) for k, v in sorted(r.attrs.items())
                  if k not in WEIGHED})
                for r in self.journal.events()
                if r.category in DEFRAG_RECORDS]

    def view(self) -> dict:
        c = self.pk.C
        return {
            "records": self.records(),
            "drains": {n.metadata.name: _subject(
                self.pk, n.metadata.annotations.get(c.ANNOT_DEFRAG_DRAIN))
                for n in self.api.list("Node")},
            "holds": {n: {k: {a: _subject(self.pk, v) for a, v in d.items()}
                          for k, d in h.items()}
                      for n, h in self.ledger.holds().items()},
            "pods": sorted((p.metadata.name, p.spec.node_name,
                            p.metadata.annotations.get(c.ANNOT_DP_RESIZE))
                           for p in self.api.list("Pod")),
        }


def both(story, **kw) -> dict:
    """The story on both packages; the port's view, which must equal
    JAX's."""
    port = story(Harness(PORT, **kw))
    jax = story(Harness(JAX, **kw))
    assert port == jax
    return port


# ---------------------------------------------------------------------------
# tests/test_defrag.py's TestDefragProposer on the stand-in
# ---------------------------------------------------------------------------


class TestDefragProposer:
    def test_persistence_gate_then_apply(self):
        def story(h):
            p = h.proposer()
            first = h.step(p)
            gated = h.records()
            second = h.step(p)
            return first, gated, second, h.view()

        first, gated, second, view = both(story)
        assert first is None and gated == []
        assert second == "dfrg-mig-1"
        (applied,) = [r for r in view["records"] if r[0] == "defrag-applied"]
        (host,) = applied[2]["hosts"]
        assert view["drains"][host] == second
        assert view["holds"][host]["drain"]["proposal"] == second
        names = [p[0] for p in view["pods"]]
        assert f"{host}-filler-0" not in names and "big" in names

    def test_cleanup_releases_drained_window(self):
        def story(h):
            p = h.proposer()
            applied = h.run(p)
            h.step(p)
            return applied, h.view()

        applied, view = both(story)
        assert len(applied) == 1
        assert all(v is None for v in view["drains"].values())
        assert view["holds"] == {}

    def test_payback_threshold_rejects(self):
        def story(h):
            applied = h.run(h.proposer(payback_min=1e9))
            return applied, h.view()

        applied, view = both(story)
        assert applied == []
        reasons = [r[2]["reason"] for r in view["records"]
                   if r[0] == "defrag-rejected"]
        assert reasons and reasons[0] == "payback"
        assert len(view["pods"]) == 4 and view["holds"] == {}
        assert all(v is None for v in view["drains"].values())

    def test_serving_tier_is_never_touched(self):
        def story(h):
            return h.run(h.proposer()), h.view()

        applied, view = both(story, n_fragged=1, serving_on="h0")
        assert applied == [] and view["records"] == []

    def test_near_done_pods_pin_their_host(self):
        def story(h):
            return h.run(h.proposer()), h.view()

        applied, view = both(story, n_fragged=3, progress=0.9)
        assert applied == [] and len(view["pods"]) == 4

    def test_no_proposal_when_demand_exceeds_free(self):
        def story(h):
            return h.run(h.proposer()), h.view()

        applied, view = both(story, n_fragged=1)
        assert applied == [] and view["records"] == []

    def test_rate_limit_one_in_flight(self):
        def story(h):
            second = h.pk.pod(WHOLE, name="big2")
            second.mark_unschedulable("no fit")
            h.api.create("Pod", second)
            p = h.proposer()
            pending = [h.pending, second]
            h.step(p, pending)
            first = h.step(p, pending)
            host = [r for r in h.records()
                    if r[0] == "defrag-applied"][0][2]["hosts"][0]
            h.add_pod(HALF, "squat", host)
            again = h.step(p, pending)
            return first, again, h.view()

        first, again, view = both(story)
        assert first is not None and again is None
        assert sum(r[0] == "defrag-applied" for r in view["records"]) == 1

    def test_drain_timeout_aborts_and_heals(self):
        def story(h):
            p = h.proposer(drain_timeout_s=15.0, demand_cooldown_s=1000.0)
            (pid,) = h.run(p)
            host = [r for r in h.records()
                    if r[0] == "defrag-applied"][0][2]["hosts"][0]
            h.add_pod(HALF, "squat", host)
            h.step(p, dt=30.0)
            return pid, host, h.view()

        pid, host, view = both(story)
        assert view["drains"][host] is None and host not in view["holds"]
        assert any(r[0] == "defrag-rejected" and r[1] == pid
                   and r[2]["reason"] == "drain-timeout"
                   for r in view["records"])

    def test_an_elastic_window_shrinks_instead_of_moving(self):
        """The second lever: fillers of an elastic gang above its min die
        alone (a shrink, the survivors stamped), nothing relocates."""
        def story(h):
            return h.run(h.proposer()), h.view()

        applied, view = both(story, elastic=(1, 4))
        (rec,) = [r for r in view["records"] if r[0] == "defrag-applied"]
        assert rec[2]["shrunk"] == 1 and rec[2]["moved"] == []
        assert [r[2]["direction"] for r in view["records"]
                if r[0] == "gang-resized"] == ["shrink"]
        assert {s for _, _, s in view["pods"] if s} == {"2"}

    def test_an_elastic_gang_at_its_min_pins_its_windows(self):
        def story(h):
            return h.run(h.proposer()), h.view()

        applied, view = both(story, elastic=(3, 4))
        assert applied == [] and len(view["pods"]) == 4

    def test_a_stray_drain_is_healed_and_a_migration_drain_kept(self):
        def story(h):
            c = h.pk.C
            for name, value in (("h0", "dfrg-old-9"),
                                ("h1", c.MIGRATION_DRAIN_PREFIX + "x:y")):
                h.api.patch("Node", name, mutate=lambda n, v=value:
                            n.metadata.annotations.update(
                                {c.ANNOT_DEFRAG_DRAIN: v}))
            h.step(h.proposer())
            return {n.metadata.name: n.metadata.annotations.get(
                c.ANNOT_DEFRAG_DRAIN) for n in h.api.list("Node")}

        drains = both(story)
        assert drains == {"h0": None, "h1": "migrate:x:y", "h2": None}


# ---------------------------------------------------------------------------
# The weighting difference, pinned
# ---------------------------------------------------------------------------


class _Weighted:
    """A JAX shape weighed as the port weighs its profile: its chips the
    profile's sevenths of a GPU."""

    def __init__(self, shape) -> None:
        self.shape = shape
        self.chips = FLEET_SEVENTHS[shape.name]

    def __hash__(self) -> int:
        return hash(self.shape)

    def __eq__(self, other) -> bool:
        return self.shape == getattr(other, "shape", other)


def jax_weighs_as_the_port(monkeypatch) -> None:
    """Give the JAX defragmenter the port's weighting: a shape's chips
    its profile's sevenths, the per-move overhead a quarter of a GPU's
    seven."""
    from nos_tpu.topology.profile import (
        extract_slice_requests, shape_from_resource,
    )

    def weighed_requests(request):
        return {_Weighted(s): q
                for s, q in extract_slice_requests(request).items()}

    def weighed_shape(resource):
        shape = shape_from_resource(resource)
        return None if shape is None else _Weighted(shape)

    # a window's hosts come from the shape's own chips, not its weight:
    # _hosts_needed once more, over the module's names with the
    # unweighted requests in them
    hosts_needed = jax_defrag.DefragProposer._hosts_needed
    unweighed_hosts_needed = types.FunctionType(
        hosts_needed.__code__,
        vars(jax_defrag) | {"extract_slice_requests": extract_slice_requests},
        hosts_needed.__name__, hosts_needed.__defaults__,
        hosts_needed.__closure__)

    monkeypatch.setattr(jax_defrag, "extract_slice_requests",
                        weighed_requests)
    monkeypatch.setattr(jax_defrag, "_shape_of", weighed_shape)
    monkeypatch.setattr(jax_defrag, "MOVE_OVERHEAD_CHIPS",
                        port_defrag.MOVE_OVERHEAD_SEVENTHS)
    monkeypatch.setattr(jax_defrag.DefragProposer, "_hosts_needed",
                        unweighed_hosts_needed)


class TestWeighting:
    def _story(self, h):
        return h.run(h.proposer()), h.view()

    def test_two_free_halves_cover_a_whole_in_jax_only(self, monkeypatch):
        """Two fragged nodes: JAX counts 8 free chips against a 2x4's 8
        and moves a filler; the port counts 6 free sevenths against a
        7g.80gb's 7, a unit short of capacity, and moves nothing."""
        port = self._story(Harness(PORT, n_fragged=2))
        jax = self._story(Harness(JAX, n_fragged=2))
        assert port[0] == [] and port[1]["records"] == []
        assert jax[0] == ["dfrg-mig-1"]
        jax_weighs_as_the_port(monkeypatch)
        assert self._story(Harness(JAX, n_fragged=2)) == port

    def test_the_weighed_jax_pays_back_as_the_port(self, monkeypatch):
        """With the port's weighting JAX's payback figures are the
        port's, to the bit: the ratio of the same whole numbers."""
        def figures(h):
            h.run(h.proposer())
            return [(r.category, {k: r.attrs.get(k) for k in WEIGHED})
                    for r in h.journal.events()
                    if r.category in DEFRAG_RECORDS]

        port = figures(Harness(PORT))
        jax_weighs_as_the_port(monkeypatch)
        jax = [(c, {k: (v if k == "payback" or v is None else round(
                v / port_defrag.SEVENTHS, 2)) for k, v in a.items()})
               for c, a in figures(Harness(JAX))]
        assert port == jax
        assert port[0][1]["unlocked_chips"] == round(3 / 7, 2)

    def test_the_payback_is_unlocked_over_cost_in_sevenths(self):
        h = Harness(PORT, progress=0.2)
        h.run(h.proposer())
        (rec,) = h.journal.events(category=port_journal.DEFRAG_APPLIED)
        cost = 0.2 * 3 + 0.25 * 7
        assert rec.attrs["payback"] == round(3 / cost, 3)
        assert rec.attrs["cost_chips"] == round(cost / 7, 2)


# ---------------------------------------------------------------------------
# tests/test_defrag.py's TestConservationDuringDefrag
# ---------------------------------------------------------------------------


class TestConservationDuringDefrag:
    @pytest.mark.parametrize("seed", range(4))
    def test_attribution_is_exclusive_and_bounded(self, seed):
        rng = np.random.default_rng(1405 + seed)
        for _ in range(300):
            free = float(rng.uniform(0.0, 16.0))
            hold = None
            if rng.random() < 0.5:
                kinds = rng.choice(["quarantine", "actuation", "drain"],
                                   size=int(rng.integers(1, 4)),
                                   replace=False)
                hold = {str(k): {} for k in kinds}
            args = (free, hold, bool(rng.random() < 0.3),
                    bool(rng.random() < 0.7), bool(rng.random() < 0.5),
                    float(rng.choice([0.0, rng.uniform(0.0, 20.0)])),
                    float(rng.choice([0.0, rng.uniform(0.0, 20.0)])))
            got = port_scheduler.attribute_free_chips(*args)
            assert got == jax_scheduler.attribute_free_chips(*args)
            cat, take, qb2, gb2 = got
            assert 0.0 <= take <= free
            assert qb2 <= args[5] and gb2 <= args[6]
            if hold is not None:
                assert cat in ("quarantine", "actuation", "drain")
                assert take == free

    @pytest.mark.parametrize("seed", range(3))
    def test_ledger_conservation_with_drain_churn(self, seed):
        """Both ledgers through the same drain holds appearing and
        resolving mid-trace and the same waterfalls: the same report,
        conserved."""
        def run(pk, attribute):
            rng = np.random.default_rng(77 + seed)
            now = [0.0]
            ledger = pk.ledger.ChipSecondLedger(clock=lambda: now[0])
            nodes = [f"n{i}" for i in range(6)]
            for _ in range(120):
                now[0] += float(rng.uniform(0.1, 2.0))
                for n in nodes:
                    if rng.random() < 0.2:
                        ledger.set_hold(n, "drain", owner="defrag-mig",
                                        proposal="dfrg-x")
                    elif rng.random() < 0.2:
                        ledger.clear_hold(n, "drain", owner="defrag-mig")
                holds = ledger.holds()
                cats: dict[str, float] = {}
                qb = float(rng.uniform(0.0, 10.0))
                gb = float(rng.uniform(0.0, 10.0))
                used_total = 0.0
                for n in nodes:
                    used = float(rng.uniform(0.0, 8.0))
                    used_total += used
                    free = 8.0 - used
                    cat, take, qb, gb = attribute(
                        free, holds.get(n), bool(rng.random() < 0.2), True,
                        bool(rng.random() < 0.5), qb, gb)
                    cats[cat] = cats.get(cat, 0.0) + take
                    if take < free:
                        cats["idle_no_demand"] = \
                            cats.get("idle_no_demand", 0.0) + (free - take)
                cats["productive"] = used_total
                ledger.observe({"pool-0": {"capacity": 48.0,
                                           "categories": cats}})
            now[0] += 1.0
            ledger.observe({})
            report = ledger.report()
            assert pk.ledger.conservation_ok(report)
            assert report["overcommit_events"] == 0
            return {pool: (p["capacity_chips"], p["chip_seconds"])
                    for pool, p in report["pools"].items()}

        assert run(PORT, port_scheduler.attribute_free_chips) == \
            run(JAX, jax_scheduler.attribute_free_chips)


# ---------------------------------------------------------------------------
# tests/test_defrag.py's TestFragCulpritRanking
# ---------------------------------------------------------------------------


class TestFragCulpritRanking:
    def test_evidence_ranked_by_stranded_gpu_seconds(self):
        """Two frag-blocked classes: the one stranding more GPU-seconds
        leads the evidence though the other's rejection is newer, on both
        packages alike."""
        from nos_tpu.cmd.assembly import build_scheduler as jbuild

        from nos_tpu_torch.cmd.assembly import build_scheduler

        def run(jax: bool):
            now = [0.0]
            if jax:
                api = JaxAPIServer()
                api.create("Node", jax_factory.make_tpu_node(
                    "h0", status_geometry={"free": {"1x1": 8}}))
                ledger = jax_ledger.ChipSecondLedger(clock=lambda: now[0])
                sched = jbuild(api, clock=lambda: now[0])
                scope = jax_scoped(ledger=ledger)
            else:
                api = APIServer()
                api.create(KIND_NODE, factory.make_gpu_node(
                    "h0", gpus=8, partitioning=C.MIG_KIND,
                    status_geometry={i: {"free": {"1g.10gb": 7}}
                                     for i in range(8)}))
                ledger = port_ledger.ChipSecondLedger(clock=lambda: now[0])
                sched = build_scheduler(api, clock=lambda: now[0])
                scope = port_scoped(ledger=ledger)
            with scope:
                for _ in range(5):
                    now[0] += 1.0
                    sched._waste_rejection_maps = [{"h0": "no fit"}]
                    sched._waste_frag_counts = {"whole": 1, "half": 1}
                    blocked = {"whole": 8.0, "half": 4.0}
                    if jax:
                        sched._waste_frag_chips = blocked
                    else:
                        sched._waste_frag_gpus = blocked
                    sched._observe_waste({"whole": 1, "half": 1})
                now[0] += 1.0
                ledger.observe({})
            sched.close()
            (pool,) = ledger.report()["pools"].values()
            return pool["evidence"]["frag_stranded"]

        ev, jev = run(False), run(True)
        assert ev == jev
        assert ev["class"] == "whole"
        assert [r["class"] for r in ev["classes"]] == ["whole", "half"]
        assert ev["classes"][0]["stranded_chip_seconds"] > \
            ev["classes"][1]["stranded_chip_seconds"]

    def test_waste_culprit_renders_ranking_and_defrag_join(self):
        from nos_tpu.obs.__main__ import _waste_culprit as jax_culprit

        from nos_tpu_torch.obs.__main__ import _waste_culprit

        journal = [
            {"seq": 1, "category": "pod-rejected", "subject": "ns/p1",
             "attrs": {"class": "mig-7g.80gb", "message": "no fit"}},
            {"seq": 2, "category": "defrag-applied", "subject": "dfrg-1",
             "attrs": {"demand_class": "mig-7g.80gb", "hosts": ["h0"],
                       "unlocked_chips": 0.43, "payback": 3.2}},
        ]
        evidence = {"class": "mig-7g.80gb", "rejected_nodes": 3,
                    "classes": [
                        {"class": "mig-7g.80gb",
                         "stranded_chip_seconds": 40.0},
                        {"class": "mig-3g.40gb",
                         "stranded_chip_seconds": 5.0}]}
        text = "\n".join(_waste_culprit(journal, "frag_stranded", evidence))
        jtext = "\n".join(jax_culprit(journal, "frag_stranded", evidence))
        assert text == jtext.replace("chips unlocked", "GPUs unlocked") \
            .replace("chip-s", "GPU-s")
        assert "culprit class mig-7g.80gb" in text
        assert "also stranding: class mig-3g.40gb" in text
        assert "dfrg-1" in text and "applied" in text

    def test_no_proposal_hints_the_knob_as_jax(self):
        from nos_tpu.obs.__main__ import _waste_culprit as jax_culprit

        from nos_tpu_torch.obs.__main__ import _waste_culprit

        evidence = {"class": "mig-7g.80gb", "rejected_nodes": 1}
        assert _waste_culprit([], "frag_stranded", evidence) == \
            jax_culprit([], "frag_stranded", evidence)


# ---------------------------------------------------------------------------
# The windows and the what-if's fork
# ---------------------------------------------------------------------------


class TestWindows:
    @settings(max_examples=200, deadline=None)
    @given(st.sets(st.integers(0, 40), max_size=24), st.integers(1, 8))
    def test_aligned_windows_as_jax(self, indices, size):
        assert aligned_index_windows(indices, size) == \
            jax_aligned_index_windows(indices, size)

    def test_a_window_is_aligned_and_whole(self):
        assert aligned_index_windows([0, 1, 2, 3, 5, 6, 7], 2) == \
            [[0, 1], [2, 3], [6, 7]]
        assert aligned_index_windows([1, 2], 2) == []
        assert aligned_index_windows(range(4), 1) == [[0], [1], [2], [3]]

    def test_a_window_is_one_node_on_every_h100_profile(self):
        """No MIG instance spans nodes: the unit's window is one node
        for every profile of the table, 0 for one no model carves."""
        h = Harness(PORT)
        proposer = h.proposer()
        snap = h.snapshot()
        from nos_tpu_torch.topology import H100_80GB

        for row in H100_80GB.mig_profiles:
            pod = factory.make_mig_pod(row.name, 1)
            assert proposer._hosts_needed(snap, [pod]) == 1
        assert proposer._hosts_needed(
            snap, [factory.make_mig_pod("5g.60gb", 1)]) == 0
        assert proposer._hosts_needed(
            snap, [factory.make_timeshare_pod(24)]) == 0


    def test_a_block_s_window_is_its_node_count(self):
        """An NVLink block "NxG" spans N nodes: its unit's window is N
        nodes (JAX's multi-host slice on v5e: 4x4 over 2 hosts, 4x8 over
        4), and a block the model does not offer is no window."""
        from nos_tpu.topology import V5E, Shape

        h = Harness(PORT)
        proposer = h.proposer()
        snap = h.snapshot()
        for jax_shape, block in (("4x4", "2x8"), ("4x8", "4x8"),
                                 ("8x8", "8x8"), ("16x16", "32x8")):
            pod = factory.make_pod(resources={
                f"nos.nebuly.com/nvlink-block-{block}": 1})
            assert proposer._hosts_needed(snap, [pod]) == \
                V5E.hosts_for(Shape.parse(jax_shape))
        assert proposer._hosts_needed(snap, [factory.make_pod(
            resources={"nos.nebuly.com/nvlink-block-3x8": 1})]) == 0

    def test_a_block_member_s_demand_is_its_node(self):
        """A block member's demand is one node's GPUs (the JAX package
        caps a slice at the host's chips), in sevenths."""
        proposer = Harness(PORT).proposer()
        pod = factory.make_pod(resources={
            "nos.nebuly.com/nvlink-block-2x8": 1})
        assert proposer._shard_sevenths(pod) == 8 * 7

    @pytest.mark.parametrize("leased", ["h0", "h1", "all"])
    def test_a_leased_node_is_never_a_window_or_a_target(self, leased):
        """Nodes under the scheduler's gang-window lease are draining
        toward a stuck block gang: the defragmenter neither empties them
        nor moves pods onto them, on either package."""
        def story(h):
            key = h.pk.C.ANNOT_GANG_LEASE
            for node, _ in h.nodes_with_pods:
                if leased in ("all", node.metadata.name):
                    node.metadata.annotations[key] = "default/big"
            out = h.run(h.proposer())
            return {"applied": out, **h.view()}

        view = both(story)
        if leased == "all":
            assert view["applied"] == [] and not any(view["drains"].values())


class TestRelocatableReverts:
    """The what-if forks a subset of the snapshot and reverts it on every
    path: a feasible window, an infeasible one, and one whose placement
    raises."""

    def _counts(self, monkeypatch):
        calls = {"fork": 0, "revert": 0}
        for name in calls:
            orig = getattr(port_snapshot.ClusterSnapshot, name)

            def wrapped(self, _orig=orig, _name=name):
                calls[_name] += 1
                return _orig(self)

            monkeypatch.setattr(port_snapshot.ClusterSnapshot, name,
                                wrapped)
        return calls

    def test_every_path_reverts(self, monkeypatch):
        calls = self._counts(monkeypatch)
        h = Harness(PORT)
        proposer = h.proposer()
        snap = h.snapshot()
        filler = factory.make_mig_pod(HALF, 1, name="f")
        assert proposer._relocatable(snap, ("h0",), [filler])
        whole = factory.make_mig_pod(WHOLE, 1, name="w")
        assert not proposer._relocatable(snap, ("h0",), [whole, whole])

        def boom(sub, pod):
            raise RuntimeError("placement failed")

        monkeypatch.setattr(proposer, "_place_one", boom)
        with pytest.raises(RuntimeError):
            proposer._relocatable(snap, ("h0",), [filler])
        assert calls == {"fork": 3, "revert": 3}
        # the parent snapshot saw nothing
        assert snap._forked is None and snap.cow_clones == 0


# ---------------------------------------------------------------------------
# The defrag fleet on both packages
# ---------------------------------------------------------------------------


def _fleet_registry():
    """The JAX stand-in of the defrag fleet: v5e restricted to {2x2, 2x4}
    and the 4x4 over two hosts, whose block the port's stand-in offers
    as 2x1 (``fleet.defrag_standin``)."""
    import json
    import tempfile

    from nos_tpu.topology.known import TopologyRegistry

    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/jax.json"
        with open(path, "w") as f:
            json.dump({"tpu-v5e": {"slice_shapes": ["2x2", "2x4", "4x4"]}},
                      f)
        reg = TopologyRegistry()
        reg.load_overrides(path)
    return reg


JAX_FLEET_REG = _fleet_registry()
JAX_FLEET_GEN = JAX_FLEET_REG.get("tpu-v5e")
# the fleet's profiles as the JAX stand-in's shapes
FLEET_TO_JAX = {**TO_JAX, "2x1": "4x4"}
# a host block's chips on the JAX side, which the chip-count label (the
# port's GPU count, 1) does not carry
JAX_CHIPS_PER_HOST = 8


def _port_fleet_resource(resource: str) -> str:
    """A JAX resource of the defrag fleet under the port's name."""
    from nos_tpu.topology.profile import shape_from_resource

    from nos_tpu_torch.topology.profile import slice_resource_name

    shape = shape_from_resource(resource)
    if shape is not None:
        return slice_resource_name(
            {v: k for k, v in FLEET_TO_JAX.items()}[shape.name])
    if resource == JC.RESOURCE_TPU:
        return C.RESOURCE_GPU
    return resource


def _jax_weighed_chip_equiv(request, chips_per_host, hbm_gb_per_chip):
    """JAX's ledger currency as the port's: a slice shape its profile's
    g/7 of a GPU, a 4x4 member its node's GPU (the port's
    ``pod_chip_equiv`` on the mapped request)."""
    return port_ledger.pod_chip_equiv(
        {_port_fleet_resource(r): q for r, q in request.items()},
        chips_per_host, 0.0)


def _jax_fleet_sevenths(resources) -> float:
    """JAX's ``free_chip_equivalents`` as the port's ``gpu_sevenths``: a
    shape its profile's sevenths, a host block's 8 chips one GPU."""
    from nos_tpu.topology.profile import shape_from_resource

    total = 0.0
    for res, qty in resources.items():
        if qty <= 0:
            continue
        shape = shape_from_resource(res)
        if shape is not None:
            total += FLEET_SEVENTHS[shape.name] * qty
        elif res == JC.RESOURCE_TPU:
            total += 7 * qty / JAX_CHIPS_PER_HOST
    return total


def _jax_pool_sevenths(self) -> tuple[float, float, bool]:
    """JAX SliceNode.pool_free with the port's weighting, the fleet's
    4x4 block too (``_jax_fleet_sevenths``)."""
    ni = self.node_info()
    free = {res: aq - ni.requested.get(res, 0.0)
            for res, aq in ni.allocatable.items()}
    has_free = any(q > 0 for q in free.values())
    return _jax_fleet_sevenths(free), 0.0, has_free


def jax_fleet_weighs_as_the_port(monkeypatch) -> None:
    """The JAX package's loop weighed as the port's throughout the fleet:
    the defragmenter (``jax_weighs_as_the_port``, a host's cap 7
    sevenths, one GPU), the planner's candidate order (``pool_free``),
    the scheduler's lease choice and drain busy share
    (``free_chip_equivalents``) and the waste ledger's currency (a node
    one GPU, a shape its profile's GPUs)."""
    import nos_tpu.partitioning.slicepart.node as jax_sp_node
    import nos_tpu.topology.profile as jax_profile

    jax_weighs_as_the_port(monkeypatch)
    monkeypatch.setattr(jax_defrag.DefragProposer, "_chips_per_host",
                        lambda self, labels: float(port_defrag.SEVENTHS))
    monkeypatch.setattr(jax_defrag.DefragProposer, "_max_chips_per_host",
                        float(port_defrag.SEVENTHS))
    monkeypatch.setattr(jax_sp_node.SliceNode, "pool_free",
                        _jax_pool_sevenths)
    monkeypatch.setattr(jax_profile, "free_chip_equivalents",
                        _jax_fleet_sevenths)
    monkeypatch.setattr(jax_ledger, "pod_chip_equiv",
                        _jax_weighed_chip_equiv)


class JaxDefragOps:
    """``fleet.PortDefragOps`` on the JAX package: the stand-in v5e
    (its snapshot taker, initializer and fake runtime on
    ``JAX_FLEET_REG``), the slice partitioner controller from its
    factory, a SliceAgent over ``FakeTpuRuntime`` a node and
    ``build_scheduler`` at the port's knobs; each node in TPU pod
    ``nvl-0`` at its host index with a chip count of 1 (the port's GPU
    count, which the ledger and the drain's capacity read).

    The drain's busy share: JAX sums the stragglers'
    ``free_chip_equivalents`` (here the port's sevenths) against the
    chip-count labels (1 a node), the port sums sevenths against 7 a
    GPU, so JAX's fraction is the port's times 7 and the same stragglers
    pass.  A block shard's quota charge: JAX's ``shard_chips_per_host``
    counts the host block's 8 chips, the port's its node's one GPU
    (``fleet.DEFRAG_SHARD_GPUS``); the fleet has no quota, so neither
    decides anything here."""

    def __init__(self, monkeypatch, progress, defrag=True,
                 payback_min=None, grow=True) -> None:
        import nos_tpu.partitioning.slicepart.factory as jax_sp_factory
        from nos_tpu.cmd.assembly import build_scheduler as jbuild
        from nos_tpu.controllers.node_controller import NodeController
        from nos_tpu.controllers.pod_controller import PodController

        from nos_tpu_torch.testing import fleet

        monkeypatch.setattr(jax_sp_factory, "SliceSnapshotTaker",
                            lambda: jax_sp.SliceSnapshotTaker(JAX_FLEET_REG))
        self.now = [0.0]
        clock = lambda: self.now[0]  # noqa: E731
        self.journal = jax_journal.DecisionJournal(maxlen=1 << 19,
                                                   clock=clock)
        self.api = JaxAPIServer()
        state = JaxClusterState()
        NodeController(self.api, state, jax_sp.SliceNodeInitializer(
            self.api, JAX_FLEET_REG)).bind()
        PodController(self.api, state).bind()
        self.controller = jax_sp_factory.new_slice_partitioner_controller(
            self.api, state, batch_timeout_s=fleet.DEFRAG_BATCH_TIMEOUT_S,
            batch_idle_s=fleet.DEFRAG_BATCH_IDLE_S, defrag_enabled=defrag,
            defrag_payback_min=(fleet.DEFRAG_PAYBACK_MIN
                                if payback_min is None else payback_min),
            defrag_interval_s=fleet.DEFRAG_INTERVAL_S,
            defrag_drain_timeout_s=fleet.DEFRAG_DRAIN_TIMEOUT_S,
            defrag_progress_fn=lambda pod: progress(pod.metadata.name),
            clock=clock)
        self.controller.bind()
        self.sched = jbuild(
            self.api, elastic_grow_budget_per_cycle=1 if grow else 0,
            clock=clock,
            drain_preempt_after_cycles=fleet.DEFRAG_DRAIN_AFTER_CYCLES,
            drain_preempt_max_busy_fraction=0.25 * port_defrag.SEVENTHS,
            drain_preempt_spare_progress=fleet.DEFRAG_SPARE_PROGRESS,
            drain_preempt_progress_fn=lambda pod: progress(
                pod.metadata.name),
            shard_chips_per_host=JAX_CHIPS_PER_HOST)
        self._agents: dict = {}

    def add_node(self, n: dict) -> None:
        from nos_tpu.controllers.sliceagent.agent import SliceAgent
        from nos_tpu.device.fake import FakePodResources, FakeTpuRuntime

        self.api.create("Node", jax_factory.make_tpu_node(
            n["name"], generation=JAX_FLEET_GEN, pod_id="nvl-0",
            host_index=n["host_index"],
            extra_labels={JC.LABEL_CHIP_COUNT: "1"}))
        agent = SliceAgent(self.api, n["name"],
                           FakeTpuRuntime(JAX_FLEET_GEN), FakePodResources())
        agent.start()
        self._agents[n["name"]] = agent

    def create_group(self, name: str, min_member: int) -> None:
        from nos_tpu.api.podgroup import PodGroup, PodGroupSpec
        from nos_tpu.kube.objects import ObjectMeta

        self.api.create("PodGroup", PodGroup(
            metadata=ObjectMeta(name=name, namespace="work"),
            spec=PodGroupSpec(min_member=min_member)))

    def delete_group(self, name: str) -> None:
        from nos_tpu.kube.client import NotFound

        try:
            self.api.delete("PodGroup", name, "work")
        except NotFound:
            pass

    def create_pod(self, p: dict) -> None:
        labels = {JC.LABEL_POD_GROUP: p["gang"]} if p["gang"] else None
        annots = None
        if p["elastic"]:
            lo, hi = p["elastic"]
            annots = {JC.ANNOT_ELASTIC: JC.ELASTIC_DP,
                      JC.ANNOT_MIN_REPLICAS: str(lo),
                      JC.ANNOT_MAX_REPLICAS: str(hi)}
        self.api.create("Pod", jax_factory.make_slice_pod(
            FLEET_TO_JAX[p["profile"]], 1, name=p["name"], namespace="work",
            priority=p["priority"], creation_timestamp=p["created"],
            labels=labels, annotations=annots))

    def delete_pod(self, name: str) -> None:
        from nos_tpu.kube.client import NotFound

        try:
            self.api.delete("Pod", name, "work")
        except NotFound:
            pass

    def cycle(self) -> None:
        self.sched.run_cycle()

    def poll(self) -> None:
        self.controller.process_if_ready()

    def tick(self) -> None:
        for name in sorted(self._agents):
            self._agents[name].tick()

    def pods(self) -> list:
        return sorted((p.metadata.name, p.spec.node_name, p.status.phase,
                       p.metadata.labels.get(JC.LABEL_POD_GROUP, ""))
                      for p in self.api.list("Pod"))

    def leases(self) -> dict:
        return {n.metadata.name: n.metadata.annotations[JC.ANNOT_GANG_LEASE]
                for n in self.api.list("Node")
                if n.metadata.annotations.get(JC.ANNOT_GANG_LEASE)}

    def records(self) -> list:
        from nos_tpu_torch.testing import fleet

        pk = JAX
        return [[r.category, _subject(pk, r.subject),
                 {k: _subject(pk, v) for k, v in sorted(r.attrs.items())}]
                for r in self.journal.events()
                if r.category in fleet.DEFRAG_RECORDS]


def jax_defrag_run(monkeypatch, spec, **kw) -> dict:
    """``fleet._defrag_run`` on the JAX package, weighed as the port."""
    from nos_tpu_torch.testing import fleet

    jax_fleet_weighs_as_the_port(monkeypatch)
    trace = {}
    ops = JaxDefragOps(monkeypatch, lambda n: trace["t"].progress(n), **kw)
    ledger = jax_ledger.ChipSecondLedger(clock=lambda: ops.now[0])
    try:
        with jax_scoped(journal=ops.journal, ledger=ledger):
            trace["t"] = fleet._DefragTrace(spec, ops)
            out = trace["t"].run()
    finally:
        ops.sched.close()
    out["waste"] = ledger.report()
    return out


@pytest.fixture(scope="module")
def fleet_runs():
    """The smoke's defrag fleet line on the port (defrag and grow on, the
    baseline and propose-only, with every gate the smoke holds), the
    port's baseline run, and the JAX package's runs of the same trace
    with defrag on and off, weighed as the port."""
    import chip_smoke

    from nos_tpu_torch.testing import fleet

    spec = fleet.defrag_fleet_spec(0)
    out = {"spec": spec, "line": chip_smoke._defrag_fleet_runs(runs=1),
           "base": fleet._defrag_run(spec, defrag=False, grow=False)}
    with pytest.MonkeyPatch.context() as mp:
        out["on"] = jax_defrag_run(mp, spec)
    with pytest.MonkeyPatch.context() as mp:
        out["off"] = jax_defrag_run(mp, spec, defrag=False, grow=False)
    return out


class TestDefragFleet:
    """The defrag fleet on both packages, bench_defrag.py's 2-host gang
    class in it as 2x1 block gangs under drain preemption: the same
    summary and waterfall with defrag on and off, both pinned."""

    def test_the_port_runs_to_the_pinned_digests(self, fleet_runs):
        import chip_smoke

        line = fleet_runs["line"]
        assert line["digest"] == chip_smoke.DEFRAG_FLEET_DIGEST
        assert line["journal_identical"]
        assert line["proposals"]["applied"] >= 1
        assert line["grows"] >= 1 and line["shrinks"] >= 1

    def test_the_fleet_runs_as_jax_to_the_pinned_digests(self, fleet_runs):
        import chip_smoke

        from nos_tpu_torch.testing import fleet

        on = fleet_runs["on"]
        assert fleet.plan_digest(on["summary"]) == \
            chip_smoke.DEFRAG_FLEET_DIGEST
        assert fleet.plan_digest(fleet.waste_summary(on["waste"])) == \
            chip_smoke.DEFRAG_FLEET_WASTE_DIGEST
        assert jax_ledger.conservation_ok(on["waste"])

    def test_the_baseline_is_jax_s(self, fleet_runs):
        from nos_tpu_torch.testing import fleet

        off, base = fleet_runs["off"], fleet_runs["base"]
        assert off["summary"] == base["summary"]
        assert fleet.waste_summary(off["waste"]) == \
            fleet.waste_summary(base["waste"])

    def test_the_gates_are_held_as_jax_meets_them(self, fleet_runs):
        """The frag halving, pinned as JAX's runs meet it, and the
        utilisation floor, at 0.95 or JAX's own floor under it; the
        smoke's figures are JAX's."""
        import chip_smoke

        from nos_tpu_torch.testing import fleet

        on, off, line = fleet_runs["on"], fleet_runs["off"], \
            fleet_runs["line"]
        frag = on["waste"]["fleet"]["chip_seconds"]["frag_stranded"]
        base_frag = off["waste"]["fleet"]["chip_seconds"]["frag_stranded"]
        assert (frag <= fleet.FRAG_HALVING_TARGET * base_frag) == \
            chip_smoke.DEFRAG_FRAG_HALVING_MET
        assert chip_smoke.DEFRAG_UTILIZATION_FLOOR == min(
            fleet.UTILIZATION_MIN_TARGET, on["utilization_min"])
        assert line["frag_stranded_gpu_s"] == frag
        assert line["frag_stranded_gpu_s_baseline"] == base_frag
        assert line["utilization_min"] == on["utilization_min"]

    def test_the_gang_class_runs_alike(self, fleet_runs):
        """Both packages lease windows for the same gangs at the same
        ticks, drain the same GPU-seconds, and bind the same gangs: none
        with defrag and grow on (the grow pass refills each window the
        drain and the defragmenter empty before a plan can carve it, in
        the JAX package's own bench too), and in the baseline a gang
        whole on the aligned window it held the lease on."""
        on, off, line = fleet_runs["on"], fleet_runs["off"], \
            fleet_runs["line"]
        gangs = line["gang_class"]
        assert gangs["bound"] == on["gangs_bound"] == []
        assert gangs["bound_baseline"] == off["gangs_bound"]
        assert gangs["drain_gpu_s"] == \
            on["waste"]["fleet"]["chip_seconds"]["drain"] > 0.0
        assert gangs["lease_changes_to_a_gang"] == sum(
            any(h.startswith("work/gang-") for h in holders)
            for _, holders, _ in on["lease_log"]) > 0
        first = off["gangs_bound"][0]
        assert first[2] == ["host-12", "host-13"] and first[3] == [True,
                                                                   True]

    def test_the_spec_keeps_the_bench_s_mix(self):
        """24 one-GPU nodes of the stand-in in one domain; the bench's
        phases, targets and durations, its classes all four: the 4x4
        gang of two members a 2x1 block gang, weighing its member's 8
        chips; the scheduler at its drain and shard knobs."""
        from nos_tpu_torch.testing import fleet

        import bench_defrag

        spec = fleet.defrag_fleet_spec(0)
        assert len(spec["nodes"]) == bench_defrag.HOSTS
        assert list(fleet.DEFRAG_PHASES) == [
            (t, dict(targets)) for t, targets in bench_defrag.PHASES]
        # the bench's 1x2 is a 2x2 on the stand-in: a 3g.40gb, 4 chips
        mapped = {"1x2": fleet.DEFRAG_HALF, "2x4": fleet.DEFRAG_WHOLE,
                  "4x4": fleet.DEFRAG_BLOCK}
        assert set(fleet.DEFRAG_CLASSES) == set(bench_defrag.CLASS_SPECS)
        for cls, (profile, members, priority, durations) in \
                fleet.DEFRAG_CLASSES.items():
            shapes, jmembers, jpriority, jdurations = \
                bench_defrag.CLASS_SPECS[cls]
            assert (members, priority, durations) == \
                (jmembers, jpriority, jdurations)
            assert profile == mapped[shapes[0]]
        assert fleet.DEFRAG_UNITS == {fleet.DEFRAG_WHOLE: 8.0,
                                      fleet.DEFRAG_HALF: 4.0,
                                      fleet.DEFRAG_BLOCK: 8.0}
        assert (fleet.DEFRAG_ELASTIC_MIN, fleet.DEFRAG_ELASTIC_MAX) == \
            (bench_defrag.ELASTIC_MIN, bench_defrag.ELASTIC_MAX)
        assert fleet.DEFRAG_SPONGES == bench_defrag.SPONGES
        assert (fleet.DEFRAG_INTERVAL_S, fleet.DEFRAG_PAYBACK_MIN,
                fleet.DEFRAG_DRAIN_TIMEOUT_S) == (
            bench_defrag.DEFRAG_INTERVAL_S, bench_defrag.DEFRAG_PAYBACK_MIN,
            bench_defrag.DEFRAG_DRAIN_TIMEOUT_S)
        assert fleet.defrag_standin().profile_names() == ["3g.40gb",
                                                          "7g.80gb"]
        assert fleet.defrag_standin().block_node_counts == (2,)
        assert fleet.DEFRAG_DRAIN_AFTER_CYCLES == 40

    def test_the_stand_ins_offer_one_block_alike(self):
        """The JAX stand-in's one multi-host shape, 4x4 over two 8-chip
        hosts, is the port stand-in's one block, two one-GPU nodes."""
        from nos_tpu_torch.testing import fleet

        standin = fleet.defrag_standin()
        assert [s.name for s in JAX_FLEET_GEN.multihost_shapes()] == ["4x4"]
        assert [JAX_FLEET_GEN.hosts_for(s)
                for s in JAX_FLEET_GEN.multihost_shapes()] == \
            list(standin.block_node_counts)
        assert standin.offers_block(fleet.DEFRAG_BLOCK)
        assert FLEET_TO_JAX[fleet.DEFRAG_BLOCK] == "4x4"

    def test_the_smoke_refuses_a_gang_class_that_did_not_run(self):
        import chip_smoke

        from nos_tpu_torch.testing import fleet

        spec = fleet.defrag_fleet_spec(0)
        out = {"lease_log": [[191.0, ["work/gang-54"], ["host-0", "host-1"]]],
               "waste": {"fleet": {"chip_seconds": {"drain": 1.0}}},
               "gangs_bound": [],
               "baseline": {"gangs_bound": [
                   ["gang-54", 206.0, ["host-12", "host-13"], [True, True]]]}}
        assert chip_smoke._defrag_gang_gate(spec, out)["drain_gpu_s"] == 1.0
        # a gang bound on a misaligned window, or off its lease, is not
        # the class's
        for bad in ([["gang-54", 206.0, ["host-13", "host-14"],
                      [True, True]]],
                    [["gang-54", 206.0, ["host-12", "host-13"],
                      [True, False]]], []):
            out["baseline"]["gangs_bound"] = bad
            with pytest.raises(SystemExit, match="gang class did not run"):
                chip_smoke._defrag_gang_gate(spec, out)

    @staticmethod
    def _pinned_run(monkeypatch, **fields):
        """The smoke's defrag fleet on a stand-in run that meets the
        digests, with ``fields`` over a run that passes every gate up to
        the gang class's."""
        import chip_smoke

        from nos_tpu_torch.testing import fleet

        waste = {"fleet": {"chip_seconds": {"frag_stranded": 1.0}}}
        out = {"summary": {}, "waste": waste, "evictions": [],
               "migrations_by_job_max": 0, "migrated_pods": 0,
               "identical": True,
               "utilization_min": chip_smoke.DEFRAG_UTILIZATION_FLOOR,
               "baseline": {"waste": waste}} | fields
        monkeypatch.setattr(fleet, "run_defrag_fleet", lambda spec: out)
        monkeypatch.setattr(fleet, "plan_digest",
                            lambda s: chip_smoke.DEFRAG_FLEET_DIGEST)
        monkeypatch.setattr(chip_smoke, "_check_waste_digest",
                            lambda *a: None)

        def gate(spec, run):
            raise AssertionError("past the gates")

        monkeypatch.setattr(chip_smoke, "_defrag_gang_gate", gate)

    def test_the_smoke_refuses_a_moved_gang_member(self, monkeypatch):
        import chip_smoke

        self._pinned_run(monkeypatch, evictions=[("gang-54-0", 0.1, "gang")])
        with pytest.raises(SystemExit, match=r"moved gang-54-0 \(gang"):
            chip_smoke._defrag_fleet_runs(runs=1)

    def test_the_smoke_refuses_a_floor_under_jax_s(self, monkeypatch):
        import chip_smoke

        floor = chip_smoke.DEFRAG_UTILIZATION_FLOOR
        self._pinned_run(monkeypatch, utilization_min=floor - 1e-6)
        with pytest.raises(SystemExit, match="utilisation floor"):
            chip_smoke._defrag_fleet_runs(runs=1)
        # at JAX's floor the run passes on to the gang class's gate
        self._pinned_run(monkeypatch, utilization_min=floor)
        with pytest.raises(AssertionError, match="past the gates"):
            chip_smoke._defrag_fleet_runs(runs=1)

    def test_the_smoke_refuses_another_digest(self, monkeypatch):
        import chip_smoke

        from nos_tpu_torch.testing import fleet

        monkeypatch.setattr(fleet, "run_defrag_fleet",
                            lambda spec: {"summary": {"other": 1}})
        with pytest.raises(SystemExit, match="defrag fleet's digest"):
            chip_smoke._defrag_fleet_runs(runs=1)
