"""The port's elastic gangs (nos_tpu_torch/scheduler/elastic.py, the
shrink rung of scheduler/capacityscheduling.py, the grow pass of
scheduler/scheduler.py, the contract in api/constants.py and
utils/pod_util.py, the training main's dp-resize exit) against the JAX
package's, on the same objects.

- ``tests/test_defrag.py``'s TestElasticGangs stories on both packages:
  the bounds parse and degrade, the grow creates one member and stamps
  the survivors, the grow respects the max and full nodes, the shrink
  rung of the victim walk, and the checkpoint honours the resize.  A
  JAX 2x2 stands for the port's 3g.40gb (the stories read resource
  counts only); names are mapped and the outcomes compared whole.
- random clusters with elastic and rigid gangs under quotas
  (``test_torch_gang.gang_cluster_spec``'s, some gangs elastic), every
  write, journal record and waste report compared after every cycle,
  on the JAX scheduler's native and Python paths;
- chip_smoke's phase 15 (b) loop on the port over the REST stub and on
  the JAX package's MPS stand-in on its own REST client, both against
  ``ELASTIC_LOOP_WRITES``, with ``ELASTIC_VICTIM`` the JAX package's
  shrink victim.
"""

from __future__ import annotations

import types

import numpy as np
import pytest

import nos_tpu.api.constants as JC
import nos_tpu.cmd.train as jax_train
import nos_tpu.scheduler.elastic as jax_elastic
import nos_tpu.utils.pod_util as jax_pod_util
from nos_tpu.kube.client import APIServer as JaxAPIServer
from nos_tpu.obs import journal as jax_journal
from nos_tpu.quota import (
    ElasticQuotaInfos as JaxQuotaInfos,
    TPUResourceCalculator as JaxCalculator,
)
from nos_tpu.scheduler import capacityscheduling as jax_cs
from nos_tpu.scheduler import framework as jax_fw
from nos_tpu.testing import factory as jax_factory

import chip_smoke
import test_torch_quota
from nos_tpu_torch.api import constants as C
from nos_tpu_torch.cmd import train as port_train
from nos_tpu_torch.kube.client import APIServer, KIND_POD
from nos_tpu_torch.obs import journal as port_journal
from nos_tpu_torch.quota import ElasticQuotaInfos, GPUResourceCalculator
from nos_tpu_torch.scheduler import capacityscheduling as port_cs
from nos_tpu_torch.scheduler import elastic as port_elastic
from nos_tpu_torch.scheduler import framework as port_fw
from nos_tpu_torch.testing import factory
from nos_tpu_torch.utils import pod_util as port_pod_util

from test_torch_gang import PATHS, gang_cluster_spec
from test_torch_planner import build_jax_shim
from test_torch_quota import QuotaTwin, Side

PORT_HALF, JAX_HALF = "3g.40gb", "2x2"


def _jax_node(name, used=0, free=0):
    geometry = {}
    if free:
        geometry["free"] = {JAX_HALF: free}
    if used:
        geometry["used"] = {JAX_HALF: used}
    return jax_factory.make_tpu_node(name, status_geometry=geometry)


def _port_node(name, used=0, free=0):
    """A MIG node of one GPU a pair of 3g.40gb, ``free`` and ``used`` of
    them reporting."""
    per_gpu: dict[int, dict] = {}
    for i in range(used + free):
        table = per_gpu.setdefault(i // 2, {})
        status = "used" if i < used else "free"
        table.setdefault(status, {}).setdefault(PORT_HALF, 0)
        table[status][PORT_HALF] += 1
    return factory.make_gpu_node(name, gpus=max(1, -(-(used + free) // 2)),
                                 partitioning=C.MIG_KIND,
                                 status_geometry=per_gpu)


JAX = types.SimpleNamespace(
    jax=True, C=JC, api=JaxAPIServer, node=_jax_node,
    pod=lambda name, **kw: jax_factory.make_slice_pod(JAX_HALF, 1, name=name,
                                                      **kw),
    elastic=jax_elastic, pod_util=jax_pod_util, fw=jax_fw, cs=jax_cs,
    calc=JaxCalculator, infos=JaxQuotaInfos, journal=jax_journal,
    train=jax_train)
PORT = types.SimpleNamespace(
    jax=False, C=C, api=APIServer, node=_port_node,
    pod=lambda name, **kw: factory.make_mig_pod(PORT_HALF, 1, name=name,
                                                **kw),
    elastic=port_elastic, pod_util=port_pod_util, fw=port_fw, cs=port_cs,
    calc=GPUResourceCalculator, infos=ElasticQuotaInfos,
    journal=port_journal, train=port_train)


def both(story, *args) -> None:
    """The story's outcome on the JAX package equals the port's."""
    assert story(PORT, *args) == story(JAX, *args)


def _gang_pod(pk, name, gang="eg", node_name="", lo=1, hi=4,
              phase="Pending"):
    c = pk.C
    return pk.pod(name, node_name=node_name, phase=phase,
                  labels={c.LABEL_POD_GROUP: gang},
                  annotations={c.ANNOT_ELASTIC: c.ELASTIC_DP,
                               c.ANNOT_MIN_REPLICAS: str(lo),
                               c.ANNOT_MAX_REPLICAS: str(hi)})


def _records(pk, journal, category) -> list:
    return [(r.category, r.subject, dict(r.attrs))
            for r in journal.events(category=category)]


# ---------------------------------------------------------------------------
# tests/test_defrag.py's TestElasticGangs on both packages
# ---------------------------------------------------------------------------


def _bounds_story(pk):
    c, util = pk.C, pk.pod_util
    out = []
    pod = _gang_pod(pk, "m0")
    out.append((util.is_elastic_dp(pod), util.elastic_replica_bounds(pod)))
    for key, value in ((c.ANNOT_MAX_REPLICAS, "garbage"),
                       (c.ANNOT_MAX_REPLICAS, "0"),
                       (c.ANNOT_MIN_REPLICAS, "0"),
                       (c.ANNOT_MIN_REPLICAS, "5"),
                       (c.ANNOT_ELASTIC, "tp")):
        p = _gang_pod(pk, "m1")
        p.metadata.annotations[key] = value
        out.append((key.split("/")[1], value, util.is_elastic_dp(p),
                    util.elastic_replica_bounds(p)))
    bare = pk.pod("bare", annotations={c.ANNOT_ELASTIC: c.ELASTIC_DP})
    out.append((util.is_elastic_dp(bare), util.elastic_replica_bounds(bare)))
    return out


def _grow_story(pk):
    """Two running members on a node of four free halves: one clone,
    pending, stamped survivors, a grow record; then a pending clone
    blocks growth."""
    c, fw = pk.C, pk.fw
    api = pk.api()
    node = pk.node("g0", free=4)
    api.create("Node", node)
    members = [_gang_pod(pk, f"m{i}", node_name="g0", phase="Running")
               for i in range(2)]
    ni = fw.NodeInfo(node=node)
    for m in members:
        api.create("Pod", m)
        ni.add_pod(m)
    lister = fw.SharedLister([ni])
    journal = pk.journal.DecisionJournal()
    prev, pk.journal._journal = pk.journal._journal, journal
    try:
        created = pk.elastic.maybe_grow(api, fw.Framework(
            [fw.NodeResourcesFit()]), lister, budget=1, clock=lambda: 42.0)
        clones = sorted(
            (p.metadata.name, p.status.phase, p.spec.node_name,
             p.metadata.creation_timestamp,
             p.metadata.labels.get(c.LABEL_POD_GROUP),
             sorted(k.split("/")[1] for k in p.metadata.annotations))
            for p in api.list("Pod") if "-e" in p.metadata.name)
        stamps = [api.get("Pod", m.metadata.name, "default")
                  .metadata.annotations.get(c.ANNOT_DP_RESIZE)
                  for m in members]
        again = pk.elastic.maybe_grow(api, fw.Framework(
            [fw.NodeResourcesFit()]), lister, budget=5, clock=lambda: 43.0)
        records = _records(pk, journal, "gang-resized")
    finally:
        pk.journal._journal = prev
    return created, clones, stamps, again, records


def _grow_limits_story(pk):
    """At the max, or on a node with nothing free, nothing grows."""
    fw = pk.fw
    out = []
    for hi, free, used in ((2, 4, 0), (4, 0, 2)):
        api = pk.api()
        node = pk.node("g0", free=free, used=used)
        api.create("Node", node)
        ni = fw.NodeInfo(node=node)
        for i in range(2):
            m = _gang_pod(pk, f"m{i}", node_name="g0", hi=hi,
                          phase="Running")
            api.create("Pod", m)
            ni.add_pod(m)
        out.append(pk.elastic.maybe_grow(
            api, fw.Framework([fw.NodeResourcesFit()]),
            fw.SharedLister([ni]), budget=3))
    return out


def _shrink_story(pk):
    """An elastic member above min is walked before a best-effort pod,
    dies alone, and its gang's survivors get the new count."""
    c, cs, fw = pk.C, pk.cs, pk.fw
    api = pk.api()
    node = pk.node("h0", free=4)
    api.create("Node", node)
    ni = fw.NodeInfo(node=node)
    members = [_gang_pod(pk, f"m{i}", node_name="h0", lo=2, hi=4,
                         phase="Running") for i in range(3)]
    be = pk.pod("scav", node_name="h0", phase="Running",
                labels={c.LABEL_TIER: c.TIER_BEST_EFFORT})
    for p in [*members, be]:
        api.create("Pod", p)
        ni.add_pod(p)
    calc = pk.calc()
    plugin = cs.CapacityScheduling(calc)
    plugin.set_framework(fw.Framework([fw.NodeResourcesFit()]))
    plugin._api = api
    preemptor = pk.pod("pree", priority=10)
    state = fw.CycleState()
    state[cs.ELASTIC_QUOTA_SNAPSHOT_KEY] = pk.infos()
    state[cs.PRE_FILTER_STATE_KEY] = cs.PreFilterState(
        calc.compute_pod_request(preemptor))
    shrink: set[str] = set()
    victims, violating, status = plugin._select_victims_on_node(
        state, preemptor, ni, pdbs=[], shrink_out=shrink)
    names = [v.metadata.name for v in victims]
    shrunk = sorted(v.metadata.name for v in victims
                    if v.metadata.uid in shrink)
    alone = [p.key for p in plugin._eviction_set(victims[0], None, shrink)]
    journal = pk.journal.DecisionJournal()
    prev, pk.journal._journal = pk.journal._journal, journal
    try:
        plugin._evict_all([victims[0]], shrink)
        records = _records(pk, journal, "gang-resized")
    finally:
        pk.journal._journal = prev
    alive = sorted((p.metadata.name,
                    p.metadata.annotations.get(c.ANNOT_DP_RESIZE))
                   for p in api.list("Pod")
                   if p.metadata.labels.get(c.LABEL_POD_GROUP) == "eg")
    return (status.is_success, names, violating, shrunk, alone, alive,
            records)


def _resize_signal_story(pk):
    c = pk.C
    api = pk.api()
    api.create("Pod", _gang_pod(pk, "m0", node_name="h0", phase="Running"))
    out = [pk.train.read_resize_signal(api, "m0", "default")]
    for value in ("3", "garbage", "0", "-2", ""):
        api.patch("Pod", "m0", "default",
                  mutate=lambda p, v=value: p.metadata.annotations.update(
                      {c.ANNOT_DP_RESIZE: v}))
        out.append(pk.train.read_resize_signal(api, "m0", "default"))
    out.append(pk.train.read_resize_signal(api, "absent", "default"))
    return out


class TestElasticGangs:
    def test_replica_bounds_parse_and_degrade(self):
        both(_bounds_story)
        pod = _gang_pod(PORT, "m0")
        assert port_pod_util.elastic_replica_bounds(pod) == (1, 4)

    def test_grow_creates_one_member_and_stamps_resize(self):
        both(_grow_story)
        created, clones, stamps, again, records = _grow_story(PORT)
        assert created == 1 and again == 0
        assert clones == [("eg-e2", "Pending", "", 42.0, "eg",
                           ["elastic", "max-replicas", "min-replicas"])]
        assert stamps == ["3", "3"]
        assert records == [("gang-resized", "default/eg",
                            {"direction": "grow", "replicas": 3,
                             "member": "default/eg-e2"})]

    def test_grow_respects_max_and_full_nodes(self):
        both(_grow_limits_story)
        assert _grow_limits_story(PORT) == [0, 0]

    def test_shrink_rung_in_victim_walk(self):
        both(_shrink_story)
        ok, names, _, shrunk, alone, alive, records = _shrink_story(PORT)
        assert ok and names[0].startswith("m") and shrunk == [names[0]]
        assert alone == [f"default/{names[0]}"]
        assert [s for _, s in alive] == ["2", "2"]
        assert records[0][2]["direction"] == "shrink"

    def test_train_checkpoint_honors_resize(self):
        both(_resize_signal_story)
        assert _resize_signal_story(PORT) == [None, 3, None, None, None,
                                              None, None]

    @pytest.mark.parametrize("env,want", [
        ({}, 1), ({"WORLD_SIZE": "3"}, 3),
        ({"NOS_TPU_DP_REPLICAS": "2", "WORLD_SIZE": "1"}, 2)])
    def test_the_boot_world_size(self, env, want):
        """JAX counts its Cloud TPU hosts, the port torchrun's workers or
        the gang's replicas the workload controller names."""
        jenv = {"TPU_WORKER_HOSTNAMES": ",".join("h" * want)} \
            if want > 1 else {}
        assert port_train.boot_world_size(env) == want \
            == jax_train.boot_world_size(jenv)

    def test_a_grown_replica_keeps_no_stamp_of_its_template(self):
        """The clone drops the template's progress, resize, displaced and
        migrate stamps and its unschedulable class, as JAX's does."""
        def story(pk):
            c = pk.C
            t = _gang_pod(pk, "m0", node_name="n", phase="Running")
            t.metadata.annotations.update({
                c.ANNOT_JOB_PROGRESS: "0.5", c.ANNOT_DP_RESIZE: "2",
                c.ANNOT_DISPLACED: "node-loss@1", c.ANNOT_MIGRATE: "x"})
            t.metadata.labels[c.LABEL_UNSCHEDULABLE_CLASS] = "quota"
            clone = pk.elastic.clone_member_for_grow(t, "eg-e1", 7.0)
            return (clone.metadata.name, clone.metadata.uid
                    != t.metadata.uid, clone.spec.node_name,
                    clone.status.phase,
                    sorted(k.split("/")[1] for k in clone.metadata.labels),
                    sorted(k.split("/")[1]
                           for k in clone.metadata.annotations))
        both(story)

    def test_the_grow_name_skips_taken_names(self):
        def story(pk):
            api = pk.api()
            members = [_gang_pod(pk, f"eg-{i}") for i in range(2)]
            for p in [*members, _gang_pod(pk, "eg-e2")]:
                api.create("Pod", p)
            return pk.elastic._grow_name(api, "default", "eg", members)
        both(story)
        assert story(PORT) == "eg-e3"


# ---------------------------------------------------------------------------
# Random clusters with elastic gangs under quotas
# ---------------------------------------------------------------------------


class ElasticSide(Side):
    """``test_torch_quota.Side`` whose pods of an elastic gang carry the
    contract (``elastic``: (min, max) in the pod's spec), and whose view
    holds every pod's dp-resize stamp."""

    def create_pod(self, p: dict, phase: str = "Pending") -> None:
        super().create_pod(p, phase)
        if not p.get("elastic"):
            return
        c = JC if self.jax else C
        lo, hi = p["elastic"]

        def mutate(pod):
            pod.metadata.annotations.update({
                c.ANNOT_ELASTIC: c.ELASTIC_DP,
                c.ANNOT_MIN_REPLICAS: str(lo),
                c.ANNOT_MAX_REPLICAS: str(hi)})

        self.api.patch(KIND_POD, p["name"], p["namespace"], mutate=mutate)

    def view(self) -> dict:
        out = super().view()
        key = JC.ANNOT_DP_RESIZE if self.jax else C.ANNOT_DP_RESIZE
        out["resize"] = {p.metadata.name: p.metadata.annotations.get(key)
                         for p in self.api.list(KIND_POD)}
        return out


def elastic_cluster_spec(seed: int) -> dict:
    """``gang_cluster_spec(seed)`` with some gangs elastic: a Running
    gang (its min one or two below its members, its max above them) and
    a pending one (its min the PodGroup's, its max one or two above),
    each with odds one half."""
    spec = gang_cluster_spec(seed)
    rng = np.random.default_rng(2_000 + seed)
    members: dict[tuple[str, str], list[dict]] = {}
    for p in spec["bound"] + [p for w in spec["waves"] for p in w] \
            + spec["late"]:
        if p.get("gang"):
            members.setdefault((p["namespace"], p["gang"]), []).append(p)
    for g in spec["groups"]:
        pods = members.get((g["namespace"], g["name"]), [])
        if not pods or rng.random() < 0.5:
            continue
        size = len(pods)
        lo = max(1, min(g["min"], size) - int(rng.integers(0, 3)))
        hi = size + int(rng.integers(1, 3))
        for p in pods:
            p["elastic"] = (lo, hi)
    return spec


def _elastic_twin(monkeypatch, spec, native: bool) -> QuotaTwin:
    monkeypatch.setattr(test_torch_quota, "JOURNALED",
                        test_torch_quota.JOURNALED + ("gang-resized",))
    if native:
        assert build_jax_shim(monkeypatch), \
            "the JAX package's shim did not build"
    return QuotaTwin(monkeypatch, spec, jax_native=native, side=ElasticSide)


def _drive(twin: QuotaTwin, spec: dict) -> None:
    twin.submit(spec["waves"][0])
    twin.step()
    twin.submit(spec["waves"][1])
    for _ in range(3):
        twin.step()
    twin.submit(spec["late"])
    for _ in range(3):
        twin.step()


class TestRandomElasticClusters:
    @pytest.mark.parametrize("seed", range(12))
    @PATHS
    def test_cycles_write_as_jax(self, monkeypatch, seed, native):
        spec = elastic_cluster_spec(seed)
        twin = _elastic_twin(monkeypatch, spec, native)
        _drive(twin, spec)
        # a shrink leaves its gang at or above its min
        api = twin.side.api
        for g in spec["groups"]:
            pods = api.list(KIND_POD, namespace=g["namespace"],
                            label_selector={C.LABEL_POD_GROUP: g["name"]})
            bounds = [port_pod_util.elastic_replica_bounds(p) for p in pods]
            if pods and bounds[0] is not None:
                assert len(pods) <= bounds[0][1], g

    def test_the_seeds_reach_every_elastic_decision(self, monkeypatch):
        """Over the twelve seeds both packages grow gangs, shrink them in
        the victim walk and stamp the survivors."""
        seen: set[str] = set()
        for seed in range(12):
            spec = elastic_cluster_spec(seed)
            twin = _elastic_twin(monkeypatch, spec, False)
            _drive(twin, spec)
            for cat, _, attrs in twin.journals()[1]:
                if cat == "gang-resized":
                    seen.add(attrs["direction"])
            if any(v for v in twin.side.view()["resize"].values()):
                seen.add("stamped")
        assert seen >= {"grow", "shrink", "stamped"}, seen


# ---------------------------------------------------------------------------
# chip_smoke's phase 15 (b) loop, on both packages over the REST stub
# ---------------------------------------------------------------------------


def _elastic_port_object(orig):
    """test_torch_scheduler's JAX-to-port object converter with a pod's
    dp-resize stamp under the port's key."""
    def convert(obj):
        out = orig(obj)
        if hasattr(getattr(obj, "spec", None), "node_name"):
            stamp = obj.metadata.annotations.get(JC.ANNOT_DP_RESIZE)
            if stamp:
                out.metadata.annotations[C.ANNOT_DP_RESIZE] = stamp
        return out
    return convert


def _jax_elastic_loop(monkeypatch, clock, advance) -> tuple[dict, list]:
    """chip_smoke's _elastic_start, _elastic_grow and _elastic_shrink on
    the JAX package's loop (the one-GPU MPS stand-in, the quotas, both
    reconcilers run once a pass), on the JAX package's REST client over
    a stub of its own, recorded through the stub's commit log as the
    smoke records.  Returns the writes and the pods team-b's evicted."""
    import contextlib
    import time

    import nos_tpu.controllers.elasticquota as jax_eq
    import nos_tpu.kube.k8s_codec as jcodec
    import test_torch_scheduler as tts
    from nos_tpu.kube.rest import KubeClient as JaxKubeClient
    from nos_tpu.kube.rest import KubeConfig as JaxKubeConfig

    from k8s_stub import StubApiServer

    reconcilers: list = []
    for cls in (jax_eq.ElasticQuotaReconciler,
                jax_eq.CompositeElasticQuotaReconciler):
        monkeypatch.setattr(cls, "bind", lambda self: reconcilers.append(
            self))
    monkeypatch.setattr(tts, "_as_port_object",
                        _elastic_port_object(tts._as_port_object))
    ns, group, members = chip_smoke.ELASTIC_GANG
    lo, hi = chip_smoke.ELASTIC_BOUNDS
    b_ns, b_name = chip_smoke.ELASTIC_PREEMPTOR
    with contextlib.ExitStack() as stack:
        stub = stack.enter_context(StubApiServer())
        api = JaxKubeClient(JaxKubeConfig(server=stub.url))
        stack.callback(api.close)
        tap = chip_smoke._StubTap(stub, decode=jcodec.from_k8s)
        loop = tts._JaxCardLoop(monkeypatch, clock, advance,
                                chip_smoke.ELASTIC_CARD_QUOTAS, api=api,
                                watch=tap.watch)
        stack.callback(loop.sched.close)

        def step() -> None:
            loop.advance()
            loop.sched.run_cycle()
            for r in reconcilers:
                r.reconcile_all()
            loop.controller.process_if_ready()
            loop.agent.tick()
            time.sleep(chip_smoke.CARD_POLL_S)

        def until(done) -> None:
            for _ in range(400):
                if done():
                    return
                step()
            raise AssertionError("the JAX loop did not get there")

        def create(name: str, namespace: str, elastic: bool) -> None:
            labels = {JC.LABEL_POD_GROUP: group} if elastic else {}
            annots = {JC.ANNOT_ELASTIC: JC.ELASTIC_DP,
                      JC.ANNOT_MIN_REPLICAS: str(lo),
                      JC.ANNOT_MAX_REPLICAS: str(hi)} if elastic else {}
            api.create("Pod", jax_factory.make_timeshare_pod(
                chip_smoke.CARD_SHARE_GB, name=name, namespace=namespace,
                creation_timestamp=clock(), labels=labels,
                annotations=annots))

        loop.create_group(group, ns, lo)
        for name in members:
            create(name, ns, True)
        create(chip_smoke.ELASTIC_SINGLE, ns, False)
        until(lambda: loop.running() == sorted(
            [*members, chip_smoke.ELASTIC_SINGLE]))
        api.patch("Pod", chip_smoke.ELASTIC_SINGLE, ns,
                  mutate=lambda p: setattr(p.status, "phase", "Succeeded"))
        until(lambda: chip_smoke.ELASTIC_GROWN in loop.running())
        before = loop.names()
        create(b_name, b_ns, False)
        until(lambda: b_name in loop.running())
        gone = sorted(before - loop.names())
        assert not tap.errors, tap.errors
    return loop.writes, gone


class TestSmokeElastic:
    def _port(self, monkeypatch, injected: bool, victim=None):
        """The smoke's loop over the REST stub as the card runs it, its
        children left out."""
        import contextlib

        from test_torch_scheduler import (
            SMOKE_DEVICE, _fresh_journal, _injected_clock,
        )

        from k8s_stub import StubApiServer
        from nos_tpu_torch.kube.rest import KubeClient, KubeConfig

        _fresh_journal(monkeypatch)
        if victim is not None:
            monkeypatch.setattr(chip_smoke, "ELASTIC_VICTIM", victim)
        with contextlib.ExitStack() as stack:
            stub = stack.enter_context(StubApiServer())
            client = KubeClient(KubeConfig(server=stub.url))
            stack.callback(client.close)
            tap = chip_smoke._StubTap(stub)
            kw = {"api": client, "watch": tap.watch}
            run = {}
            if injected:
                clock, advance = _injected_clock()
                kw |= {"clock": clock, "wall": clock}
                run = {"advance": advance, "poll_s": 0.0}
            loop, card = chip_smoke._elastic_start(
                SMOKE_DEVICE, **kw, **({"advance": run["advance"],
                                         "poll_s": 0.0} if run else {}))
            stack.callback(loop.sched.close)
            grow = chip_smoke._elastic_grow(loop, **run)
            shrink = chip_smoke._elastic_shrink(loop, **run)
            assert not tap.errors
        return loop, card, grow, shrink

    @pytest.mark.parametrize("injected", [False, True],
                             ids=["monotonic", "injected"])
    def test_the_loop_over_rest_writes_what_the_smoke_pins(
            self, monkeypatch, injected):
        """Phase 15 (b)'s loop: one plan for the gang and the plain pod,
        the grow into the freed share with no new plan, the shrink of
        ELASTIC_VICTIM alone for team-b's pod; what the stub commits is
        ELASTIC_LOOP_WRITES."""
        loop, card, grow, shrink = self._port(monkeypatch, injected)
        assert card["labels"] == {"eg-0": "in-quota", "eg-1": "over-quota",
                                  "p0": "over-quota"}
        assert grow["bind_cycle"] > grow["grow_cycle"]
        assert shrink["evicted"] == [chip_smoke.ELASTIC_VICTIM]
        assert shrink["survivors"] == ["eg-0", "eg-e2"]
        assert shrink["group_after"] == ["Scheduled", 3]
        assert loop.writes == chip_smoke.ELASTIC_LOOP_WRITES

    def test_the_jax_loop_writes_the_pinned_record(self, monkeypatch):
        """The JAX package's loop on its own REST client over the stub
        commits ELASTIC_LOOP_WRITES, and its shrink takes
        ELASTIC_VICTIM; it grows into the freed share without carving it
        again."""
        from test_torch_scheduler import _fresh_journal, _injected_clock

        _fresh_journal(monkeypatch)
        clock, advance = _injected_clock()
        writes, gone = _jax_elastic_loop(monkeypatch, clock, advance)
        assert gone == [chip_smoke.ELASTIC_VICTIM]
        assert writes == chip_smoke.ELASTIC_LOOP_WRITES
        plans = {v for states in writes["h100-node-0"] for v in states
                 if v.startswith("spec-partitioning-plan")}
        assert plans == {"spec-partitioning-plan.mps=<plan 0>"}

    def test_the_smoke_refuses_another_victim(self, monkeypatch):
        with pytest.raises(SystemExit):
            self._port(monkeypatch, False, victim="eg-0")

    def test_the_restarted_member_reads_its_replicas(self, monkeypatch):
        """A member restarted at the new count holds the stamp it was
        restarted for, and leaves on the next one: the training main's
        probe against ``NOS_TPU_DP_REPLICAS``."""
        from nos_tpu_torch.cmd.train import DP_REPLICAS_ENV

        env = {DP_REPLICAS_ENV: "3"}
        assert port_train.boot_world_size(env) == 3
        assert port_train.boot_world_size({DP_REPLICAS_ENV: "2",
                                           "WORLD_SIZE": "4"}) == 2


class TestGangIndex:
    @pytest.mark.parametrize("seed", range(3))
    def test_has_gang_pods_as_jax(self, seed):
        """The cache's gang index, the grow pass's gate, through random
        pod events on both packages: labelled pods created, relabelled,
        bound, ended and deleted."""
        from nos_tpu.scheduler.cache import SchedulerCache as JaxCache
        from nos_tpu_torch.scheduler.cache import SchedulerCache

        rng = np.random.default_rng(seed)
        api, japi = APIServer(), JaxAPIServer()
        cache, jcache = SchedulerCache(api), JaxCache(japi)
        sides = ((japi, jax_factory.make_pod, JC.LABEL_POD_GROUP),
                 (api, factory.make_pod, C.LABEL_POD_GROUP))
        seen = set()
        for _ in range(60):
            op = int(rng.integers(0, 4))
            name = f"p{int(rng.integers(0, 5))}"
            group = bool(rng.random() < 0.5)
            for a, mk, label in sides:
                pod = a.try_get("Pod", name, "default")
                if op == 0 and pod is None:
                    a.create("Pod", mk(name, labels={label: "g"}
                                       if group else {}))
                elif op == 1 and pod is not None:
                    a.patch("Pod", name, "default", mutate=lambda p, g=group,
                            k=label: p.metadata.labels.update({k: "g"})
                            if g else p.metadata.labels.pop(k, None))
                elif op == 2 and pod is not None:
                    a.patch("Pod", name, "default", mutate=lambda p:
                            setattr(p.status, "phase", "Succeeded"))
                elif op == 3 and pod is not None:
                    a.delete("Pod", name, "default")
            got = cache.has_gang_pods()
            assert got == jcache.has_gang_pods()
            seen.add(got)
        assert seen == {True, False}
        cache.close()
        jcache.close()
