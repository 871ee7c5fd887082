"""The port's control-plane substrate (nos_tpu_torch/kube, utils/guards,
utils/retry, obs/trace, obs/journal, exporter/metrics' counters,
scheduler/framework) against the JAX package's modules on the same
inputs, compared exactly: the same operations give equal results, raise
the same exceptions and record the same spans and counters.  Random
inputs come from numpy generators seeded per case (the seed is the
case's parameter); names map as in ``test_torch_timeshare``.
"""

from __future__ import annotations

import numpy as np
import pytest

import nos_tpu.api.constants as JC
import nos_tpu.kube.client as jax_client
import nos_tpu.kube.resources as jax_resources
import nos_tpu.obs.journal as jax_journal
import nos_tpu.obs.trace as jax_trace
import nos_tpu.scheduler.framework as jax_fw
import nos_tpu.utils.guards as jax_guards
import nos_tpu.utils.retry as jax_retry
from nos_tpu.testing import factory as jax_factory

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.exporter.metrics import REGISTRY, Registry
from nos_tpu_torch.kube import client, resources
from nos_tpu_torch.kube.objects import ConfigMap, ObjectMeta
from nos_tpu_torch.obs import journal, trace
from nos_tpu_torch.scheduler import framework as fw
from nos_tpu_torch.testing import factory
from nos_tpu_torch.utils import guards, retry

from test_torch_timeshare import JAX_GEN, jax_resource, port_resource

RESOURCE_NAMES = ("cpu", "memory", "nvidia.com/gpu", "nvidia.com/gpu-10gb",
                  "nvidia.com/gpu-24gb", "nvidia.com/gpu-80gb")


def _random_lists(rng, n=6):
    out = []
    for _ in range(n):
        keys = rng.choice(RESOURCE_NAMES, size=rng.integers(0, 5),
                          replace=False)
        out.append({str(k): float(rng.integers(-2, 5)) for k in keys})
    return out


class TestResources:
    @pytest.mark.parametrize("seed", range(4))
    def test_arithmetic_matches_jax(self, seed):
        rng = np.random.default_rng(seed)
        lists = _random_lists(rng)
        for a in lists:
            assert resources.negatives_only(a) == \
                jax_resources.negatives_only(a)
            for b in lists:
                for name in ("sum_resources", "subtract", "max_resources",
                             "fits"):
                    assert getattr(resources, name)(a, b) == \
                        getattr(jax_resources, name)(a, b), name

    @pytest.mark.parametrize("seed", range(3))
    def test_pod_request_matches_jax(self, seed):
        rng = np.random.default_rng(10 + seed)
        for _ in range(10):
            lists = _random_lists(rng, 4)
            pod = factory.make_pod(resources=lists[0])
            jpod = jax_factory.make_pod(resources=lists[0])
            pod.spec.containers.append(type(pod.spec.containers[0])(
                resources=lists[1]))
            jpod.spec.containers.append(type(jpod.spec.containers[0])(
                resources=lists[1]))
            pod.spec.init_containers.append(type(pod.spec.containers[0])(
                resources=lists[2]))
            jpod.spec.init_containers.append(type(jpod.spec.containers[0])(
                resources=lists[2]))
            pod.spec.overhead = jpod.spec.overhead = lists[3]
            assert resources.pod_request(pod) == \
                jax_resources.pod_request(jpod)


def _both_apis():
    return client.APIServer(), jax_client.APIServer()


def _cm(mod_objects, name, ns="ns", data=None):
    return mod_objects.ConfigMap(
        metadata=mod_objects.ObjectMeta(name=name, namespace=ns),
        data=dict(data or {}))


class TestAPIServer:
    def _same(self, fn, jfn):
        """Run one operation on both servers: equal results, or the same
        exception type."""
        try:
            got = fn()
        except Exception as e:  # noqa: BLE001 — compared below
            got = type(e).__name__
        try:
            want = jfn()
        except Exception as e:  # noqa: BLE001
            want = type(e).__name__
        return got, want

    @pytest.mark.parametrize("seed", range(4))
    def test_crud_matches_jax(self, seed):
        import nos_tpu.kube.objects as jo
        import nos_tpu_torch.kube.objects as po

        rng = np.random.default_rng(20 + seed)
        api, japi = _both_apis()
        names = [f"cm-{i}" for i in range(4)]
        for _ in range(60):
            op = str(rng.choice(["create", "get", "update", "patch",
                                 "list", "stale"]))
            name = str(rng.choice(names))
            value = str(rng.integers(0, 9))
            if op == "create":
                got, want = self._same(
                    lambda: api.create("ConfigMap", _cm(po, name)).data,
                    lambda: japi.create("ConfigMap", _cm(jo, name)).data)
            elif op == "get":
                got, want = self._same(
                    lambda: api.get("ConfigMap", name, "ns").data,
                    lambda: japi.get("ConfigMap", name, "ns").data)
            elif op == "update":
                got, want = self._same(
                    lambda: api.update("ConfigMap", _cm(po, name, data={
                        "k": value})).data,
                    lambda: japi.update("ConfigMap", _cm(jo, name, data={
                        "k": value})).data)
            elif op == "patch":
                def mutate(cm, v=value):
                    cm.data["k"] = cm.data.get("k", "") + v
                got, want = self._same(
                    lambda: api.patch("ConfigMap", name, "ns",
                                      mutate=mutate).data,
                    lambda: japi.patch("ConfigMap", name, "ns",
                                       mutate=mutate).data)
            elif op == "stale":
                # an update read at an older resource version conflicts
                def stale(server, mod):
                    obj = server.get("ConfigMap", name, "ns")
                    server.patch("ConfigMap", name, "ns",
                                 mutate=lambda cm: None)
                    obj.data["k"] = "stale"
                    return server.update("ConfigMap", obj).data
                got, want = self._same(lambda: stale(api, po),
                                       lambda: stale(japi, jo))
            else:
                got, want = self._same(
                    lambda: sorted(o.metadata.name
                                   for o in api.list("ConfigMap", "ns")),
                    lambda: sorted(o.metadata.name
                                   for o in japi.list("ConfigMap", "ns")))
            assert got == want, op
            stored = api.try_get("ConfigMap", name, "ns")
            jstored = japi.try_get("ConfigMap", name, "ns")
            assert (stored is None) == (jstored is None)
            assert stored is None or (
                stored.data, stored.metadata.resource_version) == (
                jstored.data, jstored.metadata.resource_version)

    def test_reads_are_copies(self):
        api = client.APIServer()
        node = factory.make_gpu_node("n")
        api.create(client.KIND_NODE, node)
        got = api.get(client.KIND_NODE, "n")
        got.metadata.labels["x"] = "y"
        assert "x" not in api.get(client.KIND_NODE, "n").metadata.labels
        assert api.list(client.KIND_NODE,
                        label_selector={C.LABEL_GPU_COUNT: "8"})[0].name == "n"
        assert api.list(client.KIND_NODE,
                        label_selector={C.LABEL_GPU_COUNT: "4"}) == []

    @pytest.mark.parametrize("seed", range(3))
    def test_list_selectors_match_jax(self, seed):
        """Pods of random namespaces, nodes, phases and labels on both
        servers: every namespace, label and filter selection lists the
        same names."""
        rng = np.random.default_rng(30 + seed)
        api, japi = _both_apis()
        for i in range(12):
            kw = {"namespace": str(rng.choice(["a", "b"])),
                  "node_name": str(rng.choice(["", "n1", "n2"])),
                  "phase": str(rng.choice(["Pending", "Running"])),
                  "labels": {"team": str(rng.choice(["x", "y"]))}}
            api.create(client.KIND_POD, factory.make_pod(f"p{i}", **kw))
            japi.create("Pod", jax_factory.make_pod(f"p{i}", **kw))
        selections = [
            {}, {"namespace": "a"}, {"namespace": "b"},
            {"label_selector": {"team": "x"}},
            {"namespace": "a", "label_selector": {"team": "y"}},
            {"filter_fn": lambda p: p.spec.node_name == "n1"},
            {"filter_fn": lambda p: p.status.phase == "Pending"}]
        for kw in selections:
            assert sorted(p.key for p in api.list(client.KIND_POD, **kw)) \
                == sorted(p.key for p in japi.list("Pod", **kw))


class _Flaky:
    """An API whose patch fails ``n`` times with ``exc`` first."""

    def __init__(self, n, exc):
        self.n = n
        self.exc = exc
        self.calls = 0

    def patch(self, kind, name, namespace="", *, mutate):
        self.calls += 1
        if self.calls <= self.n:
            raise self.exc("blip")
        return "done"


class TestRetry:
    @pytest.fixture(autouse=True)
    def no_sleep(self, monkeypatch):
        monkeypatch.setattr(retry, "sleep", lambda s: None)
        monkeypatch.setattr(jax_retry, "sleep", lambda s: None)

    @pytest.mark.parametrize("failures,exc", [
        (0, "Conflict"), (3, "Conflict"), (2, "TransientAPIError"),
        (1, "OSError"), (8, "Conflict"), (1, "NotFound")])
    def test_retry_on_conflict_matches_jax(self, failures, exc):
        def run(mod, cl, registry, component):
            e = getattr(cl, exc, None) or OSError
            api = _Flaky(failures, e)
            before = [registry.value(n, {"component": component}) or 0
                      for n in ("nos_tpu_retry_total",
                                "nos_tpu_retry_exhausted_total")] \
                if hasattr(registry, "value") else None
            try:
                out = mod.retry_on_conflict(api, "Node", "n", lambda o: None,
                                            component=component)
            except Exception as err:  # noqa: BLE001 — compared below
                out = type(err).__name__
            return out, api.calls, before

        got, calls, before = run(retry, client, REGISTRY, "port-test")
        want, jcalls, _ = run(jax_retry, jax_client, None, "jax-test")
        assert (got, calls) == (want, jcalls)
        retried = (REGISTRY.value("nos_tpu_retry_total",
                                  {"component": "port-test"}) or 0) \
            - before[0] \
            if exc != "NotFound" else 0
        assert retried == (min(failures, 8) if exc != "NotFound" else 0)

    def test_delays_follow_the_jax_backoff(self, monkeypatch):
        """The JAX planner's retry defaults: the same number of sleeps,
        each inside the band of the JAX Backoff's jittered cap."""
        import inspect

        slept, jslept = [], []
        monkeypatch.setattr(retry, "sleep", slept.append)
        monkeypatch.setattr(jax_retry, "sleep", jslept.append)
        for mod, cl in ((retry, client), (jax_retry, jax_client)):
            with pytest.raises(cl.Conflict):
                mod.retry_on_conflict(_Flaky(99, cl.Conflict), "Node", "n",
                                      lambda o: None)
        jitter = inspect.signature(jax_retry.Backoff).parameters[
            "jitter"].default
        assert retry.JITTER == jitter
        assert (retry.ATTEMPTS, retry.BASE_DELAY_S, retry.MAX_DELAY_S) == (
            jax_retry.DEFAULT_ATTEMPTS, jax_retry.DEFAULT_BASE_DELAY_S,
            jax_retry.DEFAULT_MAX_DELAY_S)
        caps = jax_retry.Backoff(base_s=jax_retry.DEFAULT_BASE_DELAY_S,
                                 cap_s=jax_retry.DEFAULT_MAX_DELAY_S,
                                 jitter=0)
        assert len(slept) == len(jslept) == retry.ATTEMPTS - 1
        for d in slept:
            cap = caps.next_delay()
            assert cap * (1 - jitter) <= d <= cap


class TestGuards:
    def test_tables_match_jax(self):
        for mod in (guards, jax_guards):
            @mod.guarded_by("_lock", "_a", "_b")
            @mod.invalidated_by("_gen", "_a")
            class Base:
                pass

            @mod.guarded_by("_lock2", "_c")
            class Sub(Base):
                pass

            assert mod.guarded_fields(Sub) == {"_a": "_lock", "_b": "_lock",
                                               "_c": "_lock2"}
            assert mod.guarded_fields(Base) == {"_a": "_lock",
                                                "_b": "_lock"}
            assert mod.invalidated_fields(Sub) == {"_a": "_gen"}
            with pytest.raises(ValueError):
                mod.guarded_by("_other", "_a")(Sub)
            with pytest.raises(ValueError):
                mod.invalidated_by("_other", "_a")(Sub)
            for bad in (("", "_a"), ("_lock",)):
                with pytest.raises(ValueError):
                    mod.guarded_by(*bad)


class TestTraceAndJournal:
    def _drive(self, tr, jr, detailed):
        ticks = iter(range(100))
        tracer = tr.Tracer(clock=lambda: float(next(ticks)),
                           detailed=detailed)
        prev = tr.set_tracer(tracer)
        journ = jr.DecisionJournal(clock=lambda: 7.0)
        prevj = jr.set_journal(journ)
        try:
            with tr.span("planner.plan", pods=3):
                tr.bump("forks")
                with tr.detail_span("actuator.apply_node", node="n"):
                    tr.bump("commits", 2)
                    jr.record(jr.PLAN_NODE_COMMITTED, "n", placed=1)
                with pytest.raises(KeyError):
                    with tr.span("inner"):
                        raise KeyError("x")
            jr.record(jr.NODE_ACTUATED, "m", plan_id="p")
        finally:
            tr.set_tracer(prev)
            jr.set_journal(prevj)
        return tracer.ring.dump(), [r.to_dict() for r in journ.events()]

    @pytest.mark.parametrize("detailed", [False, True])
    def test_spans_and_records_match_jax(self, detailed):
        assert self._drive(trace, journal, detailed) == \
            self._drive(jax_trace, jax_journal, detailed)

    def test_the_ring_is_bounded(self):
        ring = trace.RingExporter(maxlen=2)
        before = REGISTRY.value("nos_tpu_trace_spans_dropped_total") or 0
        tracer = trace.Tracer(ring=ring)
        for i in range(5):
            with tracer.span(f"s{i}"):
                pass
        assert [s["name"] for s in ring.dump()] == ["s3", "s4"]
        assert ring.dropped == 3 and len(ring) == 2
        assert REGISTRY.value("nos_tpu_trace_spans_dropped_total") == \
            before + 3
        count, total, worst = REGISTRY.summary("nos_tpu_span_seconds",
                                               {"span": "s4"})
        assert count >= 1 and 0 <= total and 0 <= worst

    def test_journal_filters(self):
        j = journal.DecisionJournal(maxlen=3)
        for i in range(5):
            j.record(journal.NODE_ACTUATED if i % 2 else
                     journal.ACTUATION_FAILED, f"n{i}")
        assert [r.seq for r in j.events()] == [3, 4, 5]
        assert [r.subject for r in j.events(journal.NODE_ACTUATED)] == ["n3"]
        assert [r.subject for r in j.events(subject="n4")] == ["n4"]
        assert [r.seq for r in j.events(limit=1)] == [5]
        assert j.dropped == 2


class TestRegistry:
    def test_counters_and_observations(self):
        r = Registry()
        r.describe("c", "a counter")
        r.describe("c", "a counter")
        with pytest.raises(ValueError):
            r.describe("c", "another")
        assert r.value("c") is None and r.summary("h") is None
        r.inc("c", labels={"k": "v"})
        r.inc("c", 2.5, labels={"k": "v"})
        assert r.value("c", {"k": "v"}) == 3.5 and r.value("c") is None
        r.set("g", 4.0)
        assert r.value("g") == 4.0
        for v in (0.5, 0.25, 2.0):
            r.observe("h", v, {"span": "x"})
        assert r.summary("h", {"span": "x"}) == (3, 2.75, 2.0)


def _node_pair(status: dict):
    """The same 8-GPU node on both sides."""
    from test_torch_timeshare import jax_node

    spec = {"name": "n", "kind": C.MPS_KIND, "gpus": 8, "status": status}
    return factory.make_gpu_node("n", status_geometry=status), jax_node(spec)


class TestFramework:
    @pytest.mark.parametrize("seed", range(4))
    def test_node_resources_fit_matches_jax(self, seed):
        rng = np.random.default_rng(40 + seed)
        status = {g: {"free": {f"{int(rng.choice([10, 20, 40]))}gb": 1}}
                  for g in range(8)}
        node, jnode = _node_pair(status)
        ni, jni = fw.NodeInfo(node), jax_fw.NodeInfo(jnode)
        framework, jframework = fw.Framework(), jax_fw.Framework()
        for _ in range(30):
            req = {f"nvidia.com/gpu-{int(rng.choice([10, 20, 40, 80]))}gb":
                   int(rng.integers(1, 4)), "cpu": float(rng.integers(1, 40))}
            pod = factory.make_pod(resources=req)
            jpod = jax_factory.make_pod(resources={
                jax_resource(k): v for k, v in req.items()})
            st = framework.run_filter_plugins(fw.CycleState(), pod, ni)
            jst = jframework.run_filter_plugins(jax_fw.CycleState(), jpod, jni)
            assert st.is_success == jst.is_success
            assert (st.code, st.plugin) == (jst.code, jst.plugin)
            assert st.message.replace("nvidia.com/gpu-", "") == \
                jst.message.replace(JC.RESOURCE_TIMESHARE_PREFIX, "")
            if st.is_success and rng.random() < 0.5:
                ni.add_pod(pod)
                jni.add_pod(jpod)
        assert {port_resource(k): v for k, v in jni.requested.items()} == \
            ni.requested

    def test_the_mig_guard_holds_while_geometry_is_in_flux(self):
        # a bound 3g.40gb pod whose profile was re-carved away: per
        # profile the node looks free, by compute slices it is full
        node = factory.make_gpu_node("n", gpus=1, status_geometry={
            0: {"free": {"1g.10gb": 7}}})
        ni = fw.NodeInfo(node)
        ni.add_pod(factory.make_pod(resources={"nvidia.com/mig-3g.40gb": 1}))
        ni.add_pod(factory.make_pod(resources={"nvidia.com/mig-4g.40gb": 1}))
        st = fw.Framework().run_filter_plugins(
            fw.CycleState(), factory.make_pod(resources={
                "nvidia.com/mig-1g.10gb": 1}), ni)
        assert not st.is_success and "compute slices" in st.message
        assert st.plugin == "NodeResourcesFit"
        assert fw._mig_slices({"nvidia.com/mig-3g.40gb": 2,
                               "nvidia.com/gpu-24gb": 5}) == 6

    def test_equivalence_key_matches_jax(self):
        pod = factory.make_timeshare_pod(24, 2, labels={
            C.LABEL_POD_GROUP: "g"})
        jpod = jax_factory.make_timeshare_pod(24, 2, labels={
            JC.LABEL_POD_GROUP: "g"})
        key, jkey = fw.filter_equivalence_key(pod), \
            jax_fw.filter_equivalence_key(jpod)
        assert key[:2] == jkey[:2] == ("default", "g")
        assert {(port_resource(k), v) for k, v in jkey[2]} == set(key[2])

    def test_plugins_and_runners(self):
        class Gate:
            name = "Gate"

            def __init__(self):
                self.reserved = []

            def pre_filter(self, state, pod, nodes):
                return fw.Status.unschedulable("closed", reason="gate") \
                    if pod.metadata.name == "blocked" else fw.Status.ok()

            def filter(self, state, pod, node_info):
                return fw.Status.ok()

            def post_filter(self, state, pod, nodes):
                return "n", fw.Status.ok()

            def add_pod(self, state, pod, added, node_info):
                return fw.Status.error("no")

            def remove_pod(self, state, pod, removed, node_info):
                return fw.Status.ok()

            def reserve(self, state, pod, node_name):
                self.reserved.append(node_name)
                return fw.Status.ok()

            def unreserve(self, state, pod, node_name):
                self.reserved.remove(node_name)

        gate = Gate()
        f = fw.Framework([gate, fw.NodeResourcesFit()])
        assert [type(p).__name__ for p in f.filter_chain] == \
            ["Gate", "NodeResourcesFit"]
        lister = fw.SharedLister([fw.NodeInfo(factory.make_gpu_node("n"))])
        st = f.run_pre_filter_plugins(fw.CycleState(),
                                      factory.make_pod("blocked"), lister)
        assert (st.code, st.reason, st.plugin) == \
            (fw.UNSCHEDULABLE, "gate", "Gate")
        assert f.run_post_filter_plugins(fw.CycleState(),
                                         factory.make_pod(), lister)[0] == "n"
        assert f.run_pre_filter_extension_add_pod(
            fw.CycleState(), factory.make_pod(), factory.make_pod(),
            lister.get("n")).code == fw.ERROR
        f.run_reserve_plugins(fw.CycleState(), factory.make_pod(), "n")
        assert gate.reserved == ["n"]
        f.run_unreserve_plugins(fw.CycleState(), factory.make_pod(), "n")
        assert gate.reserved == [] and lister.list()[0].name == "n"
        assert [type(p).__name__ for p in fw.Framework().plugins] == \
            ["NodeResourcesFit"]

    def test_detailed_tracer_records_filter_spans(self):
        node, _ = _node_pair({0: {"free": {"24gb": 1}}})
        tracer = trace.Tracer(detailed=True)
        prev = trace.set_tracer(tracer)
        try:
            with trace.span("planner.plan"):
                fw.Framework().run_filter_plugins(
                    fw.CycleState(), factory.make_timeshare_pod(40),
                    fw.NodeInfo(node))
        finally:
            trace.set_tracer(prev)
        spans = {s["name"]: s for s in tracer.ring.dump()}
        assert spans["framework.filter"]["attrs"]["plugin"] == \
            "NodeResourcesFit"
        assert spans["planner.plan"]["counts"] == {"filter_runs": 1}
        assert JAX_GEN.chips_per_host == 8


# ---------------------------------------------------------------------------
# The watch bus, deletes and the pod views
# ---------------------------------------------------------------------------


class _Boom(RuntimeError):
    pass


def _bus_log(api, objects):
    """Three watchers on ConfigMaps: the first writes back (cm-b is
    patched twice when cm-a is ADDED), the second raises on cm-c's
    events, the third records.  Returns both recorders' logs and the
    raised errors."""
    first, third, raised = [], [], []

    def writer(ev, cm):
        first.append((ev, cm.metadata.name, dict(cm.data)))
        if ev == "ADDED" and cm.metadata.name == "cm-a":
            for v in ("a1", "a2"):
                api.patch("ConfigMap", "cm-b", "ns", mutate=lambda c, v=v:
                          c.data.__setitem__("from", v))

    def raiser(ev, cm):
        if cm.metadata.name == "cm-c":
            raise _Boom(ev)

    api.watch("ConfigMap", writer)
    api.watch("ConfigMap", raiser)
    api.watch("ConfigMap", lambda ev, cm: third.append(
        (ev, cm.metadata.name, dict(cm.data), cm.metadata.resource_version)))
    ops = [lambda: api.create("ConfigMap", _cm(objects, "cm-b")),
           lambda: api.create("ConfigMap", _cm(objects, "cm-a")),
           lambda: api.create("ConfigMap", _cm(objects, "cm-c")),
           lambda: api.patch("ConfigMap", "cm-a", "ns", mutate=lambda c:
                             c.data.__setitem__("k", "1")),
           lambda: api.delete("ConfigMap", "cm-c", "ns"),
           lambda: api.delete("ConfigMap", "cm-c", "ns")]
    for op in ops:
        try:
            op()
        except (_Boom, jax_client.NotFound, client.NotFound) as e:
            raised.append(type(e).__name__)
    return first, third, raised, api.resource_version


class TestWatchBus:
    def test_fifo_delivery_matches_jax(self):
        """A watcher's write-back is delivered after the event that
        caused it, to every watcher in the same order; a raising watcher
        neither stops the others nor strands queued events."""
        import nos_tpu.kube.objects as jo
        import nos_tpu_torch.kube.objects as po

        api, japi = _both_apis()
        got, want = _bus_log(api, po), _bus_log(japi, jo)
        assert got == want
        first, third, raised, _ = got
        assert [e[:3] for e in third] == [
            ("ADDED", "cm-b", {}), ("ADDED", "cm-a", {}),
            ("MODIFIED", "cm-b", {"from": "a1"}),
            ("MODIFIED", "cm-b", {"from": "a2"}),
            ("ADDED", "cm-c", {}), ("MODIFIED", "cm-a", {"k": "1"}),
            ("DELETED", "cm-c", {})]
        assert raised == ["_Boom", "_Boom", "NotFound"]
        assert [e[:2] for e in first] == [e[:2] for e in third]

    def test_watch_replays_selects_and_unsubscribes_as_jax(self):
        runs = []
        for api, mk in ((client.APIServer(), factory.make_pod),
                        (jax_client.APIServer(), jax_factory.make_pod)):
            for i, node in enumerate(("n1", "n2", "n1")):
                api.create("Pod", mk(f"p{i}", node_name=node))
            seen = []
            stop = api.watch("Pod", lambda ev, p: seen.append(
                (ev, p.metadata.name)),
                selector=lambda p: p.spec.node_name == "n1")
            api.create("Pod", mk("p3", node_name="n1"))
            api.create("Pod", mk("p4", node_name="n2"))
            api.delete("Pod", "p0", "default")
            stop()
            stop()                       # idempotent
            api.create("Pod", mk("p5", node_name="n1"))
            runs.append(seen)
        assert runs[0] == runs[1] == [
            ("ADDED", "p0"), ("ADDED", "p2"), ("ADDED", "p3"),
            ("DELETED", "p0")]

    @pytest.mark.parametrize("seed", range(3))
    def test_delete_version_and_pod_views_match_jax(self, seed):
        rng = np.random.default_rng(60 + seed)
        apis = _both_apis()
        mks = (factory.make_pod, jax_factory.make_pod)
        for i in range(10):
            kw = {"node_name": str(rng.choice(["", "n1", "n2"])),
                  "phase": str(rng.choice(["Pending", "Running",
                                           "Succeeded"]))}
            for api, mk in zip(apis, mks):
                api.create("Pod", mk(f"p{i}", **kw))
        for name in rng.choice([f"p{i}" for i in range(12)], size=6):
            outcomes = []
            for api in apis:
                try:
                    api.delete("Pod", str(name), "default")
                    outcomes.append("ok")
                except (client.NotFound, jax_client.NotFound):
                    outcomes.append("NotFound")
            assert outcomes[0] == outcomes[1]
            assert apis[0].resource_version == apis[1].resource_version
        for view, args in (("pods_by_phase", ("Pending",)),
                           ("pods_by_phase", ("Running",)),
                           ("pods_on_node", ("n1",)),
                           ("pods_on_node", ("",))):
            got, want = (sorted(p.key for p in getattr(api, view)(*args))
                         for api in apis)
            assert got == want, view


# ---------------------------------------------------------------------------
# The batcher, the quarantine list and the pod predicate
# ---------------------------------------------------------------------------


class TestBatcher:
    @pytest.mark.parametrize("seed", range(4))
    def test_windows_match_jax(self, seed):
        from nos_tpu.utils.batcher import Batcher as JaxBatcher

        from nos_tpu_torch.utils.batcher import Batcher

        rng = np.random.default_rng(80 + seed)
        now = [0.0]
        b = Batcher(timeout_s=60.0, idle_s=10.0, clock=lambda: now[0])
        jb = JaxBatcher(timeout_s=60.0, idle_s=10.0, clock=lambda: now[0])
        for _ in range(200):
            op = rng.integers(0, 5)
            if op == 0:
                key = f"p{rng.integers(0, 5)}"
                b.add(key, key)
                jb.add(key, key)
            elif op == 1:
                now[0] += float(rng.choice([0.5, 4.0, 9.9, 10.0, 30.0, 61.0]))
            elif op == 2:
                assert b.drain() == jb.drain()
            elif op == 3 and rng.random() < 0.2:
                # the port drains where JAX resets: both empty the batch
                b.drain()
                jb.reset()
            assert (b.ready(), len(b)) == (jb.ready(), len(jb))

    def test_the_windows(self):
        from nos_tpu_torch.utils import batcher

        now = [0.0]
        b = batcher.Batcher(timeout_s=60.0, idle_s=10.0, clock=lambda: now[0])
        assert not b.ready()
        for t in range(0, 60, 5):       # adds every 5 s hold the idle window
            now[0] = float(t)
            b.add("p", t)
            assert not b.ready()
        now[0] = 60.0                    # ... until the timeout
        assert b.ready() and b.drain() == [55]
        assert not b.ready() and len(b) == 0
        b.add("q", 1)
        now[0] += 10.0
        assert b.ready()
        assert guards.guarded_fields(batcher.Batcher) == {
            "_items": "_lock", "_first_add": "_lock", "_last_add": "_lock"}


class TestQuarantine:
    @pytest.mark.parametrize("seed", range(4))
    def test_state_machine_matches_jax(self, seed, monkeypatch):
        import nos_tpu.obs.ledger as jax_ledger
        import nos_tpu.partitioning.core.quarantine as jq

        from nos_tpu_torch.partitioning.core import quarantine as pq

        rng = np.random.default_rng(90 + seed)
        now = [0.0]
        # the JAX list stamps its holds in the process's ledger
        monkeypatch.setattr(jax_ledger, "_ledger",
                            jax_ledger.ChipSecondLedger(clock=lambda: now[0]))
        q = pq.QuarantineList("mps", clock=lambda: now[0])
        jql = jq.QuarantineList("mps", failure_threshold=3,
                                clock=lambda: now[0])
        assert pq.FAILURE_THRESHOLD == jql.failure_threshold == 3
        reasons = (pq.REASON_PLAN_DEADLINE, pq.REASON_ACTUATION)
        assert reasons == (jq.REASON_PLAN_DEADLINE, jq.REASON_ACTUATION)
        for _ in range(300):
            node = f"n{rng.integers(0, 3)}"
            op = int(rng.integers(0, 6))
            if op == 0:
                reason = str(rng.choice(reasons))
                assert q.quarantine(node, reason) == \
                    jql.quarantine(node, reason)
            elif op == 1:
                assert q.unquarantine(node) == jql.unquarantine(node)
            elif op == 2:
                assert q.release_for_probe(node, 30.0) == \
                    jql.release_for_probe(node, 30.0)
            elif op == 3:
                assert q.record_failure(node) == jql.record_failure(node)
            elif op == 4:
                q.record_success(node)
                jql.record_success(node)
            else:
                now[0] += float(rng.choice([1.0, 29.0, 31.0]))
            assert q.items() == jql.items()
            assert q.names() == jql.names()
            assert (q.items().get(node, ("",))[0], q.is_quarantined(node)) \
                == (jql.reason(node), jql.is_quarantined(node))
        assert REGISTRY.value("nos_tpu_quarantined_nodes",
                              {"kind": "mps"}) == len(q.names())

    def test_a_failed_probe_reopens_at_once(self):
        from nos_tpu_torch.partitioning.core import quarantine as pq

        now = [0.0]
        q = pq.QuarantineList("mps", clock=lambda: now[0])
        assert [q.record_failure("n") for _ in range(3)] == [1, 2, 3]
        assert q.items()["n"][0] == pq.REASON_ACTUATION
        assert q.release_for_probe("n", 10.0)
        assert q.record_failure("n") == 3 and q.is_quarantined("n")
        q.release_for_probe("n", 10.0)
        now[0] = 20.0                    # past the window: a fresh streak
        assert q.record_failure("n") == 1 and not q.is_quarantined("n")
        q.record_success("n")
        assert q.record_failure("n") == 1


class TestPodPredicate:
    @pytest.mark.parametrize("phase", ["Pending", "Running"])
    @pytest.mark.parametrize("marked", [False, True])
    @pytest.mark.parametrize("nominated", ["", "n1"])
    @pytest.mark.parametrize("owner", ["", "DaemonSet", "Job"])
    def test_extra_resources_could_help_matches_jax(self, phase, marked,
                                                    nominated, owner):
        import nos_tpu.kube.objects as jo
        from nos_tpu.utils.pod_util import (
            extra_resources_could_help_scheduling as jax_could_help)

        import nos_tpu_torch.kube.objects as po
        from nos_tpu_torch.utils.pod_util import (
            extra_resources_could_help_scheduling)

        verdicts = []
        for objects, mk, fn in ((po, factory.make_pod,
                                 extra_resources_could_help_scheduling),
                                (jo, jax_factory.make_pod, jax_could_help)):
            pod = mk("p", phase=phase)
            pod.metadata.owner_kind = owner
            pod.status.nominated_node_name = nominated
            if marked:
                pod.status.conditions.append(objects.PodCondition(
                    "PodScheduled", "False", "Unschedulable", "no fit"))
            verdicts.append((fn(pod), pod.is_unschedulable()))
        assert verdicts[0] == verdicts[1]
        assert verdicts[0][0] == (phase == "Pending" and marked
                                  and not nominated and owner != "DaemonSet")
