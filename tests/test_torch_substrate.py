"""The port's API substrates (nos_tpu_torch/kube/{client,rest,k8s_codec,
serialize,webhook}.py) against the JAX package's, on the same inputs:

- the substrate contract of ``tests/test_substrate.py``'s TestContract
  on the in-memory ``APIServer`` and on ``KubeClient`` over
  ``k8s_stub.StubApiServer`` (a kube-apiserver-shaped stub), and its
  TestInformerResilience cases on the client: non-contiguous resource
  versions, 410 Gone, a dropped stream, a delete across a drop;
- the codec: for every kind, the port's ``to_k8s`` equals JAX's on the
  twin object (the CRDs' API group rewritten), ``from_k8s`` inverts it
  on both, and ``parse_quantity``/``format_quantity`` agree on a seeded
  set of quantities (MPS shares in GB, MIG profiles, binary and SI
  suffixes, milli);
- ``merge_diff`` equals JAX's on hypothesis-drawn nested dicts, and the
  stub's merge patch of it turns the old object into the new one;
- ``dump_state``/``load_state`` round-trip a seeded cluster, and dump
  the twin cluster as JAX does;
- ``AdmissionHandler`` answers as JAX's on the same reviews.

Every comparison is exact.
"""

from __future__ import annotations

import copy
import json
import threading
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import nos_tpu.api.elasticquota as jeq
import nos_tpu.api.pdb as jpdb
import nos_tpu.api.podgroup as jpg
import nos_tpu.kube.k8s_codec as jcodec
import nos_tpu.kube.objects as jobj
import nos_tpu.kube.rest as jrest
import nos_tpu.kube.serialize as jser
import nos_tpu.kube.webhook as jwebhook
from nos_tpu.kube.client import APIServer as JaxAPIServer

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.api import elasticquota as peq
from nos_tpu_torch.api import pdb as ppdb
from nos_tpu_torch.api import podgroup as ppg
from nos_tpu_torch.kube import k8s_codec as codec
from nos_tpu_torch.kube import objects as pobj
from nos_tpu_torch.kube import rest, serialize, webhook
from nos_tpu_torch.kube.client import (
    APIServer, Conflict, KIND_NODE, KIND_POD, NotFound,
)
from nos_tpu_torch.kube.objects import PENDING, RUNNING
from nos_tpu_torch.testing.factory import make_gpu_node, make_timeshare_pod

from k8s_stub import StubApiServer, merge_apply

JAX_GROUP = "nos.tpu/v1alpha1"
PORT_GROUP = f"{C.GROUP}/v1alpha1"
MEM = C.RESOURCE_GPU_MEMORY


@pytest.fixture(params=["memory", "rest"])
def api(request):
    if request.param == "memory":
        yield APIServer()
        return
    with StubApiServer() as stub:
        client = rest.KubeClient(rest.KubeConfig(server=stub.url))
        yield client
        client.close()


def _pod(name: str, gb: int = 24):
    return make_timeshare_pod(gb, name=name)


# ---------------------------------------------------------------------------
# The substrate contract
# ---------------------------------------------------------------------------


class TestContract:
    def test_create_get_round_trip(self, api):
        pod = _pod("p0")
        pod.metadata.labels["team"] = "a"
        api.create(KIND_POD, pod)
        got = api.get(KIND_POD, "p0", "default")
        assert got.metadata.labels["team"] == "a"
        assert got.spec.containers[0].resources == \
            pod.spec.containers[0].resources
        assert got.status.phase == PENDING

    def test_create_duplicate_conflicts(self, api):
        api.create(KIND_POD, _pod("dup"))
        with pytest.raises(Conflict):
            api.create(KIND_POD, _pod("dup"))

    def test_get_missing_raises_not_found(self, api):
        with pytest.raises(NotFound):
            api.get(KIND_POD, "ghost", "default")
        assert api.try_get(KIND_POD, "ghost", "default") is None

    def test_patch_mutate_persists(self, api):
        api.create(KIND_POD, _pod("p1"))

        def mutate(p):
            p.spec.node_name = "host-3"
            p.status.phase = RUNNING

        api.patch(KIND_POD, "p1", "default", mutate=mutate)
        got = api.get(KIND_POD, "p1", "default")
        assert got.spec.node_name == "host-3"
        assert got.status.phase == RUNNING

    def test_delete_then_not_found(self, api):
        api.create(KIND_POD, _pod("p2"))
        api.delete(KIND_POD, "p2", "default")
        with pytest.raises(NotFound):
            api.get(KIND_POD, "p2", "default")
        with pytest.raises(NotFound):
            api.delete(KIND_POD, "p2", "default")

    def test_list_filters(self, api):
        for i in range(3):
            p = _pod(f"l{i}")
            if i == 0:
                p.metadata.labels["pick"] = "yes"
            api.create(KIND_POD, p)
        assert len(api.list(KIND_POD)) == 3
        assert len(api.list(KIND_POD, label_selector={"pick": "yes"})) == 1
        assert len(api.list(KIND_POD, namespace="other")) == 0
        assert len(api.pods_by_phase(PENDING)) == 3
        assert api.kinds() == [KIND_POD]

    def test_node_annotations_round_trip(self, api):
        node = make_gpu_node("host-0", gpus=2)
        api.create(KIND_NODE, node)

        def mutate(n):
            n.metadata.annotations[C.spec_plan_annotation(C.MPS_KIND)] = "42"

        api.patch(KIND_NODE, "host-0", mutate=mutate)
        got = api.get(KIND_NODE, "host-0")
        assert got.metadata.annotations[
            C.spec_plan_annotation(C.MPS_KIND)] == "42"
        assert got.metadata.labels == node.metadata.labels
        # quantities survive the string round trip
        assert got.status.allocatable == node.status.allocatable

    def test_crd_kinds_round_trip(self, api):
        api.create(C.KIND_ELASTIC_QUOTA, peq.ElasticQuota(
            metadata=pobj.ObjectMeta(name="eq", namespace="team-a"),
            spec=peq.ElasticQuotaSpec(min={MEM: 256.0}, max={MEM: 512.0})))
        eq = api.get(C.KIND_ELASTIC_QUOTA, "eq", "team-a")
        assert eq.spec.min == {MEM: 256.0}
        assert eq.spec.max == {MEM: 512.0}
        api.create(C.KIND_POD_GROUP, ppg.PodGroup(
            metadata=pobj.ObjectMeta(name="gang", namespace="team-a"),
            spec=ppg.PodGroupSpec(min_member=4, mesh="4x8")))
        pg = api.get(C.KIND_POD_GROUP, "gang", "team-a")
        assert (pg.spec.min_member, pg.spec.mesh) == (4, "4x8")

    def test_watch_replays_and_streams(self, api):
        api.create(KIND_POD, _pod("w0"))
        events: list[tuple[str, str]] = []
        seen = threading.Event()

        def fn(event, obj):
            events.append((event, obj.metadata.name))
            if ("ADDED", "w1") in events:
                seen.set()

        unsubscribe = api.watch(KIND_POD, fn)
        try:
            # the replay of the existing object is synchronous on both
            assert ("ADDED", "w0") in events
            api.create(KIND_POD, _pod("w1"))
            assert seen.wait(5.0), f"no streamed event; got {events}"
        finally:
            unsubscribe()


class TestInformerResilience:
    """The client's informer against the stub's fault modes; each
    (object, version) delivered exactly once."""

    @pytest.fixture
    def rig(self):
        with StubApiServer() as stub:
            client = rest.KubeClient(rest.KubeConfig(server=stub.url))
            yield client, stub
            client.close()

    @staticmethod
    def _tracker():
        events: list[tuple[str, str, int]] = []
        cv = threading.Condition()

        def fn(event, obj):
            with cv:
                events.append((event, obj.metadata.name,
                               obj.metadata.resource_version))
                cv.notify_all()

        def wait_for(pred, timeout=8.0):
            deadline = time.monotonic() + timeout
            with cv:
                while not pred(events):
                    left = deadline - time.monotonic()
                    assert left > 0, f"timeout; events={events}"
                    cv.wait(left)
        return events, fn, wait_for

    @staticmethod
    def _assert_exactly_once(events):
        keys = [(name, rv) for _, name, rv in events]
        assert len(keys) == len(set(keys)), f"duplicate delivery: {events}"

    @staticmethod
    def _poke(client, name, value):
        client.patch(KIND_POD, name, "default",
                     mutate=lambda p: p.metadata.annotations.update(
                         {f"{C.GROUP}/poke": value}))

    def test_rvs_are_non_contiguous_and_tolerated(self, rig):
        client, stub = rig
        assert stub.state.rv_stride > 1
        events, fn, wait_for = self._tracker()
        client.watch(KIND_POD, fn)
        client.create(KIND_POD, _pod("gap0"))
        for i in range(3):
            self._poke(client, "gap0", str(i))
        final = client.get(KIND_POD, "gap0", "default")
        wait_for(lambda ev: any(rv == final.metadata.resource_version
                                for _, n, rv in ev if n == "gap0"))
        self._assert_exactly_once(events)

    def test_watch_survives_410_gone(self, rig):
        client, stub = rig
        events, fn, wait_for = self._tracker()
        client.create(KIND_POD, _pod("g0"))
        client.watch(KIND_POD, fn)
        wait_for(lambda ev: any(n == "g0" for _, n, _ in ev))
        stub.state.compact()
        stub.state.fire_gone("pods")
        client.create(KIND_POD, _pod("g1"))
        wait_for(lambda ev: any(n == "g1" for _, n, _ in ev))
        self._assert_exactly_once(events)
        assert ("ADDED", "g0") == events[0][:2]

    def test_watch_survives_dropped_connection(self, rig):
        client, stub = rig
        events, fn, wait_for = self._tracker()
        client.create(KIND_POD, _pod("d0"))
        client.watch(KIND_POD, fn)
        wait_for(lambda ev: any(n == "d0" for _, n, _ in ev))
        stub.state.drop_watches("pods")
        # a change, an add and (below) a read while disconnected
        self._poke(client, "d0", "while-down")
        client.create(KIND_POD, _pod("d1"))
        d0rv = client.get(KIND_POD, "d0", "default").metadata.resource_version
        wait_for(lambda ev: any(n == "d1" for _, n, _ in ev)
                 and any(n == "d0" and rv == d0rv for _, n, rv in ev))
        self._assert_exactly_once(events)

    def test_watch_recovers_delete_across_drop(self, rig):
        client, stub = rig
        events, fn, wait_for = self._tracker()
        client.create(KIND_POD, _pod("x0"))
        client.create(KIND_POD, _pod("x1"))
        client.watch(KIND_POD, fn)
        wait_for(lambda ev: len([1 for e, _, _ in ev if e == "ADDED"]) >= 2)
        stub.state.drop_watches("pods")
        client.delete(KIND_POD, "x1", "default")
        wait_for(lambda ev: any(e == "DELETED" and n == "x1"
                                for e, n, _ in ev))
        self._assert_exactly_once(
            [e for e in events if e[0] != "DELETED"])


class TestKubeConfig:
    def test_a_json_kubeconfig_loads_as_jax_loads_it(self, tmp_path):
        """A JSON kubeconfig (what the training main gets where pyyaml
        is missing) names the same server, token and CA on both."""
        path = tmp_path / "kubeconfig"
        path.write_text(json.dumps({
            "current-context": "ctx",
            "contexts": [{"name": "ctx", "context": {
                "cluster": "c", "user": "u"}}],
            "clusters": [{"name": "c", "cluster": {
                "server": "https://10.0.0.1:6443/",
                "certificate-authority": "/etc/ca.crt"}}],
            "users": [{"name": "u", "user": {"token": "t0k"}}]}))
        got, want = rest.KubeConfig.load(str(path)), \
            jrest.KubeConfig.load(str(path))
        assert vars(got) == vars(want)
        assert got.server == "https://10.0.0.1:6443"

    def test_json_without_pyyaml(self, tmp_path, monkeypatch):
        import builtins

        real_import = builtins.__import__

        def no_yaml(name, *args, **kw):
            if name == "yaml":
                raise ImportError("no yaml")
            return real_import(name, *args, **kw)

        path = tmp_path / "kubeconfig"
        path.write_text(json.dumps({"clusters": [{"name": "c", "cluster": {
            "server": "http://127.0.0.1:1"}}]}))
        monkeypatch.setattr(builtins, "__import__", no_yaml)
        assert rest.KubeConfig.load(str(path)).server == "http://127.0.0.1:1"


# ---------------------------------------------------------------------------
# The codec against the JAX package's
# ---------------------------------------------------------------------------

SHARES = ("nvidia.com/gpu-10gb", "nvidia.com/gpu-24gb", "nvidia.com/gpu-40gb",
          "nvidia.com/mig-1g.10gb", "nvidia.com/mig-3g.40gb",
          "nvidia.com/gpu", "cpu", MEM)


def _resources(rng) -> dict:
    names = rng.choice(len(SHARES), size=int(rng.integers(1, 4)),
                       replace=False)
    return {SHARES[i]: float(rng.choice([1, 2, 3, 0.5, 24, 80, 1.25]))
            for i in sorted(names)}


def _meta_kw(rng, namespaced: bool) -> dict:
    return {"name": f"obj-{int(rng.integers(1000))}",
            "namespace": "team-a" if namespaced else "",
            "labels": {f"{C.GROUP}/l{i}": f"v{int(rng.integers(9))}"
                       for i in range(int(rng.integers(0, 3)))},
            "annotations": {f"{C.GROUP}/a{i}": f"{rng.random():.4f}"
                            for i in range(int(rng.integers(0, 3)))},
            "uid": f"k8s-{int(rng.integers(1 << 30))}",
            "resource_version": int(rng.integers(0, 500))}


def _twins(kind: str, seed: int):
    """The same object on both packages, from one seed, with the fields
    the codec carries (the server stamps the creation time)."""
    rng = np.random.default_rng(seed)
    meta = _meta_kw(rng, kind != "Node")
    pmeta, jmeta = pobj.ObjectMeta(**meta), jobj.ObjectMeta(**meta)
    if kind == "Pod":
        conds = [("PodScheduled", "False", "Unschedulable", "no room")] \
            if rng.random() < 0.5 else []
        node = "n1" if rng.random() < 0.5 else ""

        def pod(m, o):
            return o.Pod(
                metadata=m,
                spec=o.PodSpec(
                    containers=[o.Container("main", _resources(
                        np.random.default_rng(seed + 1)))],
                    init_containers=[o.Container("init", {"cpu": 1.0})]
                    if seed % 2 else [],
                    overhead={"cpu": 0.25} if seed % 3 == 0 else {},
                    node_name=node, priority=int(seed % 4) * 10,
                    preemption_policy="Never" if seed % 5 == 0
                    else "PreemptLowerPriority",
                    scheduler_name="nos-scheduler"),
                status=o.PodStatus(
                    phase=RUNNING if node else PENDING,
                    conditions=[o.PodCondition(*c) for c in conds],
                    nominated_node_name="n2" if seed % 3 == 1 else ""))
        return pod(pmeta, pobj), pod(jmeta, jobj)
    if kind == "Node":
        alloc = _resources(rng)
        return (pobj.Node(metadata=pmeta, status=pobj.NodeStatus(
                    allocatable=dict(alloc), capacity=dict(alloc))),
                jobj.Node(metadata=jmeta, status=jobj.NodeStatus(
                    allocatable=dict(alloc), capacity=dict(alloc))))
    if kind == "ConfigMap":
        data = {f"k{i}": json.dumps({"v": i}) for i in range(3)}
        return (pobj.ConfigMap(metadata=pmeta, data=dict(data)),
                jobj.ConfigMap(metadata=jmeta, data=dict(data)))
    lo, hi, used = _resources(rng), _resources(rng), _resources(rng)
    if kind == "ElasticQuota":
        return (peq.ElasticQuota(pmeta, peq.ElasticQuotaSpec(lo, hi),
                                 peq.ElasticQuotaStatus(used)),
                jeq.ElasticQuota(jmeta, jeq.ElasticQuotaSpec(lo, hi),
                                 jeq.ElasticQuotaStatus(used)))
    if kind == "CompositeElasticQuota":
        nss = ["team-a", "team-b"]
        return (peq.CompositeElasticQuota(
                    pmeta, peq.CompositeElasticQuotaSpec(list(nss), lo, hi),
                    peq.ElasticQuotaStatus(used)),
                jeq.CompositeElasticQuota(
                    jmeta, jeq.CompositeElasticQuotaSpec(list(nss), lo, hi),
                    jeq.ElasticQuotaStatus(used)))
    if kind == "PodGroup":
        spec = dict(min_member=int(rng.integers(1, 9)), mesh="2x4")
        status = dict(phase="Scheduled", scheduled=int(rng.integers(0, 9)))
        return (ppg.PodGroup(pmeta, ppg.PodGroupSpec(**spec),
                             ppg.PodGroupStatus(**status)),
                jpg.PodGroup(jmeta, jpg.PodGroupSpec(**spec),
                             jpg.PodGroupStatus(**status)))
    spec = dict(min_available=int(rng.integers(0, 4)),
                selector={"app": "job"})
    status = dict(disruptions_allowed=1, current_healthy=3,
                  desired_healthy=2)
    return (ppdb.PodDisruptionBudget(
                pmeta, ppdb.PodDisruptionBudgetSpec(**spec),
                ppdb.PodDisruptionBudgetStatus(**status)),
            jpdb.PodDisruptionBudget(
                jmeta, jpdb.PodDisruptionBudgetSpec(**spec),
                jpdb.PodDisruptionBudgetStatus(**status)))


def _port_json(data):
    """JAX's JSON with the CRDs' API group rewritten to the port's."""
    if data.get("apiVersion") == JAX_GROUP:
        data = dict(data, apiVersion=PORT_GROUP)
    return data


KINDS = sorted(codec.KIND_REST)


class TestCodec:
    def test_the_kinds_and_paths_are_jax_s(self):
        assert KINDS == sorted(jcodec.KIND_REST)
        for kind in KINDS:
            (pv, pp, pn), (jv, jp, jn) = codec.KIND_REST[kind], \
                jcodec.KIND_REST[kind]
            assert (pv, pp, pn) == (PORT_GROUP if jv == JAX_GROUP else jv,
                                    jp, jn)
            for ns, name in (("", ""), ("team-a", ""), ("team-a", "x")):
                want = jcodec.rest_path(kind, ns, name).replace(
                    JAX_GROUP, PORT_GROUP)
                assert codec.rest_path(kind, ns, name) == want

    @pytest.mark.parametrize("seed", range(4))
    @pytest.mark.parametrize("kind", KINDS)
    def test_to_k8s_is_jax_s_and_from_k8s_inverts_it(self, kind, seed):
        obj, jobj_ = _twins(kind, seed)
        out = codec.to_k8s(kind, obj)
        assert out == _port_json(jcodec.to_k8s(kind, jobj_))
        # from_k8s inverts to_k8s on both packages
        back = codec.from_k8s(kind, copy.deepcopy(out))
        assert back == obj
        jback = jcodec.from_k8s(kind, jcodec.to_k8s(kind, jobj_))
        assert jback == jobj_
        assert codec.to_k8s(kind, back) == out

    @pytest.mark.parametrize("kind", KINDS)
    def test_unknown_fields_and_rfc3339_stamps_read_as_jax(self, kind):
        data = {"apiVersion": "v1", "kind": kind, "extra": {"x": 1},
                "metadata": {"name": "a", "namespace": "ns",
                             "resourceVersion": "banana",
                             "creationTimestamp": "2026-01-01T00:00:00Z",
                             "ownerReferences": [{"kind": "Job"}]},
                "status": {"allocatable": {"nvidia.com/gpu-24gb": "3"}}}
        got = codec.from_k8s(kind, copy.deepcopy(data))
        want = jcodec.from_k8s(kind, copy.deepcopy(data))
        assert codec.to_k8s(kind, got) == _port_json(
            jcodec.to_k8s(kind, want))
        assert got.metadata.creation_timestamp == \
            want.metadata.creation_timestamp == 1767225600.0
        assert got.metadata.owner_kind == "Job"

    def test_quantities_agree_with_jax(self):
        rng = np.random.default_rng(0)
        quantities = ["24", "80", "0", "500m", "1.5", "2k", "3M", "1G",
                      "64Gi", "512Mi", "1Ki", "2Ti", "1e3", "7", 24, 2.5]
        quantities += [str(int(v)) for v in rng.integers(0, 1 << 20, 20)]
        quantities += [f"{v:.3f}" for v in rng.random(10) * 100]
        quantities += [f"{int(v)}{s}" for v, s in zip(
            rng.integers(1, 999, 10),
            rng.choice(["Ki", "Mi", "Gi", "k", "M", "G", "m"], 10))]
        for q in quantities:
            got = codec.parse_quantity(q)
            assert got == jcodec.parse_quantity(q), q
            assert codec.format_quantity(got) == \
                jcodec.format_quantity(got), q
        for bad in ("banana", "3Xi", ""):
            for parse in (codec.parse_quantity, jcodec.parse_quantity):
                with pytest.raises(ValueError):
                    parse(bad)
        # an MPS share and a MIG profile round-trip as quantities
        node = make_gpu_node("h", gpus=2)
        node.status.allocatable |= {"nvidia.com/gpu-24gb": 3.0,
                                    "nvidia.com/mig-3g.40gb": 2.0}
        out = codec.to_k8s(KIND_NODE, node)
        assert out["status"]["allocatable"]["nvidia.com/gpu-24gb"] == "3"
        assert codec.from_k8s(KIND_NODE, out).status.allocatable == \
            node.status.allocatable


# ---------------------------------------------------------------------------
# merge_diff
# ---------------------------------------------------------------------------

_leaves = st.one_of(st.none(), st.booleans(), st.integers(-5, 5),
                    st.text("abc", max_size=3),
                    st.lists(st.integers(0, 3), max_size=3))
_docs = st.recursive(
    _leaves, lambda inner: st.dictionaries(st.sampled_from("abcde"), inner,
                                           max_size=4), max_leaves=12)
_objects = st.dictionaries(st.sampled_from("abcdef"), _docs, max_size=5)


class TestMergeDiff:
    @settings(max_examples=300, deadline=None, derandomize=True)
    @given(_objects, _objects)
    def test_equals_jax_s(self, old, new):
        assert rest.merge_diff(old, new) == jrest.merge_diff(old, new)

    @settings(max_examples=300, deadline=None, derandomize=True)
    @given(_objects, _objects)
    def test_the_stub_s_merge_of_it_gives_the_new_object(self, old, new):
        """Where no value is null (a merge patch's deletion), applying
        the diff to the old object gives the new one."""
        def has_null(d):
            return any(v is None or isinstance(v, dict) and has_null(v)
                       for v in d.values())
        if has_null(old) or has_null(new):
            return
        delta = rest.merge_diff(old, new)
        got = merge_apply(copy.deepcopy(old), delta or {})
        assert got == new


# ---------------------------------------------------------------------------
# serialize
# ---------------------------------------------------------------------------


def _cluster(seed: int) -> tuple[APIServer, JaxAPIServer]:
    """Twin clusters of every kind, from one seed."""
    api, japi = APIServer(), JaxAPIServer()
    for kind in KINDS:
        for i in range(1 + seed % 3):
            obj, jobj_ = _twins(kind, 10 * seed + i)
            obj.metadata.name = jobj_.metadata.name = f"{kind.lower()}-{i}"
            api.create(kind, obj)
            japi.create(kind, jobj_)
    return api, japi


class TestSerialize:
    @pytest.mark.parametrize("seed", range(3))
    def test_dump_load_round_trips(self, seed):
        api, japi = _cluster(seed)
        dumped = serialize.dump_state(api)
        assert sorted(dumped) == KINDS
        back = serialize.load_state(json.loads(json.dumps(dumped)))
        # the load is a fresh server: versions are its own
        for objs in dumped.values():
            for o in objs:
                o["metadata"]["resource_version"] = 0
        again = serialize.dump_state(back)
        for objs in again.values():
            for o in objs:
                o["metadata"]["resource_version"] = 0
        assert again == dumped

    @pytest.mark.parametrize("seed", range(3))
    def test_the_dump_is_jax_s(self, seed):
        """The same cluster dumps as JAX's does; JAX's objects carry a
        deletion timestamp the port does not model."""
        api, japi = _cluster(seed)
        got, want = serialize.dump_state(api), jser.dump_state(japi)
        for objs in want.values():
            for o in objs:
                assert o["metadata"].pop("deletion_timestamp") is None
        assert got == want

    def test_unknown_kinds_are_skipped_and_garbage_refused(self):
        api = serialize.load_state({"Widget": [{"x": 1}]})
        assert api.kinds() == []
        with pytest.raises(ValueError, match="expected object"):
            serialize.load_state({KIND_POD: [{"metadata": "banana"}]})


# ---------------------------------------------------------------------------
# The admission handler
# ---------------------------------------------------------------------------


def _review(kind: str, obj: dict, op: str = "CREATE") -> bytes:
    return json.dumps({"request": {"uid": "u1", "kind": {"kind": kind},
                                   "operation": op, "object": obj}}).encode()


class TestAdmission:
    @pytest.mark.parametrize("case", [
        "allowed", "denied", "malformed", "delete", "undecodable",
        "mutated", "validate-only"])
    def test_reviews_answer_as_jax(self, case):
        def deny(api, obj):
            if obj.metadata.name == "bad":
                raise ValueError("quota already exists")

        def mutate(raw):
            return [{"op": "add", "path": "/metadata/labels/x",
                     "value": "y"}]

        answers = []
        for mod in (webhook, jwebhook):
            handler = mod.AdmissionHandler(api=None)
            handler.register("ElasticQuota", deny)
            if case in ("mutated", "validate-only"):
                handler.register_mutating("ElasticQuota", mutate)
            name = "bad" if case == "denied" else "ok"
            body = {"allowed": _review("ElasticQuota", {
                        "metadata": {"name": name}}),
                    "denied": _review("ElasticQuota", {
                        "metadata": {"name": name}}),
                    "malformed": b"{not json",
                    "delete": _review("ElasticQuota", {}, "DELETE"),
                    "undecodable": _review("ElasticQuota", {
                        "metadata": {"name": "ok"}, "spec": "banana"}),
                    "mutated": _review("ElasticQuota", {
                        "metadata": {"name": name}}),
                    "validate-only": _review("ElasticQuota", {
                        "metadata": {"name": name}})}[case]
            path = "/validate-eq" if case == "validate-only" else ""
            answers.append((handler.handle(body, path), handler.kinds))
        got, want = answers
        assert got == want
        allowed = got[0]["response"]["allowed"]
        assert allowed == (case in ("allowed", "delete", "mutated",
                                    "validate-only"))

    def test_the_client_collects_validators(self):
        client = rest.KubeClient(rest.KubeConfig(server="http://127.0.0.1:1"))
        peq.install_quota_webhooks(client)
        assert client.admission.kinds == sorted(
            [C.KIND_COMPOSITE_ELASTIC_QUOTA, C.KIND_ELASTIC_QUOTA])
