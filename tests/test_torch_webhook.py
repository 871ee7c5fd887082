"""The port's AdmissionReview endpoint (``kube/webhook.WebhookServer``)
held to the JAX package's: ``tests/test_webhook.py``'s server cases, in
plain HTTP (``allow_insecure``) and over TLS with a throwaway
certificate, posting the same reviews to both packages' servers, each
over its own store holding the same quotas (the port's in
``nos.nebuly.com/gpu-memory`` GB where JAX's count ``google.com/tpu``
chips); the refusal to start without a certificate; and the operator
main's endpoint."""

from __future__ import annotations

import json
import shutil
import ssl
import subprocess
import urllib.error
import urllib.request

import pytest

from nos_tpu.api import elasticquota as jeq
from nos_tpu.kube import client as jclient
from nos_tpu.kube import k8s_codec as jcodec
from nos_tpu.kube import webhook as jwebhook
from nos_tpu_torch.api import constants as C
from nos_tpu_torch.api import elasticquota as peq
from nos_tpu_torch.kube import client as pclient
from nos_tpu_torch.kube import k8s_codec as pcodec
from nos_tpu_torch.kube import webhook as pwebhook

# package -> (webhook, codec, client, quota module, quota resource, units)
PACKAGES = {
    "port": (pwebhook, pcodec, pclient, peq, C.RESOURCE_GPU_MEMORY, 20),
    "jax": (jwebhook, jcodec, jclient, jeq, "google.com/tpu", 1),
}


def review(kind: str, obj: dict, uid: str = "uid-1",
           operation: str = "CREATE") -> bytes:
    return json.dumps({
        "apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
        "request": {"uid": uid, "operation": operation,
                    "kind": {"group": "nos.nebuly.com", "version": "v1alpha1",
                             "kind": kind},
                    "object": obj},
    }).encode()


def eq_json(pkg: str, name: str, namespace: str, units: int = 4) -> dict:
    res, scale = PACKAGES[pkg][4], PACKAGES[pkg][5]
    return {"metadata": {"name": name, "namespace": namespace},
            "spec": {"min": {res: units * scale}}}


def ceq_json(pkg: str, name: str, namespaces: list[str]) -> dict:
    res, scale = PACKAGES[pkg][4], PACKAGES[pkg][5]
    return {"metadata": {"name": name, "namespace": "default"},
            "spec": {"namespaces": namespaces, "min": {res: 8 * scale}}}


def make_handler(pkg: str):
    """A handler over a store where team-a has an ElasticQuota and
    team-c, team-d are governed by a CompositeElasticQuota."""
    webhook, codec, client, quota = PACKAGES[pkg][:4]
    api = client.APIServer()
    api.create(client.KIND_ELASTIC_QUOTA, codec.from_k8s(
        client.KIND_ELASTIC_QUOTA, eq_json(pkg, "quota-a", "team-a")))
    api.create(client.KIND_COMPOSITE_ELASTIC_QUOTA, codec.from_k8s(
        client.KIND_COMPOSITE_ELASTIC_QUOTA,
        ceq_json(pkg, "comp-cd", ["team-c", "team-d"])))
    h = webhook.AdmissionHandler(api)
    h.register(client.KIND_ELASTIC_QUOTA, quota.validate_elastic_quota)
    h.register(client.KIND_COMPOSITE_ELASTIC_QUOTA,
               quota.validate_composite_elastic_quota)
    return api, h


def _post(url: str, body: bytes, ctx=None) -> dict:
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10, context=ctx) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    if shutil.which("openssl") is None:
        pytest.skip("no openssl to make a throwaway certificate")
    tmp = tmp_path_factory.mktemp("certs")
    crt, key = tmp / "tls.crt", tmp / "tls.key"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", str(key), "-out", str(crt), "-days", "1",
         "-subj", "/CN=localhost",
         "-addext", "subjectAltName=DNS:localhost"],
        check=True, capture_output=True)
    return str(crt), str(key)


def serve(pkg: str, transport: str, certs_fn):
    """A started server of ``pkg`` over ``transport``; (server, scheme,
    ssl context)."""
    webhook = PACKAGES[pkg][0]
    _, handler = make_handler(pkg)
    if transport == "https":
        crt, key = certs_fn()
        server = webhook.WebhookServer(handler, host="127.0.0.1", port=0,
                                       cert_file=crt, key_file=key)
        ctx = ssl.create_default_context(cafile=crt)
        ctx.check_hostname = False
    else:
        server = webhook.WebhookServer(handler, host="127.0.0.1", port=0,
                                       allow_insecure=True)
        ctx = None
    server.start()
    return server, ("https" if transport == "https" else "http"), ctx


@pytest.mark.parametrize("transport", ["insecure", "https"])
class TestWebhookServer:
    def _both(self, request, transport, drive):
        """``drive(pkg, base_url, ctx)`` against each package's server;
        the answers must be equal."""
        certs_fn = lambda: request.getfixturevalue("certs")  # noqa: E731
        answers = {}
        for pkg in PACKAGES:
            server, scheme, ctx = serve(pkg, transport, certs_fn)
            try:
                answers[pkg] = drive(
                    pkg, f"{scheme}://127.0.0.1:{server.port}", ctx)
            finally:
                server.stop()
        assert answers["port"] == answers["jax"]
        return answers["port"]

    def test_post_enforces_rules(self, request, transport):
        def drive(pkg, base, ctx):
            url = f"{base}/validate-elasticquota"
            ok = _post(url, review("ElasticQuota",
                                   eq_json(pkg, "quota-b", "team-b")), ctx)
            dup = _post(url, review("ElasticQuota",
                                    eq_json(pkg, "dup", "team-a")), ctx)
            overlap = _post(
                f"{base}/validate-compositeelasticquota",
                review("CompositeElasticQuota",
                       ceq_json(pkg, "comp-2", ["team-c"])), ctx)
            return [ok, dup, overlap]

        ok, dup, overlap = self._both(request, transport, drive)
        assert ok["response"]["allowed"] is True
        assert dup["response"]["allowed"] is False
        assert dup["response"]["status"]["code"] == 403
        assert overlap["response"]["allowed"] is False

    def test_health_endpoints(self, request, transport):
        def drive(pkg, base, ctx):
            out = []
            for path in ("/healthz", "/readyz"):
                with urllib.request.urlopen(f"{base}{path}", timeout=10,
                                            context=ctx) as r:
                    out.append((r.status, r.read()))
            return out

        assert self._both(request, transport, drive) == [(200, b"ok")] * 2

    def test_unknown_paths_are_404(self, request, transport):
        def drive(pkg, base, ctx):
            codes = []
            for method, path in (("POST", "/other"), ("GET", "/other")):
                req = urllib.request.Request(
                    f"{base}{path}", method=method,
                    data=b"{}" if method == "POST" else None)
                with pytest.raises(urllib.error.HTTPError) as e:
                    urllib.request.urlopen(req, timeout=10, context=ctx)
                codes.append(e.value.code)
            return codes

        assert self._both(request, transport, drive) == [404, 404]


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_refuses_to_start_without_a_cert(pkg):
    _, handler = make_handler(pkg)
    server = PACKAGES[pkg][0].WebhookServer(handler, host="127.0.0.1",
                                            port=0)
    with pytest.raises(ValueError, match="requires TLS"):
        server.start()


class TestOperatorServesWebhook:
    def test_operator_main_serves_admission(self):
        """The operator main with webhook_port 0 serves nothing; its
        helper serves the production validators (plain HTTP here, as
        JAX's test drives it)."""
        from nos_tpu.api.config import OperatorConfig as JaxOperatorConfig
        from nos_tpu.cmd import operator as joperator
        from nos_tpu_torch.api.config import OperatorConfig
        from nos_tpu_torch.cmd import operator as poperator

        answers = {}
        for pkg, operator, cfg_cls in (
                ("port", poperator, OperatorConfig),
                ("jax", joperator, JaxOperatorConfig)):
            codec, client = PACKAGES[pkg][1], PACKAGES[pkg][2]
            api = client.APIServer()
            api.create(client.KIND_ELASTIC_QUOTA, codec.from_k8s(
                client.KIND_ELASTIC_QUOTA, eq_json(pkg, "held", "team-a")))
            cfg = cfg_cls(leader_election=False, webhook_port=0)
            main = operator.build_operator_main(api, cfg)
            assert not hasattr(main, "webhook")
            server = operator._serve_admission_webhook(api, cfg)
            try:
                url = f"http://127.0.0.1:{server.port}/validate-elasticquota"
                answers[pkg] = _post(url, review(
                    "ElasticQuota", eq_json(pkg, "dup", "team-a")))
            finally:
                server.stop()
        assert answers["port"] == answers["jax"]
        assert answers["port"]["response"]["allowed"] is False

    def test_operator_over_rest_with_no_port_warns_unenforced(self, caplog):
        """Over a KubeClient with webhook_port 0 the validators are
        collected and nothing serves them: JAX's loud warning."""
        import logging

        from nos_tpu_torch.api.config import OperatorConfig
        from nos_tpu_torch.cmd.operator import build_operator_main
        from nos_tpu_torch.kube.rest import KubeClient, KubeConfig

        from k8s_stub import StubApiServer

        with StubApiServer() as stub:
            client = KubeClient(KubeConfig(server=stub.url))
            try:
                with caplog.at_level(logging.WARNING,
                                     logger="nos_tpu_torch.cmd.operator"):
                    build_operator_main(client, OperatorConfig())
            finally:
                client.close()
        assert any("quota admission is UNENFORCED" in r.getMessage()
                   for r in caplog.records)
        # the quota validators and, as JAX's operator registers it, the
        # pods' mesh mutator
        assert client.admission.kinds == sorted(
            [C.KIND_COMPOSITE_ELASTIC_QUOTA, C.KIND_ELASTIC_QUOTA, "Pod"])


# ---------------------------------------------------------------------------
# Mesh normalization (tests/test_mesh_normalization.py)
# ---------------------------------------------------------------------------

def _mesh_pods(n: int, mesh: str | None, name: str = "p", **kw):
    """The same generic request on both packages: (JAX pod, port pod)."""
    from nos_tpu.api import constants as JC
    from nos_tpu.testing import factory as jf
    from nos_tpu_torch.testing import factory as pf

    jpod = jf.make_pod(name=name, resources={JC.RESOURCE_TPU: n, "cpu": 1.0},
                       annotations={JC.ANNOT_MESH: mesh} if mesh else {},
                       **kw)
    ppod = pf.make_pod(name=name, resources={C.RESOURCE_GPU: n, "cpu": 1.0},
                       annotations={C.ANNOT_MESH: mesh} if mesh else {},
                       **kw)
    return jpod, ppod


def _mapped_res(res: dict) -> dict:
    """JAX's resource names as the port's."""
    out = {}
    for k, v in res.items():
        if k.startswith("nos.tpu/slice-"):
            k = "nos.nebuly.com/nvlink-block-" + k[len("nos.tpu/slice-"):]
        elif k == "google.com/tpu":
            k = C.RESOURCE_GPU
        out[k] = v
    return out


def _raw(pkg: str, n=8, mesh="2x4", sections=("limits", "requests")):
    res_name = C.RESOURCE_GPU if pkg == "port" else "google.com/tpu"
    key = C.ANNOT_MESH if pkg == "port" else "nos.tpu/mesh"
    res = {s: {res_name: str(n), "cpu": "1"} for s in sections}
    return {"metadata": {"name": "p", "namespace": "default",
                         "annotations": {key: mesh}},
            "spec": {"containers": [
                {"name": "main", "resources": res,
                 "volumeMounts": [{"name": "x", "mountPath": "/x"}]}],
                "nodeSelector": {"pool": "gpu"}}}


def _apply_ops(ops, doc):
    """A minimal RFC 6902 evaluator for the op shapes emitted."""
    doc = json.loads(json.dumps(doc))
    for op in ops:
        parts = [p.replace("~1", "/").replace("~0", "~")
                 for p in op["path"].split("/")[1:]]
        cur = doc
        for p in parts[:-1]:
            cur = cur[int(p)] if isinstance(cur, list) else cur[p]
        if op["op"] == "remove":
            del cur[parts[-1]]
        elif op["op"] == "add":
            cur[parts[-1]] = op["value"]
    return doc


def _mapped_ops(ops):
    if ops is None:
        return None
    return [{**o, "path": o["path"].replace(
        "nos.tpu~1slice-", "nos.nebuly.com~1nvlink-block-").replace(
        "google.com~1tpu", "nvidia.com~1gpu")} for o in ops]


class TestMeshNormalizeObject:
    def test_rewrites_matching_mesh(self):
        from nos_tpu.api.mesh import normalize_mesh_request as jax_norm
        from nos_tpu_torch.api.mesh import normalize_mesh_request

        jpod, ppod = _mesh_pods(8, "2x4")
        assert jax_norm(jpod) and normalize_mesh_request(ppod)
        res = ppod.spec.containers[0].resources
        assert res == _mapped_res(jpod.spec.containers[0].resources)
        assert res["nos.nebuly.com/nvlink-block-2x4"] == 1
        assert C.RESOURCE_GPU not in res

    def test_the_order_is_nodes_then_gpus(self):
        """JAX sorts an ICI shape ("4x2" -> 2x4); the port keeps the
        mesh's order: 4 nodes of 2 GPUs."""
        from nos_tpu.api.mesh import normalize_mesh_request as jax_norm
        from nos_tpu_torch.api.mesh import normalize_mesh_request

        jpod, ppod = _mesh_pods(8, "4x2")
        assert jax_norm(jpod) and normalize_mesh_request(ppod)
        assert "nos.tpu/slice-2x4" in jpod.spec.containers[0].resources
        assert "nos.nebuly.com/nvlink-block-4x2" in \
            ppod.spec.containers[0].resources

    @pytest.mark.parametrize("mesh,n", [
        ("2x4", 4),        # GPU count mismatch
        ("banana", 8),     # unparseable
        (None, 8),         # no annotation
    ])
    def test_ineligible_left_alone(self, mesh, n):
        from nos_tpu.api.mesh import normalize_mesh_request as jax_norm
        from nos_tpu_torch.api.mesh import normalize_mesh_request

        jpod, ppod = _mesh_pods(n, mesh)
        assert not jax_norm(jpod) and not normalize_mesh_request(ppod)
        assert ppod.spec.containers[0].resources[C.RESOURCE_GPU] == n

    @pytest.mark.parametrize("mesh,n", [("1x8", 8), ("2x2x2", 8),
                                        ("2x0", 0)])
    def test_only_a_block_of_whole_nodes_is_carved(self, mesh, n):
        """The port's rule: two dims, at least two nodes (a one-node
        request is the per-node planner's, and a mesh of three dims names
        no nodes)."""
        from nos_tpu_torch.api.mesh import (
            mesh_patch_ops, normalize_mesh_request,
        )

        _, ppod = _mesh_pods(n, mesh)
        assert not normalize_mesh_request(ppod)
        assert mesh_patch_ops(_raw("port", n=n, mesh=mesh)) is None

    def test_explicit_request_wins(self):
        from nos_tpu.api.mesh import normalize_mesh_request as jax_norm
        from nos_tpu.testing import factory as jf
        from nos_tpu_torch.api.mesh import normalize_mesh_request
        from nos_tpu_torch.testing import factory as pf

        jpod = jf.make_slice_pod("2x2", 1, name="explicit",
                                 annotations={"nos.tpu/mesh": "2x2"})
        assert not jax_norm(jpod)
        for ppod in (pf.make_mig_pod("3g.40gb", 1, name="explicit",
                                     annotations={C.ANNOT_MESH: "2x2"}),
                     pf.make_pod(name="explicit", resources={
                         "nos.nebuly.com/nvlink-block-2x2": 1,
                         C.RESOURCE_GPU: 4},
                         annotations={C.ANNOT_MESH: "2x2"})):
            assert not normalize_mesh_request(ppod)

    def test_admission_hook_applies_on_create(self):
        from nos_tpu.api.mesh import (
            install_mesh_normalization as jax_install,
        )
        from nos_tpu.kube.client import APIServer as JaxAPIServer
        from nos_tpu_torch.api.mesh import install_mesh_normalization

        japi, api = JaxAPIServer(), pclient.APIServer()
        jax_install(japi)
        install_mesh_normalization(api)
        jpod, ppod = _mesh_pods(8, "2x4")
        japi.create("Pod", jpod)
        api.create(pclient.KIND_POD, ppod)
        got = api.get(pclient.KIND_POD, "p", "default")
        want = japi.get("Pod", "p", "default")
        assert got.spec.containers[0].resources == \
            _mapped_res(want.spec.containers[0].resources)

    def test_the_operator_main_installs_it(self):
        from nos_tpu_torch.api.config import OperatorConfig
        from nos_tpu_torch.cmd.operator import build_operator_main

        api = pclient.APIServer()
        build_operator_main(api, OperatorConfig())
        api.create(pclient.KIND_POD, _mesh_pods(16, "2x8")[1])
        assert api.get(pclient.KIND_POD, "p", "default").spec.containers[
            0].resources == {"nos.nebuly.com/nvlink-block-2x8": 1,
                             "cpu": 1.0}


class TestMeshPatchOps:
    def test_ops_rewrite_both_sections_only(self):
        from nos_tpu.api.mesh import mesh_patch_ops as jax_ops
        from nos_tpu_torch.api.mesh import mesh_patch_ops

        raw = _raw("port")
        ops = mesh_patch_ops(raw)
        assert ops == _mapped_ops(jax_ops(_raw("jax")))
        assert len(ops) == 4
        out = _apply_ops(ops, raw)
        for section in ("limits", "requests"):
            sec = out["spec"]["containers"][0]["resources"][section]
            assert C.RESOURCE_GPU not in sec
            assert sec["nos.nebuly.com/nvlink-block-2x4"] == "1"
            assert sec["cpu"] == "1"
        assert out["spec"]["nodeSelector"] == {"pool": "gpu"}
        assert out["spec"]["containers"][0]["volumeMounts"]

    def test_limits_only_pod(self):
        from nos_tpu.api.mesh import mesh_patch_ops as jax_ops
        from nos_tpu_torch.api.mesh import mesh_patch_ops

        ops = mesh_patch_ops(_raw("port", sections=("limits",)))
        assert ops == _mapped_ops(jax_ops(_raw("jax", sections=("limits",))))
        assert len(ops) == 2

    def test_mismatch_returns_none(self):
        from nos_tpu.api.mesh import mesh_patch_ops as jax_ops
        from nos_tpu_torch.api.mesh import mesh_patch_ops

        for kw in ({"n": 4}, {"mesh": "3x3"}):
            assert mesh_patch_ops(_raw("port", **kw)) is None
            assert jax_ops(_raw("jax", **kw)) is None
        raw, jraw = _raw("port"), _raw("jax")
        raw["spec"]["containers"][0]["resources"]["limits"][
            "nvidia.com/mig-1g.10gb"] = "1"
        jraw["spec"]["containers"][0]["resources"]["limits"][
            "nos.tpu/slice-1x1"] = "1"
        assert mesh_patch_ops(raw) is None and jax_ops(jraw) is None

    def test_webhook_returns_jsonpatch(self):
        import base64

        from nos_tpu_torch.api.mesh import mesh_patch_ops

        h = pwebhook.AdmissionHandler(pclient.APIServer())
        h.register_mutating("Pod", mesh_patch_ops)
        resp = h.handle(json.dumps({
            "request": {"uid": "u1", "operation": "CREATE",
                        "kind": {"kind": "Pod"}, "object": _raw("port")},
        }).encode())["response"]
        assert resp["allowed"] is True
        assert resp["patchType"] == "JSONPatch"
        ops = json.loads(base64.b64decode(resp["patch"]))
        assert ops == mesh_patch_ops(_raw("port"))

    def test_init_container_gpu_disqualifies(self):
        from nos_tpu.api.mesh import mesh_patch_ops as jax_ops
        from nos_tpu_torch.api.mesh import mesh_patch_ops

        raw, jraw = _raw("port"), _raw("jax")
        raw["spec"]["initContainers"] = [
            {"name": "warm", "resources": {"limits": {C.RESOURCE_GPU: "8"}}}]
        jraw["spec"]["initContainers"] = [
            {"name": "warm", "resources": {"limits": {"google.com/tpu": "8"}}}]
        assert mesh_patch_ops(raw) is None and jax_ops(jraw) is None

    def test_undecodable_pod_passes_mutate_only_path(self):
        from nos_tpu_torch.api.mesh import mesh_patch_ops

        raw = _raw("port")
        raw["spec"]["containers"][0]["resources"]["limits"]["memory"] = "1Pi"
        h = pwebhook.AdmissionHandler(pclient.APIServer())
        h.register_mutating("Pod", mesh_patch_ops)
        resp = h.handle(json.dumps({
            "request": {"uid": "u", "kind": {"kind": "Pod"},
                        "object": raw}}).encode())["response"]
        assert resp["allowed"] is True

    def test_broken_mutator_does_not_block_the_write(self):
        h = pwebhook.AdmissionHandler(pclient.APIServer())
        h.register_mutating("Pod", lambda raw: 1 / 0)
        resp = h.handle(json.dumps({
            "request": {"uid": "u", "kind": {"kind": "Pod"},
                        "object": _raw("port")}}).encode())["response"]
        assert resp["allowed"] is True
        assert "patch" not in resp


class TestMeshEndToEnd:
    def test_mesh_gang_is_carved_and_binds(self, monkeypatch):
        """A two-member gang asking for generic GPUs with a mesh is
        normalized at create on both packages, the partitioner carves
        the block (JAX's 4x4 over two v5e hosts, the port's 2x8 over two
        8-GPU nodes), and both members bind to the same nodes."""
        from nos_tpu.api.mesh import (
            install_mesh_normalization as jax_install,
        )
        from nos_tpu_torch.api.mesh import install_mesh_normalization

        from test_torch_multihost import Twin

        t = Twin(monkeypatch, 2, loop=True)
        jax_install(t.japi)
        install_mesh_normalization(t.api)
        t.group("job", 2)
        for i in range(2):
            jpod, _ = _mesh_pods(16, "4x4", name=f"job-{i}",
                                 labels={"nos.tpu/pod-group": "job"})
            _, ppod = _mesh_pods(16, "2x8", name=f"job-{i}",
                                 labels={C.LABEL_POD_GROUP: "job"})
            t.japi.create("Pod", jpod)
            t.api.create(pclient.KIND_POD, ppod)
        assert t.converge() == 2
        assert sorted(t.node_of(f"job-{i}") for i in range(2)) == \
            ["host-0", "host-1"]
        assert t.members(False) == {"host-0": "2x8", "host-1": "2x8"}
