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
        assert client.admission.kinds == sorted(
            [C.KIND_COMPOSITE_ELASTIC_QUOTA, C.KIND_ELASTIC_QUOTA])
