"""KubeClient, ``nos_tpu/kube/rest.py`` for the port: the APIServer's
method surface over a kube-apiserver's REST API, so the control plane
and the training main's pod hooks run against a real cluster from a
kubeconfig (the controller-runtime client every reference main builds).

- create, update, delete: POST, PUT and DELETE on the typed paths
  (``kube/k8s_codec.py`` translates JSON and dataclasses).
- ``patch(mutate=...)``: a JSON merge patch of exactly the fields the
  callback changed (the difference of the codec's encodings before and
  after), so fields the port does not model are never stripped.  A
  status change goes to the /status subresource; a pod gaining
  ``spec.nodeName`` goes through POST .../binding (the apiserver refuses
  to change nodeName by PUT or PATCH).
- ``watch(fn)``: an informer: the current objects replayed as ADDED
  synchronously, then a streaming thread that lists again on every
  (re)connect and diffs against what it delivered, so events raced
  between the list and the stream, or lost across a reconnect or a 410
  Gone, are recovered.
- ``register_admission``: collects the validator for the operator's
  AdmissionReview endpoint (``kube/webhook.py``); on a cluster the
  apiserver consults the webhook, with the same validator functions the
  in-memory substrate runs in-process.

Auth is a minimal kubeconfig: server, CA (file or data), bearer token or
client certificate (file or data).  ``KubeConfig.load`` reads YAML when
pyyaml is installed and JSON otherwise (a JSON kubeconfig is valid
YAML).
"""

from __future__ import annotations

import base64
import json
import logging
import ssl
import tempfile
import threading
import urllib.error
import urllib.request
from typing import Any, Callable

from nos_tpu_torch.kube.client import (
    KIND_POD, Conflict, NotFound, TransientAPIError, WatchFn,
)
from nos_tpu_torch.kube.k8s_codec import KIND_REST, from_k8s, rest_path, to_k8s
from nos_tpu_torch.kube.objects import Pod

logger = logging.getLogger(__name__)

# Kinds whose status lives behind the /status subresource (the CRDs
# declare it; Pod, Node and PDB have it natively).
_STATUS_SUBRESOURCE = {"Pod", "ElasticQuota", "CompositeElasticQuota",
                       "PodGroup", "PodDisruptionBudget", "Node"}


def merge_diff(old: Any, new: Any) -> Any:
    """The JSON merge patch (RFC 7386) turning ``old`` into ``new``; None
    when they are equal."""
    if not isinstance(old, dict) or not isinstance(new, dict):
        return new if new != old else None
    out = {}
    for key in new:
        if key not in old:
            out[key] = new[key]
        else:
            delta = merge_diff(old[key], new[key])
            if delta is not None:
                out[key] = delta
    for key in old:
        if key not in new:
            out[key] = None  # a merge patch's deletion
    return out or None


def _b64_file(data: str, suffix: str) -> str:
    tmp = tempfile.NamedTemporaryFile(suffix=suffix, delete=False,
                                      mode="wb")
    tmp.write(base64.b64decode(data))
    tmp.close()
    return tmp.name


def _read_kubeconfig(path: str) -> dict:
    with open(path) as f:
        text = f.read()
    try:
        import yaml
    except ImportError:
        return json.loads(text)
    return yaml.safe_load(text)


class KubeConfig:
    def __init__(self, server: str, token: str = "",
                 ca_file: str = "", insecure: bool = False,
                 client_cert_file: str = "",
                 client_key_file: str = "") -> None:
        self.server = server.rstrip("/")
        self.token = token
        self.ca_file = ca_file
        self.insecure = insecure
        self.client_cert_file = client_cert_file
        self.client_key_file = client_key_file

    @classmethod
    def load(cls, path: str) -> "KubeConfig":
        data = _read_kubeconfig(path)
        ctx_name = data.get("current-context", "")
        contexts = {c["name"]: c["context"]
                    for c in data.get("contexts") or []}
        ctx = contexts.get(ctx_name) or next(iter(contexts.values()), {})
        clusters = {c["name"]: c["cluster"]
                    for c in data.get("clusters") or []}
        users = {u["name"]: u["user"] for u in data.get("users") or []}
        cluster = clusters.get(ctx.get("cluster", "")) \
            or next(iter(clusters.values()), {})
        user = users.get(ctx.get("user", "")) \
            or next(iter(users.values()), {})
        ca_file = cluster.get("certificate-authority", "")
        if cluster.get("certificate-authority-data") and not ca_file:
            ca_file = _b64_file(
                cluster["certificate-authority-data"], ".crt")
        cert_file = user.get("client-certificate", "")
        if user.get("client-certificate-data") and not cert_file:
            cert_file = _b64_file(user["client-certificate-data"], ".crt")
        key_file = user.get("client-key", "")
        if user.get("client-key-data") and not key_file:
            key_file = _b64_file(user["client-key-data"], ".key")
        return cls(
            server=cluster.get("server", ""),
            token=user.get("token", ""),
            ca_file=ca_file,
            insecure=bool(cluster.get("insecure-skip-tls-verify", False)),
            client_cert_file=cert_file,
            client_key_file=key_file,
        )


class KubeClient:
    """The APIServer surface over kube-apiserver REST."""

    def __init__(self, config: KubeConfig, timeout_s: float = 10.0) -> None:
        from nos_tpu_torch.kube.webhook import AdmissionHandler

        self._cfg = config
        self._timeout = timeout_s
        self._watch_stop = threading.Event()
        self._watch_threads: list[threading.Thread] = []
        # the validators register_admission collects, for the operator's
        # AdmissionReview endpoint
        self.admission = AdmissionHandler(self)
        if config.server.startswith("https"):
            if config.insecure:
                self._ssl = ssl._create_unverified_context()
            else:
                self._ssl = ssl.create_default_context(
                    cafile=config.ca_file or None)
            if config.client_cert_file:
                self._ssl.load_cert_chain(
                    config.client_cert_file,
                    config.client_key_file or None)
        else:
            self._ssl = None

    @classmethod
    def from_kubeconfig(cls, path: str) -> "KubeClient":
        return cls(KubeConfig.load(path))

    # -- HTTP ---------------------------------------------------------------
    def _request(self, method: str, path: str, body: dict | None = None,
                 query: str = "", timeout: float | None = None,
                 content_type: str = "application/json"):
        url = self._cfg.server + path + (f"?{query}" if query else "")
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Accept", "application/json")
        if body is not None:
            req.add_header("Content-Type", content_type)
        if self._cfg.token:
            req.add_header("Authorization", f"Bearer {self._cfg.token}")
        try:
            return urllib.request.urlopen(
                req, timeout=timeout or self._timeout, context=self._ssl)
        except urllib.error.HTTPError as e:
            if e.code == 404:
                raise NotFound(path) from None
            if e.code == 409:
                raise Conflict(path) from None
            detail = e.read().decode(errors="replace")[:500]
            if e.code >= 500 or e.code == 429:
                # server-side and overload failures are retried
                # (utils/retry.py); a 4xx request error is not
                raise TransientAPIError(
                    f"{method} {path} -> HTTP {e.code}: {detail}") from None
            raise RuntimeError(
                f"{method} {path} -> HTTP {e.code}: {detail}") from None

    def _json(self, method: str, path: str, body: dict | None = None,
              query: str = "", content_type: str = "application/json"):
        with self._request(method, path, body, query,
                           content_type=content_type) as resp:
            return json.load(resp)

    # -- CRUD (the APIServer surface) ----------------------------------------
    def create(self, kind: str, obj: Any) -> Any:
        ns = getattr(obj.metadata, "namespace", "")
        data = self._json("POST", rest_path(kind, ns), to_k8s(kind, obj))
        return from_k8s(kind, data)

    def get(self, kind: str, name: str, namespace: str = "") -> Any:
        data = self._json("GET", rest_path(kind, namespace, name))
        return from_k8s(kind, data)

    def try_get(self, kind: str, name: str, namespace: str = "") -> Any | None:
        try:
            return self.get(kind, name, namespace)
        except NotFound:
            return None

    def update(self, kind: str, obj: Any) -> Any:
        ns = getattr(obj.metadata, "namespace", "")
        data = self._json("PUT", rest_path(kind, ns, obj.metadata.name),
                          to_k8s(kind, obj))
        return from_k8s(kind, data)

    _MERGE = "application/merge-patch+json"

    def patch(self, kind: str, name: str, namespace: str = "",
              mutate: Callable[[Any], None] | None = None) -> Any:
        """Merge-patch exactly the fields ``mutate`` changed: a pod's new
        ``spec.nodeName`` by POST .../binding, a status change by PATCH
        on /status, the rest by PATCH on the object."""
        obj = self.get(kind, name, namespace)
        before = to_k8s(kind, obj)
        if mutate is not None:
            mutate(obj)
        after = to_k8s(kind, obj)
        delta = merge_diff(before, after) or {}
        meta_delta = delta.get("metadata")
        if meta_delta:  # label and annotation changes, not the version
            for noise in ("resourceVersion", "uid", "creationTimestamp"):
                meta_delta.pop(noise, None)
            if not meta_delta:
                delta.pop("metadata")

        path = rest_path(kind, namespace, name)
        if kind == KIND_POD:
            spec_delta = delta.get("spec") or {}
            node_name = spec_delta.pop("nodeName", None)
            if not spec_delta:
                delta.pop("spec", None)
            if node_name:
                self._json("POST", f"{path}/binding", {
                    "apiVersion": "v1", "kind": "Binding",
                    "metadata": {"name": name, "namespace": namespace},
                    "target": {"apiVersion": "v1", "kind": "Node",
                               "name": node_name},
                })
        status_delta = None
        if kind in _STATUS_SUBRESOURCE:
            status_delta = delta.pop("status", None)
        result = None
        if delta:
            result = self._json("PATCH", path, delta,
                                content_type=self._MERGE)
        if status_delta is not None:
            result = self._json("PATCH", f"{path}/status",
                                {"status": status_delta},
                                content_type=self._MERGE)
        if result is not None:
            return from_k8s(kind, result)
        # a binding alone (or nothing): one GET for the server's view
        return self.get(kind, name, namespace)

    def delete(self, kind: str, name: str, namespace: str = "") -> None:
        with self._request("DELETE", rest_path(kind, namespace, name)):
            pass

    def list(self, kind: str, namespace: str | None = None,
             label_selector: dict[str, str] | None = None,
             filter_fn: Callable[[Any], bool] | None = None) -> list[Any]:
        query = ""
        if label_selector:
            sel = ",".join(f"{k}={v}" for k, v in label_selector.items())
            query = f"labelSelector={urllib.request.quote(sel)}"
        data = self._json("GET", rest_path(kind, namespace or ""),
                          query=query)
        out = [from_k8s(kind, item) for item in data.get("items") or []]
        if namespace is not None:
            out = [o for o in out
                   if getattr(o.metadata, "namespace", "") == namespace]
        if filter_fn is not None:
            out = [o for o in out if filter_fn(o)]
        return out

    # -- watch --------------------------------------------------------------
    def watch(self, kind: str, fn: WatchFn,
              selector=None) -> Callable[[], None]:
        """Replay the current objects as ADDED synchronously, then
        stream; every (re)connect lists again and diffs against what was
        delivered (synthetic ADDED, MODIFIED and DELETED), and only a
        strictly newer resource version is forwarded.  Returns the
        unsubscribe function.

        ``selector`` filters delivered objects on the client (the
        in-memory substrate's field selector); an object that stops
        matching gets no synthetic DELETED, so select only on fields
        that do not change while the object matters, such as a pod's
        ``spec.node_name``."""
        stop = threading.Event()
        # (namespace, name) -> the resource version delivered
        known: dict[tuple[str, str], int] = {}

        def obj_key(obj) -> tuple[str, str]:
            return (getattr(obj.metadata, "namespace", ""),
                    obj.metadata.name)

        def deliver(event: str, obj) -> None:
            if selector is not None and not selector(obj):
                return
            key = obj_key(obj)
            if event == "DELETED":
                known.pop(key, None)
                fn(event, obj)
                return
            rv = obj.metadata.resource_version
            prev = known.get(key)
            if prev is None:
                known[key] = rv
                fn("ADDED", obj)
            elif rv > prev:
                # a reconnecting stream can replay events older than
                # what sync() delivered: forwarding them would take the
                # watcher back to a stale state
                known[key] = rv
                fn("MODIFIED", obj)

        def sync() -> str:
            """List, diff against ``known``; returns the list's version."""
            listing = self._json("GET", rest_path(kind, ""))
            seen: set[tuple[str, str]] = set()
            for item in listing.get("items") or []:
                obj = from_k8s(kind, item)
                seen.add(obj_key(obj))
                deliver("MODIFIED", obj)
            for ns, name in [k for k in known if k not in seen]:
                deliver("DELETED", from_k8s(
                    kind, {"metadata": {"name": name, "namespace": ns}}))
            return str((listing.get("metadata") or {})
                       .get("resourceVersion", ""))

        rv = sync()  # the informer's synchronous initial replay

        def pump() -> None:
            from nos_tpu_torch.utils.retry import Backoff

            # a down or overloaded apiserver is not hammered by every
            # watcher in a tight loop; reset after a connect and sync
            backoff = Backoff(base_s=0.5, cap_s=30.0)
            last_rv = rv
            while not stop.is_set() and not self._watch_stop.is_set():
                try:
                    q = "watch=true" + (
                        f"&resourceVersion={last_rv}" if last_rv else "")
                    with self._request("GET", rest_path(kind, ""),
                                       query=q, timeout=330.0) as resp:
                        # the stream is registered once the headers
                        # arrived: a sync now recovers what happened
                        # since the previous list
                        last_rv = sync()
                        backoff.reset()
                        for line in resp:
                            if stop.is_set():
                                return
                            if not line.strip():
                                continue
                            evt = json.loads(line)
                            if evt.get("type") == "ERROR":
                                break  # e.g. 410 Gone: reconnect and sync
                            obj = from_k8s(kind, evt.get("object") or {})
                            deliver(evt.get("type", "MODIFIED"), obj)
                except (OSError, ValueError, NotFound, Conflict,
                        RuntimeError) as e:
                    if stop.is_set() or self._watch_stop.is_set():
                        return
                    delay = backoff.next_delay()
                    logger.debug("watch %s reconnect in %.1fs: %s",
                                 kind, delay, e)
                    stop.wait(delay)

        t = threading.Thread(target=pump, name=f"watch-{kind}", daemon=True)
        t.start()
        self._watch_threads.append(t)
        return stop.set

    def close(self) -> None:
        self._watch_stop.set()

    # -- field-index views (APIServer parity) --------------------------------
    def kinds(self) -> list[str]:
        return [k for k in KIND_REST if self.list(k)]

    def pods_by_phase(self, phase: str) -> list[Pod]:
        return self.list(KIND_POD,
                         filter_fn=lambda p: p.status.phase == phase)

    def pods_on_node(self, node_name: str) -> list[Pod]:
        return self.list(
            KIND_POD, filter_fn=lambda p: p.spec.node_name == node_name)

    def register_admission(self, kind: str, fn) -> None:
        """Collect a validator for the AdmissionReview endpoint: a
        KubeClient cannot intercept writes, the apiserver consults the
        webhook."""
        self.admission.register(kind, fn)
