"""Admission reviews and their HTTPS endpoint, ``nos_tpu/kube/webhook.py``
for the port.

On the in-memory substrate admission runs in-process (the APIServer's
``register_admission``).  On a real cluster the kube-apiserver POSTs an
AdmissionReview (v1) whose ``request.object`` is the raw kind JSON to
the operator's endpoint: ``AdmissionHandler`` decodes it with the REST
client's codec, runs every validator registered for the kind and
answers allowed or denied with the validator's message, so both
substrates enforce the same rules.  It fails closed: a review it cannot
parse is denied.  ``KubeClient.register_admission`` collects the
validators here.  ``WebhookServer`` serves the handler over HTTPS for
the operator's main.
"""

from __future__ import annotations

import base64
import json
import logging
import ssl
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

from .k8s_codec import from_k8s

logger = logging.getLogger(__name__)


def review_response(uid: str, allowed: bool, message: str = "",
                    patch_ops: list | None = None) -> dict:
    resp: dict = {"uid": uid, "allowed": allowed}
    if message:
        resp["status"] = {"message": message, "code": 403}
    if patch_ops:
        resp["patchType"] = "JSONPatch"
        resp["patch"] = base64.b64encode(
            json.dumps(patch_ops).encode()).decode()
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "response": resp}


class AdmissionHandler:
    """Request to response admission logic, without a transport."""

    def __init__(self, api) -> None:
        self._api = api
        self._validators: dict[str, list[Callable]] = {}
        self._mutators: dict[str, list[Callable]] = {}

    def register(self, kind: str, fn: Callable) -> None:
        self._validators.setdefault(kind, []).append(fn)

    def register_mutating(self, kind: str, fn: Callable) -> None:
        """``fn(raw_object_dict)`` -> an RFC 6902 op list or None.
        Mutators work on the raw JSON, so fields the codec does not
        model are never touched; their ops go back as the review's
        JSONPatch."""
        self._mutators.setdefault(kind, []).append(fn)

    @property
    def kinds(self) -> list[str]:
        return sorted(set(self._validators) | set(self._mutators))

    def handle(self, body: bytes, path: str = "") -> dict:
        """``path`` routes the review as the webhook configuration wires
        it: a /validate-* URL runs only validators, /mutate-* only
        mutators, "" (in-process use) both.  The apiserver POSTs the
        same kind to both endpoints and expects a patch only from the
        mutating one."""
        run_validators = not path or path.startswith("/validate")
        run_mutators = not path or path.startswith("/mutate")
        uid = ""
        try:
            review = json.loads(body)
            request = review["request"]
            uid = request.get("uid", "")
            kind = request["kind"]["kind"]
            operation = request.get("operation", "CREATE")
            if operation == "DELETE":
                return review_response(uid, True)
            raw = request["object"]
        except Exception as e:  # noqa: BLE001 — malformed review: deny
            logger.warning("admission: malformed review rejected (%s)", e)
            return review_response(uid, False, f"malformed AdmissionReview: {e}")
        validators = (self._validators.get(kind, [])
                      if run_validators else [])
        if validators:
            # a validated kind the codec cannot decode cannot be
            # validated: denied.  Mutate-only kinds never decode.
            try:
                obj = from_k8s(kind, raw)
            except Exception as e:  # noqa: BLE001
                logger.warning("admission: undecodable %s rejected (%s)",
                               kind, e)
                return review_response(uid, False,
                                       f"undecodable {kind}: {e}")
            for fn in validators:
                try:
                    fn(self._api, obj)
                except Exception as e:  # noqa: BLE001 — a verdict or a
                    # bug: both deny
                    return review_response(uid, False, str(e))
        ops: list = []
        for fn in (self._mutators.get(kind, []) if run_mutators else []):
            try:
                ops.extend(fn(raw) or [])
            except Exception as e:  # noqa: BLE001 — a broken mutator
                # passes the object through unchanged (failurePolicy
                # Ignore)
                logger.warning("admission: mutator for %s failed (%s); "
                               "object passed through unchanged", kind, e)
        return review_response(uid, True, patch_ops=ops or None)


class WebhookServer:
    """The HTTPS AdmissionReview endpoint around an ``AdmissionHandler``.

    ``cert_file`` and ``key_file`` hold the serving certificate the chart
    provisions (its ValidatingWebhookConfiguration's caBundle carries the
    CA).  Without one it refuses to start unless ``allow_insecure=True``
    (tests): the kube-apiserver talks TLS only, so an empty cert dir
    must fail at once rather than serve admission in cleartext."""

    def __init__(self, handler: AdmissionHandler, host: str = "0.0.0.0",
                 port: int = 9443, cert_file: str | None = None,
                 key_file: str | None = None,
                 allow_insecure: bool = False) -> None:
        self._handler = handler
        self._host, self._port = host, port
        self._cert, self._key = cert_file, key_file
        self._allow_insecure = allow_insecure
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        """The bound port (0 resolved to the kernel's pick by start())."""
        return self._httpd.server_address[1] if self._httpd else self._port

    def start(self) -> None:
        if not self._cert and not self._allow_insecure:
            raise ValueError(
                "WebhookServer without a serving cert: the kube-apiserver "
                "requires TLS — set webhook_cert_dir (the chart mounts "
                "tls.crt/tls.key) or pass allow_insecure=True in tests")
        handler = self._handler

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self) -> None:  # noqa: N802 — stdlib naming
                if not (self.path.startswith("/validate")
                        or self.path.startswith("/mutate")):
                    self.send_error(404)
                    return
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                resp = json.dumps(handler.handle(body, self.path)).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(resp)))
                self.end_headers()
                self.wfile.write(resp)

            def do_GET(self) -> None:  # noqa: N802
                if self.path in ("/healthz", "/readyz"):
                    self.send_response(200)
                    self.send_header("Content-Length", "2")
                    self.end_headers()
                    self.wfile.write(b"ok")
                else:
                    self.send_error(404)

            def log_message(self, fmt, *args):  # quiet the stdlib logger
                logger.debug("webhook: " + fmt, *args)

        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        if self._cert:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(self._cert, self._key)
            self._httpd.socket = ctx.wrap_socket(
                self._httpd.socket, server_side=True)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="admission-webhook",
            daemon=True)
        self._thread.start()
        logger.info("admission webhook serving on %s:%d (%s) for %s",
                    self._host, self.port,
                    "https" if self._cert else "http", self._handler.kinds)

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
