"""Admission reviews, the transport-free part of
``nos_tpu/kube/webhook.py`` for the port.

On the in-memory substrate admission runs in-process (the APIServer's
``register_admission``).  On a real cluster the kube-apiserver POSTs an
AdmissionReview (v1) whose ``request.object`` is the raw kind JSON to
the operator's endpoint: ``AdmissionHandler`` decodes it with the REST
client's codec, runs every validator registered for the kind and
answers allowed or denied with the validator's message, so both
substrates enforce the same rules.  It fails closed: a review it cannot
parse is denied.  ``KubeClient.register_admission`` collects the
validators here.  The HTTPS server around it (``WebhookServer``) comes
with the operator's main (ROADMAP item 8 part 2).
"""

from __future__ import annotations

import base64
import json
import logging
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
