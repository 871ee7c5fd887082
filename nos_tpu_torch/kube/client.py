"""In-memory Kubernetes API substrate, ``nos_tpu/kube/client.py`` for the
port: the durable store through which the planner and the node side
exchange annotations and ConfigMaps.

Reads return deep copies (as a real API server serialises); every write
bumps the resource version.  The watch bus, deletes, the pod views, the
``Informer`` and the admission hooks wait for the controller slice,
which is the first to call them.
"""

from __future__ import annotations

import copy
import threading
from collections import defaultdict
from typing import Any, Callable

from .objects import ConfigMap, Node, Pod


class NotFound(Exception):
    pass


class Conflict(Exception):
    pass


class TransientAPIError(RuntimeError):
    """A server-side failure worth retrying (5xx / 429), distinct from a
    permanent request error."""


class APIServer:
    """Typed object store: kind -> key -> object.  Keys are
    "namespace/name" for namespaced kinds, "name" for cluster kinds."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._stores: dict[str, dict[str, Any]] = defaultdict(dict)
        self._rv = 0

    @staticmethod
    def _key(obj: Any) -> str:
        ns = getattr(obj.metadata, "namespace", "")
        return f"{ns}/{obj.metadata.name}" if ns else obj.metadata.name

    def _write(self, kind: str, key: str, obj: Any) -> Any:
        self._rv += 1
        obj.metadata.resource_version = self._rv
        self._stores[kind][key] = copy.deepcopy(obj)
        return copy.deepcopy(obj)

    # -- CRUD -------------------------------------------------------------
    def create(self, kind: str, obj: Any) -> Any:
        with self._lock:
            key = self._key(obj)
            if key in self._stores[kind]:
                raise Conflict(f"{kind} {key} already exists")
            return self._write(kind, key, obj)

    def get(self, kind: str, name: str, namespace: str = "") -> Any:
        with self._lock:
            key = f"{namespace}/{name}" if namespace else name
            store = self._stores[kind]
            if key not in store:
                raise NotFound(f"{kind} {key}")
            return copy.deepcopy(store[key])

    def try_get(self, kind: str, name: str, namespace: str = "") -> Any | None:
        try:
            return self.get(kind, name, namespace)
        except NotFound:
            return None

    def update(self, kind: str, obj: Any) -> Any:
        """PUT with optimistic concurrency: an object read at version N
        cannot overwrite version M != N (version 0 is unconditional)."""
        with self._lock:
            key = self._key(obj)
            store = self._stores[kind]
            if key not in store:
                raise NotFound(f"{kind} {key}")
            sent_rv = getattr(obj.metadata, "resource_version", 0)
            current_rv = store[key].metadata.resource_version
            if sent_rv and sent_rv != current_rv:
                raise Conflict(
                    f"{kind} {key}: resourceVersion {sent_rv} != "
                    f"{current_rv}")
            return self._write(kind, key, obj)

    def patch(self, kind: str, name: str, namespace: str = "",
              *, mutate: Callable[[Any], None]) -> Any:
        """Read-modify-write under the store lock (the strategic merge
        patch the reference applies to node annotations)."""
        with self._lock:
            key = f"{namespace}/{name}" if namespace else name
            store = self._stores[kind]
            if key not in store:
                raise NotFound(f"{kind} {key}")
            obj = copy.deepcopy(store[key])
            mutate(obj)
            return self._write(kind, key, obj)

    def list(self, kind: str, namespace: str | None = None,
             label_selector: dict[str, str] | None = None,
             filter_fn: Callable[[Any], bool] | None = None) -> list[Any]:
        with self._lock:
            out = []
            for obj in self._stores[kind].values():
                if namespace is not None and \
                        getattr(obj.metadata, "namespace", "") != namespace:
                    continue
                if label_selector is not None and any(
                        obj.metadata.labels.get(k) != v
                        for k, v in label_selector.items()):
                    continue
                if filter_fn is not None and not filter_fn(obj):
                    continue
                out.append(copy.deepcopy(obj))
            return out


KIND_POD = "Pod"
KIND_NODE = "Node"
KIND_CONFIGMAP = "ConfigMap"

__all__ = [
    "APIServer", "NotFound", "Conflict", "TransientAPIError",
    "KIND_POD", "KIND_NODE", "KIND_CONFIGMAP", "Node", "Pod", "ConfigMap",
]
