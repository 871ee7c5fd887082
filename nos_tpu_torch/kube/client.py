"""In-memory Kubernetes API substrate, ``nos_tpu/kube/client.py`` for the
port: the durable store and watch bus through which the partitioner
controller, the node agents, the scheduler and the quota reconcilers
exchange annotations, pods, ConfigMaps and quotas.

Reads return deep copies (as a real API server serialises); every write
(create, update, patch, delete) bumps the resource version and fans out
to the kind's watchers, synchronously and in store-commit order.  A
validating admission hook registered for a kind (the quota webhooks)
runs on every create, update and patch of it and denies the write by
raising.  ``locked()`` lends the store's lock to the MIG node's kubelet
simulator, which must take it before its own.  ``kube/rest.py``'s
``KubeClient`` offers the same surface over a kube-apiserver's REST API.
The JAX package's ``Informer``, a watch-maintained store, is not ported
yet (ROADMAP item 8 part 2): the scheduler cache indexes its watch
events itself.
"""

from __future__ import annotations

import copy
import threading
from collections import defaultdict
from typing import Any, Callable

from nos_tpu_torch.api.constants import (
    KIND_COMPOSITE_ELASTIC_QUOTA, KIND_ELASTIC_QUOTA,
    KIND_POD_DISRUPTION_BUDGET, KIND_POD_GROUP,
)

from .objects import ConfigMap, Node, Pod

# (event type, object): "ADDED", "MODIFIED" or "DELETED"
WatchFn = Callable[[str, Any], None]


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
        # (callback, selector): selector None delivers everything
        self._watchers: dict[str, list[
            tuple[WatchFn, Callable[[Any], bool] | None]]] = defaultdict(list)
        self._admission: dict[str, list[Callable[["APIServer", Any], None]]] \
            = defaultdict(list)
        self._rv = 0
        self._event_queue: list[tuple[str, str, Any]] = []
        self._delivering = False

    def register_admission(self, kind: str,
                           fn: Callable[["APIServer", Any], None]) -> None:
        """Register a validating webhook for ``kind``: ``fn(api, obj)``
        raises to deny a create, update or patch (reference
        elasticquota_webhook.go:48-97)."""
        self._admission[kind].append(fn)

    def _admit(self, kind: str, obj: Any) -> None:
        for fn in self._admission.get(kind, ()):
            fn(self, obj)

    def kinds(self) -> list[str]:
        """The kinds with at least one stored object (what a state dump
        enumerates)."""
        with self._lock:
            return [k for k, s in self._stores.items() if s]

    def locked(self):
        """The store's reentrant lock, for a caller that must take it
        before its own: watch callbacks run under it, so a component
        taking (own, then store) on another thread would deadlock
        against (store, then own) in a callback."""
        return self._lock

    @staticmethod
    def _key(obj: Any) -> str:
        ns = getattr(obj.metadata, "namespace", "")
        return f"{ns}/{obj.metadata.name}" if ns else obj.metadata.name

    def _notify(self, kind: str, event: str, obj: Any) -> None:
        """FIFO delivery.  A watcher that writes back re-enters here;
        delivering its event at once would hand the watchers after it
        the newer state before the event that caused it, so the nested
        event is queued and the outermost call drains the queue in
        order.  The queue always drains fully: a raising watcher does
        not strand the events behind it, and the first error is raised
        once the queue is empty."""
        self._event_queue.append((kind, event, copy.deepcopy(obj)))
        if self._delivering:
            return
        self._delivering = True
        first_exc: BaseException | None = None
        try:
            while self._event_queue:
                k, ev, o = self._event_queue.pop(0)
                for fn, selector in list(self._watchers.get(k, [])):
                    # the selector reads the queued copy, before the
                    # per-watcher copy, and must not mutate it
                    if selector is not None and not selector(o):
                        continue
                    try:
                        fn(ev, copy.deepcopy(o))
                    except BaseException as e:
                        if first_exc is None:
                            first_exc = e
        finally:
            self._delivering = False
        if first_exc is not None:
            raise first_exc

    def _write(self, kind: str, key: str, obj: Any, event: str) -> None:
        self._rv += 1
        obj.metadata.resource_version = self._rv
        self._stores[kind][key] = copy.deepcopy(obj)
        self._notify(kind, event, obj)

    # -- CRUD -------------------------------------------------------------
    def create(self, kind: str, obj: Any) -> Any:
        with self._lock:
            key = self._key(obj)
            if key in self._stores[kind]:
                raise Conflict(f"{kind} {key} already exists")
            self._admit(kind, obj)
            self._write(kind, key, obj, "ADDED")
            # a watcher may have written back: return the stored state
            return copy.deepcopy(self._stores[kind][key])

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
            self._admit(kind, obj)
            self._write(kind, key, obj, "MODIFIED")
            return copy.deepcopy(store[key])

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
            self._admit(kind, obj)
            self._write(kind, key, obj, "MODIFIED")
            return copy.deepcopy(obj)

    def delete(self, kind: str, name: str, namespace: str = "") -> None:
        with self._lock:
            key = f"{namespace}/{name}" if namespace else name
            store = self._stores[kind]
            if key not in store:
                raise NotFound(f"{kind} {key}")
            obj = store.pop(key)
            # a delete is a mutation too: views memoised on the
            # resource version must see it
            self._rv += 1
            self._notify(kind, "DELETED", obj)

    @property
    def resource_version(self) -> int:
        """The store's mutation counter, bumped by every create, update,
        patch and delete."""
        with self._lock:
            return self._rv

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

    def watch(self, kind: str, fn: WatchFn,
              selector: Callable[[Any], bool] | None = None
              ) -> Callable[[], None]:
        """Register a watcher and return its unsubscribe function.  The
        watcher first gets a synthetic ADDED event for every stored
        object (an informer's sync).  ``selector`` is the field selector:
        it runs before the per-watcher copy and must not mutate the
        object.  An object that stops matching is simply no longer
        delivered (no synthetic DELETED), so select only on fields that
        do not change while the object matters, such as a pod's
        ``spec.node_name``."""
        entry = (fn, selector)
        with self._lock:
            self._watchers[kind].append(entry)
            for obj in list(self._stores[kind].values()):
                if selector is not None and not selector(obj):
                    continue
                fn("ADDED", copy.deepcopy(obj))

        def unsubscribe() -> None:
            with self._lock:
                if entry in self._watchers[kind]:
                    self._watchers[kind].remove(entry)

        return unsubscribe

    # -- field-index views (reference gpupartitioner.go:270-292) ---------
    def pods_by_phase(self, phase: str) -> list[Pod]:
        return self.list(KIND_POD, filter_fn=lambda p: p.status.phase == phase)

    def pods_on_node(self, node_name: str) -> list[Pod]:
        return self.list(KIND_POD,
                         filter_fn=lambda p: p.spec.node_name == node_name)


KIND_POD = "Pod"
KIND_NODE = "Node"
KIND_CONFIGMAP = "ConfigMap"

__all__ = [
    "APIServer", "NotFound", "Conflict", "TransientAPIError",
    "WatchFn", "KIND_POD", "KIND_NODE", "KIND_CONFIGMAP",
    "KIND_ELASTIC_QUOTA", "KIND_COMPOSITE_ELASTIC_QUOTA",
    "KIND_POD_DISRUPTION_BUDGET", "KIND_POD_GROUP", "Node", "Pod",
    "ConfigMap",
]
