"""Watch-driven cluster view for the scheduler, the kube-scheduler
cache: ``nos_tpu/scheduler/cache.py`` for the port.

The cache watches Node and Pod events through two ``Informer``s with
no store of their own (the API server's watch replays the current
objects first) and keeps, per node, its latest object and its bound
active pods; every event touching a node bumps that node's generation,
and ``snapshot()`` rebuilds the NodeInfo of exactly the nodes whose
generation moved.  On the same stream it keeps:

- the view epoch (``view_epoch()``), moved by every bump: while it
  stands still ``snapshot()`` hands back the same SharedLister, and the
  capacity plugin's victim prescreen keys its masks on it;
- the dirty set (``drain_dirty()``): nodes bumped since the last drain,
  ``None`` meaning all of them (the first drain, and after
  ``invalidate_all()``), which the scheduler turns into a full rescan;
- the pending-pod index (``pending_pods()``), the cycle's work list
  without a store scan.

The scheduler books a pod it just bound into a cycle snapshot in place
(``Scheduler._assume_bound``); the bind's own event has already bumped
the node (the bus is synchronous), so the next ``snapshot()`` rebuilds
that node from the store and the in-place booking never outlives the
cycle.
"""

from __future__ import annotations

import threading

from nos_tpu_torch.kube.client import APIServer, Informer, KIND_NODE, KIND_POD
from nos_tpu_torch.kube.objects import Node, PENDING, Pod, RUNNING
from nos_tpu_torch.scheduler.framework import NodeInfo, SharedLister
from nos_tpu_torch.utils.guards import guarded_by, invalidated_by


@guarded_by("_lock", "_node_objs", "_pods_by_node", "_pod_node",
            "_gen", "_built", "_epoch", "_dirty", "_snap",
            "_pending")
@invalidated_by("_bump_locked", "_node_objs", "_pods_by_node", "_pod_node")
class SchedulerCache:
    """Every index is written on watch delivery and read by the
    scheduling loop, under ``_lock``.  Every in-place change of the node
    and pod indexes is followed by ``_bump_locked`` in the same critical
    section, so a NodeInfo reused by generation is never stale; the
    epoch, dirty set, snapshot and pending index are derived from that
    same bump."""

    def __init__(self, api: APIServer) -> None:
        self._lock = threading.Lock()
        # node objects live in the cache's OWN index, written in the
        # same critical section as the generation bump: snapshot() must
        # read (object, generation) atomically, or a concurrent node
        # write between the two reads would tag a NodeInfo built from
        # the stale object with the NEW generation - consuming the very
        # signal meant to invalidate it
        self._node_objs: dict[str, object] = {}
        # pods are indexed independently of node existence: a pod bound
        # to a node the cache has not seen yet (watch registration
        # races, replacement hosts) is picked up on the node's first
        # NodeInfo build
        self._pods_by_node: dict[str, dict[str, Pod]] = {}
        self._pod_node: dict[str, str] = {}
        self._gen: dict[str, int] = {}
        self._built: dict[str, tuple[int, NodeInfo]] = {}
        # fleet-wide view epoch: moves with every per-node bump, so one
        # integer comparison certifies "nothing in the fleet changed"
        self._epoch = 0
        # dirty node names since the last drain; None = everything is
        # dirty (initial state and after invalidate_all) so the first
        # cycle and the backstop both take the full-rescan path
        self._dirty: set[str] | None = None
        # epoch-gated snapshot reuse: the same SharedLister object is
        # handed back while the epoch stands still, so a clean cycle
        # costs zero NodeInfo list rebuilds
        self._snap: tuple[int, SharedLister] | None = None
        # pending (unbound) pods, maintained from the same pod stream:
        # the cycle work list without a full store scan.  Watch delivery
        # hands this cache its own deep copies, so the stored objects
        # are private to it.
        self._pending: dict[str, Pod] = {}
        # hook order matters: the pod handler reads these indexes, so
        # they exist before the informers replay their initial ADDEDs;
        # store=False: this cache is the store
        self._nodes = Informer(api, KIND_NODE, on_event=self._on_node,
                               store=False)
        self._pods = Informer(api, KIND_POD, on_event=self._on_pod,
                              store=False)

    # -- watch handlers (fire on the API server's synchronous bus) ----------
    # callers hold the cache lock
    def _bump_locked(self, node_name: str) -> None:
        self._gen[node_name] = self._gen.get(node_name, 0) + 1
        self._epoch += 1
        if self._dirty is not None:
            self._dirty.add(node_name)

    def _on_node(self, event: str, node: Node) -> None:
        name = node.metadata.name
        with self._lock:
            if event == "DELETED":
                self._node_objs.pop(name, None)
                self._built.pop(name, None)
            else:
                self._node_objs[name] = node
            self._bump_locked(name)

    def _on_pod(self, event: str, pod: Pod) -> None:
        key = pod.key
        tracked = (event != "DELETED" and bool(pod.spec.node_name)
                   and pod.status.phase in (PENDING, RUNNING))
        pending = (event != "DELETED" and not pod.spec.node_name
                   and pod.status.phase == PENDING)
        with self._lock:
            if pending:
                self._pending[key] = pod
            else:
                self._pending.pop(key, None)
            prev = self._pod_node.get(key)
            if prev is not None and (not tracked
                                     or prev != pod.spec.node_name):
                self._pods_by_node.get(prev, {}).pop(key, None)
                del self._pod_node[key]
                self._bump_locked(prev)
            if tracked:
                node_name = pod.spec.node_name
                self._pods_by_node.setdefault(node_name, {})[key] = pod
                self._pod_node[key] = node_name
                self._bump_locked(node_name)

    def assume(self, pod: Pod) -> None:
        """Book a just-bound pod into the indexes.  On the synchronous
        in-memory bus this repeats what the bind's event already did; on
        a substrate whose pod events can lag node events it keeps a node
        rebuild from resurrecting the pre-bind view.  The pod's own
        event later overwrites the same key."""
        node_name = pod.spec.node_name
        with self._lock:
            self._pending.pop(pod.key, None)
            self._pods_by_node.setdefault(node_name, {})[pod.key] = pod
            self._pod_node[pod.key] = node_name
            self._bump_locked(node_name)

    # -- incremental-cycle feeds --------------------------------------------
    def drain_dirty(self) -> frozenset[str] | None:
        """Node names bumped since the last drain, then reset the set.
        ``None`` means everything is dirty (first drain, or after
        `invalidate_all()`) - the caller must full-rescan."""
        with self._lock:
            dirty = self._dirty
            self._dirty = set()
            return None if dirty is None else frozenset(dirty)

    def invalidate_all(self) -> None:
        """Level-trigger: forget all incremental state.  The next
        `drain_dirty()` returns None and the next `snapshot()` rebuilds;
        the periodic backstop and test harnesses call this."""
        with self._lock:
            self._dirty = None
            self._snap = None
            self._epoch += 1

    def view_epoch(self) -> int:
        """Fleet-wide change counter: equal epochs certify that no node
        or bound-pod event landed in between (memo-key material)."""
        with self._lock:
            return self._epoch

    def pending_pods(self) -> list[Pod]:
        """The unbound PENDING pods, from the watch-maintained index -
        no store scan, no deep copies.  Callers treat the objects as
        read-only (they are this cache's private watch copies)."""
        with self._lock:
            return list(self._pending.values())

    # -- the per-cycle snapshot ---------------------------------------------
    def snapshot(self) -> SharedLister:
        """A SharedLister over the current view.  NodeInfos for
        unchanged nodes are the SAME objects as the previous snapshot
        (generation-gated reuse); changed nodes are rebuilt from the
        watch-maintained node/pod records.  While the view epoch stands
        still the SAME SharedLister object is returned, so a clean
        cycle pays one integer compare instead of an O(nodes) rebuild."""
        with self._lock:
            if self._snap is not None and self._snap[0] == self._epoch:
                return self._snap[1]
            infos = []
            for name, node in self._node_objs.items():
                gen = self._gen.get(name, 0)
                cached = self._built.get(name)
                if cached is None or cached[0] != gen:
                    ni = NodeInfo(node=node)
                    for pod in self._pods_by_node.get(name, {}).values():
                        ni.add_pod(pod)
                    cached = (gen, ni)
                    self._built[name] = cached
                infos.append(cached[1])
            lister = SharedLister(infos)
            self._snap = (self._epoch, lister)
            return lister

    def close(self) -> None:
        self._nodes.close()
        self._pods.close()
