"""Cluster state and desired-partitioning types,
``nos_tpu/partitioning/state.py`` for the port (reference
internal/partitioning/state/state.go:29-222 and partitioning.go:24-56).
"""

from __future__ import annotations

import copy
import threading
from dataclasses import dataclass, field

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.kube.objects import Node, Pod
from nos_tpu_torch.scheduler.framework import NodeInfo
from nos_tpu_torch.utils.guards import guarded_by

# ---------------------------------------------------------------------------
# Desired state
# ---------------------------------------------------------------------------


@dataclass
class UnitPartitioning:
    """Desired profile quantities for one GPU (GPUPartitioning: GPUIndex
    and Resources)."""

    index: int
    resources: dict[str, int] = field(default_factory=dict)  # resource name -> qty


@dataclass
class NodePartitioning:
    units: list[UnitPartitioning] = field(default_factory=list)

    def _canon(self) -> dict[int, dict[str, int]]:
        out: dict[int, dict[str, int]] = {}
        for u in self.units:
            res = out.setdefault(u.index, {})
            for k, v in u.resources.items():
                if v > 0:
                    res[k] = res.get(k, 0) + v
        return {i: r for i, r in out.items() if r}

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, NodePartitioning):
            return NotImplemented
        return self._canon() == other._canon()


class PartitioningState(dict):
    """node name -> NodePartitioning, with order-insensitive equality
    (reference partitioning.go:40-56)."""

    def equal(self, other: "PartitioningState") -> bool:
        a = {k: v for k, v in self.items() if v.units}
        b = {k: v for k, v in other.items() if v.units}
        return a.keys() == b.keys() and all(a[k] == b[k] for k in a)

    @property
    def empty(self) -> bool:
        return not any(v.units for v in self.values())


# ---------------------------------------------------------------------------
# Live cluster state
# ---------------------------------------------------------------------------


@guarded_by("_lock", "_nodes", "_node_pods", "_partitioning_counts")
class ClusterState:
    """Thread-safe view of nodes and pod bindings; the partitioner
    snapshots it per batch."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._nodes: dict[str, Node] = {}
        self._node_pods: dict[str, dict[str, Pod]] = {}
        self._partitioning_counts: dict[str, int] = {}

    # -- nodes ------------------------------------------------------------
    def update_node(self, node: Node, pods: list[Pod] | None = None) -> None:
        with self._lock:
            old = self._nodes.get(node.name)
            if old is not None:
                self._bump_kind_locked(old, -1)
            self._nodes[node.name] = node
            self._bump_kind_locked(node, +1)
            if pods is not None:
                self._node_pods[node.name] = {p.key: p for p in pods}
            else:
                self._node_pods.setdefault(node.name, {})

    def delete_node(self, name: str) -> None:
        with self._lock:
            node = self._nodes.pop(name, None)
            if node is not None:
                self._bump_kind_locked(node, -1)
            self._node_pods.pop(name, None)

    def _bump_kind_locked(self, node: Node, delta: int) -> None:
        kind = node.metadata.labels.get(C.LABEL_PARTITIONING, "")
        if kind:
            self._partitioning_counts[kind] = (
                self._partitioning_counts.get(kind, 0) + delta
            )

    def is_partitioning_enabled(self, kind: str) -> bool:
        """At least one node opted into ``kind``; hybrid nodes count
        toward every kind (reference state.go IsPartitioningEnabled)."""
        with self._lock:
            return (self._partitioning_counts.get(kind, 0) > 0
                    or self._partitioning_counts.get(C.HYBRID_KIND, 0) > 0)

    # -- pods -------------------------------------------------------------
    def update_pod(self, pod: Pod) -> None:
        """Track or move a bound pod; a node the node controller has not
        seen is ignored (it owns node lifecycle)."""
        with self._lock:
            for pods in self._node_pods.values():
                pods.pop(pod.key, None)
            if pod.spec.node_name and pod.spec.node_name in self._nodes:
                self._node_pods[pod.spec.node_name][pod.key] = pod

    def delete_pod(self, pod_key: str) -> None:
        with self._lock:
            for pods in self._node_pods.values():
                pods.pop(pod_key, None)

    # -- snapshot access ---------------------------------------------------
    def nodes(self) -> dict[str, Node]:
        with self._lock:
            return dict(self._nodes)

    def pods_on(self, node_name: str) -> list[Pod]:
        with self._lock:
            return list(self._node_pods.get(node_name, {}).values())

    def node_infos(self) -> dict[str, NodeInfo]:
        """Deep-copied scheduling views: a snapshot rewrites its nodes'
        allocatable, which must never write through to the live state."""
        with self._lock:
            out: dict[str, NodeInfo] = {}
            for name, node in self._nodes.items():
                ni = NodeInfo(node=copy.deepcopy(node))
                for pod in self._node_pods.get(name, {}).values():
                    ni.add_pod(pod)
                out[name] = ni
            return out
