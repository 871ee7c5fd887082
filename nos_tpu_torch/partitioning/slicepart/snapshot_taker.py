"""MIG strategy snapshot taker,
``nos_tpu/partitioning/slicepart/snapshot_taker.py`` for the port
(reference internal/partitioning/mig/snapshot_taker.go:31-53): wrap the
nodes labelled for MIG (or hybrid) partitioning, of a known GPU model
and with a GPU count, as SliceNodes; quarantined nodes are left out."""

from __future__ import annotations

from typing import Collection

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.topology.hybrid import gpu_count
from nos_tpu_torch.topology.known import DEFAULT_REGISTRY, GpuModelRegistry

from ..core.interfaces import SnapshotTaker
from ..core.snapshot import ClusterSnapshot
from ..state import ClusterState
from .calculators import SliceProfileFilter
from .node import SliceNode


class SliceSnapshotTaker(SnapshotTaker):
    def __init__(self, registry: GpuModelRegistry = DEFAULT_REGISTRY) -> None:
        self._registry = registry

    def take_snapshot(self, cluster_state: ClusterState,
                      exclude: Collection[str] = ()) -> ClusterSnapshot:
        infos = cluster_state.node_infos()
        nodes = {}
        for name, node in cluster_state.nodes().items():
            if name in exclude:
                continue
            labels = node.metadata.labels
            if labels.get(C.LABEL_PARTITIONING, "") not in (C.MIG_KIND,
                                                           C.HYBRID_KIND):
                continue
            if labels.get(C.LABEL_ACCELERATOR, "") not in self._registry.models \
                    or gpu_count(labels) is None:
                continue
            # built on the deep-copied NodeInfo's node: SliceNode rewrites
            # its allocatable, which must not reach ClusterState
            nodes[name] = SliceNode(infos[name].node, infos[name],
                                    self._registry)
        return ClusterSnapshot(nodes, SliceProfileFilter())
