"""Node controller, ``nos_tpu/controllers/node_controller.py`` for the
port (reference internal/controllers/gpupartitioner/node_controller.go:60-135):
tracks the nodes that carry the partitioning label, with their live
pods, in ``ClusterState``, and has the ``NodeInitializer`` give a virgin
MIG-family node its first geometry.
"""

from __future__ import annotations

import logging

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.kube.client import APIServer, KIND_NODE
from nos_tpu_torch.kube.objects import FAILED, SUCCEEDED, Node
from nos_tpu_torch.partitioning.core import NodeInitializer
from nos_tpu_torch.partitioning.slicepart import is_node_initialized
from nos_tpu_torch.partitioning.state import ClusterState

logger = logging.getLogger(__name__)


class NodeController:
    def __init__(self, api: APIServer, cluster_state: ClusterState,
                 initializer: NodeInitializer | None = None) -> None:
        self._api = api
        self._state = cluster_state
        self._initializer = initializer

    def reconcile(self, event: str, node: Node) -> None:
        name = node.metadata.name
        kind = node.metadata.labels.get(C.LABEL_PARTITIONING, "")
        if event == "DELETED" or not kind:
            self._state.delete_node(name)
            return
        if kind in (C.MIG_KIND, C.HYBRID_KIND) \
                and self._initializer is not None \
                and not is_node_initialized(node):
            try:
                self._initializer.init_node_partitioning(name)
                node = self._api.get(KIND_NODE, name)
            except Exception as e:  # noqa: BLE001 — retried on the next event
                logger.warning("node %s init failed: %s", name, e)
        # only live pods take capacity: a finished pod keeps its node
        # name, and counting it would inflate the node's requests forever
        live = [p for p in self._api.pods_on_node(name)
                if p.status.phase not in (SUCCEEDED, FAILED)]
        self._state.update_node(node, live)

    def bind(self) -> None:
        self._api.watch(KIND_NODE, self.reconcile)
