"""Node controller, ``nos_tpu/controllers/node_controller.py`` for the
port (reference internal/controllers/gpupartitioner/node_controller.go:60-135):
tracks the nodes that carry the partitioning label, with their live
pods, in ``ClusterState``.

The JAX controller also initialises a virgin MIG-family node's geometry
through a ``NodeInitializer``; that comes back with the MIG strategy
(ROADMAP item 4).
"""

from __future__ import annotations

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.kube.client import APIServer, KIND_NODE
from nos_tpu_torch.kube.objects import FAILED, SUCCEEDED, Node
from nos_tpu_torch.partitioning.state import ClusterState


class NodeController:
    def __init__(self, api: APIServer, cluster_state: ClusterState) -> None:
        self._api = api
        self._state = cluster_state

    def reconcile(self, event: str, node: Node) -> None:
        name = node.metadata.name
        if event == "DELETED" or \
                not node.metadata.labels.get(C.LABEL_PARTITIONING, ""):
            self._state.delete_node(name)
            return
        # only live pods take capacity: a finished pod keeps its node
        # name, and counting it would inflate the node's requests forever
        live = [p for p in self._api.pods_on_node(name)
                if p.status.phase not in (SUCCEEDED, FAILED)]
        self._state.update_node(node, live)

    def bind(self) -> None:
        self._api.watch(KIND_NODE, self.reconcile)
