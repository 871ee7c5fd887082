"""Pod controller, ``nos_tpu/controllers/pod_controller.py`` for the port
(reference internal/controllers/gpupartitioner/pod_controller.go:47-112):
keeps ``ClusterState``'s pod bindings in step with the API server."""

from __future__ import annotations

from nos_tpu_torch.kube.client import APIServer, KIND_POD
from nos_tpu_torch.kube.objects import FAILED, SUCCEEDED, Pod
from nos_tpu_torch.partitioning.state import ClusterState


class PodController:
    def __init__(self, api: APIServer, cluster_state: ClusterState) -> None:
        self._api = api
        self._state = cluster_state

    def reconcile(self, event: str, pod: Pod) -> None:
        if event == "DELETED" or pod.status.phase in (SUCCEEDED, FAILED):
            self._state.delete_pod(pod.key)
            return
        if pod.spec.node_name:
            self._state.update_pod(pod)

    def bind(self) -> None:
        self._api.watch(KIND_POD, self.reconcile)
