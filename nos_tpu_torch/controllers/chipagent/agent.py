"""The MPS node agent, ``nos_tpu/controllers/chipagent/agent.py`` for
the port (reference cmd/gpuagent, gpuagent.go:54-152): the timeshare
plugin and the reporter of one node.

There is no actuator on the MPS path: the plugin applies the ConfigMap.
The agent refuses a node whose partitioning kind is neither ``mps`` nor
``hybrid``, as the reference refuses a MIG GPU (gpuagent.go:106-114).
"""

from __future__ import annotations

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.controllers.kubelet import admit_bound_pods
from nos_tpu_torch.device.timeshare_plugin import TimeshareDevicePlugin
from nos_tpu_torch.kube.client import APIServer, KIND_NODE
from nos_tpu_torch.partitioning.timeshare.partitioner import (
    DEVICE_PLUGIN_CM_NAME, DEVICE_PLUGIN_CM_NAMESPACE,
)

from .reporter import ChipReporter


class ChipAgent:
    def __init__(self, api: APIServer, node_name: str,
                 cm_name: str = DEVICE_PLUGIN_CM_NAME,
                 cm_namespace: str = DEVICE_PLUGIN_CM_NAMESPACE,
                 heartbeat: bool = True) -> None:
        self._api = api
        self._node_name = node_name
        self.plugin = TimeshareDevicePlugin(api, node_name, cm_name,
                                            cm_namespace)
        self.reporter = ChipReporter(api, node_name, self.plugin,
                                     heartbeat=heartbeat)

    def start(self) -> None:
        node = self._api.get(KIND_NODE, self._node_name)
        kind = node.metadata.labels.get(C.LABEL_PARTITIONING, "")
        if kind not in (C.MPS_KIND, C.HYBRID_KIND):
            raise RuntimeError(
                f"chipagent must not run on node {self._node_name} with "
                f"partitioning kind {kind!r} (reference cmd/gpuagent/"
                f"gpuagent.go:106-114)")
        self.tick()

    def tick(self) -> None:
        """One admission, plugin and report pass, in that order: as on a
        real node, admission comes before the usage report.  MIG pods on
        a hybrid node are left to the MIG node's admission."""
        admit_bound_pods(self._api, self._node_name)
        self.plugin.tick()
        self.reporter.reconcile()
