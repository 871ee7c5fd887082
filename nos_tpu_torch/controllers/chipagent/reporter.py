"""The MPS node's reporter, ``nos_tpu/controllers/chipagent/reporter.py``
for the port (reference internal/controllers/gpuagent/reporter.go:50-110).

The MPS path has no node-side actuator: the timeshare plugin applies the
ConfigMap itself.  The reporter renders each GPU's free and used shares
as ``status-gpu-<i>-<N>gb-{free,used}`` annotations, from the applied
config and the node's Running pods, stamps the agent's heartbeat (unless
``heartbeat=False``: the partitioner's suspicion then has no signal for
the node, and a report that changes nothing writes nothing), and
stamps ``status-partitioning-plan.mps`` with the applied key's plan id:
that closes the handshake the MPS partitioner opened.

Used shares go to GPUs greedily in GPU-index order from the Running
pods' requests, as the JAX reporter attributes them: the counterpart of
the reference's slicing client mapping shared device ids
``<uuid>::<replica>`` to GPU indexes (pkg/gpu/slicing/client.go:86-105).
"""

from __future__ import annotations

import logging

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.device.timeshare_plugin import TimeshareDevicePlugin
from nos_tpu_torch.kube.client import APIServer, KIND_NODE
from nos_tpu_torch.kube.objects import Node, RUNNING
from nos_tpu_torch.kube.resources import pod_request
from nos_tpu_torch.partitioning.timeshare.partitioner import plan_id_from_key
from nos_tpu_torch.topology.annotations import strip_status_annotations
from nos_tpu_torch.topology.profile import extract_timeshare_requests
from nos_tpu_torch.utils.retry import retry_on_conflict

logger = logging.getLogger(__name__)


class ChipReporter:
    def __init__(self, api: APIServer, node_name: str,
                 plugin: TimeshareDevicePlugin,
                 heartbeat: bool = True) -> None:
        self._api = api
        self._node_name = node_name
        self._plugin = plugin
        # stamped with every landed report: a node that never reported
        # carries none, and every report is a real write
        self._heartbeat_enabled = heartbeat
        self._heartbeat = 0

    def reconcile(self) -> None:
        node = self._api.get(KIND_NODE, self._node_name)
        applied = node.metadata.annotations.get(
            C.ANNOT_PLUGIN_APPLIED_CONFIG, "")
        if not applied:
            return
        gpus = self._plugin.gpu_config(applied)
        if gpus is None:
            return

        # shares asked for by the node's Running pods, per share size
        demand: dict[str, int] = {}
        for pod in self._api.pods_on_node(self._node_name):
            if pod.status.phase != RUNNING:
                continue
            for gb, qty in extract_timeshare_requests(pod_request(pod)).items():
                demand[f"{gb}gb"] = demand.get(f"{gb}gb", 0) + qty

        annotations: dict[str, str] = {}
        for idx in sorted(gpus):
            for share, total in gpus[idx].items():
                used = min(total, demand.get(share, 0))
                if used:
                    demand[share] -= used
                    annotations[
                        f"{C.ANNOT_STATUS_PREFIX}{idx}-{share}-used"] = str(used)
                free = total - used
                if free:
                    annotations[
                        f"{C.ANNOT_STATUS_PREFIX}{idx}-{share}-free"] = str(free)

        plan_id = plan_id_from_key(self._node_name, applied)
        heartbeat = ""
        if self._heartbeat_enabled:
            self._heartbeat += 1
            heartbeat = str(self._heartbeat)

        def mutate(n: Node) -> None:
            strip_status_annotations(n.metadata.annotations,
                                     family=C.MPS_KIND)
            n.metadata.annotations.update(annotations)
            if heartbeat:
                n.metadata.annotations[
                    C.heartbeat_annotation(C.MPS_KIND)] = heartbeat
            if plan_id:
                n.metadata.annotations[
                    C.status_plan_annotation(C.MPS_KIND)] = plan_id

        retry_on_conflict(self._api, KIND_NODE, self._node_name, mutate,
                          component="chipagent-reporter")
        logger.debug("chipagent reporter: node %s reported", self._node_name)
