"""SliceReporter: the MIG agent's observation half,
``nos_tpu/controllers/sliceagent/reporter.py`` for the port (reference
internal/controllers/migagent/reporter.go:54-123).

Each pass reads the carved devices through the device client and
writes them to the node: ``status-gpu-<i>-<profile>-{used,free}``
counts, each GPU's placement records (``status-gpu-placements-<i>``,
the pins that make the planner placement-aware), the agent's heartbeat
(unless ``heartbeat=False``) and ``status-partitioning-plan.mig``, the last plan id the actuator
parsed, which closes the plan handshake.
"""

from __future__ import annotations

import logging

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.device.gpuclient import SliceDeviceClient
from nos_tpu_torch.kube.client import APIServer, KIND_NODE
from nos_tpu_torch.kube.objects import Node
from nos_tpu_torch.topology import USED
from nos_tpu_torch.topology.annotations import (
    StatusAnnotation, encode_placement_records, strip_status_annotations,
)
from nos_tpu_torch.topology.profile import profile_from_resource
from nos_tpu_torch.utils.retry import retry_on_conflict

from .shared import SharedState

logger = logging.getLogger(__name__)


class SliceReporter:
    def __init__(self, api: APIServer, node_name: str,
                 client: SliceDeviceClient, shared: SharedState,
                 heartbeat: bool = True) -> None:
        self._api = api
        self._node_name = node_name
        self._client = client
        self._shared = shared
        # a per-process counter stamped with every report: a dead or
        # wedged agent's value freezes
        self._heartbeat_enabled = heartbeat
        self._heartbeat = 0

    def reconcile(self) -> None:
        devices = self._client.get_devices()
        placements = self._client.runtime.placements()
        annotations: dict[str, str] = {}
        counts: dict[tuple[int, str, str], int] = {}
        placed: dict[int, list] = {}
        for d in devices:
            profile = profile_from_resource(d.resource_name)
            if profile is None:
                continue
            status = "used" if d.status == USED else "free"
            key = (d.unit_index, profile, status)
            counts[key] = counts.get(key, 0) + 1
            pl = placements.get(d.device_id)
            if pl is not None:
                placed.setdefault(d.unit_index, []).append((status[0], pl))
        for (idx, profile, status), qty in counts.items():
            annotations[StatusAnnotation(idx, profile, status, qty).key] = \
                str(qty)
        for idx, records in placed.items():
            annotations[f"{C.ANNOT_PLACEMENTS_PREFIX}{idx}"] = \
                encode_placement_records(records)
        plan_id = self._shared.last_parsed_plan_id
        heartbeat = ""
        if self._heartbeat_enabled:
            self._heartbeat += 1
            heartbeat = str(self._heartbeat)

        def mutate(node: Node) -> None:
            strip_status_annotations(node.metadata.annotations,
                                     family=C.MIG_KIND)
            node.metadata.annotations.update(annotations)
            if heartbeat:
                node.metadata.annotations[
                    C.heartbeat_annotation(C.MIG_KIND)] = heartbeat
            if plan_id:
                node.metadata.annotations[
                    C.status_plan_annotation(C.MIG_KIND)] = plan_id

        retry_on_conflict(self._api, KIND_NODE, self._node_name, mutate,
                          component="sliceagent-reporter")
        self._shared.on_report_done()
        logger.debug("sliceagent reporter: node %s reported",
                     self._node_name)
