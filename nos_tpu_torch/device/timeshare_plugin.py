"""The timeshare plugin, ``nos_tpu/device/timeshare_plugin.py`` for the
port: re-advertises a node's MPS shares from the config its plan wrote.

It plays the reference's forked NVIDIA device plugin reading the MPS
sharing ConfigMap (internal/partitioning/mps/partitioner.go:61-114).  It
reads the node's ``nos.nebuly.com/device-plugin.config`` label (the plan
id), derives the key ``config_key(node, plan id)``, loads that key's
NVIDIA-shaped sharing config (``sharing.mps.resources``, as
``partitioning/timeshare/partitioner.py`` renders it), advertises the
config's ``nvidia.com/gpu-<N>gb`` totals as the node's allocatable and
capacity, and stamps the applied key and a generation counter: the
readiness signal that takes the place of the reference's blind
propagation sleep.  The kubelet-facing half, which hands a pod its share
at Allocate, is ``device/deviceplugin``'s ``TimeshareReplicaPlugin``.
"""

from __future__ import annotations

import json
import logging

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.kube.client import APIServer, KIND_CONFIGMAP, KIND_NODE
from nos_tpu_torch.kube.objects import Node
from nos_tpu_torch.partitioning.timeshare.partitioner import config_key
from nos_tpu_torch.topology.profile import (
    is_timeshare_resource, timeshare_resource_name,
)
from nos_tpu_torch.utils.retry import retry_on_conflict

logger = logging.getLogger(__name__)


class TimeshareDevicePlugin:
    def __init__(self, api: APIServer, node_name: str,
                 cm_name: str, cm_namespace: str) -> None:
        self._api = api
        self._node_name = node_name
        self._cm_name = cm_name
        self._cm_namespace = cm_namespace

    def gpu_config(self, key: str) -> dict[int, dict[str, int]] | None:
        """GPU index -> share ("24gb") -> replicas for a ConfigMap key,
        None if the key is missing."""
        cm = self._api.try_get(KIND_CONFIGMAP, self._cm_name,
                               self._cm_namespace)
        if cm is None or key not in cm.data:
            return None
        cfg = json.loads(cm.data[key])
        out: dict[int, dict[str, int]] = {}
        for r in cfg.get("sharing", {}).get("mps", {}).get("resources", []):
            share = f"{int(r['memoryGB'])}gb"
            for device in r["devices"]:
                table = out.setdefault(int(device), {})
                table[share] = table.get(share, 0) + int(r["replicas"])
        return out

    def tick(self) -> bool:
        """Apply the labelled config if it is not applied yet; True if
        the node was updated."""
        node = self._api.get(KIND_NODE, self._node_name)
        plan_id = node.metadata.labels.get(C.LABEL_DEVICE_PLUGIN_CONFIG, "")
        if not plan_id:
            return False
        key = config_key(self._node_name, plan_id)
        if node.metadata.annotations.get(C.ANNOT_PLUGIN_APPLIED_CONFIG) == key:
            return False
        gpus = self.gpu_config(key)
        if gpus is None:
            logger.warning("timeshare plugin: config key %s not found", key)
            return False

        totals: dict[str, float] = {}
        for shares in gpus.values():
            for share, qty in shares.items():
                res = timeshare_resource_name(int(share[:-2]))
                totals[res] = totals.get(res, 0.0) + qty

        def mutate(n: Node) -> None:
            for table in (n.status.allocatable, n.status.capacity):
                for res in [r for r in table if is_timeshare_resource(r)]:
                    del table[res]
            n.status.allocatable.update(totals)
            n.status.capacity.update(totals)
            gen = int(n.metadata.annotations.get(C.ANNOT_PLUGIN_GENERATION, "0"))
            n.metadata.annotations[C.ANNOT_PLUGIN_GENERATION] = str(gen + 1)
            n.metadata.annotations[C.ANNOT_PLUGIN_APPLIED_CONFIG] = key

        retry_on_conflict(self._api, KIND_NODE, self._node_name, mutate,
                          component="timeshare-plugin")
        logger.info("timeshare plugin: node %s applied %s", self._node_name, key)
        return True
