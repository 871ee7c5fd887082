"""MPS actuation: the timeshare plugin's ConfigMap and the node's plan
label, ``nos_tpu/partitioning/timeshare/partitioner.py`` for the port
(reference internal/partitioning/mps/partitioner.go:61-157).

``TimesharePartitioner`` writes the node's sharing config under the key
``<node>.<plan id>`` of the plugin's ConfigMap (dropping the node's
older keys), labels the node ``nos.nebuly.com/device-plugin.config=
<plan id>`` and stamps its ``spec-partitioning-plan.mps`` annotation.
The label holds the plan id alone, as the JAX package's does; the
port's own timeshare plugin (``device/timeshare_plugin.py``) derives
the key from its node name and is the label's reader, NVIDIA's device
plugin is not.  Where the reference then sleeps a fixed delay for the
plugin, the node's reporter stamps ``status-partitioning-plan.mps``
once the plugin has applied the key, and the partitioner controller
waits for that.
"""

from __future__ import annotations

import json
import logging

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.kube.client import (
    APIServer, KIND_CONFIGMAP, KIND_NODE, NotFound,
)
from nos_tpu_torch.kube.objects import ConfigMap, Node, ObjectMeta
from nos_tpu_torch.topology.profile import gb_from_resource
from nos_tpu_torch.utils.retry import retry_on_conflict

from ..core.interfaces import Partitioner
from ..state import NodePartitioning

logger = logging.getLogger(__name__)

DEVICE_PLUGIN_CM_NAME = "nos-device-plugin-configs"
DEVICE_PLUGIN_CM_NAMESPACE = "nebuly-nos"


def config_key(node_name: str, plan_id: str) -> str:
    # "." delimits: a plan id never holds one, so rsplit-once recovers
    # the node name even for an FQDN, and "gpu-a" cannot claim
    # "gpu-a-2"'s keys
    return f"{node_name}.{plan_id}"


def key_belongs_to_node(node_name: str, key: str) -> bool:
    return "." in key and key.rsplit(".", 1)[0] == node_name


def plan_id_from_key(node_name: str, key: str) -> str:
    return key.rsplit(".", 1)[1] if key_belongs_to_node(node_name, key) else ""


def to_plugin_config(partitioning: NodePartitioning) -> dict:
    """The node's partitioning as the device plugin's sharing config, as
    the reference renders it (mps/partitioner.go:123-157): per GPU index
    and share size, ``nvidia.com/gpu`` renamed to
    ``nvidia.com/gpu-<N>gb``, with its replicas and memoryGB."""
    resources = []
    for unit in partitioning.units:
        for res, qty in unit.resources.items():
            gb = gb_from_resource(res)
            if gb is not None and qty > 0:
                resources.append({
                    "name": C.RESOURCE_GPU, "rename": res, "memoryGB": gb,
                    "replicas": qty, "devices": [str(unit.index)]})
    return {"version": "v1", "sharing": {"mps": {
        "failRequestsGreaterThanOne": True, "resources": resources}}}


class TimesharePartitioner(Partitioner):
    def __init__(self, api: APIServer,
                 cm_name: str = DEVICE_PLUGIN_CM_NAME,
                 cm_namespace: str = DEVICE_PLUGIN_CM_NAMESPACE) -> None:
        self._api = api
        self._cm_name = cm_name
        self._cm_namespace = cm_namespace

    def apply_partitioning(self, node_name: str, plan_id: str,
                           partitioning: NodePartitioning) -> None:
        key = config_key(node_name, plan_id)
        payload = json.dumps(to_plugin_config(partitioning))

        def mutate_cm(cm: ConfigMap) -> None:
            for k in [k for k in cm.data if key_belongs_to_node(node_name, k)]:
                del cm.data[k]
            cm.data[key] = payload

        try:
            retry_on_conflict(self._api, KIND_CONFIGMAP, self._cm_name,
                              mutate_cm, self._cm_namespace,
                              component=C.MPS_KIND)
        except NotFound:
            self._api.create(KIND_CONFIGMAP, ConfigMap(
                metadata=ObjectMeta(name=self._cm_name,
                                    namespace=self._cm_namespace),
                data={key: payload}))

        def mutate_node(node: Node) -> None:
            # the label holds the plan id alone (a label value caps at 63
            # characters); the plugin derives the key from its node name
            node.metadata.labels[C.LABEL_DEVICE_PLUGIN_CONFIG] = plan_id
            node.metadata.annotations[C.spec_plan_annotation(C.MPS_KIND)] = \
                plan_id

        retry_on_conflict(self._api, KIND_NODE, node_name, mutate_node,
                          component=C.MPS_KIND)
        logger.info("mps: node %s config %s published", node_name, key)
