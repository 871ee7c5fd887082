"""MIG strategy actuation: the spec annotations and the plan id on the
node, ``nos_tpu/partitioning/slicepart/partitioner.py`` for the port
(reference internal/partitioning/mig/partitioner.go:43-75 and
initializer.go:44-83).

The decision plane never touches devices: it writes
``spec-gpu-<i>-<profile>`` annotations and
``spec-partitioning-plan.mig``, and the node's MIG agent
(``controllers/sliceagent``) carves the instances.
"""

from __future__ import annotations

import logging

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.kube.client import APIServer, KIND_NODE
from nos_tpu_torch.kube.objects import Node
from nos_tpu_torch.topology.annotations import (
    spec_from_geometries, strip_spec_annotations,
)
from nos_tpu_torch.topology.geometry import fewest_slices_geometry
from nos_tpu_torch.topology.hybrid import gpu_count, mig_gpus
from nos_tpu_torch.topology.known import DEFAULT_REGISTRY, GpuModelRegistry
from nos_tpu_torch.topology.packing import enumerate_geometries
from nos_tpu_torch.topology.profile import profile_from_resource
from nos_tpu_torch.utils.retry import retry_on_conflict

from ..core.actuator import new_plan_id
from ..core.interfaces import NodeInitializer, Partitioner
from ..state import NodePartitioning

logger = logging.getLogger(__name__)


def _write_spec(api: APIServer, node_name: str,
                geometries: dict[int, dict[str, int]], plan_id: str,
                component: str) -> None:
    def mutate(node: Node) -> None:
        strip_spec_annotations(node.metadata.annotations, family=C.MIG_KIND)
        node.metadata.annotations.update(spec_from_geometries(geometries))
        node.metadata.annotations[C.spec_plan_annotation(C.MIG_KIND)] = \
            plan_id

    retry_on_conflict(api, KIND_NODE, node_name, mutate, component=component)


class SlicePartitioner(Partitioner):
    def __init__(self, api: APIServer) -> None:
        self._api = api

    def apply_partitioning(self, node_name: str, plan_id: str,
                           partitioning: NodePartitioning) -> None:
        geometries: dict[int, dict[str, int]] = {}
        for unit in partitioning.units:
            profiles: dict[str, int] = {}
            for res, qty in unit.resources.items():
                profile = profile_from_resource(res)
                if profile is not None and qty > 0:
                    profiles[profile] = profiles.get(profile, 0) + qty
            geometries[unit.index] = profiles
        _write_spec(self._api, node_name, geometries, plan_id, C.MIG_KIND)
        logger.info("mig: node %s spec updated (plan %s)", node_name, plan_id)


class SliceNodeInitializer(NodeInitializer):
    """A virgin node's GPUs each get the fewest-slices geometry, 7g.80gb
    on an H100 (reference mig/initializer.go:58-83): every GPU the MIG
    family owns, where the JAX initializer writes the one unit of a
    TPU host."""

    def __init__(self, api: APIServer,
                 registry: GpuModelRegistry = DEFAULT_REGISTRY) -> None:
        self._api = api
        self._registry = registry

    def init_node_partitioning(self, node_name: str) -> None:
        node = self._api.get(KIND_NODE, node_name)
        labels = node.metadata.labels
        model = self._registry.get(labels.get(C.LABEL_ACCELERATOR, ""))
        count = gpu_count(labels)
        if count is None:
            raise ValueError(f"node {node_name}: no GPU count")
        fewest = fewest_slices_geometry(
            dict(g) for g in enumerate_geometries(model))
        geometries = {i: dict(fewest) for i in mig_gpus(labels, count)}
        _write_spec(self._api, node_name, geometries, new_plan_id(),
                    f"{C.MIG_KIND}-init")
        logger.info("mig: initialized virgin node %s", node_name)


def is_node_initialized(node: Node) -> bool:
    """Initialised once the node carries a spec annotation (reference
    core/util.go:76-83); the MPS path writes none."""
    return any(C.SPEC_ANNOT_RE.match(k) for k in node.metadata.annotations)
