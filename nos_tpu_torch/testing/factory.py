"""Object factories for tests and the smoke run,
``nos_tpu/testing/factory.py`` for the port (reference
pkg/test/factory/core_factory.go:27-229): GPU nodes, pods and pod
groups."""

from __future__ import annotations

import itertools
from typing import Mapping

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.api.podgroup import PodGroup, PodGroupSpec
from nos_tpu_torch.kube.objects import (
    Container, Node, NodeStatus, ObjectMeta, PENDING, Pod, PodSpec, PodStatus,
)
from nos_tpu_torch.topology.annotations import StatusAnnotation
from nos_tpu_torch.topology.known import H100_80GB, GpuModel
from nos_tpu_torch.topology.profile import (
    slice_resource_name, timeshare_resource_name,
)

_name_counter = itertools.count(1)


def make_node(name: str = "", labels: dict | None = None,
              annotations: dict | None = None,
              allocatable: dict | None = None) -> Node:
    name = name or f"node-{next(_name_counter)}"
    return Node(
        metadata=ObjectMeta(name=name, labels=labels or {},
                            annotations=annotations or {}),
        status=NodeStatus(allocatable=dict(allocatable or {}),
                          capacity=dict(allocatable or {})),
    )


def make_gpu_node(name: str = "", model: GpuModel = H100_80GB,
                  gpus: int = 8, partitioning: str = C.MPS_KIND,
                  status_geometry: Mapping[int, Mapping[str, Mapping[str, int]]]
                  | None = None,
                  extra_labels: dict | None = None, domain: str = "",
                  host_index: int | None = None,
                  spare: bool = False) -> Node:
    """A node of ``gpus`` cards of ``model``.  ``status_geometry`` is
    {GPU index: {"free" | "used": {profile: qty}}}, rendered as the node
    agent's status annotations and added to the allocatable.  ``domain``
    names its NVLink domain ("": unlabelled), ``host_index`` its ordinal
    there (None: unlabelled); ``spare`` holds it as a warm spare."""
    labels = {
        C.LABEL_ACCELERATOR: model.name,
        C.LABEL_PARTITIONING: partitioning,
        C.LABEL_GPU_COUNT: str(gpus),
    }
    if domain:
        labels[C.LABEL_NVLINK_DOMAIN] = domain
    if host_index is not None:
        labels[C.LABEL_HOST_INDEX] = str(host_index)
    if spare:
        labels[C.LABEL_SPARE] = C.SPARE_WARM
    labels.update(extra_labels or {})
    annotations: dict[str, str] = {}
    allocatable: dict[str, float] = {
        C.CPU: 64.0, C.MEMORY: 256 * 1024.0**3, C.RESOURCE_GPU: float(gpus),
    }
    for index, tables in (status_geometry or {}).items():
        for status, table in tables.items():
            for profile, qty in table.items():
                annotations[StatusAnnotation(index, profile, status,
                                             qty).key] = str(qty)
                if "." in profile:
                    res = slice_resource_name(profile)
                else:
                    res = timeshare_resource_name(int(profile[:-2]))
                allocatable[res] = allocatable.get(res, 0.0) + qty
    return make_node(name, labels, annotations, allocatable)


def make_pod(name: str = "", namespace: str = "default",
             resources: dict | None = None, priority: int = 0,
             node_name: str = "", phase: str = PENDING,
             labels: dict | None = None, annotations: dict | None = None,
             creation_timestamp: float = 0.0) -> Pod:
    name = name or f"pod-{next(_name_counter)}"
    return Pod(
        metadata=ObjectMeta(name=name, namespace=namespace,
                            labels=labels or {}, annotations=annotations or {},
                            creation_timestamp=creation_timestamp),
        spec=PodSpec(containers=[Container(resources=dict(resources or {}))],
                     priority=priority, node_name=node_name),
        status=PodStatus(phase=phase),
    )


def make_timeshare_pod(gb: int, qty: int = 1, **kw) -> Pod:
    """A pod asking for ``qty`` shares of ``gb`` GB (``nvidia.com/gpu-<gb>gb``)
    and one CPU."""
    res = {timeshare_resource_name(gb): qty, C.CPU: 1.0}
    return make_pod(resources=res, **kw)


def make_mig_pod(profile: str, qty: int = 1, **kw) -> Pod:
    """A pod asking for ``qty`` MIG instances of ``profile``
    (``nvidia.com/mig-<profile>``) and one CPU."""
    res = {slice_resource_name(profile): qty, C.CPU: 1.0}
    return make_pod(resources=res, **kw)


def make_pod_group(name: str, min_member: int, mesh: str = "",
                   namespace: str = "default") -> PodGroup:
    """A PodGroup: its members are the pods labelled
    ``nos.nebuly.com/pod-group: <name>`` in ``namespace``."""
    return PodGroup(metadata=ObjectMeta(name=name, namespace=namespace),
                    spec=PodGroupSpec(min_member=min_member, mesh=mesh))




def admit_all(api) -> int:
    """The kubelet's admission for agentless tests and fleets: every
    bound Pending pod on every node moves to Running, MIG pods too (no
    agent holds their devices back), as the JAX package's ``admit_all``
    does."""
    from nos_tpu_torch.controllers.kubelet import admit_bound_pods
    from nos_tpu_torch.kube.client import KIND_NODE

    return sum(admit_bound_pods(api, node.metadata.name, mig_pods=True)
               for node in api.list(KIND_NODE))
