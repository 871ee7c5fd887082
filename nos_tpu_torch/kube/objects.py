"""Minimal Kubernetes object model, ``nos_tpu/kube/objects.py`` for the
port: the typed Node, Pod, ConfigMap and ObjectMeta the planner and the
API server exchange (the corev1 types of the reference).
"""

from __future__ import annotations

import copy
import itertools
from dataclasses import dataclass, field

from .resources import ResourceList

_uid_counter = itertools.count(1)

# The APIServer deep-copies on every read and write; these trees are
# acyclic and alias-free, so a direct structural copy keeps deepcopy's
# semantics without its per-object dispatch.
_ATOMIC = (str, int, float, bool, type(None))


def _fast_copy(v, memo):
    t = v.__class__
    if t in _ATOMIC:
        return v
    if t is dict:
        return {k: _fast_copy(x, memo) for k, x in v.items()}
    if t is list:
        return [_fast_copy(x, memo) for x in v]
    if t is tuple:
        return tuple(_fast_copy(x, memo) for x in v)
    dc = getattr(v, "__deepcopy__", None)
    if dc is not None:
        return dc(memo)
    return copy.deepcopy(v, memo)


class FastCopy:
    """Mixin: structural ``__deepcopy__`` over every instance attribute."""

    def __deepcopy__(self, memo):
        new = object.__new__(self.__class__)
        nd = new.__dict__
        for k, v in self.__dict__.items():
            nd[k] = _fast_copy(v, memo)
        return new


def new_uid() -> str:
    return f"uid-{next(_uid_counter)}"


@dataclass
class ObjectMeta(FastCopy):
    name: str = ""
    namespace: str = ""
    uid: str = field(default_factory=new_uid)
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    creation_timestamp: float = 0.0
    owner_kind: str = ""          # e.g. "DaemonSet", read by pod predicates
    resource_version: int = 0


@dataclass
class Container(FastCopy):
    name: str = "main"
    resources: ResourceList = field(default_factory=dict)


@dataclass
class PodSpec(FastCopy):
    containers: list[Container] = field(default_factory=list)
    init_containers: list[Container] = field(default_factory=list)
    overhead: ResourceList = field(default_factory=dict)
    node_name: str = ""
    priority: int = 0


@dataclass
class PodCondition(FastCopy):
    type: str
    status: str
    reason: str = ""
    message: str = ""


# Pod phases
PENDING = "Pending"
RUNNING = "Running"
SUCCEEDED = "Succeeded"
FAILED = "Failed"


@dataclass
class PodStatus(FastCopy):
    phase: str = PENDING
    conditions: list[PodCondition] = field(default_factory=list)
    nominated_node_name: str = ""


@dataclass
class Pod(FastCopy):
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)

    @property
    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"

    def is_unschedulable(self) -> bool:
        """Marked unschedulable by the scheduler: the condition
        PodScheduled=False with reason Unschedulable (reference
        pkg/util/pod/pod.go:31-39).  A reason refined in place
        ("Unschedulable/<class>") still counts."""
        return any(
            c.type == "PodScheduled" and c.status == "False"
            and c.reason.split("/", 1)[0] == "Unschedulable"
            for c in self.status.conditions
        )


@dataclass
class NodeStatus(FastCopy):
    allocatable: ResourceList = field(default_factory=dict)
    capacity: ResourceList = field(default_factory=dict)


@dataclass
class Node(FastCopy):
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    status: NodeStatus = field(default_factory=NodeStatus)

    @property
    def name(self) -> str:
        return self.metadata.name


@dataclass
class ConfigMap(FastCopy):
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    data: dict[str, str] = field(default_factory=dict)
