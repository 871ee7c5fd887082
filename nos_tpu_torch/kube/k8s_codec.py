"""Kubernetes JSON to and from the port's object model,
``nos_tpu/kube/k8s_codec.py`` for the port.

The in-memory APIServer stores typed dataclasses; a kube-apiserver
speaks camelCase JSON with string quantities.  This module translates
exactly the kinds and fields the control plane uses: unknown incoming
fields are ignored, and the outgoing JSON carries only what the port
sets.  It backs ``kube/rest.py`` (the REST substrate) and
``kube/webhook.py`` (admission reviews).  The CRDs are served under the
port's group, ``nos.nebuly.com/v1alpha1``; the MPS shares
(``nvidia.com/gpu-<n>gb``) and MIG profiles are plain extended-resource
quantities.
"""

from __future__ import annotations

import calendar
import re
import time
from typing import Any

from nos_tpu_torch.api.constants import GROUP
from nos_tpu_torch.api.elasticquota import (
    CompositeElasticQuota, CompositeElasticQuotaSpec, ElasticQuota,
    ElasticQuotaSpec, ElasticQuotaStatus,
)
from nos_tpu_torch.api.pdb import (
    PodDisruptionBudget, PodDisruptionBudgetSpec, PodDisruptionBudgetStatus,
)
from nos_tpu_torch.api.podgroup import PodGroup, PodGroupSpec, PodGroupStatus
from nos_tpu_torch.kube.objects import (
    ConfigMap, Container, Node, NodeStatus, ObjectMeta, Pod, PodCondition,
    PodSpec, PodStatus,
)

GROUP_VERSION = f"{GROUP}/v1alpha1"

# kind -> (apiVersion, REST plural, namespaced)
KIND_REST: dict[str, tuple[str, str, bool]] = {
    "Pod": ("v1", "pods", True),
    "Node": ("v1", "nodes", False),
    "ConfigMap": ("v1", "configmaps", True),
    "ElasticQuota": (GROUP_VERSION, "elasticquotas", True),
    "CompositeElasticQuota": (GROUP_VERSION, "compositeelasticquotas", True),
    "PodGroup": (GROUP_VERSION, "podgroups", True),
    "PodDisruptionBudget": ("policy/v1", "poddisruptionbudgets", True),
}

_QTY_SUFFIX = {
    "Ki": 2 ** 10, "Mi": 2 ** 20, "Gi": 2 ** 30, "Ti": 2 ** 40,
    "k": 1e3, "M": 1e6, "G": 1e9, "T": 1e12, "m": 1e-3,
}


def parse_quantity(q: Any) -> float:
    """A resource.Quantity string as a float: plain numbers, binary and
    SI suffixes, milli."""
    if isinstance(q, (int, float)):
        return float(q)
    s = str(q).strip()
    m = re.fullmatch(r"([0-9.eE+-]+)([A-Za-z]*)", s)
    if not m:
        raise ValueError(f"unparseable quantity {q!r}")
    value, suffix = m.groups()
    mult = _QTY_SUFFIX.get(suffix, None) if suffix else 1
    if mult is None:
        raise ValueError(f"unknown quantity suffix {suffix!r} in {q!r}")
    return float(value) * mult


def format_quantity(v: float) -> str:
    if v == int(v):
        return str(int(v))
    return str(v)


def _resources_out(rl: dict) -> dict:
    return {k: format_quantity(v) for k, v in (rl or {}).items()}


def _resources_in(data: dict) -> dict:
    return {k: parse_quantity(v) for k, v in (data or {}).items()}


_RFC3339 = "%Y-%m-%dT%H:%M:%SZ"


def _ts_in(s: Any) -> float:
    """A creation timestamp, as seconds or RFC 3339; 0.0 when absent or
    unreadable."""
    if not s:
        return 0.0
    try:
        return float(s)
    except (TypeError, ValueError):
        pass
    try:
        return float(calendar.timegm(time.strptime(str(s), _RFC3339)))
    except ValueError:
        return 0.0


def meta_out(meta: ObjectMeta, namespaced: bool) -> dict:
    out: dict = {"name": meta.name}
    if namespaced and meta.namespace:
        out["namespace"] = meta.namespace
    if meta.labels:
        out["labels"] = dict(meta.labels)
    if meta.annotations:
        out["annotations"] = dict(meta.annotations)
    if meta.resource_version:
        out["resourceVersion"] = str(meta.resource_version)
    if meta.uid and not meta.uid.startswith("uid-"):
        out["uid"] = meta.uid
    return out


def meta_in(data: dict) -> ObjectMeta:
    owners = data.get("ownerReferences") or []
    owner_kind = owners[0].get("kind", "") if owners else ""
    try:
        rv = int(data.get("resourceVersion", 0))
    except (TypeError, ValueError):
        rv = 0
    return ObjectMeta(
        name=data.get("name", ""),
        namespace=data.get("namespace", ""),
        uid=data.get("uid") or ObjectMeta().uid,
        labels=dict(data.get("labels") or {}),
        annotations=dict(data.get("annotations") or {}),
        creation_timestamp=_ts_in(data.get("creationTimestamp")),
        owner_kind=owner_kind,
        resource_version=rv,
    )


# -- per-kind codecs ---------------------------------------------------------

def _pod_out(p: Pod) -> dict:
    def container_out(c: Container) -> dict:
        return {"name": c.name,
                "resources": {"limits": _resources_out(c.resources)}}

    spec: dict = {
        "containers": [container_out(c) for c in p.spec.containers],
        "schedulerName": p.spec.scheduler_name,
    }
    if p.spec.init_containers:
        spec["initContainers"] = [
            container_out(c) for c in p.spec.init_containers]
    if p.spec.overhead:
        spec["overhead"] = _resources_out(p.spec.overhead)
    if p.spec.node_name:
        spec["nodeName"] = p.spec.node_name
    if p.spec.priority:
        spec["priority"] = p.spec.priority
    if p.spec.preemption_policy != "PreemptLowerPriority":
        spec["preemptionPolicy"] = p.spec.preemption_policy
    status: dict = {"phase": p.status.phase}
    if p.status.conditions:
        status["conditions"] = [
            {"type": c.type, "status": c.status, "reason": c.reason,
             "message": c.message} for c in p.status.conditions]
    if p.status.nominated_node_name:
        status["nominatedNodeName"] = p.status.nominated_node_name
    return {"spec": spec, "status": status}


def _pod_in(data: dict) -> Pod:
    def container_in(c: dict) -> Container:
        limits = (c.get("resources") or {}).get("limits") or {}
        requests = (c.get("resources") or {}).get("requests") or {}
        return Container(name=c.get("name", "main"),
                         resources=_resources_in(limits or requests))

    spec = data.get("spec") or {}
    status = data.get("status") or {}
    return Pod(
        metadata=meta_in(data.get("metadata") or {}),
        spec=PodSpec(
            containers=[container_in(c)
                        for c in spec.get("containers") or []],
            init_containers=[container_in(c)
                             for c in spec.get("initContainers") or []],
            overhead=_resources_in(spec.get("overhead") or {}),
            node_name=spec.get("nodeName", ""),
            priority=spec.get("priority") or 0,
            preemption_policy=spec.get("preemptionPolicy")
            or "PreemptLowerPriority",
            scheduler_name=spec.get("schedulerName", ""),
        ),
        status=PodStatus(
            phase=status.get("phase", "Pending"),
            conditions=[
                PodCondition(type=c.get("type", ""),
                             status=c.get("status", ""),
                             reason=c.get("reason", ""),
                             message=c.get("message", ""))
                for c in status.get("conditions") or []],
            nominated_node_name=status.get("nominatedNodeName", ""),
        ),
    )


def _node_out(n: Node) -> dict:
    return {"status": {
        "allocatable": _resources_out(n.status.allocatable),
        "capacity": _resources_out(n.status.capacity),
    }}


def _node_in(data: dict) -> Node:
    status = data.get("status") or {}
    return Node(
        metadata=meta_in(data.get("metadata") or {}),
        status=NodeStatus(
            allocatable=_resources_in(status.get("allocatable") or {}),
            capacity=_resources_in(status.get("capacity") or {}),
        ),
    )


def _configmap_out(cm: ConfigMap) -> dict:
    return {"data": dict(cm.data)}


def _configmap_in(data: dict) -> ConfigMap:
    return ConfigMap(metadata=meta_in(data.get("metadata") or {}),
                     data=dict(data.get("data") or {}))


def _eq_out(eq: ElasticQuota) -> dict:
    return {"spec": {"min": _resources_out(eq.spec.min),
                     "max": _resources_out(eq.spec.max)},
            "status": {"used": _resources_out(eq.status.used)}}


def _eq_in(data: dict) -> ElasticQuota:
    spec = data.get("spec") or {}
    status = data.get("status") or {}
    return ElasticQuota(
        metadata=meta_in(data.get("metadata") or {}),
        spec=ElasticQuotaSpec(min=_resources_in(spec.get("min") or {}),
                              max=_resources_in(spec.get("max") or {})),
        status=ElasticQuotaStatus(used=_resources_in(
            status.get("used") or {})),
    )


def _ceq_out(ceq: CompositeElasticQuota) -> dict:
    return {"spec": {"min": _resources_out(ceq.spec.min),
                     "max": _resources_out(ceq.spec.max),
                     "namespaces": list(ceq.spec.namespaces)},
            "status": {"used": _resources_out(ceq.status.used)}}


def _ceq_in(data: dict) -> CompositeElasticQuota:
    spec = data.get("spec") or {}
    status = data.get("status") or {}
    return CompositeElasticQuota(
        metadata=meta_in(data.get("metadata") or {}),
        spec=CompositeElasticQuotaSpec(
            min=_resources_in(spec.get("min") or {}),
            max=_resources_in(spec.get("max") or {}),
            namespaces=list(spec.get("namespaces") or [])),
        status=ElasticQuotaStatus(used=_resources_in(
            status.get("used") or {})),
    )


def _pg_out(pg: PodGroup) -> dict:
    return {"spec": {"minMember": pg.spec.min_member, "mesh": pg.spec.mesh},
            "status": {"phase": pg.status.phase,
                       "scheduled": pg.status.scheduled}}


def _pg_in(data: dict) -> PodGroup:
    spec = data.get("spec") or {}
    status = data.get("status") or {}
    return PodGroup(
        metadata=meta_in(data.get("metadata") or {}),
        spec=PodGroupSpec(min_member=spec.get("minMember") or 1,
                          mesh=spec.get("mesh", "")),
        status=PodGroupStatus(phase=status.get("phase", "Pending"),
                              scheduled=status.get("scheduled") or 0),
    )


def _pdb_out(pdb: PodDisruptionBudget) -> dict:
    return {"spec": {"minAvailable": pdb.spec.min_available,
                     "selector": {"matchLabels": dict(pdb.spec.selector)}},
            "status": {
                "disruptionsAllowed": pdb.status.disruptions_allowed,
                "currentHealthy": pdb.status.current_healthy,
                "desiredHealthy": pdb.status.desired_healthy}}


def _pdb_in(data: dict) -> PodDisruptionBudget:
    spec = data.get("spec") or {}
    status = data.get("status") or {}
    selector = (spec.get("selector") or {}).get("matchLabels") or {}
    return PodDisruptionBudget(
        metadata=meta_in(data.get("metadata") or {}),
        spec=PodDisruptionBudgetSpec(
            min_available=spec.get("minAvailable") or 0,
            selector=dict(selector)),
        status=PodDisruptionBudgetStatus(
            disruptions_allowed=status.get("disruptionsAllowed") or 0,
            current_healthy=status.get("currentHealthy") or 0,
            desired_healthy=status.get("desiredHealthy") or 0),
    )


_OUT = {"Pod": _pod_out, "Node": _node_out, "ConfigMap": _configmap_out,
        "ElasticQuota": _eq_out, "CompositeElasticQuota": _ceq_out,
        "PodGroup": _pg_out, "PodDisruptionBudget": _pdb_out}
_IN = {"Pod": _pod_in, "Node": _node_in, "ConfigMap": _configmap_in,
       "ElasticQuota": _eq_in, "CompositeElasticQuota": _ceq_in,
       "PodGroup": _pg_in, "PodDisruptionBudget": _pdb_in}


def to_k8s(kind: str, obj: Any) -> dict:
    api_version, _, namespaced = KIND_REST[kind]
    body = _OUT[kind](obj)
    body["apiVersion"] = api_version
    body["kind"] = kind
    body["metadata"] = meta_out(obj.metadata, namespaced)
    return body


def from_k8s(kind: str, data: dict) -> Any:
    return _IN[kind](data)


def rest_path(kind: str, namespace: str = "", name: str = "") -> str:
    """A kind's API path: the collection without a name, the object with
    one."""
    api_version, plural, namespaced = KIND_REST[kind]
    prefix = f"/api/{api_version}" if "/" not in api_version \
        else f"/apis/{api_version}"
    if namespaced and namespace:
        path = f"{prefix}/namespaces/{namespace}/{plural}"
    else:
        path = f"{prefix}/{plural}"
    return f"{path}/{name}" if name else path
