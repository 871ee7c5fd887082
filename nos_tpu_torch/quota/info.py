"""ElasticQuotaInfo: the per-quota usage ledger,
``nos_tpu/quota/info.py`` for the port (reference
pkg/scheduler/plugins/capacityscheduling/elasticquotainfo.go:30-361),
ResourceLists as plain dicts and the arithmetic exact.

A limit bounds only the resources it names, as in the JAX package: the
reference's scheduler compares cpu and memory always (sumGreaterThan,
elasticquotainfo.go:319-338), which would hold any pod asking for a CPU
unschedulable under a quota in ``nos.nebuly.com/gpu-memory`` alone,
while its own reconciler labels that pod in-quota
(quota.LessThanOrEqual, elasticquota.go:53).  The reconciler's rule
holds everywhere here.  Aggregates count a CompositeElasticQuota once,
not once per namespace it spans.
"""

from __future__ import annotations

import math
from typing import Iterable, Mapping

from nos_tpu_torch.kube.resources import (
    ResourceList, subtract, subtract_non_negative, sum_resources,
)


def sum_greater_than(x1: Mapping[str, float], x2: Mapping[str, float],
                     y: Mapping[str, float]) -> bool:
    """True iff any resource of (x1+x2) that y names exceeds y."""
    return any(x1.get(r, 0.0) + x2.get(r, 0.0) > limit
               for r, limit in y.items())


def greater_than(x: Mapping[str, float], y: Mapping[str, float]) -> bool:
    return sum_greater_than(x, {}, y)


def sum_less_than_equal(x1: Mapping[str, float], x2: Mapping[str, float],
                        y: Mapping[str, float]) -> bool:
    return not sum_greater_than(x1, x2, y)


class ElasticQuotaInfo:
    """Wraps one ElasticQuota or CompositeElasticQuota with usage tracking
    (reference elasticquotainfo.go:176-310)."""

    def __init__(self, resource_name: str, resource_namespace: str,
                 namespaces: Iterable[str], min: ResourceList,
                 max: ResourceList | None, calculator,
                 composite: bool = False) -> None:
        self.resource_name = resource_name
        self.resource_namespace = resource_namespace
        self.namespaces: set[str] = set(namespaces)
        self.min: ResourceList = dict(min)
        self.max: ResourceList = dict(max or {})
        self.max_enforced = bool(max)
        self.used: ResourceList = {}
        # pod key ("ns/name") -> the request booked for it, so usage can
        # be released without the pod object (a composite quota's
        # namespace set shrinking under it)
        self.pods: dict[str, ResourceList] = {}
        self.calculator = calculator
        self.composite = composite

    # -- usage bookkeeping --------------------------------------------------
    def add_pod_if_not_present(self, pod) -> None:
        key = pod.key
        if key in self.pods:
            return
        req = self.calculator.compute_pod_request(pod)
        self.pods[key] = req
        self.used = sum_resources(self.used, req)

    def delete_pod_if_present(self, pod) -> None:
        self._release(pod.key)

    def _release(self, key: str) -> None:
        req = self.pods.pop(key, None)
        if req is not None:
            self.used = subtract(self.used, req)

    # -- limit checks -------------------------------------------------------
    def used_over_min_with(self, pod_request: ResourceList) -> bool:
        return sum_greater_than(pod_request, self.used, self.min)

    def used_over_max_with(self, pod_request: ResourceList) -> bool:
        if self.max_enforced:
            return sum_greater_than(pod_request, self.used, self.max)
        return False

    def used_over_min(self) -> bool:
        return greater_than(self.used, self.min)

    def used_over(self, limit: ResourceList) -> bool:
        return greater_than(self.used, limit)

    def used_lte_with(self, limit: ResourceList, pod_request: ResourceList) -> bool:
        return sum_less_than_equal(pod_request, self.used, limit)

    def clone(self) -> "ElasticQuotaInfo":
        out = ElasticQuotaInfo(
            self.resource_name, self.resource_namespace, set(self.namespaces),
            dict(self.min), dict(self.max) if self.max_enforced else None,
            self.calculator, self.composite,
        )
        out.max_enforced = self.max_enforced
        out.used = dict(self.used)
        out.pods = {k: dict(v) for k, v in self.pods.items()}
        return out


class ElasticQuotaInfos(dict):
    """namespace -> ElasticQuotaInfo (reference elasticquotainfo.go:31-174).
    A CompositeElasticQuota registers the same info under every namespace it
    spans."""

    def clone(self) -> "ElasticQuotaInfos":
        out = ElasticQuotaInfos()
        seen: dict[int, ElasticQuotaInfo] = {}
        for ns, info in self.items():
            # a composite quota stays one object under all its namespaces
            if id(info) not in seen:
                seen[id(info)] = info.clone()
            out[ns] = seen[id(info)]
        return out

    def add(self, info: ElasticQuotaInfo) -> None:
        for ns in info.namespaces:
            self[ns] = info

    def update_info(self, old: ElasticQuotaInfo, new: ElasticQuotaInfo) -> None:
        """Replace ``old`` with ``new``, carrying the usage booked on
        ``old``, the previous info of the same quota object (the
        reference's per-namespace carry, elasticquotainfo.go:51-66, is
        last-wins over map order and corrupts a composite quota's
        ledger when it grows over a plain one).  Pods of namespaces that
        left the quota are released; those of newly covered namespaces
        are the caller's recount (``CapacityScheduling._recount``),
        idempotent through ``add_pod_if_not_present``."""
        new.pods = {k: dict(v) for k, v in old.pods.items()}
        new.used = dict(old.used)
        for key in list(new.pods):
            ns = key.split("/", 1)[0]
            if ns not in new.namespaces:
                new._release(key)
        for ns in old.namespaces:
            if ns not in new.namespaces and self.get(ns) is old:
                del self[ns]
        for ns in new.namespaces:
            self[ns] = new

    def delete(self, info: ElasticQuotaInfo) -> None:
        for ns in info.namespaces:
            self.pop(ns, None)

    # -- aggregates ---------------------------------------------------------
    def _unique_infos(self) -> list[ElasticQuotaInfo]:
        seen: dict[int, ElasticQuotaInfo] = {}
        for info in self.values():
            seen[id(info)] = info
        return list(seen.values())

    def aggregated_min(self) -> ResourceList:
        total: ResourceList = {}
        for info in self._unique_infos():
            total = sum_resources(total, info.min)
        return total

    def aggregated_used(self) -> ResourceList:
        total: ResourceList = {}
        for info in self._unique_infos():
            total = sum_resources(total, info.used)
        return total

    def aggregated_used_over_min_with(self, pod_request: ResourceList) -> bool:
        return sum_greater_than(self.aggregated_used(), pod_request,
                                self.aggregated_min())

    def aggregated_overquotas(self) -> ResourceList:
        """Total quota usable over-min: sum of each quota's unused min
        (reference elasticquotainfo.go:121-152)."""
        total: ResourceList = {}
        for info in self._unique_infos():
            total = sum_resources(total, subtract_non_negative(info.min, info.used))
        return total

    def get_guaranteed_overquotas(self, namespace: str) -> ResourceList:
        """The share of aggregate unused min guaranteed to `namespace`'s
        quota, proportional to its min (reference elasticquotainfo.go:81-119).
        """
        info = self.get(namespace)
        if info is None:
            raise KeyError(f"no elastic quota covers namespace {namespace!r}")
        total_min = self.aggregated_min()
        over = self.aggregated_overquotas()
        result: ResourceList = {}
        for r, v in over.items():
            t = total_min.get(r, 0.0)
            pct = (info.min.get(r, 0.0) / t) if t > 0 else 0.0
            result[r] = float(math.floor(v * pct))
        return result
