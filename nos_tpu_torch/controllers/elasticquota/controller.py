"""ElasticQuota and CompositeElasticQuota reconcilers,
``nos_tpu/controllers/elasticquota/controller.py`` for the port
(reference internal/controllers/elasticquota/{elasticquota_controller.go:
66-189, compositeelasticquota_controller.go:70-244, elasticquota.go:
38-149}).

A reconcile walks the quota's Running pods in a fixed order (creation
time, priority, request, name), sums ``used``, and labels each pod
``nos.nebuly.com/capacity=in-quota`` while the running sum stays within
min on every resource min names, ``over-quota`` after: the label the
preemption walk keys on.  Resources min does not name are dropped from
``status.used``.  A composite quota's reconcile first deletes every
plain ElasticQuota in its namespaces.  A label flip is journaled and
noted in the chip-second ledger (``obs/ledger.py``) as the
``quota_stranded`` hint: the team whose borrowing last moved.
"""

from __future__ import annotations

import logging

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.api.elasticquota import (
    CompositeElasticQuota, ElasticQuota,
)
from nos_tpu_torch.kube.client import (
    APIServer, KIND_COMPOSITE_ELASTIC_QUOTA, KIND_ELASTIC_QUOTA, KIND_POD,
    NotFound,
)
from nos_tpu_torch.kube.objects import RUNNING, Pod
from nos_tpu_torch.kube.resources import ResourceList, sum_resources
from nos_tpu_torch.obs import journal as J
from nos_tpu_torch.obs.ledger import get_ledger
from nos_tpu_torch.quota import GPUResourceCalculator
from nos_tpu_torch.utils.retry import retry_on_conflict

logger = logging.getLogger(__name__)


class _ReentrancyGuard:
    """The API server delivers watch events synchronously, so a reconcile
    that patches pods or status triggers itself again through its own
    watches.  Nested triggers are queued and drained in passes, a
    bounded stack however many labels flip; a run of identical passes
    (two reconcilers disagreeing on a label) or a pass count past the
    backstop drops what is queued, with a warning."""

    MAX_STALL_PASSES = 100
    MAX_TOTAL_PASSES = 10000

    def __init__(self) -> None:
        self._active = False
        self._pending: list[tuple[str, str]] = []

    def run(self, name: str, namespace: str, fn) -> None:
        self._pending.append((name, namespace))
        if self._active:
            return
        self._active = True
        try:
            stalled = passes = 0
            prev_batch: dict | None = None
            while self._pending:
                batch = dict.fromkeys(self._pending)
                self._pending.clear()
                stalled = stalled + 1 if batch == prev_batch else 0
                passes += 1
                if stalled >= self.MAX_STALL_PASSES \
                        or passes >= self.MAX_TOTAL_PASSES:
                    logger.warning(
                        "elasticquota reconcile livelock: dropping %d "
                        "pending reconcile(s) after %d passes (%d "
                        "identical; last batch %s): quota labels and "
                        "status may be stale",
                        len(batch), passes, stalled, sorted(batch))
                    break
                prev_batch = batch
                for n, ns in batch:
                    fn(n, ns)
        finally:
            self._active = False


class _PodsReconciler:
    """The pods walk both reconcilers share (reference
    elasticquota.go:38-149)."""

    def __init__(self, api: APIServer,
                 calculator: GPUResourceCalculator) -> None:
        self._api = api
        self._calculator = calculator

    def patch_pods_and_compute_used(self, pods: list[Pod],
                                    quota_min: ResourceList,
                                    quota_max: ResourceList) -> ResourceList:
        pods = sorted(pods, key=self._sort_key)
        used: ResourceList = {r: 0.0 for r in (*quota_min, *quota_max)}
        for pod in pods:
            used = sum_resources(used,
                                 self._calculator.compute_pod_request(pod))
            # first come first served, on the resources min names
            # (quota.LessThanOrEqual, elasticquota.go:53)
            over = any(used.get(r, 0.0) > quota_min[r] for r in quota_min)
            self._patch_capacity_label(
                pod, C.CAPACITY_OVER_QUOTA if over else C.CAPACITY_IN_QUOTA)
        return {r: v for r, v in used.items() if r in quota_min}

    def _sort_key(self, pod: Pod):
        req = self._calculator.compute_pod_request(pod)
        return (pod.metadata.creation_timestamp, pod.spec.priority,
                sorted(req.items()), pod.metadata.name)

    def _patch_capacity_label(self, pod: Pod, desired: str) -> None:
        prev = pod.metadata.labels.get(C.LABEL_CAPACITY)
        if prev == desired:
            return
        try:
            retry_on_conflict(
                self._api, KIND_POD, pod.metadata.name,
                lambda p: p.metadata.labels.__setitem__(
                    C.LABEL_CAPACITY, desired),
                pod.metadata.namespace, component="elasticquota")
        except NotFound:
            return
        # a flip is a quota decision: over-quota (from the start too) is
        # a borrow, back within min a reclaim; a first in-quota label is
        # neither
        if desired == C.CAPACITY_OVER_QUOTA:
            get_ledger().note_quota_flip(
                pod.key, pod.metadata.namespace, borrowed=True)
            J.record(J.QUOTA_BORROW, pod.key,
                     namespace=pod.metadata.namespace)
        elif prev is not None:
            get_ledger().note_quota_flip(
                pod.key, pod.metadata.namespace, borrowed=False)
            J.record(J.QUOTA_RECLAIM, pod.key,
                     namespace=pod.metadata.namespace)


class ElasticQuotaReconciler:
    """One ElasticQuota's status and its pods' labels (reference
    elasticquota_controller.go:66-189)."""

    def __init__(self, api: APIServer,
                 calculator: GPUResourceCalculator | None = None) -> None:
        self._api = api
        self._calculator = calculator or GPUResourceCalculator()
        self._pods = _PodsReconciler(api, self._calculator)
        self._guard = _ReentrancyGuard()

    def reconcile(self, name: str, namespace: str) -> None:
        self._guard.run(name, namespace, self._reconcile)

    def _reconcile(self, name: str, namespace: str) -> None:
        try:
            eq: ElasticQuota = self._api.get(KIND_ELASTIC_QUOTA, name,
                                             namespace)
        except NotFound:
            return
        pods = self._api.list(KIND_POD, namespace=namespace,
                              filter_fn=lambda p: p.status.phase == RUNNING)
        used = self._pods.patch_pods_and_compute_used(
            pods, eq.spec.min, eq.spec.max)
        if eq.status.used != used:
            retry_on_conflict(
                self._api, KIND_ELASTIC_QUOTA, name,
                lambda o: setattr(o.status, "used", dict(used)),
                namespace, component="elasticquota")

    def reconcile_all(self) -> None:
        for eq in self._api.list(KIND_ELASTIC_QUOTA):
            self.reconcile(eq.metadata.name, eq.metadata.namespace)

    def bind(self) -> None:
        """Reconcile on every quota event and on every pod event in a
        governed namespace (the operator's watches, reference
        cmd/operator/operator.go:50-126)."""
        self._api.watch(KIND_ELASTIC_QUOTA, lambda e, o: self.reconcile(
            o.metadata.name, o.metadata.namespace))

        def on_pod(event: str, pod: Pod) -> None:
            ns = pod.metadata.namespace
            for eq in self._api.list(KIND_ELASTIC_QUOTA, namespace=ns):
                self.reconcile(eq.metadata.name, eq.metadata.namespace)

        self._api.watch(KIND_POD, on_pod)


class CompositeElasticQuotaReconciler:
    """One CompositeElasticQuota over its namespaces; deletes every
    plain ElasticQuota there (reference
    compositeelasticquota_controller.go:112-137)."""

    def __init__(self, api: APIServer,
                 calculator: GPUResourceCalculator | None = None) -> None:
        self._api = api
        self._calculator = calculator or GPUResourceCalculator()
        self._pods = _PodsReconciler(api, self._calculator)
        self._guard = _ReentrancyGuard()

    def reconcile(self, name: str, namespace: str) -> None:
        self._guard.run(name, namespace, self._reconcile)

    def _reconcile(self, name: str, namespace: str) -> None:
        try:
            ceq: CompositeElasticQuota = self._api.get(
                KIND_COMPOSITE_ELASTIC_QUOTA, name, namespace)
        except NotFound:
            return
        for ns in ceq.spec.namespaces:
            for eq in self._api.list(KIND_ELASTIC_QUOTA, namespace=ns):
                logger.warning(
                    "deleting ElasticQuota %s/%s overlapping "
                    "CompositeElasticQuota %s",
                    ns, eq.metadata.name, ceq.metadata.name)
                try:
                    self._api.delete(KIND_ELASTIC_QUOTA, eq.metadata.name, ns)
                except NotFound:
                    pass
        pods: list[Pod] = []
        for ns in ceq.spec.namespaces:
            pods.extend(self._api.list(
                KIND_POD, namespace=ns,
                filter_fn=lambda p: p.status.phase == RUNNING))
        used = self._pods.patch_pods_and_compute_used(
            pods, ceq.spec.min, ceq.spec.max)
        if ceq.status.used != used:
            retry_on_conflict(
                self._api, KIND_COMPOSITE_ELASTIC_QUOTA, name,
                lambda o: setattr(o.status, "used", dict(used)),
                namespace, component="elasticquota")

    def reconcile_all(self) -> None:
        for ceq in self._api.list(KIND_COMPOSITE_ELASTIC_QUOTA):
            self.reconcile(ceq.metadata.name, ceq.metadata.namespace)

    def bind(self) -> None:
        self._api.watch(KIND_COMPOSITE_ELASTIC_QUOTA,
                        lambda e, o: self.reconcile(o.metadata.name,
                                                    o.metadata.namespace))

        def on_pod(event: str, pod: Pod) -> None:
            ns = pod.metadata.namespace
            for ceq in self._api.list(KIND_COMPOSITE_ELASTIC_QUOTA):
                if ns in ceq.spec.namespaces:
                    self.reconcile(ceq.metadata.name, ceq.metadata.namespace)

        self._api.watch(KIND_POD, on_pod)
