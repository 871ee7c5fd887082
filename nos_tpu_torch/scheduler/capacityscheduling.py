"""CapacityScheduling: elastic-quota enforcement and over-quota
preemption, ``nos_tpu/scheduler/capacityscheduling.py`` for the port
(reference pkg/scheduler/plugins/capacityscheduling/
capacity_scheduling.go), in ``nos.nebuly.com/gpu-memory`` GB
(``quota/calculator.py``).

Its points (reference :92-95):

- PreFilter (:190-278): a clone of the quota ledger into the cycle
  state; nominated pods accounted; a pod is rejected when its quota's
  used + request passes max, or the aggregate used + request passes the
  aggregate min.
- AddPod / RemovePod (:286-321): keep that clone coherent through the
  preemption what-ifs.
- PostFilter (:323-341): preemption, choosing victims by quota standing
  with the guaranteed share of the unused min (SelectVictimsOnNode
  :468-675), budgets respected, evicted by deleting the pods.
- Reserve / Unreserve (:343-369): book usage on the live ledger.

As in the JAX package, the aggregates count a CompositeElasticQuota
once, not once per namespace it spans (the reference's map range counts
it N times, elasticquotainfo.go:154-174).  A gang member is only ever
evicted with its whole gang (``gang.evict_gang``), and a gang preemptor
reaches PostFilter through its stuck member with the placed mates
booked in the cycle state (``Scheduler._gang_no_fit``), so victims are
chosen against the whole gang's claim.  The walk's cheapest rung is a
shrink (``scheduler/elastic.py``): a member of an elastic data-parallel
gang above its min is walked first, dies alone, and its gang's
survivors get the dp-resize stamp.
"""

from __future__ import annotations

import logging
from typing import Any

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.api.pdb import list_pdbs
from nos_tpu_torch.device import native
from nos_tpu_torch.exporter.metrics import REGISTRY
from nos_tpu_torch.kube.client import (
    APIServer, KIND_COMPOSITE_ELASTIC_QUOTA, KIND_ELASTIC_QUOTA, KIND_POD,
    NotFound,
)
from nos_tpu_torch.kube.objects import PENDING, RUNNING, Pod
from nos_tpu_torch.kube.resources import (
    ResourceList, fits, pod_request, sum_resources,
)
from nos_tpu_torch.obs import journal as J
from nos_tpu_torch.obs.journal import MAX_JOURNAL_NODES
from nos_tpu_torch.quota import (
    ElasticQuotaInfo, ElasticQuotaInfos, GPUResourceCalculator,
)
from nos_tpu_torch.scheduler.framework import (
    CycleState, Framework, NodeInfo, SharedLister, Status, _mig_slots,
)
from nos_tpu_torch.scheduler.elastic import record_shrink, shrink_headroom
from nos_tpu_torch.scheduler.gang import evict_gang, gang_name
from nos_tpu_torch.scheduler.native_filter import node_model
from nos_tpu_torch.topology.known import DEFAULT_REGISTRY
from nos_tpu_torch.utils.pod_util import (
    elastic_replica_bounds, is_displaced_fresh, is_over_quota, job_progress,
    tier_rank, workload_tier,
)

logger = logging.getLogger(__name__)

REGISTRY.describe("nos_tpu_preemptions_total",
                  "Over-quota preemption decisions executed")
REGISTRY.describe("nos_tpu_preemption_victims_total",
                  "Pods evicted by over-quota preemption")

PRE_FILTER_STATE_KEY = "PreFilterCapacityScheduling"
ELASTIC_QUOTA_SNAPSHOT_KEY = "ElasticQuotaSnapshot"
# (now, displaced age cap) the scheduler puts in the cycle state before
# PostFilter, so the restart-cost walk judges "displaced" as the
# admission queue does; absent (the plugin driven alone) a stamp never
# expires
DISPLACED_CONTEXT_KEY = "DisplacedPreemptorContext"
# the scheduler's view epoch, put in the cycle state before PostFilter
# only when the walk runs on the cache's own lister: equal epochs
# certify the same nodes and allocatables, the victim masks' key
VIEW_EPOCH_CONTEXT_KEY = "SchedulerViewEpoch"


class PreFilterState:
    """Reference capacity_scheduling.go:61-73."""

    def __init__(self, pod_req: ResourceList,
                 nominated_in_eq_with_req: ResourceList | None = None,
                 nominated_with_req: ResourceList | None = None) -> None:
        self.pod_req = pod_req
        # the request plus the nominated pods of the same quota at the
        # preemptor's priority or above
        self.nominated_in_eq_with_req = \
            nominated_in_eq_with_req or dict(pod_req)
        # the request plus those, plus the nominated pods of other
        # quotas within their min
        self.nominated_with_req = nominated_with_req or dict(pod_req)


def victim_prescreen(preemptor: Pod, pv: Pod,
                     snapshot: ElasticQuotaInfos) -> bool:
    """Whether ``pv`` could ever be a victim of ``preemptor`` in
    ``_select_victims_on_node``'s walk: a superset of its branches (it
    skips the guaranteed-share arithmetic and the preemptor's standing,
    which only narrow), so a node it clears holds no victim.  A
    preemptor outside any quota takes lower-priority pods outside any
    quota; one inside a quota takes lower-priority pods of its own
    namespace, or over-quota-labelled pods of other governed
    namespaces."""
    preemptor_governed = snapshot.get(preemptor.metadata.namespace) \
        is not None
    governed = snapshot.get(pv.metadata.namespace) is not None
    if not preemptor_governed:
        return not governed and pv.spec.priority < preemptor.spec.priority
    if not governed:
        return False
    if pv.metadata.namespace == preemptor.metadata.namespace:
        return pv.spec.priority < preemptor.spec.priority
    return is_over_quota(pv)


def _spec_unchanged(old: ElasticQuotaInfo, new: ElasticQuotaInfo) -> bool:
    """Nothing the ledger reads changed: a status-only update (the
    reconcilers' ``used``) skips the recount."""
    return (old.namespaces == new.namespaces and old.min == new.min
            and old.max == new.max and old.max_enforced == new.max_enforced)


def info_from_quota(obj: Any, calculator: GPUResourceCalculator,
                    composite: bool = False) -> ElasticQuotaInfo:
    """The ledger entry of an ElasticQuota or CompositeElasticQuota (the
    informer's mapping, reference informer.go:139-260)."""
    return ElasticQuotaInfo(
        resource_name=obj.metadata.name,
        resource_namespace=obj.metadata.namespace,
        namespaces=obj.namespaces, min=obj.spec.min,
        max=obj.spec.max or None, calculator=calculator,
        composite=composite)


def _fits_empty(req: ResourceList, ni: NodeInfo) -> bool:
    """NodeResourcesFit's verdict on ``ni`` with no pod on it."""
    if not fits(req, ni.allocatable):
        return False
    model = DEFAULT_REGISTRY.models.get(
        ni.node.metadata.labels.get(C.LABEL_ACCELERATOR, ""))
    pod_g, pod_m = _mig_slots(req, model)
    if not pod_g:
        return True
    cap_g, cap_m = _mig_slots(ni.allocatable, model)
    return pod_g <= cap_g and pod_m <= cap_m


class CapacityScheduling:
    """The plugin.  ``attach(api)`` syncs the ledger from the API server
    (the informer); detached, the ledger stays empty."""

    name = "CapacityScheduling"

    def __init__(self, calculator: GPUResourceCalculator | None = None
                 ) -> None:
        self.calculator = calculator or GPUResourceCalculator()
        self.elastic_quota_infos = ElasticQuotaInfos()
        self._api: APIServer | None = None
        self._framework: Framework | None = None
        # called as on_preempt(preemptor, victims) before each eviction:
        # how a run audits that every cross-namespace victim was
        # over-quota
        self.on_preempt = None
        self._nominated_rv: int | None = None
        self._nominated_cache: list[Pod] = []
        # request signature -> (view epoch, nodes that fit it empty);
        # cleared whole past 512 signatures
        self._victim_mask_cache: dict[
            tuple, tuple[int, frozenset[str]]] = {}

    # -- wiring -------------------------------------------------------------
    def set_framework(self, fw: Framework) -> None:
        """The framework whose Filter the what-ifs rerun (reference
        RunFilterPluginsWithNominatedPods, :610,639)."""
        self._framework = fw

    def attach(self, api: APIServer) -> None:
        """Watch quotas and pods (the informer handlers, reference
        capacity_scheduling.go:131-172)."""
        self._api = api
        api.watch(KIND_ELASTIC_QUOTA, self._on_eq_event)
        api.watch(KIND_COMPOSITE_ELASTIC_QUOTA, self._on_ceq_event)
        api.watch(KIND_POD, self._on_pod_event)

    def _on_eq_event(self, event: str, eq: Any) -> None:
        # a composite quota shadows plain ones on its namespaces
        # (reference informer.go:139-260)
        ns = eq.metadata.namespace
        existing = self.elastic_quota_infos.get(ns)
        if event == "DELETED":
            if existing is not None and not existing.composite \
                    and existing.resource_name == eq.metadata.name:
                self.elastic_quota_infos.delete(existing)
            return
        if existing is not None and existing.composite:
            return
        new = info_from_quota(eq, self.calculator)
        if existing is not None and _spec_unchanged(existing, new):
            return
        if existing is not None:
            self.elastic_quota_infos.update_info(existing, new)
        else:
            self.elastic_quota_infos.add(new)
        self._recount(new)

    def _on_ceq_event(self, event: str, ceq: Any) -> None:
        new = info_from_quota(ceq, self.calculator, composite=True)
        existing = next(
            (info for info in self.elastic_quota_infos.values()
             if info.composite and info.resource_name == ceq.metadata.name
             and info.resource_namespace == ceq.metadata.namespace), None)
        if event == "DELETED":
            if existing is not None:
                self.elastic_quota_infos.delete(existing)
            return
        if existing is not None and _spec_unchanged(existing, new):
            return
        if existing is not None:
            self.elastic_quota_infos.update_info(existing, new)
        else:
            for ns in new.namespaces:
                shadowed = self.elastic_quota_infos.get(ns)
                if shadowed is not None:
                    self.elastic_quota_infos.delete(shadowed)
            self.elastic_quota_infos.add(new)
        self._recount(new)

    def _recount(self, info: ElasticQuotaInfo) -> None:
        """Book the assigned pods a quota finds when it appears."""
        if self._api is None:
            return
        for pod in self._api.list(KIND_POD):
            if pod.metadata.namespace in info.namespaces \
                    and pod.spec.node_name \
                    and pod.status.phase in (PENDING, RUNNING):
                info.add_pod_if_not_present(pod)

    def _on_pod_event(self, event: str, pod: Pod) -> None:
        info = self.elastic_quota_infos.get(pod.metadata.namespace)
        if info is None:
            return
        if event == "DELETED" or pod.status.phase not in (PENDING, RUNNING):
            info.delete_pod_if_present(pod)
        elif pod.spec.node_name:
            info.add_pod_if_not_present(pod)

    # -- PreFilter ----------------------------------------------------------
    def pre_filter(self, state: CycleState, pod: Pod,
                   nodes: SharedLister) -> Status:
        # an existing clone in the state is reused: a gang's members
        # share one state and see each other through AddPod
        snapshot = state.get(ELASTIC_QUOTA_SNAPSHOT_KEY)
        if snapshot is None:
            snapshot = self.elastic_quota_infos.clone()
            state[ELASTIC_QUOTA_SNAPSHOT_KEY] = snapshot
        pod_req = self.calculator.compute_pod_request(pod)
        eq = snapshot.get(pod.metadata.namespace)
        if eq is None:
            state[PRE_FILTER_STATE_KEY] = PreFilterState(pod_req)
            return Status.ok()
        nominated_in_eq: ResourceList = {}
        nominated_all: ResourceList = {}
        for np in self._nominated_pods():
            if np.metadata.uid == pod.metadata.uid:
                continue
            ns = np.metadata.namespace
            info = self.elastic_quota_infos.get(ns)
            if info is None:
                continue
            req = self.calculator.compute_pod_request(np)
            if ns == pod.metadata.namespace \
                    and np.spec.priority >= pod.spec.priority:
                nominated_in_eq = sum_resources(nominated_in_eq, req)
                nominated_all = sum_resources(nominated_all, req)
            elif ns != pod.metadata.namespace and not info.used_over_min():
                nominated_all = sum_resources(nominated_all, req)
        pfs = PreFilterState(pod_req,
                             sum_resources(nominated_in_eq, pod_req),
                             sum_resources(nominated_all, pod_req))
        state[PRE_FILTER_STATE_KEY] = pfs
        if eq.used_over_max_with(pfs.nominated_in_eq_with_req):
            return Status.unschedulable(
                f"quota {eq.resource_namespace}/{eq.resource_name} "
                f"used more than max", reason="quota")
        if snapshot.aggregated_used_over_min_with(pfs.nominated_with_req):
            return Status.unschedulable("total quota used is more than min",
                                        reason="quota")
        return Status.ok()

    def _nominated_pods(self) -> list[Pod]:
        """The pending pods nominated to a node, memoised on the API's
        resource version: PreFilter runs for every pod of every cycle
        and nominations are rare.  A substrate without that counter
        (the REST client) lists every time."""
        if self._api is None:
            return []
        rv = getattr(self._api, "resource_version", None)
        if rv is not None and rv == self._nominated_rv:
            return self._nominated_cache
        pods = self._api.list(
            KIND_POD, filter_fn=lambda p: (p.status.nominated_node_name
                                           and not p.spec.node_name
                                           and p.status.phase == PENDING))
        if rv is not None:
            self._nominated_rv = rv
            self._nominated_cache = pods
        return pods

    # -- PreFilter extensions -----------------------------------------------
    def add_pod(self, state: CycleState, pod_to_schedule: Pod,
                pod_to_add: Pod, node_info: NodeInfo) -> Status:
        snapshot = state.get(ELASTIC_QUOTA_SNAPSHOT_KEY)
        if snapshot is None:
            return Status.error("no ElasticQuotaSnapshot in cycle state")
        info = snapshot.get(pod_to_add.metadata.namespace)
        if info is not None:
            info.add_pod_if_not_present(pod_to_add)
        return Status.ok()

    def remove_pod(self, state: CycleState, pod_to_schedule: Pod,
                   pod_to_remove: Pod, node_info: NodeInfo) -> Status:
        snapshot = state.get(ELASTIC_QUOTA_SNAPSHOT_KEY)
        if snapshot is None:
            return Status.error("no ElasticQuotaSnapshot in cycle state")
        info = snapshot.get(pod_to_remove.metadata.namespace)
        if info is not None:
            info.delete_pod_if_present(pod_to_remove)
        return Status.ok()

    # -- Reserve / Unreserve ------------------------------------------------
    def reserve(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        info = self.elastic_quota_infos.get(pod.metadata.namespace)
        if info is not None:
            info.add_pod_if_not_present(pod)
        return Status.ok()

    def unreserve(self, state: CycleState, pod: Pod, node_name: str) -> None:
        info = self.elastic_quota_infos.get(pod.metadata.namespace)
        if info is not None:
            info.delete_pod_if_present(pod)

    # -- PostFilter: preemption ---------------------------------------------
    def post_filter(self, state: CycleState, pod: Pod,
                    nodes: SharedLister) -> tuple[str, Status]:
        if pod.spec.preemption_policy == "Never":
            return "", Status.unschedulable(
                "not eligible due to preemptionPolicy=Never")
        if PRE_FILTER_STATE_KEY not in state:
            return "", Status.unschedulable("PreFilter was not run")
        # a node the pod cannot fit even empty yields no candidate (the
        # walk's last check refilters with every victim gone): skipping
        # it changes no decision and no journal line
        mask = self._victim_screen(state, pod, nodes)
        if mask is not None and not mask:
            J.record(J.PREEMPTION_NONE, pod.key,
                     message="preemption found no candidates")
            return "", Status.unschedulable("preemption found no candidates")
        pdbs = list_pdbs(self._api) if self._api is not None else []
        # a gang's members, listed once per PostFilter
        gang_cache: dict[tuple[str, str], list[Pod]] = {}
        candidates: list[tuple[str, list[Pod], int, set[str]]] = []
        for ni in nodes.list():
            if mask is not None and ni.name not in mask:
                continue
            shrink_uids: set[str] = set()
            victims, num_violating, st = self._select_victims_on_node(
                state, pod, ni, pdbs, gang_cache, shrink_out=shrink_uids)
            if st.is_success and victims:
                # scored and counted on the whole eviction set: a gang
                # dies together, wherever its members run, but a shrink
                # victim dies alone
                candidates.append((ni.name,
                                   self._expand_eviction(victims, gang_cache,
                                                         shrink_uids),
                                   num_violating, shrink_uids))
        if not candidates:
            J.record(J.PREEMPTION_NONE, pod.key,
                     message="preemption found no candidates")
            return "", Status.unschedulable("preemption found no candidates")
        node_name, victims, _, shrink_uids = min(
            candidates, key=lambda c: self._candidate_key(c[:3]))
        if self.on_preempt is not None:
            self.on_preempt(pod, victims)
        self._evict_all(victims, shrink_uids)
        REGISTRY.inc("nos_tpu_preemptions_total")
        REGISTRY.inc("nos_tpu_preemption_victims_total", len(victims))
        J.record(J.PREEMPTION, pod.key, node=node_name,
                 victims=[v.key for v in victims[:MAX_JOURNAL_NODES]],
                 victim_count=len(victims))
        logger.info("preempting %d pod(s) on %s for %s",
                    len(victims), node_name, pod.key)
        return node_name, Status.ok()

    def _victim_screen(self, state: CycleState, pod: Pod,
                       nodes: SharedLister) -> frozenset[str] | None:
        """The nodes ``pod`` fits when empty (``_fits_empty``, through
        the native ``victim_prescreen`` in one call), cached per request
        signature under the view epoch the scheduler put in the state;
        None (screen nothing) without an epoch."""
        epoch = state.get(VIEW_EPOCH_CONTEXT_KEY)
        if epoch is None:
            return None
        req = pod_request(pod)
        sig = tuple(sorted((k, v) for k, v in req.items() if v > 0))
        cached = self._victim_mask_cache.get(sig)
        if cached is not None and cached[0] == epoch:
            return cached[1]
        nis = nodes.list()
        pod_g = _mig_slots(req, None)[0]
        # one call per GPU model: the request's memory slots are the
        # model's; the slots are read only where the request holds MIG
        # profiles (the profile parse is the costly part)
        groups: dict = {}
        for i, ni in enumerate(nis):
            groups.setdefault(node_model(ni) if pod_g else None,
                              []).append(i)
        passing = [False] * len(nis)
        for model, idxs in groups.items():
            slots = [_mig_slots(nis[i].allocatable, model) if pod_g
                     else (0, 0) for i in idxs]
            verdicts = native.victim_prescreen(
                [[nis[i].allocatable.get(k, 0.0) for k, _ in sig]
                 for i in idxs],
                [v for _, v in sig], [g for g, _ in slots],
                [m for _, m in slots], pod_g,
                _mig_slots(req, model)[1] if pod_g else 0)
            for i, ok in zip(idxs, verdicts):
                passing[i] = ok
        mask = frozenset(ni.name for ni, ok in zip(nis, passing) if ok)
        if len(self._victim_mask_cache) > 512:
            self._victim_mask_cache.clear()
        self._victim_mask_cache[sig] = (epoch, mask)
        return mask

    def _expand_eviction(self, victims: list[Pod],
                         gang_cache: dict | None = None,
                         shrink_uids: set[str] | None = None) -> list[Pod]:
        """The victims with every gang mate of each, once each; a shrink
        victim without its mates."""
        out: list[Pod] = []
        seen: set[str] = set()
        for v in victims:
            for m in self._eviction_set(v, gang_cache, shrink_uids):
                if m.metadata.uid not in seen:
                    seen.add(m.metadata.uid)
                    out.append(m)
        return out

    @staticmethod
    def _candidate_key(cand: tuple[str, list[Pod], int]
                       ) -> tuple[int, int, int, int, str]:
        """Upstream's pickOneNodeForPreemption: fewest PDB violations,
        lowest highest victim priority, lowest priority sum, fewest
        victims, then the node's name."""
        name, victims, num_violating = cand
        priorities = [v.spec.priority for v in victims]
        return (num_violating, max(priorities), sum(priorities),
                len(victims), name)

    def _evict_all(self, victims: list[Pod],
                   shrink_uids: set[str] | None = None) -> None:
        """Evict each gang once (the list is already gang-expanded, and
        ``evict_gang`` deletes every member).  A shrink victim, an
        elastic member above its gang's min, is deleted alone, and its
        gang's survivors get the dp-resize stamp: the job loses one
        replica, not its run."""
        if self._api is None:
            return
        evicted_gangs: set[tuple[str, str]] = set()
        shrunk: dict[tuple[str, str], int] = {}
        for v in victims:
            gang = gang_name(v)
            if shrink_uids and v.metadata.uid in shrink_uids and gang:
                key = (v.metadata.namespace, gang)
                try:
                    self._api.delete(KIND_POD, v.metadata.name,
                                     v.metadata.namespace)
                except NotFound:
                    pass
                shrunk[key] = shrunk.get(key, 0) + 1
                continue
            if gang:
                key = (v.metadata.namespace, gang)
                if key in evicted_gangs:
                    continue
                evicted_gangs.add(key)
            evict_gang(self._api, v)
        for (ns, gang), n in sorted(shrunk.items()):
            # a gang both shrunk and evicted whole in one walk died whole,
            # and record_shrink records nothing for it
            record_shrink(self._api, ns, gang, n)

    def _select_victims_on_node(
            self, state: CycleState, pod: Pod, node_info: NodeInfo,
            pdbs: list | None = None, gang_cache: dict | None = None,
            shrink_out: set[str] | None = None
    ) -> tuple[list[Pod], int, Status]:
        """Reference SelectVictimsOnNode (capacity_scheduling.go:468-675),
        on clones, so a node that fails leaves no trace.

        Shrink before evict: members of an elastic gang above its min are
        walked first and their eviction takes no mate; at most (live
        members - min) of one gang shrink in a walk, the rest are evicted
        with their gang.  The shrink victims' uids go to ``shrink_out``.
        Which pods are eligible does not change, so the victim
        prescreen's superset contract holds."""
        base_snapshot: ElasticQuotaInfos = state[ELASTIC_QUOTA_SNAPSHOT_KEY]
        pfs: PreFilterState = state[PRE_FILTER_STATE_KEY]
        if not any(victim_prescreen(pod, pv, base_snapshot)
                   for pv in node_info.pods):
            return [], 0, Status.unschedulable("no victims found")

        snapshot = base_snapshot.clone()
        ni = node_info.clone()
        wstate = CycleState(state)
        wstate[ELASTIC_QUOTA_SNAPSHOT_KEY] = snapshot
        pod_req = pfs.pod_req
        nominated_in_eq = pfs.nominated_in_eq_with_req
        nominated_all = pfs.nominated_with_req
        preemptor_info = snapshot.get(pod.metadata.namespace)

        def remove(p: Pod) -> None:
            ni.remove_pod(p)
            self.remove_pod(wstate, pod, p, ni)

        def add(p: Pod) -> None:
            ni.add_pod(p)
            self.add_pod(wstate, pod, p, ni)

        # A displaced preemptor (``is_displaced_fresh``, the admission
        # queue's rule) walks equal victims least job progress first: it
        # has already lost one run, and evicting a nearly done job wastes
        # a whole one.  Order only; every other walk is unchanged.
        disp_now, disp_cap = state.get(DISPLACED_CONTEXT_KEY, (0.0, 0.0))
        displaced_preemptor = is_displaced_fresh(pod, disp_now, disp_cap)

        def restart_cost(p: Pod) -> float:
            return job_progress(p) if displaced_preemptor else 0.0

        # each elastic gang's shrink budget left in this walk
        shrink_left: dict[tuple[str, str], int] = {}

        def headroom(pv: Pod) -> int:
            g = gang_name(pv)
            if not g or elastic_replica_bounds(pv) is None:
                return 0
            key = (pv.metadata.namespace, g)
            if key not in shrink_left:
                shrink_left[key] = shrink_headroom(
                    [m for m in self._eviction_set(pv, gang_cache)
                     if m.status.phase in (PENDING, RUNNING)])
            return shrink_left[key]

        # In-quota serving pods are never victims; an over-quota one is
        # reclaimable like any borrower.  The walk takes shrinkable
        # elastic members first, then best-effort before batch before
        # serving, then lowest priority first (reference :516), then the
        # newest.
        node_pods = sorted(
            (p for p in ni.pods
             if workload_tier(p) != C.TIER_SERVING or is_over_quota(p)),
            key=lambda p: (0 if headroom(p) > 0 else 1, -tier_rank(p),
                           p.spec.priority, restart_cost(p),
                           -p.metadata.creation_timestamp))
        potential: list[Pod] = []

        def select(pv: Pod) -> None:
            # a victim takes one unit of its gang's shrink budget while
            # there is one left: it then dies alone
            if headroom(pv) > 0:
                shrink_left[(pv.metadata.namespace, gang_name(pv))] -= 1
                if shrink_out is not None:
                    shrink_out.add(pv.metadata.uid)
            potential.append(pv)
            remove(pv)

        if preemptor_info is not None:
            more_than_min = preemptor_info.used_over_min_with(nominated_in_eq)
            for pv in node_pods:
                pv_info = snapshot.get(pv.metadata.namespace)
                if pv_info is None:
                    continue
                if more_than_min:
                    # the preemptor would run over its min: lower-priority
                    # pods of its own namespace...
                    if pv.metadata.namespace == pod.metadata.namespace:
                        if pv.spec.priority < pod.spec.priority:
                            select(pv)
                        continue
                    # ...or over-quota pods of others, while the preemptor
                    # stays within min plus its guaranteed share of the
                    # unused min and the victim's quota is past its own
                    # (:547-564)
                    if not is_over_quota(pv):
                        continue
                    g = snapshot.get_guaranteed_overquotas(
                        pod.metadata.namespace)
                    min_plus_g = sum_resources(g, preemptor_info.min)
                    if preemptor_info.used_lte_with(min_plus_g,
                                                    nominated_in_eq):
                        pv_g = snapshot.get_guaranteed_overquotas(
                            pv.metadata.namespace)
                        if pv_info.used_over(
                                sum_resources(pv_g, pv_info.min)):
                            select(pv)
                elif pv.metadata.namespace != pod.metadata.namespace \
                        and pv_info.used_over_min() and is_over_quota(pv):
                    # within min: its guarantee is lent out, so only
                    # other namespaces' over-quota borrowers (:566-581)
                    select(pv)
        else:
            # outside any quota: plain priority preemption among pods
            # outside any quota (:583-596)
            for pv in node_pods:
                if snapshot.get(pv.metadata.namespace) is None \
                        and pv.spec.priority < pod.spec.priority:
                    select(pv)

        if not potential:
            return [], 0, Status.unschedulable("no victims found")
        fw = self._framework
        if fw is None:
            return [], 0, Status.error("framework handle not set")
        if not fw.run_filter_plugins(wstate, pod, ni).is_success:
            return [], 0, Status.unschedulable(
                "pod does not fit even after removing all candidates")
        if preemptor_info is not None:
            if preemptor_info.used_over_max_with(pod_req):
                return [], 0, Status.unschedulable("max quota exceeded")
            if snapshot.aggregated_used_over_min_with(pod_req):
                return [], 0, Status.unschedulable("total min quota exceeded")

        # Reprieve as many as possible (:626-673), the budget violators
        # first, while capacity is freest; those that stay despite a
        # budget count for the node choice.
        violating, non_violating = self._split_pdb_violation(
            potential, pdbs, gang_cache, shrink_out)
        victims: list[Pod] = []
        num_violating = 0

        def reprieve(pv: Pod) -> bool:
            add(pv)
            fits_now = fw.run_filter_plugins(wstate, pod, ni).is_success
            over_quota = preemptor_info is not None and (
                preemptor_info.used_over_max_with(nominated_in_eq)
                or snapshot.aggregated_used_over_min_with(nominated_all))
            if not fits_now or over_quota:
                remove(pv)
                victims.append(pv)
                return False
            return True

        # the walk's order inverted: the most protected tier, highest
        # priority and most progress get their room back first, shrink
        # victims (the cheapest rung) last, so the reprieve does not undo
        # the walk's order
        shrunk = shrink_out or set()
        by_prio = lambda p: (p.metadata.uid in shrunk,  # noqa: E731
                             tier_rank(p), -p.spec.priority,
                             -restart_cost(p), p.metadata.creation_timestamp)
        for pv in sorted(violating, key=by_prio):
            if not reprieve(pv):
                num_violating += 1
        for pv in sorted(non_violating, key=by_prio):
            reprieve(pv)

        # a reprieved pod whose gang mate stayed a victim dies with it:
        # fold it back, so the counts are the true eviction's.  A shrink
        # victim dooms no mate.
        doomed_gangs = {(v.metadata.namespace, gang_name(v))
                        for v in victims
                        if gang_name(v) and v.metadata.uid not in shrunk}
        if doomed_gangs:
            victim_uids = {v.metadata.uid for v in victims}
            violating_uids = {p.metadata.uid for p in violating}
            for pv in potential:
                if pv.metadata.uid in victim_uids:
                    continue
                g = gang_name(pv)
                if g and (pv.metadata.namespace, g) in doomed_gangs:
                    remove(pv)
                    victims.append(pv)
                    victim_uids.add(pv.metadata.uid)
                    if pv.metadata.uid in violating_uids:
                        num_violating += 1
        return victims, num_violating, Status.ok()

    def _eviction_set(self, victim: Pod, cache: dict | None = None,
                      shrink_uids: set[str] | None = None) -> list[Pod]:
        """What evicting ``victim`` takes: its whole gang, wherever the
        members run, unless it is a shrink victim, which goes alone.
        ``cache`` memoises each gang's members."""
        g = gang_name(victim)
        if not g or self._api is None or (
                shrink_uids is not None
                and victim.metadata.uid in shrink_uids):
            return [victim]
        key = (victim.metadata.namespace, g)
        members = cache.get(key) if cache is not None else None
        if members is None:
            members = self._api.list(
                KIND_POD, namespace=victim.metadata.namespace,
                label_selector={C.LABEL_POD_GROUP: g})
            if cache is not None:
                cache[key] = members
        if not any(m.metadata.uid == victim.metadata.uid for m in members):
            members = [victim] + members
        return members

    def _split_pdb_violation(
            self, pods: list[Pod], pdbs: list | None,
            gang_cache: dict | None = None,
            shrink_uids: set[str] | None = None
    ) -> tuple[list[Pod], list[Pod]]:
        """filterPodsWithPDBViolation, gang-aware: a candidate violates
        when a budget it matches lacks room for every Running pod of its
        eviction set; a pod charged earlier in the walk is not charged
        again, and pods not Running use no budget."""
        if pdbs is None:
            pdbs = list_pdbs(self._api) if self._api is not None else []
        if not pdbs:
            return [], list(pods)
        allowed = [pdb.status.disruptions_allowed for pdb in pdbs]
        charged: set[tuple[int, str]] = set()
        violating: list[Pod] = []
        non_violating: list[Pod] = []
        for pod in pods:
            needed: dict[int, list[str]] = {}
            for m in self._eviction_set(pod, gang_cache, shrink_uids):
                if m.status.phase != RUNNING:
                    continue
                for i, pdb in enumerate(pdbs):
                    if pdb.matches(m) and (i, m.metadata.uid) not in charged:
                        needed.setdefault(i, []).append(m.metadata.uid)
            if any(allowed[i] < len(uids) for i, uids in needed.items()):
                violating.append(pod)
                continue
            for i, uids in needed.items():
                allowed[i] -= len(uids)
                charged.update((i, u) for u in uids)
            non_violating.append(pod)
        return violating, non_violating
