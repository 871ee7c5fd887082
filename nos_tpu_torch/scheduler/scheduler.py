"""The scheduling loop, ``nos_tpu/scheduler/scheduler.py`` for the port.

The reference rebuilds the stock kube-scheduler with the
CapacityScheduling plugin registered (cmd/scheduler/scheduler.go:43-59).
Here ``Scheduler`` drives the framework the planner simulates with over
the live cluster view: PreFilter, Filter on every node, a score, Reserve,
bind; with no fit, PostFilter (preemption) and then the pod marked
unschedulable, which is what the partitioner waits for
(``extra_resources_could_help_scheduling``).

Each cycle takes the pending pods in admission order (serving, freshly
displaced, batch, best-effort; then priority, creation, key), defers the
pods of a namespace waiting behind a higher-priority quota claim, and
places the rest one by one on a cycle view the watch-driven cache keeps
incremental (``scheduler/cache.py``): only nodes events touched are
re-screened, per Filter equivalence class.  Pods sharing a pod-group
label are a gang, placed all or nothing inside one NVLink domain by
``schedule_gang`` when the cycle reaches its first member
(``scheduler/gang.py``).  Preemption is budgeted per cycle; a single
preemptor that won room binds into it in the same cycle, a gang on a
later one.

Not here (ROADMAP item 7): the gang windows and their lease, drain
preemption and duration-aware backfill, which serve a gang consuming a
multi-node slice (no H100 resource spans nodes), and elastic grow.  The
JAX scheduler's native prescreen and native choose (item 23) and its
chip-second waste ledger (item 9) are not ported either: the score's
lease, defrag-drain and window terms read zero without them, so the
score is ``(headroom, name)``, the JAX key on nodes with no window
labels.
"""

from __future__ import annotations

import logging
import time
from collections import Counter
from typing import Any, Callable

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.exporter.metrics import REGISTRY
from nos_tpu_torch.api.podgroup import PHASE_SCHEDULED
from nos_tpu_torch.kube.client import APIServer, KIND_POD, NotFound
from nos_tpu_torch.kube.objects import PENDING, RUNNING, Pod
from nos_tpu_torch.kube.resources import pod_request, sum_resources
from nos_tpu_torch.obs import journal as J
from nos_tpu_torch.obs.journal import MAX_JOURNAL_NODES
from nos_tpu_torch.obs.trace import bump as obs_bump, span as obs_span
from nos_tpu_torch.scheduler.cache import SchedulerCache
from nos_tpu_torch.scheduler.capacityscheduling import (
    DISPLACED_CONTEXT_KEY, VIEW_EPOCH_CONTEXT_KEY, CapacityScheduling,
)
from nos_tpu_torch.scheduler.framework import (
    CycleState, Framework, NodeInfo, SharedLister, Status, UNSCHEDULABLE,
    filter_equivalence_key,
)
from nos_tpu_torch.scheduler.gang import (
    GANG_DOMAIN_KEY, gang_name, get_pod_group, set_pod_group_status,
)
from nos_tpu_torch.utils.guards import invalidated_by
from nos_tpu_torch.utils.pod_util import (
    admission_rank, displacement, is_over_quota, workload_class,
    workload_tier,
)
from nos_tpu_torch.utils.retry import retry_on_conflict

logger = logging.getLogger(__name__)

REGISTRY.describe("nos_tpu_schedule_latency_seconds",
                  "Queue-admission to bind latency per workload class")
REGISTRY.describe("nos_tpu_rebind_latency_seconds",
                  "Displacement stamp to re-bind latency per workload "
                  "class")
REGISTRY.describe("nos_tpu_schedule_pending_age_seconds",
                  "Oldest still-pending pod's age per workload class")
REGISTRY.describe("nos_tpu_schedule_pending_pods",
                  "Still-pending pods per workload class after a cycle")

# The JAX Scheduler's defaults, the values a caller that passes none
# runs (read when a Scheduler is built).  At most
# PREEMPT_BUDGET_PER_CYCLE PostFilter searches a cycle: every pending pod
# is tried each cycle, and unbudgeted searches multiply the cycle's cost
# and let same-cycle preemptors fight over one space; the rest retry
# next cycle.
PREEMPT_BUDGET_PER_CYCLE = 2
# a displaced pod ranks between serving and batch until its stamp is
# older than this (<= 0: no expiry)
DISPLACED_AGE_CAP_S = 300.0
# every this many cycles the incremental view is dropped and rebuilt
# whole, the backstop behind the watch-dirty set
FULL_RESCAN_EVERY = 512


@invalidated_by("_invalidate_scans", "_cycle_lister_cache")
class Scheduler:
    # the pods' default spec.scheduler_name: the pods this one schedules
    name = "nos-tpu-scheduler"

    def __init__(self, api: APIServer, framework: Framework,
                 capacity: CapacityScheduling,
                 preempt_budget_per_cycle: int | None = None,
                 displaced_age_cap_s: float | None = None,
                 clock: Callable[[], float] = time.time) -> None:
        self._api = api
        self._framework = framework
        # the framework's capacity plugin: the quota head-of-line rule
        # reads its ledger and calculator
        self._capacity = capacity
        # schedule latency is clock() - creation_timestamp: the clock
        # shares the pods' time domain (wall clock in production)
        self._clock = clock
        self._preempt_budget_per_cycle = (
            PREEMPT_BUDGET_PER_CYCLE if preempt_budget_per_cycle is None
            else preempt_budget_per_cycle)
        self._displaced_age_cap_s = (
            DISPLACED_AGE_CAP_S if displaced_age_cap_s is None
            else displaced_age_cap_s)
        self._preempt_budget = self._preempt_budget_per_cycle
        # namespace -> the priority of its quota-rejected claimant, this
        # cycle (``_record_quota_hol``)
        self._quota_hol: dict[str, int] = {}
        # The cycle's snapshot: built once a cycle, pods bound in the
        # cycle booked into it in place, dropped after an eviction.
        self._cycle_lister_cache: SharedLister | None = None
        self._cache = SchedulerCache(api)
        # The view is incremental: the previous cycle's snapshot and
        # derived indexes are kept and only the watch-dirty nodes
        # applied; every FULL_RESCAN_EVERY cycles, or when the cache
        # asks for it, a full rescan rebuilds all.
        self._cycles_since_rescan = 0
        # node -> equivalence class -> (verdict, why): the Filter memo
        self._filter_cache: dict[str, dict] = {}
        # equivalence class -> [feasible NodeInfos by name, rejections by
        # node, their journal attrs (memo), stale node names]: one scan
        # per class and state, not per pod; moved nodes are marked stale
        # and re-screened on the index's next use
        self._class_scan_cache: dict[tuple, Any] = {}
        # True while run_cycle drives the entry points: the snapshot is
        # shared by the cycle's pods
        self._in_cycle = False

    def close(self) -> None:
        """Detach the cache's watches (a replaced scheduler on a
        long-lived API server must not keep paying for them)."""
        self._cache.close()

    # -- cluster view -------------------------------------------------------
    def snapshot(self) -> SharedLister:
        return self._cache.snapshot()

    def _cycle_lister(self) -> SharedLister:
        if self._cycle_lister_cache is None:
            self._cycle_lister_cache = self.snapshot()
            self._filter_cache = {}
            self._class_scan_cache = {}
        return self._cycle_lister_cache

    def _begin_cycle_view(self) -> None:
        """Install the cycle's view: the dirty nodes drained into the kept
        snapshot and indexes; every FULL_RESCAN_EVERY cycles, or when the
        cache returns None, everything is dropped and rebuilt."""
        self._cycles_since_rescan += 1
        dirty = self._cache.drain_dirty()
        if dirty is None \
                or self._cycles_since_rescan >= FULL_RESCAN_EVERY:
            self._cycles_since_rescan = 0
            if dirty is not None:
                # the periodic backstop: level-trigger the cache too and
                # swallow its None drain
                self._cache.invalidate_all()
                self._cache.drain_dirty()
            obs_bump("sched_full_rescans")
            self._drop_cycle_snapshot()
            return
        for name in sorted(dirty):
            self._invalidate_scans(name)
        self._cycle_lister_cache = self.snapshot()

    def _drop_cycle_snapshot(self) -> None:
        self._cycle_lister_cache = None
        self._filter_cache = {}
        self._class_scan_cache = {}

    def schedule_one(self, pod: Pod) -> str | None:
        """Try to place one pod; returns the node's name or None."""
        if not self._in_cycle:
            self._begin_cycle_view()
        return self._schedule_one(pod)

    def _preempt_then_retry(self, state: CycleState, pod: Pod,
                            lister: SharedLister) -> tuple[bool, str | None]:
        """PostFilter and, when it evicted, one immediate retry: the
        in-memory API deletes victims at once, so the room is free now,
        and without the retry lower-tier pods later in the same cycle
        would bind into it.  Returns (handled, node); handled=False means
        nothing was preempted."""
        nominated, post = self._post_filter_budgeted(state, pod, lister)
        if not (post.is_success and nominated):
            return False, None
        placed = self._schedule_one(pod, allow_preempt=False)
        if placed is None:
            self._nominate(pod, nominated)
        return True, placed

    def _schedule_one(self, pod: Pod,
                      allow_preempt: bool = True) -> str | None:
        if allow_preempt:
            # the retry after preemption is the same attempt
            obs_bump("schedule_one")
        lister = self._cycle_lister()
        state = CycleState()
        status = self._framework.run_pre_filter_plugins(state, pod, lister)
        if not status.is_success:
            if not allow_preempt:
                return None
            if status.reason == "quota":
                self._record_quota_hol(pod)
            # a quota rejection is resolved by evicting over-quota
            # borrowers (reference capacity_scheduling.go:323-341)
            if status.code == UNSCHEDULABLE:
                handled, placed = self._preempt_then_retry(state, pod, lister)
                if handled:
                    return placed
            self._mark_unschedulable(pod, status)
            return None
        equiv = self._filter_equiv_key(pod)
        scan = self._class_scan_cache.get(equiv) if equiv is not None \
            else None
        if scan is None:
            feasible: dict[str, NodeInfo] = {}
            rejections: dict[str, str] = {}
            for ni in lister.list():
                name = ni.name
                ok, why = self._filter_passes(state, pod, ni, equiv, name)
                if ok:
                    feasible[name] = ni
                else:
                    rejections[name] = why
            scan = [feasible, rejections, None, set()]
            if equiv is not None:
                self._class_scan_cache[equiv] = scan
        elif scan[3]:
            self._refresh_scan(scan, state, pod, equiv, lister)
        feasible, rejections = scan[0], scan[1]
        if not feasible:
            if not allow_preempt:
                return None
            handled, placed = self._preempt_then_retry(state, pod, lister)
            if handled:
                return placed
            if scan[2] is None:
                scan[2] = self._node_reason_attrs(rejections)
            self._mark_unschedulable(pod, Status.unschedulable("no fit"),
                                     node_attrs=scan[2])
            return None
        chosen = self._choose_node(pod, feasible)
        status = self._framework.run_reserve_plugins(state, pod, chosen.name)
        if not status.is_success:
            self._framework.run_unreserve_plugins(state, pod, chosen.name)
            self._mark_unschedulable(pod, status)
            return None
        if not self._bind(pod, chosen.name):
            # the pod vanished: nothing placed, and the ledger booked it
            # after its DELETED event, so nothing else releases it
            self._framework.run_unreserve_plugins(state, pod, chosen.name)
            return None
        self._assume_bound(pod, chosen.name)
        self._observe_schedule_latency([pod])
        self._observe_rebind([pod])
        return chosen.name

    @staticmethod
    def _filter_equiv_key(pod: Pod) -> tuple | None:
        """The pod's Filter equivalence class, or None for a gang member:
        the pins in its cycle state change TopologyFilter's verdict, so
        its verdicts are never memoised."""
        if gang_name(pod):
            return None
        return filter_equivalence_key(pod)

    def _filter_passes(self, state: CycleState, pod: Pod, ni: NodeInfo,
                       equiv: tuple | None, name: str) -> tuple[bool, str]:
        """(verdict, why), memoised per node and class (not for a class
        of None); ``why`` is "plugin: message" on a rejection."""
        if equiv is None:
            return self._filter_verdict(state, pod, ni)
        per_node = self._filter_cache.setdefault(name, {})
        verdict = per_node.get(equiv)
        if verdict is None:
            verdict = self._filter_verdict(state, pod, ni)
            per_node[equiv] = verdict
        return verdict

    def _filter_verdict(self, state: CycleState, pod: Pod,
                        ni: NodeInfo) -> tuple[bool, str]:
        st = self._framework.run_filter_plugins(state, pod, ni)
        if st.is_success:
            return True, ""
        return False, f"{st.plugin or 'Filter'}: {st.message}"

    def _assume_bound(self, pod: Pod, node_name: str) -> None:
        """Book a just-bound pod into the cache and the cycle snapshot,
        so later pods of the cycle see its room taken."""
        assumed = pod.__deepcopy__({})
        assumed.spec.node_name = node_name
        self._cache.assume(assumed)
        if self._cycle_lister_cache is not None:
            ni = self._cycle_lister_cache.get(node_name)
            if ni is not None:
                ni.add_pod(assumed)
        self._invalidate_scans(node_name)

    def _refresh_scan(self, scan: list, state: CycleState, pod: Pod,
                      equiv: tuple, lister: SharedLister) -> None:
        """Re-screen only a class index's stale nodes; untouched nodes
        keep their verdicts, nodes gone from the fleet drop out, and the
        memoised journal attrs are dropped."""
        feasible, rejections, stale = scan[0], scan[1], scan[3]
        for name in sorted(stale):
            feasible.pop(name, None)
            rejections.pop(name, None)
            ni = lister.get(name)
            if ni is None:
                continue
            ok, why = self._filter_passes(state, pod, ni, equiv, name)
            if ok:
                feasible[name] = ni
            else:
                rejections[name] = why
        stale.clear()
        scan[2] = None

    def _invalidate_scans(self, node_name: str) -> None:
        """A node's capacity moved: its Filter memo dies and it goes
        stale in every class index."""
        self._filter_cache.pop(node_name, None)
        for scan in self._class_scan_cache.values():
            scan[3].add(node_name)

    def run_cycle(self) -> int:
        """Schedule every pending, unbound pod of this scheduler; returns
        how many were bound.  Pods sharing a pod-group label are admitted
        all or nothing."""
        self._in_cycle = True
        try:
            with obs_span("scheduler.run_cycle") as sp:
                bound = self._run_cycle()
                if sp is not None:
                    sp.set("bound", bound)
                return bound
        finally:
            self._in_cycle = False

    def _run_cycle(self) -> int:
        pods = [p for p in self._pending_pods()
                if p.spec.scheduler_name == self.name]
        bound = 0
        self._preempt_budget = self._preempt_budget_per_cycle
        self._quota_hol = {}
        self._begin_cycle_view()
        now = self._clock()
        pods.sort(key=lambda p: (admission_rank(p, now,
                                                self._displaced_age_cap_s),
                                 -p.spec.priority,
                                 p.metadata.creation_timestamp, p.key))
        gangs: dict[tuple[str, str], list[Pod]] = {}
        for pod in pods:
            g = gang_name(pod)
            if g:
                gangs.setdefault((pod.metadata.namespace, g), []).append(pod)
        seen_gangs: set[tuple[str, str]] = set()
        for pod in pods:
            if self._quota_hol_defers(pod):
                continue
            g = gang_name(pod)
            if not g:
                if self._schedule_one(pod) is not None:
                    bound += 1
                continue
            # a gang is scheduled where its first member stands in the
            # admission order
            key = (pod.metadata.namespace, g)
            if key not in seen_gangs:
                seen_gangs.add(key)
                bound += self.schedule_gang(gangs[key])
        self._publish_pending_gauges()
        return bound

    # -- quota head-of-line -------------------------------------------------
    # A quota-rejected pod waits for headroom in its namespace's quota.
    # For the rest of the cycle, lower-priority pods of that namespace
    # must not bind into headroom that frees up, or small pods would eat
    # every freed piece before the claimant's whole request gathers.

    def _record_quota_hol(self, pod: Pod,
                          total_request: dict | None = None) -> None:
        """``pod`` claims its namespace's freed headroom for the cycle;
        a gang's claim is judged on ``total_request``, the whole gang's."""
        ns = pod.metadata.namespace
        cap = self._capacity
        # a claimant that alone passes its namespace's max or the
        # aggregate min can never schedule, and would block its
        # namespace forever: it claims nothing
        req = total_request if total_request is not None \
            else cap.calculator.compute_pod_request(pod)
        info = cap.elastic_quota_infos.get(ns)
        over_own_max = (info is not None and info.max_enforced
                        and any(req.get(r, 0.0) > limit
                                for r, limit in info.max.items()))
        agg_min = cap.elastic_quota_infos.aggregated_min()
        over_agg_min = any(req.get(r, 0.0) > limit
                           for r, limit in agg_min.items())
        if over_own_max or over_agg_min:
            logger.warning(
                "quota HOL: claimant %s requests more than %s can ever "
                "grant (namespace max or aggregated min): never "
                "schedulable, not blocking the namespace", pod.key, ns)
            return
        self._quota_hol[ns] = max(self._quota_hol.get(ns, 0),
                                  pod.spec.priority)
        J.record(J.QUOTA_HOL_CLAIM, pod.key, namespace=ns,
                 priority=pod.spec.priority)

    def _quota_hol_defers(self, pod: Pod) -> bool:
        blocker = self._quota_hol.get(pod.metadata.namespace)
        if blocker is None or pod.spec.priority >= blocker:
            return False
        if workload_tier(pod) == C.TIER_SERVING:
            # the serving tier never queues behind a claim: one lacking
            # headroom is rejected by PreFilter itself
            return False
        self._mark_unschedulable(pod, Status.unschedulable(
            f"waiting behind a higher-priority quota claim in namespace "
            f"{pod.metadata.namespace}", reason="quota-hol"))
        return True

    def _pending_pods(self) -> list[Pod]:
        """The unbound Pending pods, from the cache's index (read-only:
        they are the cache's own copies)."""
        return self._cache.pending_pods()

    # -- gangs --------------------------------------------------------------

    def _gang_journal(self, members: list[Pod], admitted: bool,
                      message: str, bound: int = 0) -> None:
        first = members[0]
        J.record(J.GANG_ADMITTED if admitted else J.GANG_REJECTED,
                 f"{first.metadata.namespace}/{gang_name(first)}",
                 message=message, bound=bound,
                 members=[p.key for p in members[:MAX_JOURNAL_NODES]],
                 members_total=len(members))

    def schedule_gang(self, members: list[Pod]) -> int:
        """Place a pod group all or nothing: every member simulated on
        clones of the cycle view inside one NVLink domain, each taking
        capacity the next sees; bound only if all fit, else every member
        marked unschedulable, so the partitioner sees the whole gang's
        demand.  Returns the members bound."""
        if not self._in_cycle:
            self._begin_cycle_view()
        with obs_span("scheduler.schedule_gang",
                      gang=f"{members[0].metadata.namespace}"
                           f"/{gang_name(members[0])}",
                      members=len(members)):
            first = members[0]
            gang = gang_name(first)
            pg = get_pod_group(self._api, gang, first.metadata.namespace)
            min_member = pg.spec.min_member if pg else len(members)
            # every live member counts, Running mates too: a recreated
            # worker of a running gang schedules instead of waiting for
            # members forever
            alive = len(self._api.list(
                KIND_POD, namespace=first.metadata.namespace,
                label_selector={C.LABEL_POD_GROUP: gang},
                filter_fn=lambda p: p.status.phase in (PENDING, RUNNING)))
            if alive < min_member:
                msg = f"pod group waiting for members ({alive}/{min_member})"
                self._gang_journal(members, False, msg)
                for pod in members:
                    self._mark_unschedulable(pod, Status.unschedulable(msg))
                return 0
            base = self._cycle_lister()
            candidates = self._domains_best_fit(base)
            placements: list[tuple[Pod, NodeInfo]] = []
            state = CycleState()
            for pins in candidates:
                placements, state, _, _ = self._attempt_gang(pins, base,
                                                             members)
                if len(placements) == len(members):
                    break
            if len(placements) != len(members):
                self._gang_no_fit(members, candidates, base)
                return 0
            return self._bind_gang(members, pg, alive, placements, state)

    def _domains_best_fit(self, base: SharedLister) -> list[dict]:
        """The candidate pins, one per NVLink domain, least free
        whole-GPU capacity first (large domains stay whole for large
        gangs), ties by name.  "" (the unlabelled nodes) is pinned too:
        a gang trying them takes only unlabelled nodes."""
        free: dict[str, float] = {}
        for ni in base.list():
            domain = ni.node.metadata.labels.get(C.LABEL_NVLINK_DOMAIN, "")
            free[domain] = free.get(domain, 0.0) + max(
                0.0, ni.free().get(C.RESOURCE_GPU, 0.0))
        return [{GANG_DOMAIN_KEY: d}
                for d in sorted(free, key=lambda d: (free[d], d))]

    def _gang_no_fit(self, members: list[Pod], candidates: list[dict],
                     base: SharedLister) -> None:
        """No domain holds the gang.  A gang claiming its guaranteed min
        must not starve behind over-quota borrowers, so it gets a
        preemption, under the cycle's budget, on the first domain where
        it would fit with every evictable pod gone: PostFilter for the
        stuck member with its placed mates booked in cycle state, so the
        victims are chosen against the whole gang's claim.  The victims'
        gangs die whole (``evict_gang``); the gang binds on a later
        cycle.  Then every member is marked unschedulable."""
        preempted = False
        if self._preempt_budget > 0:
            pins = self._gang_feasible_after_evictions(members, candidates,
                                                       base)
            if pins is not None:
                _, st, domain, stuck = self._attempt_gang(pins, base,
                                                          members)
                if stuck is not None:
                    nominated, post = self._post_filter_budgeted(
                        st, stuck, SharedLister(domain))
                    # deliberately no nomination: a nominated member
                    # stops looking lacking to the partitioner, which
                    # would split the gang's demand
                    preempted = post.is_success and bool(nominated)
        msg = "gang does not fit as a whole"
        if preempted:
            msg += " (evicted over-quota victims, retrying)"
        self._gang_journal(members, False, msg)
        for pod in members:
            self._mark_unschedulable(pod, Status.unschedulable(msg))

    def _bind_gang(self, members: list[Pod], pg: Any, alive: int,
                   placements: list[tuple[Pod, NodeInfo]],
                   state: CycleState) -> int:
        """Reserve every member, rolling the whole gang back if one
        Reserve fails; then bind them, and set the PodGroup Scheduled."""
        for pod, ni in placements:
            st = self._framework.run_reserve_plugins(state, pod, ni.name)
            if not st.is_success:
                for p2, n2 in placements:
                    self._framework.run_unreserve_plugins(state, p2, n2.name)
                self._gang_journal(
                    members, False,
                    f"reserve failed for {pod.key}: {st.message}")
                for p2 in members:
                    self._mark_unschedulable(p2, st)
                return 0
        bound = 0
        for pod, ni in placements:
            if self._bind(pod, ni.name):
                self._assume_bound(pod, ni.name)
                bound += 1
            else:
                # a vanished member: its booking is released here
                self._framework.run_unreserve_plugins(state, pod, ni.name)
        if pg is not None:
            # the live members less those that vanished mid-cycle
            set_pod_group_status(self._api, pg, PHASE_SCHEDULED,
                                 alive - (len(placements) - bound))
        if bound == len(members):
            self._observe_schedule_latency(members)
            self._observe_rebind(members)
        self._gang_journal(members, True, "gang admitted", bound=bound)
        logger.info("gang %s: bound %d pods", gang_name(members[0]), bound)
        return bound

    def _attempt_gang(self, pins: dict, base: SharedLister,
                      members: list[Pod]) -> tuple[
                          list[tuple[Pod, NodeInfo]], CycleState,
                          list[NodeInfo], Pod | None]:
        """The whole gang placed in one pinned domain on clones of
        ``base``.  Returns (placements, state, domain, stuck): the
        placements are complete on success; ``stuck`` is the first member
        that found no fit, with its placed mates' capacity taken on the
        domain's clones and their quota booked in ``state``, the context
        PostFilter needs."""
        domain = [ni.clone() for ni in base.list()
                  if self._pins_match(ni, pins)]
        lister = SharedLister(domain)
        state = CycleState(pins)
        placements: list[tuple[Pod, NodeInfo]] = []
        for pod in members:
            status = self._framework.run_pre_filter_plugins(state, pod,
                                                            lister)
            feasible = []
            if status.is_success:
                feasible = [ni for ni in domain
                            if self._framework.run_filter_plugins(
                                state, pod, ni).is_success]
            if not feasible:
                if status.reason == "quota":
                    # the gang waits on quota headroom: lower-priority
                    # pods of its namespace defer, and the claim is
                    # judged on the whole gang's request
                    self._record_quota_hol(
                        pod, total_request=self._gang_total_request(members))
                return [], state, domain, pod
            chosen = min(feasible, key=self._score_key(pod))
            chosen.add_pod(pod)
            self._framework.run_pre_filter_extension_add_pod(
                state, pod, pod, chosen)
            placements.append((pod, chosen))
        return placements, state, domain, None

    def _gang_total_request(self, members: list[Pod]) -> dict:
        """The gang's whole request in the capacity plugin's currency."""
        total: dict = {}
        for m in members:
            total = sum_resources(
                total, self._capacity.calculator.compute_pod_request(m))
        return total

    @staticmethod
    def _pins_match(ni: NodeInfo, pins: dict) -> bool:
        domain = pins.get(GANG_DOMAIN_KEY)
        return domain is None or \
            ni.node.metadata.labels.get(C.LABEL_NVLINK_DOMAIN, "") == domain

    def _gang_feasible_after_evictions(
            self, members: list[Pod], candidates: list[dict],
            base: SharedLister) -> dict | None:
        """The first candidate domain that would hold the gang were every
        evictable pod gone, or None: a gang that cannot fit even then
        must not evict a victim every cycle to no effect.

        Evictable follows the capacity plugin's victim rules: in-quota
        serving pods never; a preemptor with no quota takes lower
        priority pods that have none; one over its min (the whole gang's
        request counted) takes lower-priority pods of its own namespace
        and over-quota pods of others; one within its min takes
        over-quota pods of others.  A gang mate of an evictable pod is
        evictable too (it dies with its gang).  Quota PreFilters are
        skipped, since evictions are what relaxes them: only the Filter
        plugins gate here."""
        first = members[0]
        infos = self._capacity.elastic_quota_infos
        preemptor_info = infos.get(first.metadata.namespace)
        more_than_min = preemptor_info is not None and \
            preemptor_info.used_over_min_with(
                self._gang_total_request(members))

        def directly_evictable(p: Pod) -> bool:
            if workload_tier(p) == C.TIER_SERVING and not is_over_quota(p):
                return False
            if preemptor_info is None:
                if infos.get(p.metadata.namespace) is not None:
                    return False
                return p.spec.priority < first.spec.priority
            if p.metadata.namespace == first.metadata.namespace:
                return more_than_min and p.spec.priority < first.spec.priority
            return is_over_quota(p)

        doomed = {(p.metadata.namespace, gang_name(p))
                  for ni in base.list() for p in ni.pods
                  if gang_name(p) and directly_evictable(p)}

        def evictable(p: Pod) -> bool:
            g = gang_name(p)
            return directly_evictable(p) or (
                bool(g) and (p.metadata.namespace, g) in doomed)

        fw = Framework([p for p in self._framework.plugins
                        if hasattr(p, "filter")])
        for pins in candidates:
            domain = []
            for ni in base.list():
                if not self._pins_match(ni, pins):
                    continue
                optimistic = NodeInfo(node=ni.node)
                for p in ni.pods:
                    if not evictable(p):
                        optimistic.add_pod(p)
                domain.append(optimistic)
            lister = SharedLister(domain)
            state = CycleState(pins)
            placed = 0
            for pod in members:
                fw.run_pre_filter_plugins(state, pod, lister)
                feasible = [ni for ni in domain
                            if fw.run_filter_plugins(state, pod,
                                                     ni).is_success]
                if not feasible:
                    break
                chosen = min(feasible, key=self._score_key(pod))
                chosen.add_pod(pod)
                placed += 1
            if placed == len(members):
                return pins
        return None

    def _post_filter_budgeted(self, state: CycleState, pod: Pod,
                              lister: SharedLister) -> tuple[str, Status]:
        """PostFilter under the cycle's preemption budget; once it is
        spent, unschedulable pods wait for the next cycle."""
        if self._preempt_budget <= 0:
            return "", Status.unschedulable(
                "preemption budget for this cycle spent")
        self._preempt_budget -= 1
        state[DISPLACED_CONTEXT_KEY] = (self._clock(),
                                        self._displaced_age_cap_s)
        if lister is self._cycle_lister_cache:
            state[VIEW_EPOCH_CONTEXT_KEY] = self._cache.view_epoch()
        nominated, status = self._framework.run_post_filter_plugins(
            state, pod, lister)
        if status.is_success:
            # victims were evicted: the snapshot is stale
            self._cycle_lister_cache = None
        return nominated, status

    def _choose_node(self, pod: Pod,
                     feasible: dict[str, NodeInfo]) -> NodeInfo:
        """The feasible node with the least headroom on the pod's own
        resources (packs shares tightly), ties by host index, then
        name."""
        nis = list(feasible.values())
        if len(nis) == 1:
            return nis[0]
        return min(nis, key=self._score_key(pod))

    @staticmethod
    def _score_key(pod: Pod) -> Callable[[NodeInfo], tuple]:
        """Nodes under a defrag drain last (the room a defrag move frees
        is for the demand it was made for), then the least headroom on
        the pod's own resources, then the numeric host index (an absent
        or unparsable label counts as 0), then the name: hosts fill in
        their physical order, where the name's order would put
        gpu-node-10 before gpu-node-2.  The JAX package also avoids the
        hosts a stuck gang's window lease reserves and prefers hosts
        whose aligned windows are already broken; the lease and the
        windows come with ROADMAP item 7.2."""
        req = pod_request(pod)

        def key(ni: NodeInfo) -> tuple:
            free = ni.free()
            drained = bool(ni.node.metadata.annotations.get(
                C.ANNOT_DEFRAG_DRAIN))
            try:
                idx = int(ni.node.metadata.labels.get(
                    C.LABEL_HOST_INDEX, "0"))
            except ValueError:
                idx = 0
            return (drained, sum(free.get(r, 0.0) for r in req), idx,
                    ni.name)

        return key

    def _patch_pod(self, pod: Pod, mutate: Callable[[Any], None]) -> bool:
        """Patch a pod that may have vanished since the cycle listed it;
        False exactly when it did."""
        try:
            retry_on_conflict(self._api, KIND_POD, pod.metadata.name,
                              mutate, pod.metadata.namespace,
                              component="scheduler")
        except NotFound:
            logger.debug("scheduler: pod %s vanished mid-cycle", pod.key)
            return False
        return True

    def _observe_schedule_latency(self, pods: list[Pod]) -> None:
        """Queue-admission to bind latency of one scheduling unit: a pod,
        or a gang whose last member just bound, from its earliest
        member's creation.  A unit without a creation time, or a clock
        behind it, observes nothing."""
        ts = min(p.metadata.creation_timestamp for p in pods)
        if ts <= 0.0:
            return
        latency = self._clock() - ts
        if latency < 0.0:
            return
        REGISTRY.observe("nos_tpu_schedule_latency_seconds", latency,
                         labels={"class": workload_class(pods[0])})

    def _observe_rebind(self, pods: list[Pod]) -> None:
        """A displaced unit bound again: the earliest displacement stamp
        among ``pods`` to bind latency, and JOB_REBOUND journalled (a
        gang's subject is "namespace/gang")."""
        stamps = [d for d in (displacement(p) for p in pods)
                  if d is not None]
        if not stamps:
            return
        cause, ts = min(stamps, key=lambda d: d[1])
        if ts <= 0.0:
            return
        latency = self._clock() - ts
        if latency < 0.0:
            return
        first = pods[0]
        REGISTRY.observe("nos_tpu_rebind_latency_seconds", latency,
                         labels={"class": workload_class(first)})
        g = gang_name(first)
        subject = f"{first.metadata.namespace}/{g}" if g else first.key
        J.record(J.JOB_REBOUND, subject, cause=cause,
                 latency_s=round(latency, 3), members_total=len(pods),
                 **{"class": workload_class(first)})

    def _publish_pending_gauges(self) -> None:
        """Per class: the pods still pending after the cycle and the
        oldest one's age.  A class the registry has a series for and no
        pending pod reads 0."""
        now = self._clock()
        count: dict[str, int] = {}
        oldest: dict[str, float] = {}
        for p in self._pending_pods():
            if p.spec.node_name or p.spec.scheduler_name != self.name:
                continue
            cls = workload_class(p)
            count[cls] = count.get(cls, 0) + 1
            ts = p.metadata.creation_timestamp
            if 0.0 < ts <= now:
                oldest[cls] = max(oldest.get(cls, 0.0), now - ts)
        published = set(REGISTRY.gauge_label_values(
            "nos_tpu_schedule_pending_pods", "class"))
        published.update(REGISTRY.gauge_label_values(
            "nos_tpu_schedule_pending_age_seconds", "class"))
        for cls in published - set(count):
            REGISTRY.set("nos_tpu_schedule_pending_pods", 0.0,
                         labels={"class": cls})
            REGISTRY.set("nos_tpu_schedule_pending_age_seconds", 0.0,
                         labels={"class": cls})
        for cls, n in count.items():
            REGISTRY.set("nos_tpu_schedule_pending_pods", float(n),
                         labels={"class": cls})
            REGISTRY.set("nos_tpu_schedule_pending_age_seconds",
                         oldest.get(cls, 0.0), labels={"class": cls})

    def _bind(self, pod: Pod, node_name: str) -> bool:
        """Bind only: Running is the node agent's claim.  False when the
        pod vanished (no write, so nothing may be assumed)."""
        def mutate(p: Pod) -> None:
            p.spec.node_name = node_name
            p.status.conditions = [
                c for c in p.status.conditions if c.type != "PodScheduled"]
            p.metadata.labels.pop(C.LABEL_UNSCHEDULABLE_CLASS, None)
            # the displaced claim is consumed by this bind
            p.metadata.annotations.pop(C.ANNOT_DISPLACED, None)
        if not self._patch_pod(pod, mutate):
            return False
        J.record(J.POD_BOUND, pod.key, node=node_name)
        logger.debug("scheduler: bound %s -> %s", pod.key, node_name)
        return True

    def _nominate(self, pod: Pod, node_name: str) -> None:
        def mutate(p: Pod) -> None:
            p.status.nominated_node_name = node_name
        self._patch_pod(pod, mutate)
        J.record(J.POD_NOMINATED, pod.key, node=node_name)

    @staticmethod
    def _node_reason_attrs(node_reasons: dict[str, str]) -> dict:
        """Journal attrs of a rejection map: per-node verdicts and
        per-reason counts, each capped at MAX_JOURNAL_NODES, and the
        total."""
        if not node_reasons:
            return {}
        return {
            "nodes": dict(sorted(node_reasons.items())[:MAX_JOURNAL_NODES]),
            "reason_counts": dict(Counter(
                node_reasons.values()).most_common(MAX_JOURNAL_NODES)),
            "nodes_total": len(node_reasons),
        }

    @staticmethod
    def _already_marked(pod: Pod, status: Status) -> bool:
        """The pod carries exactly the condition and class label a mark
        would write: a pod rejected every cycle is not patched again."""
        if pod.metadata.labels.get(C.LABEL_UNSCHEDULABLE_CLASS) \
                != (status.reason or None):
            return False
        for c in pod.status.conditions:
            if c.type == "PodScheduled":
                return (c.status == "False"
                        and c.reason == "Unschedulable"
                        and c.message == status.message)
        return False

    def _mark_unschedulable(self, pod: Pod, status: Status,
                            node_attrs: dict | None = None) -> None:
        if not self._already_marked(pod, status):
            self._patch_pod(pod, lambda p: p.mark_unschedulable(
                status.message, status.reason))
        attrs: dict = {"reason": status.reason, "message": status.message,
                       "class": workload_class(pod)}
        if status.plugin:
            attrs["plugin"] = status.plugin
        if node_attrs:
            attrs.update(node_attrs)
        g = gang_name(pod)
        if g:
            attrs["gang"] = f"{pod.metadata.namespace}/{g}"
        J.record(J.POD_REJECTED, pod.key, **attrs)


__all__ = ["DISPLACED_AGE_CAP_S", "FULL_RESCAN_EVERY",
           "PREEMPT_BUDGET_PER_CYCLE", "Scheduler"]
