"""The scheduling loop, ``nos_tpu/scheduler/scheduler.py`` for the port:
its single-pod path.

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
re-screened, per Filter equivalence class.  Preemption is budgeted per
cycle; a preemptor that won room binds into it in the same cycle.

Not here yet (ROADMAP item 7, the gang slice): ``schedule_gang`` and its
windows and lease, drain preemption and duration-aware backfill, elastic
grow; a pending pod with a pod-group label makes ``run_cycle`` and
``schedule_one`` raise NotImplementedError rather than place a gang's
members as singles.  The JAX scheduler's native prescreen and native
choose (item 23) and its chip-second waste ledger (item 9) are not
ported either: the score's lease, defrag-drain and window terms read
zero without them, so the score is ``(headroom, name)``, the JAX key on
nodes with no window labels.
"""

from __future__ import annotations

import logging
import time
from collections import Counter
from typing import Any, Callable

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.exporter.metrics import REGISTRY
from nos_tpu_torch.kube.client import APIServer, KIND_POD, NotFound
from nos_tpu_torch.kube.objects import Pod
from nos_tpu_torch.kube.resources import pod_request
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
from nos_tpu_torch.scheduler.gang import gang_name
from nos_tpu_torch.utils.guards import invalidated_by
from nos_tpu_torch.utils.pod_util import (
    admission_rank, displacement, workload_class, workload_tier,
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

GANGS_NOT_PORTED = ("gang scheduling (pod-group pods) is ROADMAP item 7's "
                    "gang slice, not ported yet")

# The JAX Scheduler's defaults, the values every caller runs.  At most
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
                 clock: Callable[[], float] = time.time) -> None:
        self._api = api
        self._framework = framework
        # the framework's capacity plugin: the quota head-of-line rule
        # reads its ledger and calculator
        self._capacity = capacity
        # schedule latency is clock() - creation_timestamp: the clock
        # shares the pods' time domain (wall clock in production)
        self._clock = clock
        self._preempt_budget = PREEMPT_BUDGET_PER_CYCLE
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
        if gang_name(pod):
            raise NotImplementedError(f"{pod.key}: {GANGS_NOT_PORTED}")
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
        equiv = filter_equivalence_key(pod)
        scan = self._class_scan_cache.get(equiv)
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
        self._observe_schedule_latency(pod)
        self._observe_rebind(pod)
        return chosen.name

    def _filter_passes(self, state: CycleState, pod: Pod, ni: NodeInfo,
                       equiv: tuple, name: str) -> tuple[bool, str]:
        """(verdict, why), memoised per node and class; ``why`` is
        "plugin: message" on a rejection."""
        per_node = self._filter_cache.setdefault(name, {})
        verdict = per_node.get(equiv)
        if verdict is None:
            st = self._framework.run_filter_plugins(state, pod, ni)
            verdict = (True, "") if st.is_success else \
                (False, f"{st.plugin or 'Filter'}: {st.message}")
            per_node[equiv] = verdict
        return verdict

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
        how many were bound.  Raises NotImplementedError, before any
        decision, when one of them is a gang member."""
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
        gang = next((p for p in pods if gang_name(p)), None)
        if gang is not None:
            raise NotImplementedError(f"{gang.key}: {GANGS_NOT_PORTED}")
        bound = 0
        self._preempt_budget = PREEMPT_BUDGET_PER_CYCLE
        self._quota_hol = {}
        self._begin_cycle_view()
        now = self._clock()
        pods.sort(key=lambda p: (admission_rank(p, now,
                                                DISPLACED_AGE_CAP_S),
                                 -p.spec.priority,
                                 p.metadata.creation_timestamp, p.key))
        for pod in pods:
            if self._quota_hol_defers(pod):
                continue
            if self._schedule_one(pod) is not None:
                bound += 1
        self._publish_pending_gauges()
        return bound

    # -- quota head-of-line -------------------------------------------------
    # A quota-rejected pod waits for headroom in its namespace's quota.
    # For the rest of the cycle, lower-priority pods of that namespace
    # must not bind into headroom that frees up, or small pods would eat
    # every freed piece before the claimant's whole request gathers.

    def _record_quota_hol(self, pod: Pod) -> None:
        ns = pod.metadata.namespace
        cap = self._capacity
        # a claimant that alone passes its namespace's max or the
        # aggregate min can never schedule, and would block its
        # namespace forever: it claims nothing
        req = cap.calculator.compute_pod_request(pod)
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

    def _post_filter_budgeted(self, state: CycleState, pod: Pod,
                              lister: SharedLister) -> tuple[str, Status]:
        """PostFilter under the cycle's preemption budget; once it is
        spent, unschedulable pods wait for the next cycle."""
        if self._preempt_budget <= 0:
            return "", Status.unschedulable(
                "preemption budget for this cycle spent")
        self._preempt_budget -= 1
        state[DISPLACED_CONTEXT_KEY] = (self._clock(), DISPLACED_AGE_CAP_S)
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
        resources (packs shares tightly), ties by name."""
        nis = list(feasible.values())
        if len(nis) == 1:
            return nis[0]
        return min(nis, key=self._score_key(pod))

    @staticmethod
    def _score_key(pod: Pod) -> Callable[[NodeInfo], tuple]:
        req = pod_request(pod)

        def key(ni: NodeInfo) -> tuple:
            free = ni.free()
            return (sum(free.get(r, 0.0) for r in req), ni.name)

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

    def _observe_schedule_latency(self, pod: Pod) -> None:
        """Queue-admission to bind latency; a pod without a creation
        time, or a clock behind it, observes nothing."""
        ts = pod.metadata.creation_timestamp
        if ts <= 0.0:
            return
        latency = self._clock() - ts
        if latency < 0.0:
            return
        REGISTRY.observe("nos_tpu_schedule_latency_seconds", latency,
                         labels={"class": workload_class(pod)})

    def _observe_rebind(self, pod: Pod) -> None:
        """A displaced pod bound again: displacement stamp to bind
        latency, and JOB_REBOUND journalled."""
        disp = displacement(pod)
        if disp is None:
            return
        cause, ts = disp
        if ts <= 0.0:
            return
        latency = self._clock() - ts
        if latency < 0.0:
            return
        REGISTRY.observe("nos_tpu_rebind_latency_seconds", latency,
                         labels={"class": workload_class(pod)})
        J.record(J.JOB_REBOUND, pod.key, cause=cause,
                 latency_s=round(latency, 3), members_total=1,
                 **{"class": workload_class(pod)})

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
        J.record(J.POD_REJECTED, pod.key, **attrs)


__all__ = ["DISPLACED_AGE_CAP_S", "FULL_RESCAN_EVERY", "GANGS_NOT_PORTED",
           "PREEMPT_BUDGET_PER_CYCLE", "Scheduler"]
