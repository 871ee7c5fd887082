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

A gang consuming one NVLink block ``NxG`` (N whole nodes of G GPUs, the
JAX package's multi-host slice) is placed in one host-index-aligned
window of a domain (``gang.gang_slice_windows``); every other gang tries
whole domains, best fit first.  A block gang that does not fit leases
its most drained window (``_reserve_gang_window``): one lease for the
fleet, the oldest stuck gang's, re-picked every cycle, published on the
window's nodes (``ANNOT_GANG_LEASE``) so the partitioner drains the same
window.  Singles avoid the leased nodes whenever another node fits (the
score's first term), and while they tie on headroom prefer nodes whose
aligned windows are already broken (the score's window term, over the
cycle's window-busy map).  Two opt-in levers act on the lease: drain
preemption evicts the last stragglers off a window held
``drain_preempt_after_cycles`` cycles (at most
``drain_preempt_max_busy_fraction`` of its GPUs, least progress first,
sparing those past ``drain_preempt_spare_progress``, whole gangs,
within disruption budgets; the freed GPUs carry the ledger's ``drain``
hold until the lease resolves), and duration-aware backfill lets a
single onto the window only if its expected duration fits inside the
window's drain ETA (``backfill_remaining_fn``, ``backfill_duration_fn``).

At each cycle's end, before the cycle's view drops, every GPU of the
view is booked to one category of the chip-second waste ledger
(``obs/ledger.py``, ``_observe_waste``): held GPUs as productive, free
ones by the holds the owning subsystems stamped (quarantine, actuation,
drain), then by the cycle's own verdicts: a node every pending class
was rejected on is ``frag_stranded``, quota-blocked and stuck-gang
demand take ``quota_stranded`` and ``gang_wait`` up to its own size,
and the rest is ``idle_no_demand``.  Warm spares and nodes without a
GPU count stay outside.

After the waterfall, the elastic grow pass (``scheduler/elastic.py``)
clones one more member of an elastic gang whose NVLink domain still
holds one, up to ``elastic_grow_budget_per_cycle`` gangs a cycle; the
clones are the next cycle's demand.

Two host-C++ paths (``native/gpu_shim.cc``) stand in for Python loops
and decide the same: before a class's scan, the native batch fit screen
(``scheduler/native_filter.py``) seeds the Filter memo with the nodes
NodeResourcesFit rejects, with its messages byte for byte
(``prescreen_fails`` counts them); the score's argmin over the feasible
nodes is one ``nos_score_batch`` call, ``_score_key`` the reference,
with the window-busy table sorted by ``nos_window_busy``.
"""

from __future__ import annotations

import ctypes
import functools
import logging
import time
from collections import Counter
from typing import Any, Callable

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.device import native
from nos_tpu_torch.exporter.metrics import REGISTRY
from nos_tpu_torch.api.podgroup import PHASE_SCHEDULED
from nos_tpu_torch.api.pdb import list_pdbs, refresh_pdb_status
from nos_tpu_torch.kube.client import APIServer, KIND_NODE, KIND_POD, NotFound
from nos_tpu_torch.kube.objects import PENDING, RUNNING, Pod
from nos_tpu_torch.kube.resources import pod_request, sum_resources
from nos_tpu_torch.obs import journal as J
from nos_tpu_torch.obs import ledger as L
from nos_tpu_torch.obs.journal import MAX_JOURNAL_NODES
from nos_tpu_torch.obs.ledger import get_ledger, pod_chip_equiv
from nos_tpu_torch.obs.trace import bump as obs_bump, span as obs_span
from nos_tpu_torch.scheduler.cache import SchedulerCache
from nos_tpu_torch.scheduler.elastic import maybe_grow, record_shrink
from nos_tpu_torch.scheduler.capacityscheduling import (
    DISPLACED_CONTEXT_KEY, VIEW_EPOCH_CONTEXT_KEY, CapacityScheduling,
)
from nos_tpu_torch.scheduler.framework import (
    CycleState, Framework, NodeInfo, SharedLister, Status, UNSCHEDULABLE,
    filter_equivalence_key,
)
from nos_tpu_torch.scheduler.gang import (
    GANG_DOMAIN_KEY, GANG_HOST_SET_KEY, evict_gang, gang_name,
    gang_slice_windows, get_pod_group, set_pod_group_status,
)
from nos_tpu_torch.topology.known import (
    DEFAULT_REGISTRY, GpuModel, GpuModelRegistry,
)
from nos_tpu_torch.topology.profile import (
    PROFILE_RE, block_gpus, is_timeshare_resource, profile_from_resource,
)
from nos_tpu_torch.scheduler.native_filter import FitPrescreen
from nos_tpu_torch.utils.guards import invalidated_by
from nos_tpu_torch.utils.pod_util import (
    admission_rank, displacement, elastic_replica_bounds, is_over_quota,
    job_progress, workload_class, workload_tier,
)
from nos_tpu_torch.utils.retry import retry_on_conflict

logger = logging.getLogger(__name__)

REGISTRY.describe("nos_tpu_drain_preemptions_total",
                  "Straggler pods evicted to complete a window drain")
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
# drain preemption's defaults: evict when the stragglers hold at most
# this share of the window's GPUs, and never one past this progress
DRAIN_PREEMPT_MAX_BUSY_FRACTION = 0.25
DRAIN_PREEMPT_SPARE_PROGRESS = 0.75
# a GPU's compute slices: the lease's and the drain's currency is
# sevenths of a GPU, as the planner's is
_SEVENTHS = 7
# the journal's reason for a single backfill keeps off a leased node
BACKFILL_REJECTION = "Backfill: job would outlive the drain window"


def _gen_window_sizes(accel: str, registry: GpuModelRegistry =
                      DEFAULT_REGISTRY) -> tuple[int, ...]:
    """The block window sizes (nodes) of the node's GPU model; () for a
    model the registry does not know."""
    model = registry.models.get(accel)
    if model is None:
        return ()
    # memoised on the frozen model itself: an override (load_overrides)
    # installs a new model, whose sizes are computed afresh
    return _window_sizes_of(model)


@functools.lru_cache(maxsize=64)
def _window_sizes_of(model: GpuModel) -> tuple[int, ...]:
    return tuple(sorted(set(model.block_node_counts)))


def gpu_sevenths(resources) -> float:
    """Capacity in sevenths of a GPU (the JAX package's chip
    equivalents, ``free_chip_equivalents``): a MIG instance its compute
    slices, an NVLink block every GPU of the block, a whole GPU and an
    MPS share 7 each; non-positive quantities and every other resource
    (cpu, memory) ignored.  The lease's drained-window choice and the
    drain's busy share read it."""
    total = 0.0
    for res, qty in resources.items():
        if qty <= 0:
            continue
        profile = profile_from_resource(res)
        if profile is not None:
            m = PROFILE_RE.match(profile)
            total += (int(m.group("g")) if m is not None
                      else _SEVENTHS * block_gpus(profile)) * qty
        elif res == C.RESOURCE_GPU or is_timeshare_resource(res):
            total += _SEVENTHS * qty
    return total


def attribute_free_chips(
        free: float, hold: dict | None, reserved: bool, demand: bool,
        rejected: bool, quota_budget: float, gang_budget: float,
) -> tuple[str, float, float, float]:
    """Book one node's ``free`` GPUs to exactly one waterfall category:
    the holds first (quarantine, actuation, drain, provisioning), then
    the gang window lease (``reserved``: the node is under it), then this
    cycle's verdicts, the quota and gang budgets consumed in node order.
    Returns (category, GPUs taken, quota budget left, gang budget left);
    the caller books ``free - taken`` as idle_no_demand."""
    take = free
    if hold is not None and L.QUARANTINE in hold:
        cat = L.QUARANTINE
    elif hold is not None and L.ACTUATION in hold:
        cat = L.ACTUATION
    elif hold is not None and L.DRAIN in hold:
        cat = L.DRAIN
    elif hold is not None and L.PROVISIONING in hold:
        cat = L.PROVISIONING
    elif reserved:
        cat = L.GANG_WAIT
    elif not demand:
        cat = L.IDLE_NO_DEMAND
    elif rejected:
        cat = L.FRAG_STRANDED
    elif quota_budget > 0.0:
        # demand the quota gates rejected before any node was screened:
        # the GPUs it could use, capped at the demand itself
        cat = L.QUOTA_STRANDED
        take = min(free, quota_budget)
        quota_budget -= take
    elif gang_budget > 0.0:
        cat = L.GANG_WAIT
        take = min(free, gang_budget)
        gang_budget -= take
    else:
        cat = L.IDLE_NO_DEMAND
    return cat, take, quota_budget, gang_budget


# The window-busy map rides its own event: _mark_busy is both its
# invalidation and its only in-place writer (a node flips busy after a
# bind), so noslint N012 holds it like the cycle view's indexes.
@invalidated_by("_invalidate_scans", "_cycle_lister_cache")
@invalidated_by("_mark_busy", "_busy_map_cache")
class Scheduler:
    # the pods' default spec.scheduler_name: the pods this one schedules
    name = "nos-tpu-scheduler"

    def __init__(self, api: APIServer, framework: Framework,
                 capacity: CapacityScheduling,
                 preempt_budget_per_cycle: int | None = None,
                 displaced_age_cap_s: float | None = None,
                 elastic_grow_budget_per_cycle: int = 1,
                 clock: Callable[[], float] = time.time,
                 drain_preempt_after_cycles: int | None = None,
                 drain_preempt_max_busy_fraction: float =
                 DRAIN_PREEMPT_MAX_BUSY_FRACTION,
                 drain_preempt_spare_progress: float =
                 DRAIN_PREEMPT_SPARE_PROGRESS,
                 drain_preempt_progress_fn: Callable[
                     [Pod], float] | None = None,
                 backfill_remaining_fn: Callable[
                     [Pod], float | None] | None = None,
                 backfill_duration_fn: Callable[
                     [Pod], float | None] | None = None,
                 registry: GpuModelRegistry = DEFAULT_REGISTRY) -> None:
        self._api = api
        # the GPU models whose NVLink blocks the score's window term reads
        # (a fleet on a restricted stand-in passes its own)
        self._registry = registry
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
        # elastic gangs the cycle-end grow pass may grow (0 = off)
        self._elastic_grow_budget = elastic_grow_budget_per_cycle
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
        # The native batch fit screen seeds that memo with a class's
        # NodeResourcesFit fails over every unseen node in one call; only
        # where NodeResourcesFit runs first, since the memo keeps its
        # messages.  Set to None to run the pipeline on every node.
        screen = FitPrescreen(framework)
        self._prescreen = screen if screen.message_exact else None
        # node -> (cap_g, used_g, cap_m, used_m) for the screen's guards,
        # dropped with the node's Filter memo
        self._guard_cache: dict[str, tuple[int, int, int, int]] = {}
        # the classes screened against the current view: a later pod of
        # one skips even the look for unseen nodes
        self._screened_classes: set = set()
        # equivalence class -> [feasible NodeInfos by name, rejections by
        # node, their journal attrs (memo), stale node names]: one scan
        # per class and state, not per pod; moved nodes are marked stale
        # and re-screened on the index's next use
        self._class_scan_cache: dict[tuple, Any] = {}
        # True while run_cycle drives the entry points: the snapshot is
        # shared by the cycle's pods
        self._in_cycle = False
        # -- the waste waterfall's inputs, reset every cycle
        # (``_observe_waste``).  The rejection maps of this cycle's
        # no-fit verdicts, deduplicated by identity: they are the class
        # scan cache's own dicts, so the same objects recur on clean
        # incremental cycles, which the skeleton memo keys on.
        self._waste_rejection_maps: list[dict[str, str]] = []
        # (key, rejection maps, per-pool template) of the last waterfall,
        # valid while the view epoch, holds, budgets and maps stand still
        self._waste_skel: tuple | None = None
        # pending class -> the nodes it was rejected on (the frag
        # culprit's evidence), and its frag-blocked GPU demand
        self._waste_frag_counts: dict[str, int] = {}
        self._waste_frag_gpus: dict[str, float] = {}
        # pending class -> GPU-seconds it has stayed frag-blocked, kept
        # across cycles: several classes stranding one pool are ranked
        # by it, not by whose rejection is newest
        self._frag_class_gpu_seconds: dict[str, float] = {}
        self._last_waste_t: float | None = None
        # pending class -> GPU demand the quota gates blocked; the sum
        # caps quota_stranded
        self._waste_quota_blocked: dict[str, float] = {}
        # stuck gang -> its members' GPU demand; the sum caps gang_wait
        self._waste_pending_gangs: dict[str, float] = {}
        # stranding class or stuck gang -> its displacement cause
        self._waste_displaced: dict[str, str] = {}
        # -- the gang window lease.  Each cycle the oldest stuck block
        # gang leases its most drained candidate window (re-picked every
        # cycle: whichever window is closest to empty wins), published on
        # the window's nodes; singles avoid the leased nodes whenever
        # another fits.  (gang key, nodes) or None.
        self._lease: tuple[tuple[str, str], frozenset[str]] | None = None
        self._reserved_hosts: frozenset[str] = frozenset()
        # the first cycle clears leases a predecessor left on the nodes
        self._lease_healed = False
        # Drain preemption (opt-in, None = off: evicting healthy pods is
        # the operator's policy choice): once a gang has held the lease
        # this many cycles, the last stragglers on the window (at most
        # the busy fraction of its GPUs) are evicted, least progress
        # first; one whose progress reached the spare threshold is
        # never evicted (it frees the window by finishing).  Progress is
        # ANNOT_JOB_PROGRESS, or drain_preempt_progress_fn(pod) where a
        # simulator injects its job table.
        self._drain_after = drain_preempt_after_cycles
        self._drain_fraction = drain_preempt_max_busy_fraction
        self._drain_spare_progress = drain_preempt_spare_progress
        self._progress_fn = drain_preempt_progress_fn or job_progress
        self._drain_cycles = 0
        self._drain_gang: tuple[str, str] | None = None
        # the nodes whose free GPUs drain preemption bought this lease
        # period (the ledger's DRAIN holds, cleared when it resolves)
        self._drain_hold_hosts: frozenset[str] = frozenset()
        # Duration-aware backfill (opt-in, both functions): a single may
        # bind onto a leased node only if its expected duration
        # (backfill_duration_fn; None = unknown, which excludes it) fits
        # inside the window's drain ETA, the most remaining seconds of
        # the pods already there (backfill_remaining_fn; None = unknown,
        # which makes the ETA infinite).  The ETA is cached per cycle.
        self._backfill_remaining_fn = backfill_remaining_fn
        self._backfill_duration_fn = backfill_duration_fn
        self._window_eta: float | None = None
        # (domain, host index) -> the node has pods: the score's window
        # term, built once per cycle view; _mark_busy flips a bound node
        # in place.  Its marshalled form for the native argmin is keyed
        # on the map's identity and dropped on every flip.
        self._busy_map_cache: dict[tuple[str, int], bool] | None = None
        self._busy_arrays_cache: tuple | None = None

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
            self._guard_cache = {}
            self._screened_classes = set()
            self._class_scan_cache = {}
            self._busy_map_cache = None
            self._busy_arrays_cache = None
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
        if dirty:
            # the busy map first: a dirtied node may have just emptied,
            # so the map is rebuilt from the view rather than flipped
            # busy by _invalidate_scans
            self._busy_map_cache = None
            self._busy_arrays_cache = None
            for name in sorted(dirty):
                self._invalidate_scans(name)
            # the dirtied nodes are unseen again by every class
            self._screened_classes = set()
        self._cycle_lister_cache = self.snapshot()

    def _drop_cycle_snapshot(self) -> None:
        self._cycle_lister_cache = None
        self._busy_map_cache = None
        self._busy_arrays_cache = None
        self._filter_cache = {}
        self._guard_cache = {}
        self._screened_classes = set()
        self._class_scan_cache = {}

    def _seed_filter_memo_native(self, pod: Pod, equiv: tuple,
                                 lister: SharedLister) -> None:
        """Seed the Filter memo with the native screen's fails for the
        pod's class on the nodes it has no verdict for yet: a native fail
        is NodeResourcesFit's, with its message, and NodeResourcesFit
        runs first.  Native passes decide nothing; the pipeline runs
        there."""
        prescreen = self._prescreen
        if prescreen is None or equiv in self._screened_classes:
            return
        self._screened_classes.add(equiv)
        unseen = [ni for ni in lister.list()
                  if equiv not in self._filter_cache.get(ni.name, ())]
        if not unseen:
            return
        msgs = prescreen.screen_nodes(unseen, pod_request(pod),
                                      guard_cache=self._guard_cache)
        if msgs is None:
            return
        seeded = 0
        for ni, why in zip(unseen, msgs):
            if why is not None:
                self._filter_cache.setdefault(ni.name, {})[equiv] = \
                    (False, why)
                seeded += 1
        if seeded:
            obs_bump("prescreen_fails", seeded)

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
                self._note_quota_blocked(pod)
            # a quota rejection is resolved by evicting over-quota
            # borrowers (reference capacity_scheduling.go:323-341)
            if status.code == UNSCHEDULABLE:
                handled, placed = self._preempt_then_retry(state, pod, lister)
                if handled:
                    return placed
            self._mark_unschedulable(pod, status)
            return None
        equiv = self._filter_equiv_key(pod)
        if equiv is not None and self._prescreen is not None:
            self._seed_filter_memo_native(pod, equiv, lister)
        # backfill's verdicts are the pod's own, not its class's: no
        # class index while it judges a leased window
        cacheable = equiv is not None and (
            self._backfill_duration_fn is None or not self._reserved_hosts)
        scan = self._class_scan_cache.get(equiv) if cacheable else None
        if scan is None:
            feasible: dict[str, NodeInfo] = {}
            rejections: dict[str, str] = {}
            for ni in lister.list():
                name = ni.name
                if not self._backfill_allows(pod, name):
                    rejections[name] = BACKFILL_REJECTION
                    continue
                ok, why = self._filter_passes(state, pod, ni, equiv, name)
                if ok:
                    feasible[name] = ni
                else:
                    rejections[name] = why
            scan = [feasible, rejections, None, set()]
            if cacheable:
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
            self._note_no_fit(pod, rejections)
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
            if not self._backfill_allows(pod, name):
                rejections[name] = BACKFILL_REJECTION
                continue
            ok, why = self._filter_passes(state, pod, ni, equiv, name)
            if ok:
                feasible[name] = ni
            else:
                rejections[name] = why
        stale.clear()
        scan[2] = None

    def _invalidate_scans(self, node_name: str) -> None:
        """A node's capacity moved: its Filter memo dies, it goes stale
        in every class index, and its window-busy entry flips busy."""
        self._filter_cache.pop(node_name, None)
        self._guard_cache.pop(node_name, None)
        for scan in self._class_scan_cache.values():
            scan[3].add(node_name)
        self._mark_busy(node_name)

    @staticmethod
    def _window_key(labels: dict) -> tuple[str, int] | None:
        """(NVLink domain, host index) of a node's labels, or None with no
        domain or an unparsable index: one parsing for the busy map, the
        in-place flip and the score's window term."""
        domain = labels.get(C.LABEL_NVLINK_DOMAIN, "")
        if not domain:
            return None
        try:
            return domain, int(labels.get(C.LABEL_HOST_INDEX, "0"))
        except ValueError:
            return None

    def _mark_busy(self, node_name: str) -> None:
        """Keep the cycle's window-busy map true after a bind: the node
        now has a pod, so the whole-free-window terms involving it stop
        this cycle."""
        if self._busy_map_cache is None or self._cycle_lister_cache is None:
            return
        ni = self._cycle_lister_cache.get(node_name)
        if ni is None:
            return
        key = self._window_key(ni.node.metadata.labels)
        if key is not None:
            self._busy_map_cache[key] = True
            # the marshalled form is keyed on the dict's identity: an
            # in-place flip drops it
            self._busy_arrays_cache = None

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
        self._window_eta = None
        self._quota_hol = {}
        self._begin_cycle_view()
        self._waste_rejection_maps = []
        self._waste_frag_counts = {}
        self._waste_frag_gpus = {}
        self._waste_quota_blocked = {}
        self._waste_pending_gangs = {}
        self._waste_displaced = {}
        now = self._clock()
        pods.sort(key=lambda p: (admission_rank(p, now,
                                                self._displaced_age_cap_s),
                                 -p.spec.priority,
                                 p.metadata.creation_timestamp, p.key))
        # the lease goes once its gang no longer waits; a gang still
        # stuck earns it (and may move it) again this cycle
        pending_gangs = {(p.metadata.namespace, gang_name(p))
                         for p in pods if gang_name(p)}
        if self._lease is not None and self._lease[0] not in pending_gangs:
            self._lease = None
            self._sync_lease_annotations(frozenset())
            self._clear_drain_holds()
        elif not self._lease_healed and self._lease is None:
            # a predecessor may have died holding a lease, whose
            # annotations would skew the partitioner for good
            self._sync_lease_annotations(frozenset())
        self._lease_healed = True
        self._reserved_hosts = (self._lease[1] if self._lease is not None
                                else frozenset())
        self._window_eta = None     # follows _reserved_hosts
        self._maybe_drain_preempt()
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
        pending_counts = self._publish_pending_gauges()
        # before the cycle's view drops: the waterfall reads the view
        # after this cycle's binds and this cycle's verdicts
        self._observe_waste(pending_counts)
        # the grow pass last: its clones are the next cycle's demand and
        # must not move this cycle's waterfall or gauges.  A fleet with no
        # gang pod (the cache's index) skips the pass's scan of every pod.
        if self._elastic_grow_budget > 0 and self._cache.has_gang_pods():
            maybe_grow(self._api, self._framework, self._cycle_lister(),
                       budget=self._elastic_grow_budget, clock=self._clock)
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
        self._note_quota_blocked(pod)
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
                self._note_stuck_gang(members)
                self._gang_journal(members, False, msg)
                for pod in members:
                    self._mark_unschedulable(pod, Status.unschedulable(msg))
                return 0
            # a block gang's candidates are the aligned windows of the
            # partitioner's shard convention, those clear of the lease
            # and of defrag drains first; every other gang's are whole
            # domains, best fit first
            windows = gang_slice_windows(self._api, members)
            base = self._cycle_lister()
            if windows:
                candidates = [{GANG_DOMAIN_KEY: domain,
                               GANG_HOST_SET_KEY: hosts}
                              for domain, hosts
                              in self._order_gang_windows(windows)]
            else:
                candidates = self._domains_best_fit(base)
            placements: list[tuple[Pod, NodeInfo]] = []
            state = CycleState()
            for pins in candidates:
                placements, state, _, _ = self._attempt_gang(pins, base,
                                                             members)
                if len(placements) == len(members):
                    break
            if len(placements) != len(members):
                msg = self._gang_no_fit(members, candidates, base)
                # the lease's node patches come before the members'
                # marks, as in the JAX package
                self._reserve_gang_window(
                    (first.metadata.namespace, gang), windows, base)
                for pod in members:
                    self._mark_unschedulable(pod,
                                             Status.unschedulable(msg))
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
                     base: SharedLister) -> str:
        """No candidate holds the gang.  A gang claiming its guaranteed
        min must not starve behind over-quota borrowers, so it gets a
        preemption, under the cycle's budget, on the first candidate
        where it would fit with every evictable pod gone: PostFilter for
        the stuck member with its placed mates booked in cycle state, so
        the victims are chosen against the whole gang's claim.  The
        victims' gangs die whole (``evict_gang``); the gang binds on a
        later cycle.  Returns the members' message; the caller marks
        them."""
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
        self._note_stuck_gang(members)
        self._gang_journal(members, False, msg)
        return msg

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
        if domain is not None and \
                ni.node.metadata.labels.get(C.LABEL_NVLINK_DOMAIN, "") \
                != domain:
            return False
        hosts = pins.get(GANG_HOST_SET_KEY)
        return hosts is None or ni.name in hosts

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
            self._busy_map_cache = None
            self._busy_arrays_cache = None
        return nominated, status

    # -- duration-aware backfill ---------------------------------------------
    def _backfill_allows(self, pod: Pod, name: str) -> bool:
        """True off the leased nodes, or with backfill off; on them, the
        pod's expected duration must fit the window's drain ETA (an
        unknown duration never gambles the window)."""
        if name not in self._reserved_hosts \
                or self._backfill_duration_fn is None \
                or self._backfill_remaining_fn is None:
            return True
        duration = self._backfill_duration_fn(pod)
        if duration is None:
            return False
        return duration <= self._window_drain_eta()

    def _window_drain_eta(self) -> float:
        """The most remaining seconds among the pods on the leased nodes
        (cached per cycle); an unknown remainder makes it infinite: the
        window will not drain by itself soon, and drain preemption is
        the lever there."""
        if self._window_eta is not None:
            return self._window_eta
        eta = 0.0
        for p in self._api.list(KIND_POD):
            if p.spec.node_name in self._reserved_hosts \
                    and p.status.phase in (PENDING, RUNNING):
                rem = self._backfill_remaining_fn(p)
                if rem is None:
                    eta = float("inf")
                    break
                eta = max(eta, rem)
        self._window_eta = eta
        return eta

    # -- drain preemption ---------------------------------------------------
    def _maybe_drain_preempt(self) -> None:
        """Evict the last stragglers off a long-held lease window (see
        __init__).  Once per lease period: after an attempt the counter
        restarts, so survivors (spared or within a disruption budget's
        reprieve) get another full ``drain_preempt_after_cycles``."""
        if self._drain_after is None:
            return
        gang = self._lease[0] if self._lease is not None else None
        if gang != self._drain_gang:
            self._drain_gang, self._drain_cycles = gang, 0
            return
        if gang is None:
            return
        self._drain_cycles += 1
        if self._drain_cycles < self._drain_after:
            return
        hosts = self._reserved_hosts
        # a serving pod is never drain-evicted: no mechanism preempts the
        # serving tier for batch progress
        stragglers = [
            p for p in self._api.list(KIND_POD)
            if p.spec.node_name in hosts
            and p.status.phase in (PENDING, RUNNING)
            and (p.metadata.namespace, gang_name(p)) != gang
            and workload_tier(p) != C.TIER_SERVING]
        if not stragglers:
            return
        capacity = 0.0
        for node in self._api.list(KIND_NODE):
            if node.metadata.name in hosts:
                try:
                    capacity += _SEVENTHS * float(node.metadata.labels.get(
                        C.LABEL_GPU_COUNT, "0"))
                except ValueError:
                    pass
        busy = sum(gpu_sevenths(pod_request(p)) for p in stragglers)
        if capacity <= 0 or busy > self._drain_fraction * capacity:
            return      # not the final stretch: keep waiting
        # disruption budgets: each candidate's whole eviction set is
        # charged (evict_gang takes every gang mate)
        pdbs = [refresh_pdb_status(self._api, pdb)
                for pdb in list_pdbs(self._api)]
        allowed = [pdb.status.disruptions_allowed for pdb in pdbs]
        evicted = 0
        doomed_keys: set[str] = set()
        # progress is the gang's (the most of its members): eviction
        # takes the whole gang, so an unannotated member must not take
        # its nearly done gang past the spare rule
        prog_cache: dict[tuple[str, str], float] = {}

        def progress(p: Pod) -> float:
            g = gang_name(p)
            if not g:
                return self._progress_fn(p)
            key = (p.metadata.namespace, g)
            if key not in prog_cache:
                mates = self._api.list(
                    KIND_POD, namespace=p.metadata.namespace,
                    label_selector={C.LABEL_POD_GROUP: g})
                prog_cache[key] = max(
                    [self._progress_fn(m) for m in mates] or [0.0])
            return prog_cache[key]

        stragglers = sorted(
            (p for p in stragglers
             if progress(p) < self._drain_spare_progress),
            key=progress)
        shrunk_gangs: dict[tuple[str, str], int] = {}
        for pod in stragglers:
            if pod.key in doomed_keys:
                continue
            g = gang_name(pod)
            members = [pod] if not g else self._api.list(
                KIND_POD, namespace=pod.metadata.namespace,
                label_selector={C.LABEL_POD_GROUP: g})
            # an elastic dp straggler shrinks first: it loses only its
            # members on the window, within the gang's min
            shrink = False
            if g:
                bounds = elastic_replica_bounds(pod)
                if bounds is not None:
                    live = [m for m in members
                            if m.status.phase in (PENDING, RUNNING)]
                    headroom = max(0, len(live) - bounds[0])
                    on_window = [m for m in live
                                 if m.spec.node_name in hosts
                                 and m.key not in doomed_keys]
                    members = on_window[:headroom]
                    if not members:
                        continue    # at its min: nothing to shrink
                    shrink = True
            needed: dict[int, int] = {}
            for m in members:
                if m.status.phase != RUNNING or m.key in doomed_keys:
                    continue
                for i, pdb in enumerate(pdbs):
                    if pdb.matches(m):
                        needed[i] = needed.get(i, 0) + 1
            if any(allowed[i] < n for i, n in needed.items()):
                continue        # a budget lacks allowance: reprieve
            for i, n in needed.items():
                allowed[i] -= n
            doomed_keys.update(m.key for m in members)
            if shrink:
                for m in members:
                    try:
                        self._api.delete(KIND_POD, m.metadata.name,
                                         m.metadata.namespace)
                        evicted += 1
                    except NotFound:
                        pass
                key = (pod.metadata.namespace, g)
                shrunk_gangs[key] = shrunk_gangs.get(key, 0) + len(members)
            else:
                evicted += len(evict_gang(self._api, pod))
        for (ns, g), n in sorted(shrunk_gangs.items()):
            record_shrink(self._api, ns, g, n)
        if evicted:
            # the freed GPUs were bought by eviction: until the lease
            # resolves, their idle time is the ledger's drain, not gang
            # assembly's wait
            ledger = get_ledger()
            for host in hosts:
                ledger.set_hold(host, L.DRAIN, owner=self.name,
                                gang=f"{gang[0]}/{gang[1]}",
                                evicted=evicted)
            self._drain_hold_hosts = frozenset(hosts)
            REGISTRY.inc("nos_tpu_drain_preemptions_total",
                         labels={"gang": f"{gang[0]}/{gang[1]}"},
                         value=evicted)
            logger.info(
                "drain preemption for gang %s/%s: evicted %d straggler "
                "pod(s) off %s after %d cycles", gang[0], gang[1],
                evicted, sorted(hosts), self._drain_cycles)
        self._drain_cycles = 0

    def _clear_drain_holds(self) -> None:
        if not self._drain_hold_hosts:
            return
        ledger = get_ledger()
        for host in self._drain_hold_hosts:
            ledger.clear_hold(host, L.DRAIN, owner=self.name)
        self._drain_hold_hosts = frozenset()

    # -- the gang window lease ----------------------------------------------
    def _order_gang_windows(self, windows: list) -> list:
        """Windows clear of the lease and of defrag drains first (a
        smaller gang binding into either would reset the larger drain's
        clock, or refill the nodes a defrag move just emptied), in
        adjacency order otherwise."""
        avoid = set(self._reserved_hosts)
        lister = self._cycle_lister_cache
        if lister is not None:
            for ni in lister.list():
                if ni.node.metadata.annotations.get(C.ANNOT_DEFRAG_DRAIN):
                    avoid.add(ni.name)
        return sorted(windows, key=lambda item: len(item[1] & avoid))

    def _reserve_gang_window(self, gang_key: tuple[str, str],
                             windows: list, base: SharedLister) -> None:
        """A stuck block gang leases its most drained candidate window
        (the most free GPU sevenths: the least left to wait for),
        re-picked every cycle.  One lease for the fleet, the oldest stuck
        gang's (the admission order).  Advisory: singles leave the leased
        nodes whenever another fits, so it costs nothing with room."""
        if self._lease is not None and self._lease[0] != gang_key:
            return          # an older gang holds this cycle's lease
        if not windows:
            return
        free_by_name = {ni.name: gpu_sevenths(ni.free())
                        for ni in base.list()}
        best: tuple[float, frozenset[str]] | None = None
        for _, hosts in windows:
            if not hosts:
                continue
            drained = sum(free_by_name.get(h, 0.0) for h in hosts)
            if best is None or drained > best[0]:
                best = (drained, frozenset(hosts))
        if best is None:
            return
        if best[1] != self._reserved_hosts:
            # the lease moved: the drain holds belong to the old window
            self._clear_drain_holds()
        self._lease = (gang_key, best[1])
        self._reserved_hosts = best[1]
        self._window_eta = None
        self._sync_lease_annotations(best[1], gang_key)
        logger.debug("gang %s leased window %s", gang_key, sorted(best[1]))

    def _sync_lease_annotations(self, hosts: frozenset[str],
                                gang_key: tuple[str, str] | None = None
                                ) -> None:
        """Publish the lease on its nodes (ANNOT_GANG_LEASE, the value
        "<namespace>/<gang>") and clear it everywhere else.  Every node is
        visited, which also heals leases a restarted scheduler left."""
        value = f"{gang_key[0]}/{gang_key[1]}" if gang_key else ""
        for node in self._api.list(KIND_NODE):
            has = node.metadata.annotations.get(C.ANNOT_GANG_LEASE, "")
            want = value if node.metadata.name in hosts else ""
            if has == want:
                continue

            def mutate(n: Any, want: str = want) -> None:
                if want:
                    n.metadata.annotations[C.ANNOT_GANG_LEASE] = want
                else:
                    n.metadata.annotations.pop(C.ANNOT_GANG_LEASE, None)
            try:
                retry_on_conflict(self._api, KIND_NODE, node.metadata.name,
                                  mutate, component="scheduler-gang-lease")
            except Exception:  # noqa: BLE001 — advisory: the next cycle's full sweep heals a half-synced lease, so no failure here may abort the cycle
                logger.debug("lease annotation patch failed for %s",
                             node.metadata.name)

    # -- the score's window terms -------------------------------------------
    def _cycle_busy_map(self, lister: SharedLister) -> dict:
        """The window-busy map, kept for the cycle when ``lister`` is the
        cycle view (flips ride _mark_busy); built afresh for any other."""
        if lister is not self._cycle_lister_cache:
            return self._window_busy_map(lister)
        if self._busy_map_cache is None:
            self._busy_map_cache = self._window_busy_map(lister)
        return self._busy_map_cache

    def _window_busy_map(self, lister: SharedLister) -> dict:
        """(domain, host index) -> the node has pods."""
        busy: dict[tuple[str, int], bool] = {}
        for ni in lister.list():
            key = self._window_key(ni.node.metadata.labels)
            if key is None:
                continue
            busy[key] = busy.get(key, False) or bool(ni.pods)
        return busy

    def _busy_score_arrays(self, busy: dict) -> tuple:
        """The busy map marshalled for ``nos_score_batch``: domain ->
        dense group id (in sorted domain order), and the (group id, host
        index, busy) triples sorted by ``nos_window_busy`` so the argmin
        can binary-search a window's members.  Cached on the map's
        identity: _mark_busy's flip drops it, and a new map misses."""
        cached = self._busy_arrays_cache
        if cached is not None and cached[0] is busy:
            return cached[1]
        domains = sorted({d for d, _ in busy})
        gid_of = {d: g for g, d in enumerate(domains)}
        n = len(busy)
        gid_a = (ctypes.c_longlong * max(1, n))()
        idx_a = (ctypes.c_longlong * max(1, n))()
        val_a = (ctypes.c_uint8 * max(1, n))()
        for i, ((d, idx), val) in enumerate(busy.items()):
            gid_a[i] = gid_of[d]
            idx_a[i] = idx
            val_a[i] = 1 if val else 0
        native.window_busy_sort(gid_a, idx_a, val_a, n)
        arrays = (gid_of, gid_a, idx_a, val_a, n)
        self._busy_arrays_cache = (busy, arrays)
        return arrays

    def _choose_node(self, pod: Pod,
                     feasible: dict[str, NodeInfo]) -> NodeInfo:
        """``_score_key``'s argmin over the feasible nodes, with the
        window terms over the cycle view's busy map: in one native call,
        in Python where ``_native_choose`` declines."""
        nis = list(feasible.values())
        if len(nis) == 1:
            return nis[0]
        chosen = self._native_choose(pod, nis)
        if chosen is not None:
            return chosen
        return min(nis, key=self._score_key(pod, self._cycle_lister_cache))

    def _native_choose(self, pod: Pod,
                       nis: list[NodeInfo]) -> NodeInfo | None:
        """``_score_key``'s argmin through ``nos_score_batch``: the
        avoidance, the headroom (the same Python sum), the window term
        over the cycle view's sorted busy table, the host index and the
        rank of the name, compared in that order.  None where a host
        index is negative or past 64 bits, which the Python argmin takes
        (JAX's guard: C's division truncates where Python's floors)."""
        lister = self._cycle_lister_cache
        busy = self._cycle_busy_map(lister) if lister is not None else {}
        gid_of, busy_gid, busy_idx, busy_val, m = \
            self._busy_score_arrays(busy)
        req = pod_request(pod)
        n = len(nis)
        avoided = (ctypes.c_uint8 * n)()
        headroom = (ctypes.c_double * n)()
        gids = (ctypes.c_longlong * n)()
        widx = (ctypes.c_longlong * n)()
        hidx = (ctypes.c_longlong * n)()
        rank = (ctypes.c_longlong * n)()
        wsizes: list[int] = []
        woff = (ctypes.c_longlong * (n + 1))()
        rank_of = {name: r
                   for r, name in enumerate(sorted(ni.name for ni in nis))}
        for i, ni in enumerate(nis):
            meta = ni.node.metadata
            try:
                idx = int(meta.labels.get(C.LABEL_HOST_INDEX, "0"))
            except ValueError:
                idx = 0
            if not 0 <= idx < 1 << 63:
                return None
            free = ni.free()
            headroom[i] = sum(free.get(r, 0.0) for r in req)
            hidx[i] = idx
            avoided[i] = 1 if (
                ni.name in self._reserved_hosts
                or meta.annotations.get(C.ANNOT_DEFRAG_DRAIN)) else 0
            rank[i] = rank_of[ni.name]
            gids[i] = -1
            wkey = self._window_key(meta.labels) if m else None
            if wkey is not None:
                # a domain missing from the busy map fails every
                # membership test, so its term is 0: the group stays -1
                g = gid_of.get(wkey[0])
                if g is not None:
                    gids[i] = g
                    widx[i] = wkey[1]
                    wsizes.extend(self._window_sizes(ni))
            woff[i + 1] = len(wsizes)
        ws_arr = (ctypes.c_longlong * max(1, len(wsizes)))(*wsizes)
        out = native.score_batch(avoided, headroom, gids, widx, hidx, rank,
                                 ws_arr, woff, busy_gid, busy_idx, busy_val,
                                 n, m)
        return nis[out]

    def _window_sizes(self, ni: NodeInfo) -> tuple[int, ...]:
        """The block window sizes (nodes) of the node's GPU model, on a
        node a block can take: one of the MIG family (the group pass
        carves blocks over MIG nodes only, so an MPS or hybrid node
        breaks no window a block gang could use)."""
        labels = ni.node.metadata.labels
        if labels.get(C.LABEL_PARTITIONING) != C.MIG_KIND:
            return ()
        return _gen_window_sizes(labels.get(C.LABEL_ACCELERATOR, ""),
                                 self._registry)

    def _score_key(self, pod: Pod, lister: SharedLister | None = None
                   ) -> Callable[[NodeInfo], tuple]:
        """Nodes under the gang lease or a defrag drain last (the leased
        window must drain, and the room a defrag move frees is for the
        demand it was made for), then the least headroom on the pod's
        own resources (packs tightly), then the window term, then the
        numeric host index (absent or unparsable: 0), then the name:
        nodes fill in their physical order, where the name's order would
        put gpu-node-10 before gpu-node-2.  The window term, with
        ``lister`` given, sums the sizes of the node's aligned block
        windows that are wholly free in the busy map: a single placed
        there would break a window a block gang could use."""
        req = pod_request(pod)
        busy = self._cycle_busy_map(lister) if lister is not None else {}

        def window_penalty(ni: NodeInfo) -> int:
            if not busy:
                return 0
            wkey = self._window_key(ni.node.metadata.labels)
            if wkey is None:
                return 0
            domain, idx = wkey
            pen = 0
            for size in self._window_sizes(ni):
                start = (idx // size) * size
                if all(busy.get((domain, i)) is False
                       for i in range(start, start + size)):
                    pen += size
            return pen

        def key(ni: NodeInfo) -> tuple:
            free = ni.free()
            avoided = (ni.name in self._reserved_hosts
                       or bool(ni.node.metadata.annotations.get(
                           C.ANNOT_DEFRAG_DRAIN)))
            try:
                idx = int(ni.node.metadata.labels.get(
                    C.LABEL_HOST_INDEX, "0"))
            except ValueError:
                idx = 0
            return (avoided, sum(free.get(r, 0.0) for r in req),
                    window_penalty(ni), idx, ni.name)

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

    def _publish_pending_gauges(self) -> dict[str, int]:
        """Per class: the pods still pending after the cycle and the
        oldest one's age.  A class the registry has a series for and no
        pending pod reads 0.  Returns the pending count per class, the
        waterfall's is-there-demand signal."""
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
        return count

    # -- the chip-second waste waterfall (obs/ledger.py) --------------------
    def _gpu_demand(self, pod: Pod) -> float:
        """The GPUs ``pod`` would hold (``pod_chip_equiv``; a MIG
        instance lies on one GPU, so one GPU caps it)."""
        return pod_chip_equiv(pod_request(pod), 1.0,
                              float(self._capacity.calculator.gb_per_gpu))

    def _note_quota_blocked(self, pod: Pod) -> None:
        """The quota gates rejected ``pod`` (PreFilter or the head-of-line
        rule): free GPUs its class could use read quota_stranded, up to
        its demand."""
        cls = workload_class(pod)
        self._waste_quota_blocked[cls] = max(
            self._waste_quota_blocked.get(cls, 0.0), self._gpu_demand(pod))

    def _note_no_fit(self, pod: Pod, rejections: dict[str, str]) -> None:
        """Filter rejected ``pod`` on every node: those verdicts are the
        frag_stranded derivation (a node every pending class was
        rejected on holds GPUs no pending demand can use).  Class-mates
        hand in the same cached dict, so a class is noted once."""
        maps = self._waste_rejection_maps
        if not any(m is rejections for m in maps):
            maps.append(rejections)
        cls = workload_class(pod)
        disp = displacement(pod)
        if disp is not None:
            # a displaced victim stranding capacity: the evidence names
            # its cause
            self._waste_displaced.setdefault(cls, disp[0])
        self._waste_frag_counts[cls] = max(
            self._waste_frag_counts.get(cls, 0), len(rejections))
        self._waste_frag_gpus[cls] = max(
            self._waste_frag_gpus.get(cls, 0.0), self._gpu_demand(pod))

    def _note_stuck_gang(self, members: list[Pod]) -> None:
        """A gang that failed admission this cycle, with its members'
        GPU demand: the cap on its gang_wait."""
        first = members[0]
        key = f"{first.metadata.namespace}/{gang_name(first)}"
        gpus = sum(self._gpu_demand(m) for m in members)
        self._waste_pending_gangs[key] = max(
            self._waste_pending_gangs.get(key, 0.0), gpus)
        disp = next((d for d in (displacement(m) for m in members)
                     if d is not None), None)
        if disp is not None:
            self._waste_displaced.setdefault(key, disp[0])

    def _waste_evidence(self) -> tuple[dict | None, dict | None,
                                       dict | None]:
        """(frag, quota, gang) evidence of this cycle.  The frag culprit
        is the class with the most frag-blocked GPU-seconds so far
        (each class's demand accrues over the interval since the last
        cycle), then the most rejections, then its name."""
        now = self._clock()
        dt = (max(0.0, now - self._last_waste_t)
              if self._last_waste_t is not None else 0.0)
        self._last_waste_t = now
        for cls, gpus in self._waste_frag_gpus.items():
            self._frag_class_gpu_seconds[cls] = \
                self._frag_class_gpu_seconds.get(cls, 0.0) + gpus * dt
        frag_ev: dict | None = None
        if self._waste_frag_counts:
            ranked = sorted(
                self._waste_frag_counts,
                key=lambda c: (-self._frag_class_gpu_seconds.get(c, 0.0),
                               -self._waste_frag_counts[c], c))
            top = ranked[0]
            frag_ev = {
                "class": top,
                "rejected_nodes": self._waste_frag_counts[top],
                "classes": [
                    {"class": c,
                     "stranded_chip_seconds": round(
                         self._frag_class_gpu_seconds.get(c, 0.0), 1),
                     "blocked_chips": round(
                         self._waste_frag_gpus.get(c, 0.0), 2)}
                    for c in ranked[:3]],
            }
            if top in self._waste_displaced:
                frag_ev["displaced_cause"] = self._waste_displaced[top]
        quota_ev: dict | None = None
        if self._waste_quota_blocked:
            top_q = max(self._waste_quota_blocked.items(),
                        key=lambda kv: kv[1])
            quota_ev = {"class": top_q[0],
                        "blocked_chips": round(top_q[1], 2)}
        gang_ev: dict | None = None
        if self._lease is not None:
            gang_ev = {"gang": f"{self._lease[0][0]}/{self._lease[0][1]}"}
        elif self._waste_pending_gangs:
            top_g = max(self._waste_pending_gangs.items(),
                        key=lambda kv: kv[1])
            gang_ev = {"gang": top_g[0]}
        if gang_ev is not None:
            cause = self._waste_displaced.get(str(gang_ev["gang"]))
            if cause is not None:
                gang_ev["displaced_cause"] = cause
        return frag_ev, quota_ev, gang_ev

    def _observe_waste(self, pending_by_class: dict[str, int]) -> None:
        """Cycle end: book every GPU of the cycle's view to one category
        and hand the per-pool waterfall to the ledger.  A node's held
        GPUs are productive; its free GPUs go by ``attribute_free_chips``
        (the holds, then this cycle's verdicts, the quota and gang
        budgets each capped at the blocked demand's own size).  Each GPU
        lands in exactly one bucket, so the waterfall conserves.

        The per-node loop is a pure function of the view, the holds, the
        demand flag, the budgets and the rejection maps.  While the view
        epoch and the rest stand still (the maps by identity), the last
        per-pool template is replayed with only the evidence
        re-resolved, whose frag integral accrues every cycle."""
        ledger = get_ledger()
        lister = self._cycle_lister()
        holds = ledger.holds()
        demand = bool(pending_by_class) or bool(self._waste_pending_gangs)
        quota_budget = sum(self._waste_quota_blocked.values())
        gang_budget = sum(self._waste_pending_gangs.values())
        frag_ev, quota_ev, gang_ev = self._waste_evidence()
        shared = {L.GANG_WAIT: gang_ev, L.FRAG_STRANDED: frag_ev,
                  L.QUOTA_STRANDED: quota_ev}

        rej_maps = tuple(self._waste_rejection_maps)
        skel_key = None
        if lister is self._cycle_lister_cache:
            skel_key = (self._cache.view_epoch(), demand, quota_budget,
                        gang_budget, self._reserved_hosts, holds)
            prev = self._waste_skel
            if prev is not None and prev[0] == skel_key \
                    and len(prev[1]) == len(rej_maps) \
                    and all(a is b for a, b in zip(prev[1], rej_maps)):
                replay: dict[str, dict[str, object]] = {}
                for pool, (pcap, pcats, evcats) in prev[2].items():
                    evidence = {}
                    for cat, src in evcats.items():
                        live = shared[cat] if src is None else src
                        if live:
                            evidence[cat] = dict(live)
                    replay[pool] = {"capacity": pcap,
                                    "categories": dict(pcats),
                                    "evidence": evidence}
                ledger.observe(replay)
                return

        gb_per_gpu = float(self._capacity.calculator.gb_per_gpu)
        pools: dict[str, dict[str, Any]] = {}
        for ni in lister.list():
            labels = ni.node.metadata.labels
            if C.is_warm_spare_labels(labels):
                # a warm spare is reserve, not capacity, until promoted
                continue
            try:
                cap = float(labels.get(C.LABEL_GPU_COUNT, "0") or 0.0)
            except ValueError:
                cap = 0.0
            if cap <= 0.0:
                continue        # no GPU count: outside the ledger
            pool = labels.get(C.LABEL_NVLINK_DOMAIN, "") or "-"
            entry = pools.setdefault(
                pool, {"capacity": 0.0, "categories": {}, "evidence": {}})
            entry["capacity"] += cap
            cats = entry["categories"]
            used = min(cap, pod_chip_equiv(ni.requested, cap, gb_per_gpu))
            free = cap - used
            if used > 0.0:
                cats[L.PRODUCTIVE] = cats.get(L.PRODUCTIVE, 0.0) + used
            if free <= 0.0:
                continue
            name = ni.name
            hold = holds.get(name)
            cat, take, quota_budget, gang_budget = attribute_free_chips(
                free, hold, name in self._reserved_hosts, demand,
                any(name in m for m in rej_maps), quota_budget,
                gang_budget)
            if cat in L.HOLD_PRECEDENCE:
                evidence = {"node": name, **(hold or {})[cat]}
            else:
                evidence = shared.get(cat)
            cats[cat] = cats.get(cat, 0.0) + take
            if take < free:
                cats[L.IDLE_NO_DEMAND] = \
                    cats.get(L.IDLE_NO_DEMAND, 0.0) + (free - take)
            if evidence:
                entry["evidence"].setdefault(cat, dict(evidence))
        if skel_key is not None:
            # the shared evidence symbolically (None: re-resolved at
            # replay), a hold's evidence as it is
            self._waste_skel = (skel_key, rej_maps, {
                pool: (entry["capacity"], dict(entry["categories"]),
                       {cat: None if cat in shared else dict(ev)
                        for cat, ev in entry["evidence"].items()})
                for pool, entry in pools.items()})
        else:
            self._waste_skel = None
        ledger.observe(pools)

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


__all__ = ["DISPLACED_AGE_CAP_S", "DRAIN_PREEMPT_MAX_BUSY_FRACTION",
           "DRAIN_PREEMPT_SPARE_PROGRESS", "FULL_RESCAN_EVERY",
           "PREEMPT_BUDGET_PER_CYCLE", "Scheduler", "attribute_free_chips",
           "gpu_sevenths"]
