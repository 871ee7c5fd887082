"""Background defragmentation, ``nos_tpu/partitioning/core/defrag.py``
for the port: propose re-carves and migrations that turn stranded free
GPU capacity back into placeable capacity.

The waste ledger (``obs/ledger.py``) names fragmentation: free capacity
on nodes whose free geometry fits no pending class.  Jobs keep their
admission-time placement for life, so that capacity comes back only by
moving something, and the copy-on-write snapshot (``snapshot.py``) makes
"what if we moved it?" cheap to ask.  The proposer runs from the MIG
partitioner controller after each plan:

1. **Frag-blocked demand**: pending pods the cluster's free MIG capacity
   covers (counted blind to profiles, the verdict the ledger's
   ``frag_stranded`` keys on) that are still unschedulable and not
   quota-blocked.  Demand must persist across two steps, so a pod the
   plan just rescued is never migrated for.
2. **Propose**: the aligned candidate windows of the unit's size
   (``topology/windows.py``) whose resident pods are all movable,
   cheapest first.  Feasibility is proved on a fork of a snapshot
   subset: every victim must first-fit (or re-carve then fit) on a node
   outside the window, and the fork is reverted on every path: the
   proposal acts through evictions, never through geometry written on a
   hypothesis.
3. **Score**: ``payback = unlocked capacity / migration cost``; the cost
   is the restart cost (``nos.tpu/job-progress`` times the pod's
   capacity: the progress the victim earns again) plus a constant per
   move.  A proposal below the threshold is journaled DEFRAG_REJECTED
   and nothing moves.
4. **Actuate**: stamp ``nos.tpu/defrag-drain`` on the window's nodes
   (the scheduler and the planner then avoid refilling them), put DRAIN
   holds on the waste ledger (the emptied GPUs are bought downtime,
   never ``frag_stranded``), and evict the victims, a rigid gang whole;
   an elastic member above its gang's min shrinks alone instead
   (``scheduler/elastic.py``).  The workload controller recreates the
   movers and the scheduler places them elsewhere.

Never touched: serving-tier pods, pods past the spare progress (a job
near its end frees its capacity soonest by finishing), members of rigid
gangs, pods moved within the cooldown, and pods whose
PodDisruptionBudget has no allowance.

Rate limits: one applied proposal in flight, at most one step per
``interval_s``, and a drain deadline after which a stuck proposal is
aborted and its annotations and holds cleared.  Disabled (the factory's
default) the proposer is never built, and every decision is the one a
build without it makes.

**The H100 translation.**  A MIG instance lies on one node, so its
window is one node (``_hosts_needed`` is 1 for every MIG profile of the
``GpuModelRegistry``); an NVLink block ``NxG`` needs an aligned window of
N nodes, its node count, which takes the multi-node branch of
``_propose``.  The
currency is the planner's sevenths of a GPU (``snapshot._gpu_sevenths``:
a MIG instance is its g compute slices, a whole GPU 7), where the JAX
package counts chips.  Sevenths keep every capacity sum a whole number,
so no verdict hangs on float rounding or on the order a node lists its
resources in; the journal gives capacities in GPUs (sevenths / 7), as
the ledger does.  The per-move overhead is the JAX package's quarter of
a chip as a quarter of a GPU (a chip is a GPU throughout the port).  A
3g.40gb weighs 3/7 of a GPU where the JAX package weighs a 2x2 half its
host, so a payback differs from JAX's on the MIG stand-in, and a window
of two free 3g.40gb does not cover a 7g.80gb where two 2x2 cover a 2x4.

Nodes under the scheduler's gang-window lease (``ANNOT_GANG_LEASE``)
are already draining toward a stuck block gang: no window takes them,
and no relocation lands on them, as in the JAX package.  Migration
drains (``C.is_migration_drain``) are never healed here.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Any, Callable

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.api.pdb import list_pdbs
from nos_tpu_torch.exporter.metrics import REGISTRY
from nos_tpu_torch.kube.client import APIServer, KIND_NODE, KIND_POD, NotFound
from nos_tpu_torch.kube.objects import PENDING, RUNNING, Pod
from nos_tpu_torch.kube.resources import pod_request
from nos_tpu_torch.obs import journal as J
from nos_tpu_torch.obs.journal import MAX_JOURNAL_NODES
from nos_tpu_torch.obs.ledger import DRAIN as LEDGER_DRAIN, get_ledger
from nos_tpu_torch.topology.known import DEFAULT_REGISTRY, GpuModelRegistry
from nos_tpu_torch.topology.profile import (
    PROFILE_RE, block_dims, block_gpus, extract_slice_requests,
    profile_from_resource,
)
from nos_tpu_torch.topology.windows import aligned_index_windows
from nos_tpu_torch.utils.pod_util import (
    elastic_replica_bounds, workload_class, workload_tier,
)
from nos_tpu_torch.utils.retry import retry_on_conflict

from .interfaces import SliceCalculator
from .snapshot import ClusterSnapshot, SnapshotError

logger = logging.getLogger(__name__)

REGISTRY.describe("nos_tpu_defrag_proposals_total",
                  "Defragmentation proposals by verdict "
                  "(proposed/applied/rejected)")
REGISTRY.describe("nos_tpu_defrag_migrated_pods_total",
                  "Pods evicted for an applied defrag proposal")
REGISTRY.describe("nos_tpu_defrag_unlocked_chips_total",
                  "Stranded free GPUs unlocked by applied proposals")

# a GPU's compute slices: the currency's unit is one of them
SEVENTHS = 7
#: Constant per-move overhead (sevenths: a quarter of a GPU) added to
#: each victim's restart cost: many tiny moves are not free even at zero
#: progress, and the payback ratio needs a finite denominator.
MOVE_OVERHEAD_SEVENTHS = 0.25 * SEVENTHS


def _profile_sevenths(profile: str) -> float:
    """A MIG instance's compute slices; an NVLink block shard every GPU
    of its block (the JAX package's ``shape.chips``)."""
    m = PROFILE_RE.match(profile)
    if m is None:
        return float(SEVENTHS * block_gpus(profile))
    return float(m.group("g"))


def _annotation_progress(pod: Pod) -> float:
    """The default restart-cost signal: the workload's ANNOT_JOB_PROGRESS
    fraction (absent or garbage: 0, nothing to lose)."""
    raw = pod.metadata.annotations.get(C.ANNOT_JOB_PROGRESS, "")
    try:
        value = float(raw)
    except ValueError:
        return 0.0
    if not math.isfinite(value):
        return 0.0
    return min(1.0, max(0.0, value))


class _Proposal:
    """One scored migration plan: empty ``hosts`` by evicting
    ``victims``.  ``shrink_uids`` marks the victims that are elastic dp
    members dying by shrink (alone, within their gang's min, nothing to
    relocate); the rest must relocate.  Capacities in sevenths."""

    __slots__ = ("proposal_id", "hosts", "victims", "unlocked",
                 "cost", "payback", "demand", "demand_class",
                 "shrink_uids")

    def __init__(self, proposal_id: str, hosts: tuple[str, ...],
                 victims: list[Pod], unlocked: float, cost: float,
                 demand: str, demand_class: str,
                 shrink_uids: frozenset[str] = frozenset()) -> None:
        self.proposal_id = proposal_id
        self.hosts = hosts
        self.victims = victims
        self.unlocked = unlocked
        self.cost = cost
        self.payback = unlocked / cost if cost > 0 else float("inf")
        self.demand = demand
        self.demand_class = demand_class
        self.shrink_uids = shrink_uids


def _gpus(sevenths: float) -> float:
    """Sevenths as GPUs, as the journal gives them."""
    return round(sevenths / SEVENTHS, 2)


class DefragProposer:
    """The rate-limited background defragmenter (module docstring), owned
    by one partitioner controller: ``step()`` runs after each plan cycle
    and limits itself to one step per ``interval_s``."""

    def __init__(self, api: APIServer, kind: str,
                 calculator: SliceCalculator, *,
                 payback_min: float = 1.5,
                 interval_s: float = 10.0,
                 drain_timeout_s: float = 120.0,
                 demand_cooldown_s: float | None = None,
                 spare_progress: float = 0.75,
                 progress_fn: Callable[[Pod], float] | None = None,
                 registry: GpuModelRegistry = DEFAULT_REGISTRY,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self._api = api
        self._kind = kind
        self._calculator = calculator
        self._payback_min = payback_min
        self._interval_s = interval_s
        self._drain_timeout_s = drain_timeout_s
        # once a proposal was applied for a demand unit, none may target
        # it until the cooldown passes: the planner gets its chance to
        # carve the freed window, and a job's churn is bounded
        self._demand_cooldown_s = (
            demand_cooldown_s if demand_cooldown_s is not None
            else max(drain_timeout_s, 3.0 * interval_s))
        self._spare_progress = spare_progress
        self._progress = progress_fn or _annotation_progress
        self._registry = registry
        self._clock = clock
        self._owner = f"defrag-{kind}"
        self._seq = 0
        # the first step is never deferred
        self._last_step = clock() - interval_s
        # proposal id -> (hosts, drain deadline): the one drain in flight
        self._active: dict[str, tuple[tuple[str, ...], float]] = {}
        # demand units seen frag-blocked on the previous step
        self._stuck_seen: frozenset[str] = frozenset()
        # demand unit -> its last applied proposal's time
        self._demand_last: dict[str, float] = {}
        # victim pod key -> eviction time: a pod moved once is untouchable
        # for a cooldown, so a job's churn is bounded
        self._moved_recent: dict[str, float] = {}
        # the newest applied proposal per demand class, which ``obs
        # waste`` joins
        self.last_applied: dict[str, dict[str, object]] = {}
        # one sweep at the first step clears the drains a predecessor
        # left (the in-memory ``_active`` does not survive a restart)
        self._healed = False

    # -- the step ------------------------------------------------------------
    def step(self, snapshot: ClusterSnapshot,
             pending: list[Pod]) -> str | None:
        """One look for a defrag opportunity; returns the applied
        proposal's id (None when nothing moved).  Never raises: a defrag
        failure must not take the plan cycle down with it."""
        try:
            return self._step(snapshot, pending)
        except SnapshotError:
            logger.warning("defrag[%s]: snapshot unusable this step",
                           self._kind, exc_info=True)
            return None
        except Exception:  # noqa: BLE001 — a background optimisation:
            # an API hiccup skips the step, never the plan cycle
            logger.warning("defrag[%s]: step failed, skipping it",
                           self._kind, exc_info=True)
            return None

    def _step(self, snapshot: ClusterSnapshot,
              pending: list[Pod]) -> str | None:
        self._heal_stray_drains()
        self._cleanup()
        now = self._clock()
        if now - self._last_step < self._interval_s:
            return None
        self._last_step = now
        if self._active:
            return None         # one drain in flight at a time
        elastic = self._elastic_headroom()
        units = self._frag_units(snapshot, pending, elastic)
        for key in [k for k, t in self._demand_last.items()
                    if now - t >= self._demand_cooldown_s]:
            del self._demand_last[key]
        for key in [k for k, t in self._moved_recent.items()
                    if now - t >= self._demand_cooldown_s]:
            del self._moved_recent[key]
        persistent = [u for u in units
                      if u[0] in self._stuck_seen
                      and u[0] not in self._demand_last]
        self._stuck_seen = frozenset(key for key, _, _ in units)
        if not persistent:
            return None
        # the hardest demand first: the largest window is the scarcest
        persistent.sort(key=lambda u: (-u[2], u[0]))
        for key, pods, hosts_needed in persistent:
            proposal = self._propose(snapshot, key, pods, hosts_needed,
                                     elastic)
            if proposal is None:
                continue
            if proposal.payback < self._payback_min:
                REGISTRY.inc("nos_tpu_defrag_proposals_total",
                             labels={"kind": self._kind,
                                     "verdict": "rejected"})
                J.record(J.DEFRAG_REJECTED, proposal.proposal_id,
                         reason="payback", demand=proposal.demand,
                         hosts=list(proposal.hosts)[:MAX_JOURNAL_NODES],
                         unlocked_chips=_gpus(proposal.unlocked),
                         cost_chips=_gpus(proposal.cost),
                         payback=round(proposal.payback, 3),
                         threshold=self._payback_min)
                continue
            if self._actuate(proposal):
                self._demand_last[key] = now
                return proposal.proposal_id
        return None

    # -- demand --------------------------------------------------------------
    def _elastic_headroom(self) -> dict[tuple[str, str], int]:
        """(namespace, gang) -> members the gang may lose before its
        declared min: the defragmenter's second lever, a window held by
        elastic members empties by shrinking them (they die alone,
        nothing to relocate)."""
        out: dict[tuple[str, str], int] = {}
        for pod in self._api.list(KIND_POD):
            gang = pod.metadata.labels.get(C.LABEL_POD_GROUP, "")
            if not gang:
                continue
            key = (pod.metadata.namespace, gang)
            if key in out:
                continue
            bounds = elastic_replica_bounds(pod)
            if bounds is None:
                continue
            members = self._api.list(
                KIND_POD, namespace=pod.metadata.namespace,
                label_selector={C.LABEL_POD_GROUP: gang},
                filter_fn=lambda p: p.status.phase in (PENDING, RUNNING))
            out[key] = max(0, len(members) - bounds[0])
        return out

    def _elastic_slack(self, elastic: dict[tuple[str, str], int]) -> float:
        """The capacity shrinking every elastic gang to its min would free,
        counted as available in the frag screen (the room a blocked class
        may take from the sponge)."""
        slack = 0.0
        for (ns, gang), headroom in elastic.items():
            if headroom <= 0:
                continue
            members = self._api.list(
                KIND_POD, namespace=ns,
                label_selector={C.LABEL_POD_GROUP: gang},
                filter_fn=lambda p: p.status.phase in (PENDING, RUNNING))
            if members:
                slack += headroom * self._shard_sevenths(members[0])
        return slack

    def _frag_units(self, snapshot: ClusterSnapshot, pending: list[Pod],
                    elastic: dict[tuple[str, str], int] | None = None
                    ) -> list[tuple[str, list[Pod], int]]:
        """Frag-blocked demand units: (key, pods, hosts needed).

        A unit qualifies when the cluster's free MIG capacity (blind to
        profiles) covers its demand and it is still unschedulable and
        not quota-blocked: capacity exists but is carved or pinned
        wrong, where only moving something helps (the planner spent its
        carve-only answer this cycle; a unit short of capacity is left
        to quota or autoscaling).  A gang's members are one unit, keyed
        by the gang."""
        free = 0.0
        for pn in snapshot.nodes().values():
            ni = pn.node_info()
            free += self._node_slice_free(
                ni, self._node_cap(ni.node.metadata.labels))
        if elastic:
            free += self._elastic_slack(elastic)
        units: dict[str, list[Pod]] = {}
        for pod in pending:
            cls = pod.metadata.labels.get(C.LABEL_UNSCHEDULABLE_CLASS, "")
            if cls.startswith("quota"):
                continue
            if not self._calculator.requested_profiles(pod):
                continue
            gang = pod.metadata.labels.get(C.LABEL_POD_GROUP, "")
            if gang and elastic is not None \
                    and (pod.metadata.namespace, gang) in elastic:
                # an elastic gang's own pending (grow) member is the
                # sponge, not demand worth moving anything for
                continue
            key = f"{pod.metadata.namespace}/{gang}" if gang else pod.key
            units.setdefault(key, []).append(pod)
        out: list[tuple[str, list[Pod], int]] = []
        for key, pods in sorted(units.items()):
            demand = sum(self._shard_sevenths(p) for p in pods)
            if demand <= 0 or demand > free:
                continue        # short of capacity: not a frag problem
            hosts_needed = self._hosts_needed(snapshot, pods)
            if hosts_needed > 0:
                out.append((key, pods, hosts_needed))
        return out

    @staticmethod
    def _node_slice_free(ni: Any, cap: float) -> float:
        """Free MIG capacity on one node, in sevenths; the whole-GPU
        resource the node also advertises is not counted, or it would
        count its capacity twice."""
        total = 0.0
        for res, qty in ni.free().items():
            if qty <= 0:
                continue
            profile = profile_from_resource(res)
            if profile is not None:
                total += min(_profile_sevenths(profile), cap) * qty
        return total

    @staticmethod
    def _shard_sevenths(pod: Pod) -> float:
        """The pod's demand in sevenths: a MIG instance its compute
        slices (it lies on one GPU), a block member one node's shard,
        its G GPUs (the JAX package caps a slice at the host's chips)."""
        total = 0.0
        for p, q in extract_slice_requests(pod_request(pod)).items():
            dims = block_dims(p)
            if dims is not None:
                total += float(SEVENTHS * dims[1]) * q
            else:
                total += min(_profile_sevenths(p), float(SEVENTHS)) * q
        return total

    def _hosts_needed(self, snapshot: ClusterSnapshot,
                      pods: list[Pod]) -> int:
        """The window size (nodes) the unit's largest profile spans on
        the snapshot's GPU models: 1 for MIG profiles, N for a block
        "NxG" the model offers; 0 when no model present carves them all
        (migration cannot invent a geometry)."""
        profiles: set[str] = set()
        for pod in pods:
            profiles.update(extract_slice_requests(pod_request(pod)))
        if not profiles:
            return 0
        best = 0
        for node in snapshot.nodes().values():
            labels = node.node_info().node.metadata.labels
            model = self._registry.models.get(
                labels.get(C.LABEL_ACCELERATOR, ""))
            if model is None:
                continue
            if any(model.profile(p) is None and not model.offers_block(p)
                   for p in profiles):
                continue        # a profile this model does not carve
            needed = max(max(model.hosts_for(p) for p in profiles), 1)
            best = needed if best == 0 else min(best, needed)
        return best

    # -- proposal ------------------------------------------------------------
    def _propose(self, snapshot: ClusterSnapshot, demand: str,
                 demand_pods: list[Pod], hosts_needed: int,
                 elastic: dict[tuple[str, str], int] | None = None
                 ) -> _Proposal | None:
        """The best candidate window for the demand unit, by payback.
        Elastic members on the window shrink (alone, up to their gang's
        headroom); every other pod must relocate, proved on a fork of a
        snapshot subset."""
        elastic = elastic or {}
        nodes = snapshot.nodes()
        by_pool: dict[str, dict[int, str]] = {}
        immovable: set[str] = set()
        cost: dict[str, float] = {}
        stranded: dict[str, float] = {}
        victims: dict[str, list[Pod]] = {}
        for name, pn in nodes.items():
            ni = pn.node_info()
            labels = ni.node.metadata.labels
            annots = ni.node.metadata.annotations
            if annots.get(C.ANNOT_GANG_LEASE) \
                    or annots.get(C.ANNOT_DEFRAG_DRAIN):
                immovable.add(name)     # already draining toward something
            pool = labels.get(C.LABEL_NVLINK_DOMAIN, "")
            try:
                idx = int(labels.get(C.LABEL_HOST_INDEX, "0"))
            except ValueError:
                continue
            by_pool.setdefault(pool, {})[idx] = name
            cap = self._node_cap(labels)
            node_cost = 0.0
            node_victims: list[Pod] = []
            for pod in ni.pods:
                move = self._move_cost(pod, cap)
                if move is None:
                    immovable.add(name)
                    break
                node_cost += move
                node_victims.append(pod)
            cost[name] = node_cost
            victims[name] = node_victims
            stranded[name] = self._node_slice_free(ni, cap)
        best: _Proposal | None = None
        for pool in sorted(by_pool):
            hosts = by_pool[pool]
            if not pool and hosts_needed > 1:
                continue        # unlabelled nodes form no aligned windows
            windows = (aligned_index_windows(hosts, hosts_needed)
                       if hosts_needed > 1
                       else [[i] for i in sorted(hosts)])
            candidates: list[tuple[float, tuple[str, ...]]] = []
            for window in windows:
                names = tuple(hosts[i] for i in window)
                if any(n in immovable for n in names):
                    continue
                if sum(len(victims[n]) for n in names) == 0:
                    continue    # already whole: nothing to unlock here
                candidates.append((sum(cost[n] for n in names), names))
            # the cheapest feasible window wins within the pool
            for window_cost, names in sorted(candidates):
                window_victims = [p for n in names for p in victims[n]]
                split = self._split_shrink(window_victims, elastic)
                if split is None:
                    continue
                shrink_uids, movers = split
                if not self._relocatable(snapshot, names, movers):
                    continue
                unlocked = sum(stranded[n] for n in names) + sum(
                    self._shard_sevenths(p) for p in window_victims
                    if p.metadata.uid in shrink_uids)
                self._seq += 1
                proposal = _Proposal(
                    f"dfrg-{self._kind}-{self._seq}", names,
                    window_victims, unlocked, window_cost, demand,
                    self._demand_class(demand_pods),
                    shrink_uids=shrink_uids)
                REGISTRY.inc("nos_tpu_defrag_proposals_total",
                             labels={"kind": self._kind,
                                     "verdict": "proposed"})
                J.record(J.DEFRAG_PROPOSED, proposal.proposal_id,
                         demand=demand, hosts=list(names)[:MAX_JOURNAL_NODES],
                         victims=[p.key for p in
                                  window_victims[:MAX_JOURNAL_NODES]],
                         victim_count=len(window_victims),
                         unlocked_chips=_gpus(unlocked),
                         cost_chips=_gpus(window_cost),
                         payback=round(proposal.payback, 3),
                         demand_class=proposal.demand_class)
                if best is None or proposal.payback > best.payback:
                    best = proposal
                break           # one scored proposal per pool per step
        return best

    def _split_shrink(self, window_victims: list[Pod],
                      elastic: dict[tuple[str, str], int]
                      ) -> tuple[frozenset[str], list[Pod]] | None:
        """Split the window's victims: elastic members shrink (up to
        their gang's headroom, nothing to relocate), the rest relocate.
        None when the window holds an elastic member its gang cannot
        spare: shrinking below min breaks the contract, and the replica
        count is the gang's own controller's, not the defragmenter's to
        relocate."""
        shrink: set[str] = set()
        movers: list[Pod] = []
        budget = dict(elastic)
        for pod in sorted(window_victims, key=lambda p: p.key):
            gang = pod.metadata.labels.get(C.LABEL_POD_GROUP, "")
            key = (pod.metadata.namespace, gang)
            if gang and key in elastic:
                if budget.get(key, 0) <= 0:
                    return None
                budget[key] -= 1
                shrink.add(pod.metadata.uid)
            else:
                movers.append(pod)
        return frozenset(shrink), movers

    def _move_cost(self, pod: Pod, cap: float) -> float | None:
        """The restart cost (sevenths of progress earned again, plus the
        overhead) of moving ``pod``, or None when it is untouchable: the
        serving tier (shielded from every batch-side optimisation), past
        the spare progress (it frees its capacity soonest by finishing),
        a member of a rigid gang (placing a gang again needs the whole
        gang placed together, which this first-fit what-if cannot prove,
        so evicting one risks the whole gang; elastic members take the
        shrink path instead), or moved within the cooldown."""
        if workload_tier(pod) == C.TIER_SERVING:
            return None
        if pod.metadata.labels.get(C.LABEL_POD_GROUP, "") \
                and elastic_replica_bounds(pod) is None:
            return None         # rigid gang: never moved piecemeal
        if pod.key in self._moved_recent:
            return None         # the churn bound: one move per cooldown
        progress = self._progress(pod)
        if progress >= self._spare_progress:
            return None
        held = sum(min(_profile_sevenths(p), cap) * q
                   for p, q in extract_slice_requests(
                       pod_request(pod)).items())
        return progress * held + MOVE_OVERHEAD_SEVENTHS

    @staticmethod
    def _node_cap(labels: dict[str, str]) -> float:
        """A node's capacity in sevenths: its GPU count label's GPUs."""
        try:
            return float(labels.get(C.LABEL_GPU_COUNT, "0") or 0.0) \
                * SEVENTHS
        except ValueError:
            return 0.0

    @staticmethod
    def _demand_class(pods: list[Pod]) -> str:
        return workload_class(pods[0]) if pods else ""

    def _relocatable(self, snapshot: ClusterSnapshot,
                     window: tuple[str, ...],
                     window_victims: list[Pod]) -> bool:
        """Would every victim fit somewhere outside the window?  Proved
        on a fork of the snapshot's subset, so each placement sees the
        ones before; reverted on every path: the what-if commits nothing
        (the proposal acts through evictions)."""
        if not window_victims:
            return True         # a window emptied by shrinks alone
        others = [n for n in snapshot.nodes() if n not in window]
        if not others:
            return False
        sub = snapshot.subset(others)
        sub.fork()
        try:
            ordered = sorted(
                window_victims,
                key=lambda p: (-self._shard_sevenths(p), p.key))
            return all(self._place_one(sub, pod) for pod in ordered)
        finally:
            sub.revert()

    def _place_one(self, sub: ClusterSnapshot, pod: Pod) -> bool:
        profiles = self._calculator.requested_profiles(pod)
        for cand in sub.get_candidate_nodes():
            annots = cand.node_info().node.metadata.annotations
            if annots.get(C.ANNOT_GANG_LEASE) \
                    or annots.get(C.ANNOT_DEFRAG_DRAIN):
                continue        # never refill a draining window
            node = sub.get_node_for_write(cand.name)
            if node.add_pod(pod):
                return True
            if node.update_geometry_for(dict(profiles)) \
                    and node.add_pod(pod):
                return True
        return False

    # -- actuation -----------------------------------------------------------
    def _actuate(self, proposal: _Proposal) -> bool:
        """Stamp the drain (annotations and ledger holds), then evict the
        victims, a rigid gang whole, an elastic member alone.  The PDB
        allowance is checked against the live budgets at this moment; a
        refusal journals DEFRAG_REJECTED.  Returns whether the proposal
        was applied."""
        from nos_tpu_torch.scheduler.elastic import record_shrink
        from nos_tpu_torch.scheduler.gang import evict_gang, gang_name

        if not self._pdb_allows(proposal.victims):
            REGISTRY.inc("nos_tpu_defrag_proposals_total",
                         labels={"kind": self._kind, "verdict": "rejected"})
            J.record(J.DEFRAG_REJECTED, proposal.proposal_id, reason="pdb",
                     demand=proposal.demand,
                     hosts=list(proposal.hosts)[:MAX_JOURNAL_NODES])
            return False
        ledger = get_ledger()
        for host in proposal.hosts:
            self._stamp_drain(host, proposal.proposal_id)
            ledger.set_hold(host, LEDGER_DRAIN, owner=self._owner,
                            proposal=proposal.proposal_id,
                            demand=proposal.demand)
        evicted = 0
        evicted_gangs: set[tuple[str, str]] = set()
        shrunk: dict[tuple[str, str], int] = {}
        for pod in proposal.victims:
            gang = gang_name(pod)
            if pod.metadata.uid in proposal.shrink_uids and gang:
                # an elastic shrink: the member dies alone, within its
                # gang's declared min
                try:
                    self._api.delete(KIND_POD, pod.metadata.name,
                                     pod.metadata.namespace)
                except NotFound:
                    continue
                gkey = (pod.metadata.namespace, gang)
                shrunk[gkey] = shrunk.get(gkey, 0) + 1
                evicted += 1
                continue
            if gang:
                gkey = (pod.metadata.namespace, gang)
                if gkey in evicted_gangs:
                    continue
                evicted_gangs.add(gkey)
            evicted += len(evict_gang(self._api, pod))
        now = self._clock()
        for pod in proposal.victims:
            if pod.metadata.uid not in proposal.shrink_uids:
                self._moved_recent[pod.key] = now
        for (ns, gang), n in sorted(shrunk.items()):
            record_shrink(self._api, ns, gang, n,
                          proposal=proposal.proposal_id)
        self._active[proposal.proposal_id] = (
            proposal.hosts, self._clock() + self._drain_timeout_s)
        REGISTRY.inc("nos_tpu_defrag_proposals_total",
                     labels={"kind": self._kind, "verdict": "applied"})
        REGISTRY.inc("nos_tpu_defrag_migrated_pods_total", float(evicted),
                     labels={"kind": self._kind})
        REGISTRY.inc("nos_tpu_defrag_unlocked_chips_total",
                     proposal.unlocked / SEVENTHS,
                     labels={"kind": self._kind})
        self.last_applied[proposal.demand_class or ""] = {
            "proposal": proposal.proposal_id, "demand": proposal.demand,
            "hosts": list(proposal.hosts)[:MAX_JOURNAL_NODES],
            "unlocked_chips": _gpus(proposal.unlocked),
            "migrated_pods": evicted,
        }
        J.record(J.DEFRAG_APPLIED, proposal.proposal_id,
                 demand=proposal.demand, demand_class=proposal.demand_class,
                 hosts=list(proposal.hosts)[:MAX_JOURNAL_NODES],
                 victims=[p.key for p in
                          proposal.victims[:MAX_JOURNAL_NODES]],
                 victim_count=len(proposal.victims), migrated=evicted,
                 shrunk=sum(shrunk.values()),
                 moved=[p.key for p in proposal.victims
                        if p.metadata.uid not in
                        proposal.shrink_uids][:MAX_JOURNAL_NODES],
                 unlocked_chips=_gpus(proposal.unlocked),
                 cost_chips=_gpus(proposal.cost),
                 payback=round(proposal.payback, 3))
        logger.info(
            "defrag[%s]: applied %s, emptied %s (%d victim(s), %.2f GPUs "
            "unlocked, payback %.2f) for %s",
            self._kind, proposal.proposal_id, sorted(proposal.hosts),
            evicted, proposal.unlocked / SEVENTHS, proposal.payback,
            proposal.demand)
        return True

    def _pdb_allows(self, victims: list[Pod]) -> bool:
        pdbs = list_pdbs(self._api)
        if not pdbs:
            return True
        needed: dict[int, int] = {}
        for pod in victims:
            if pod.status.phase != RUNNING:
                continue
            for i, pdb in enumerate(pdbs):
                if pdb.matches(pod):
                    needed[i] = needed.get(i, 0) + 1
        return all(pdbs[i].status.disruptions_allowed >= n
                   for i, n in needed.items())

    def _stamp_drain(self, host: str, proposal_id: str) -> None:
        def mutate(node: Any) -> None:
            node.metadata.annotations[C.ANNOT_DEFRAG_DRAIN] = proposal_id

        try:
            retry_on_conflict(self._api, KIND_NODE, host, mutate,
                              component=self._owner)
        except Exception:  # noqa: BLE001 — advisory: a half-stamped drain
            # only weakens refill avoidance, and _cleanup clears it
            logger.debug("defrag drain stamp failed for %s", host)

    def _clear_drain(self, host: str, owned_value: str) -> None:
        """Clear the drain only while it still holds ``owned_value``: a
        migration drain (``failure.py``) that replaced our stamp on a node
        that started dying mid-proposal must survive our cleanup."""
        def mutate(node: Any) -> None:
            if node.metadata.annotations.get(
                    C.ANNOT_DEFRAG_DRAIN) == owned_value:
                node.metadata.annotations.pop(C.ANNOT_DEFRAG_DRAIN, None)

        try:
            retry_on_conflict(self._api, KIND_NODE, host, mutate,
                              component=self._owner)
        except NotFound:
            pass                # the node left the cluster
        except Exception:  # noqa: BLE001 — retried on the next sweep
            logger.debug("defrag drain clear failed for %s", host)

    def _heal_stray_drains(self) -> None:
        """At the first step, clear every defrag drain no proposal of this
        proposer owns: a predecessor that died mid-drain must not push
        those nodes last forever.  A migration drain is the recovery
        plane's and is left alone."""
        if self._healed:
            return
        self._healed = True
        owned = set(self._active)
        for node in self._api.list(KIND_NODE):
            if C.is_migration_drain(node.metadata.annotations):
                continue
            value = node.metadata.annotations.get(C.ANNOT_DEFRAG_DRAIN)
            if value and value not in owned:
                logger.info("defrag[%s]: healing stray drain %s on %s",
                            self._kind, value, node.metadata.name)
                self._clear_drain(node.metadata.name, value)
                get_ledger().clear_hold(node.metadata.name, LEDGER_DRAIN,
                                        owner=self._owner)

    def _cleanup(self) -> None:
        """Resolve the drains in flight: a window whose nodes emptied is
        released (annotations and holds cleared: its GPUs are the
        planner's to carve); one stuck past its deadline is aborted and
        journaled, so a wedged eviction never pins the drain."""
        if not self._active:
            return
        now = self._clock()
        ledger = get_ledger()
        live_by_host: dict[str, int] = {}
        for pod in self._api.list(KIND_POD):
            if pod.spec.node_name and pod.status.phase in (PENDING,
                                                           RUNNING):
                live_by_host[pod.spec.node_name] = \
                    live_by_host.get(pod.spec.node_name, 0) + 1
        for pid, (hosts, deadline) in list(self._active.items()):
            drained = all(live_by_host.get(h, 0) == 0 for h in hosts)
            if not drained and now < deadline:
                continue
            for host in hosts:
                self._clear_drain(host, pid)
                ledger.clear_hold(host, LEDGER_DRAIN, owner=self._owner)
            del self._active[pid]
            if not drained:
                REGISTRY.inc("nos_tpu_defrag_proposals_total",
                             labels={"kind": self._kind,
                                     "verdict": "rejected"})
                J.record(J.DEFRAG_REJECTED, pid, reason="drain-timeout",
                         hosts=list(hosts)[:MAX_JOURNAL_NODES])
