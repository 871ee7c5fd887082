"""Node-loss recovery: failure detection, warm spares, drain-then-migrate,
``nos_tpu/partitioning/core/failure.py`` for the port.

The quarantine (``quarantine.py``) reacts to a node that failed a plan
handshake or an actuation, after the fact and only for the planner's own
traffic.  This module gets the displaced workload back onto GPUs, with
three mechanisms driven from the partitioner controller's poll:

- **Missed-heartbeat suspicion** (``suspect_after_s``): the node agents
  stamp a counter (``agent-heartbeat.<family>``) on every report; a node
  whose counter has not moved for longer than the threshold is
  quarantined as suspect (``REASON_SUSPECT``), left out of snapshots as
  any quarantined node is, and released as soon as the counter moves
  again.  Freshness is judged by the value changing, on the detector's
  own clock, never by comparing clocks.
- **Warm spares** (``spare_hosts_per_pool``): nodes labelled
  ``spare: "warm"`` take no pod (the scheduler's SpareGuard) and join no
  plan (the controller leaves them out of its snapshot).  When an
  active node vanishes, a spare of its NVLink domain is promoted: one
  patch takes the spare label off and the vanished node's host index
  on, so the domain's indices are whole again.  A MIG spare is carved
  already (the initializer carves a virgin node), so its rebind needs
  no plan; an MPS spare is carved by the first plan that sees it.
- **Drain-then-migrate** (``migrate_grace_s``): for a predicted failure
  (a suspect node, or one an operator stamped ``maintenance``) the
  residents are moved instead of lost: the node gets the migration drain
  (the scheduler stops filling it), every resident gets ``migrate`` (a
  checkpointing workload exits at its next checkpoint) and a
  JOB_DISPLACED record, and residents still there after the grace are
  evicted, whole gangs at a time (a gang cannot run in part).  The
  workload's controller recreates them with the ``displaced`` stamp, and
  the scheduler's displaced tier binds them ahead of the batch backlog.

Off means off: with ``spare_hosts_per_pool=0`` and ``suspect_after_s=0``
the factories build no policy, and a policy with nothing to do writes
nothing.  A migrating node's free GPUs are held as ``drain`` in the
chip-second ledger (``obs/ledger.py``) from its drain stamp until the
migration ends.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Mapping

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.exporter.metrics import REGISTRY
from nos_tpu_torch.kube.client import APIServer, KIND_NODE, KIND_POD, NotFound
from nos_tpu_torch.kube.objects import Node, PENDING, Pod, RUNNING
from nos_tpu_torch.obs import journal as J
from nos_tpu_torch.obs.journal import MAX_JOURNAL_NODES, record as journal_record
from nos_tpu_torch.obs.ledger import DRAIN as LEDGER_DRAIN, get_ledger
from nos_tpu_torch.utils.guards import guarded_by
from nos_tpu_torch.utils.retry import retry_on_conflict

from .quarantine import QuarantineList, REASON_SUSPECT

logger = logging.getLogger(__name__)

REGISTRY.describe("nos_tpu_node_suspect_total",
                  "Nodes quarantined on missed agent heartbeats")
REGISTRY.describe("nos_tpu_spare_hosts",
                  "Warm spare hosts currently held per topology pool")
REGISTRY.describe("nos_tpu_spare_promotions_total",
                  "Warm spares promoted into a vanished host's index")
REGISTRY.describe("nos_tpu_drain_migrations_total",
                  "Resident pods evicted by drain-then-migrate after "
                  "the checkpoint grace")


def is_warm_spare(node: Node) -> bool:
    return C.is_warm_spare_labels(node.metadata.labels)


def _pool_of(node: Node) -> str:
    return node.metadata.labels.get(C.LABEL_NVLINK_DOMAIN, "") or "-"


def host_index_vacancies(live: Mapping[int, str],
                         expected_count: int) -> list[int]:
    """The host indices missing from ``live`` under the contiguous-from-0
    convention, judged against ``expected_count`` nodes.  The spare
    policy seeds its first baseline with ``max(live)`` (interior gaps
    only: all one view can prove)."""
    return [idx for idx in range(expected_count) if idx not in live]


def healthy_spares_by_pool(
        nodes: Mapping[str, Node],
        is_quarantined: Callable[[str], bool] | None = None,
) -> dict[str, list[str]]:
    """pool -> sorted names of the warm spares that may be promoted: not
    quarantined (a spare whose own agent froze would take the vacancy
    while the domain stays broken) and not marked for maintenance."""
    out: dict[str, list[str]] = {}
    for name, node in nodes.items():
        if not is_warm_spare(node):
            continue
        if is_quarantined is not None and is_quarantined(name):
            continue
        if node.metadata.annotations.get(C.ANNOT_MAINTENANCE, ""):
            continue
        out.setdefault(_pool_of(node), []).append(name)
    for names in out.values():
        names.sort()
    return out


def promote_spare(api: APIServer, spare: str, pool: str, idx: int, *,
                  kind: str = "", dead: str = "",
                  cross_pool: bool = False) -> bool:
    """One label patch turns a warm spare into a vacancy's replacement:
    the spare label off, the vacated host index on and, for a cross-pool
    borrow (the capacity plane's stockout degradation,
    ``capacity/provisioner.py``), the target NVLink domain too, in the
    same patch.  Its geometry is carved and reported already, so a
    displaced workload rebinds on the scheduler's next snapshot.  False
    (the caller's next poll retries) when the spare vanished or the patch
    failed."""
    def mutate(n: Node) -> None:
        n.metadata.labels.pop(C.LABEL_SPARE, None)
        n.metadata.labels[C.LABEL_HOST_INDEX] = str(idx)
        if cross_pool:
            n.metadata.labels[C.LABEL_NVLINK_DOMAIN] = pool

    try:
        retry_on_conflict(api, KIND_NODE, spare, mutate,
                          component="spare-promotion")
    except NotFound:
        return False
    except Exception:  # noqa: BLE001 — advisory: the next poll retries
        logger.warning("spare promotion patch failed for %s "
                       "(kind=%s pool=%s)", spare, kind, pool)
        return False
    REGISTRY.inc("nos_tpu_spare_promotions_total", labels={"pool": pool})
    journal_record(J.SPARE_BORROWED if cross_pool else J.SPARE_PROMOTED,
                   spare, kind=kind, pool=pool, host_index=idx, replaced=dead)
    logger.info("spare promotion[%s]: %s into %s index %d (replacing %s%s)",
                kind, spare, pool, idx, dead,
                ", cross-pool borrow" if cross_pool else "")
    return True


@guarded_by("_lock", "_hb", "_expected", "_migrations", "_stray_hb",
            "_evicted")
class SelfHealingPolicy:
    """The recovery plane of one partitioning kind, stepped from its
    PartitionerController's poll.  Every API write goes through
    retry_on_conflict and is advisory: a failed patch retries on the
    next poll and never aborts the plan cycle."""

    def __init__(self, api: APIServer, kind: str,
                 quarantine: QuarantineList,
                 spare_hosts_per_pool: int = 0,
                 suspect_after_s: float = 0.0,
                 migrate_grace_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self._api = api
        self._kind = kind
        self._quarantine = quarantine
        self._spares_per_pool = spare_hosts_per_pool
        self._suspect_after_s = suspect_after_s
        self._migrate_grace_s = migrate_grace_s
        self._clock = clock
        self._lock = threading.Lock()
        # node -> (last heartbeat value, when it last changed)
        self._hb: dict[str, tuple[str, float]] = {}
        # pool -> {host index: node} of the active (non-spare) members at
        # the previous step: the vacancy baseline
        self._expected: dict[str, dict[int, str]] = {}
        # node -> (cause, drain stamped at): migrations in flight
        self._migrations: dict[str, tuple[str, float]] = {}
        # node -> heartbeat value when a predecessor's suspect-cause
        # drain was first seen: the hold pending a verdict
        self._stray_hb: dict[str, str] = {}
        # node -> pod keys the straggler pass evicted off it already
        self._evicted: dict[str, set[str]] = {}
        # pools warned short of spares, vacancies warned unfillable
        # (warned again on a transition only: the policy runs every poll)
        self._short_warned: set[str] = set()
        self._vacancy_warned: set[tuple[str, int]] = set()

    def _my_kind(self, node: Node) -> bool:
        return node.metadata.labels.get(C.LABEL_PARTITIONING, "") in (
            self._kind, C.HYBRID_KIND)

    # -- the poll's entry point ---------------------------------------------
    def step(self, nodes: Mapping[str, Node]) -> None:
        """One recovery pass over the cluster's nodes: feed the detector,
        promote spares into vacancies, advance migrations.  Never raises:
        recovery must not take the plan loop down."""
        try:
            mine = {name: node for name, node in nodes.items()
                    if self._my_kind(node)}
            if self._suspect_after_s > 0.0:
                self._detect_failures(mine)
            if self._spares_per_pool > 0:
                self._reconcile_spares(mine)
            self._advance_migrations(mine)
        except Exception:  # noqa: BLE001 — the plan loop comes first
            logger.exception("self-healing[%s]: step failed", self._kind)

    # -- failure detector ----------------------------------------------------
    def _detect_failures(self, nodes: Mapping[str, Node]) -> None:
        now = self._clock()
        with self._lock:
            for name in [n for n in self._hb if n not in nodes]:
                del self._hb[name]
        hb_key = C.heartbeat_annotation(self._kind)
        for name, node in nodes.items():
            value = node.metadata.annotations.get(hb_key, "")
            if not value:
                continue    # an agent that never beat gives no signal
            with self._lock:
                entry = self._hb.get(name)
                if entry is None or entry[0] != value:
                    self._hb[name] = (value, now)
                    fresh = True
                else:
                    fresh = now - entry[1] < self._suspect_after_s
            if fresh:
                # a suspect whose heartbeat moved is healthy; the
                # controller's sweep leaves REASON_SUSPECT to us
                if self._quarantine.reason(name) == REASON_SUSPECT:
                    self._quarantine.unquarantine(name)
            elif not self._quarantine.is_quarantined(name):
                if self._quarantine.quarantine(name, REASON_SUSPECT):
                    REGISTRY.inc("nos_tpu_node_suspect_total",
                                 labels={"kind": self._kind})

    # -- warm spares ---------------------------------------------------------
    def _owns_promotion(self, node: Node) -> bool:
        """One family reconciles a node's spares: a hybrid node is seen
        by both families' policies, and two promotions could put two
        spares on one vacated index.  The MIG family owns hybrid pools,
        as the JAX package's slice family does."""
        kind = node.metadata.labels.get(C.LABEL_PARTITIONING, "")
        return kind == self._kind or (kind == C.HYBRID_KIND
                                      and self._kind == C.MIG_KIND)

    def _reconcile_spares(self, nodes: Mapping[str, Node]) -> None:
        active: dict[str, dict[int, str]] = {}
        owned = {name: node for name, node in nodes.items()
                 if self._owns_promotion(node)}
        # only healthy spares count as inventory and may be promoted
        spares_by_pool = healthy_spares_by_pool(
            owned, self._quarantine.is_quarantined)
        for name, node in owned.items():
            if is_warm_spare(node):
                continue
            try:
                idx = int(node.metadata.labels.get(
                    C.LABEL_HOST_INDEX, ""))
            except ValueError:
                continue
            active.setdefault(_pool_of(node), {})[idx] = name
        with self._lock:
            expected = {pool: dict(table)
                        for pool, table in self._expected.items()}
        # a pool seen for the first time (a fresh process) has no
        # baseline, so a node lost before the first poll leaves no
        # vacancy; indices run contiguously from 0, so an interior gap
        # is one.  A lost highest index reads as a smaller pool from
        # one view alone.
        for pool, live in active.items():
            if pool in expected or not live:
                continue
            gaps = {idx: "(lost-before-restart)"
                    for idx in host_index_vacancies(live, max(live))}
            if gaps:
                expected[pool] = {**live, **gaps}
        promoted: dict[str, dict[int, str]] = {}
        # vacancies not filled this poll ride forward in the baseline, or
        # a failed patch would erase the vacancy for good
        unfilled: dict[str, dict[int, str]] = {}
        for pool, table in expected.items():
            live = active.get(pool, {})
            for idx, dead in sorted(table.items()):
                if idx in live or dead in nodes:
                    self._vacancy_warned.discard((pool, idx))
                    continue        # still there (maybe quarantined)
                candidates = sorted(spares_by_pool.get(pool, []))
                if not candidates:
                    unfilled.setdefault(pool, {})[idx] = dead
                    if (pool, idx) not in self._vacancy_warned:
                        self._vacancy_warned.add((pool, idx))
                        logger.warning(
                            "self-healing[%s]: pool %s lost host %s "
                            "(index %d) with no warm spare left",
                            self._kind, pool, dead, idx)
                    continue
                spare = candidates[0]
                if promote_spare(self._api, spare, pool, idx,
                                 kind=self._kind, dead=dead):
                    spares_by_pool[pool].remove(spare)
                    promoted.setdefault(pool, {})[idx] = spare
                    self._vacancy_warned.discard((pool, idx))
                else:
                    unfilled.setdefault(pool, {})[idx] = dead
        # the next baseline: the active members now, what was just
        # promoted (its patch may not be in this poll's view yet, and one
        # vacancy must not take two spares) and the vacancies still open
        for pool, table in promoted.items():
            active.setdefault(pool, {}).update(table)
        for pool, table in unfilled.items():
            pool_table = active.setdefault(pool, {})
            for idx, dead in table.items():
                pool_table.setdefault(idx, dead)
        with self._lock:
            self._expected = active
        for pool in set(spares_by_pool) | set(active):
            held = len(spares_by_pool.get(pool, []))
            REGISTRY.set("nos_tpu_spare_hosts", float(held),
                         labels={"pool": pool})
            if held >= self._spares_per_pool:
                self._short_warned.discard(pool)
            elif pool not in self._short_warned:
                self._short_warned.add(pool)
                logger.warning(
                    "self-healing[%s]: pool %s holds %d/%d warm "
                    "spares — provision more",
                    self._kind, pool, held, self._spares_per_pool)

    # -- drain-then-migrate --------------------------------------------------
    def _migration_targets(self, nodes: Mapping[str, Node]
                           ) -> dict[str, str]:
        """node -> cause for every node to drain: heartbeat suspects and
        nodes an operator marked for maintenance."""
        targets: dict[str, str] = {}
        for name, node in nodes.items():
            if is_warm_spare(node):
                continue
            if node.metadata.annotations.get(C.ANNOT_MAINTENANCE, ""):
                targets[name] = "maintenance"
            elif self._quarantine.reason(name) == REASON_SUSPECT:
                targets[name] = "node-suspect"
        return targets

    def _advance_migrations(self, nodes: Mapping[str, Node]) -> None:
        targets = self._migration_targets(nodes)
        now = self._clock()
        with self._lock:
            current = dict(self._migrations)
        # migrations that finished, recovered or vanished end first
        for name in current:
            if name not in targets:
                self._end_migration(name, nodes.get(name))
        # then a dead predecessor's strays: drains of our kind this
        # policy does not track and no longer wants are retracted; those
        # still targeted are adopted by _begin_migration below.  A
        # suspect-cause stray is held until the detector can judge it.
        with self._lock:
            for name in [n for n in self._stray_hb
                         if n not in nodes or n in targets]:
                del self._stray_hb[name]
        for name, node in nodes.items():
            if C.migration_drain_owner(
                    node.metadata.annotations) != self._kind:
                continue
            if name in current or name in targets:
                continue
            if self._stray_verdict_pending(name, node):
                continue
            with self._lock:
                self._stray_hb.pop(name, None)
            self._end_migration(name, node)
        for name, cause in targets.items():
            entry = current.get(name)
            if entry is None:
                self._begin_migration(name, cause, now)
            elif now - entry[1] >= self._migrate_grace_s:
                self._evict_stragglers(name, cause)

    def _stray_verdict_pending(self, name: str, node: Node) -> bool:
        """True while a predecessor's suspect drain must be held: the
        heartbeat has not moved since the stray was first seen and the
        detector could still suspect the node.  It resolves when the
        heartbeat moves (alive: retracted) or stays frozen past
        suspect_after_s (suspected again: adopted)."""
        if self._suspect_after_s <= 0.0:
            return False    # no detector: nothing will target it again
        if node.metadata.annotations.get(C.ANNOT_DEFRAG_DRAIN, "") != \
                C.migration_drain_value(self._kind, "node-suspect"):
            return False    # another cause targets at once
        hb = node.metadata.annotations.get(
            C.heartbeat_annotation(self._kind), "")
        if not hb:
            return False    # no signal: the detector can never judge
        with self._lock:
            seen = self._stray_hb.get(name)
            if seen is None:
                self._stray_hb[name] = hb
                return True
        return seen == hb

    def _begin_migration(self, node: str, cause: str,
                         now: float) -> None:
        """Stamp the drain (the scheduler stops filling the node) and ask
        every resident to checkpoint and exit (``migrate`` and a
        JOB_DISPLACED record).  One family owns a node's migration: if
        the other family's plane drains the node already, ours defers,
        judged inside the retried mutate so two concurrent detectors
        cannot both see no owner.  Running again for a drain we own
        (adopting a stray) skips the residents stamped already, so a
        restart journals no second displacement."""
        stamped = [False]

        def mutate(n: Node) -> None:
            owner = C.migration_drain_owner(n.metadata.annotations)
            if owner and owner != self._kind:
                stamped[0] = False      # the other family's: defer
                return
            n.metadata.annotations[C.ANNOT_DEFRAG_DRAIN] = \
                C.migration_drain_value(self._kind, cause)
            stamped[0] = True

        try:
            retry_on_conflict(self._api, KIND_NODE, node, mutate,
                              component="drain-migrate")
        except NotFound:
            return
        except Exception:  # noqa: BLE001 — the next poll retries
            logger.warning("drain-migrate[%s]: drain stamp failed "
                           "for %s", self._kind, node)
            return
        if not stamped[0]:
            return
        get_ledger().set_hold(node, LEDGER_DRAIN,
                              owner=f"{self._kind}-migrate", cause=cause)
        with self._lock:
            self._migrations[node] = (cause, now)
        subjects: set[str] = set()
        fresh = 0
        for pod in self._residents(node):
            if pod.metadata.annotations.get(C.ANNOT_MIGRATE, ""):
                continue    # asked already (adoption)
            self._stamp_migrate(pod, cause)
            fresh += 1
            gang = pod.metadata.labels.get(C.LABEL_POD_GROUP, "")
            subjects.add(f"{pod.metadata.namespace}/{gang}" if gang
                         else pod.key)
        for subject in sorted(subjects)[:MAX_JOURNAL_NODES]:
            journal_record(J.JOB_DISPLACED, subject, cause=cause,
                           node=node, kind=self._kind)
        if fresh:
            logger.info(
                "drain-migrate[%s]: draining %s (%s): %d resident "
                "pod(s) asked to checkpoint and exit",
                self._kind, node, cause, fresh)

    def _stamp_migrate(self, pod: Pod, cause: str) -> None:
        def mutate(p: Pod) -> None:
            p.metadata.annotations[C.ANNOT_MIGRATE] = cause

        try:
            retry_on_conflict(self._api, KIND_POD, pod.metadata.name,
                              mutate, pod.metadata.namespace,
                              component="drain-migrate")
        except NotFound:
            pass
        except Exception:  # noqa: BLE001 — the eviction after the grace
            # still fires; the pod only loses its clean exit
            logger.debug("drain-migrate: migrate stamp failed for %s",
                         pod.key)

    def _evict_stragglers(self, node: str, cause: str) -> None:
        """The grace is over: residents that did not leave are evicted,
        each with its whole gang (a gang cannot run in part, and its
        room on the dying node is lost anyway).  Runs every poll past
        the grace, so the pods evicted already are remembered: a
        graceful termination keeps them resident for many polls."""
        from nos_tpu_torch.scheduler.gang import evict_gang

        with self._lock:
            doomed: set[str] = set(self._evicted.get(node, ()))
        residents = [p for p in self._residents(node)
                     if p.key not in doomed]
        if not residents:
            return
        evicted = 0
        for pod in residents:
            if pod.key in doomed:
                continue
            keys = evict_gang(self._api, pod)
            doomed.update(keys)
            evicted += len(keys)
        with self._lock:
            self._evicted[node] = doomed
        if evicted:
            REGISTRY.inc("nos_tpu_drain_migrations_total", evicted,
                         labels={"kind": self._kind})
            logger.info("drain-migrate[%s]: evicted %d straggler "
                        "pod(s) off %s (%s) after the %.1fs grace",
                        self._kind, evicted, node, cause,
                        self._migrate_grace_s)

    def _end_migration(self, node: str, live_node: Node | None) -> None:
        """The node recovered (heartbeat moved, maintenance lifted) or
        left: forget the migration and, when the drain is ours, clear it
        and un-ask the residents."""
        with self._lock:
            self._migrations.pop(node, None)
            self._evicted.pop(node, None)
        get_ledger().clear_hold(node, LEDGER_DRAIN,
                                owner=f"{self._kind}-migrate")
        if live_node is None:
            return
        if C.migration_drain_owner(
                live_node.metadata.annotations) != self._kind:
            return      # the other family's, or a defrag drain
        _retract_drain_and_stamps(self._api, self._kind, node)

    def _residents(self, node: str) -> list[Pod]:
        return [p for p in self._api.pods_on_node(node)
                if p.status.phase in (PENDING, RUNNING)]


def _retract_drain_and_stamps(api: APIServer, kind: str,
                              node: str) -> bool:
    """The migration's retraction, shared by the enabled policy's
    ``_end_migration`` and the disabled controller's startup heal: the
    node's ``kind``-owned migration drain off (owner checked), then the
    residents' ``migrate`` stamps, or each would exit at its next
    checkpoint on a healthy node.  False when the node write failed (the
    stamps stay for the next pass)."""
    def mutate(n: Node) -> None:
        if C.migration_drain_owner(n.metadata.annotations) == kind:
            n.metadata.annotations.pop(C.ANNOT_DEFRAG_DRAIN, None)

    try:
        retry_on_conflict(api, KIND_NODE, node, mutate,
                          component="drain-migrate")
    except NotFound:
        return False
    except Exception:  # noqa: BLE001 — a stray stamp only weakens the
        # refill avoidance; the next recovery poll heals it
        logger.debug("drain-migrate: drain clear failed for %s", node)
        return False
    for pod in api.pods_on_node(node):
        if not pod.metadata.annotations.get(C.ANNOT_MIGRATE, ""):
            continue

        def unstamp(p: Pod) -> None:
            p.metadata.annotations.pop(C.ANNOT_MIGRATE, None)

        try:
            retry_on_conflict(api, KIND_POD, pod.metadata.name,
                              unstamp, pod.metadata.namespace,
                              component="drain-migrate")
        except NotFound:
            pass
        except Exception:  # noqa: BLE001 — a stale stamp costs one
            # clean checkpoint exit, never a crash
            logger.debug("drain-migrate: migrate clear failed for %s",
                         pod.key)
    return True


def heal_stray_migration_drains(api: APIServer, kind: str) -> int:
    """The startup heal of a controller running without the recovery
    plane: a recovery-enabled predecessor that died mid-migration left
    ``kind``-owned migration drains and residents' ``migrate`` stamps
    that nothing else would retract.  Returns the nodes healed."""
    healed = 0
    for node in api.list(KIND_NODE):
        name = node.metadata.name
        if C.migration_drain_owner(node.metadata.annotations) != kind:
            continue
        if not _retract_drain_and_stamps(api, kind, name):
            logger.warning("drain-migrate[%s]: stray drain heal "
                           "failed for %s", kind, name)
            continue
        get_ledger().clear_hold(name, LEDGER_DRAIN, owner=f"{kind}-migrate")
        healed += 1
        logger.info("drain-migrate[%s]: healed stray migration drain "
                    "on %s (recovery plane disabled)", kind, name)
    return healed
