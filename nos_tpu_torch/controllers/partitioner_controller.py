"""The partitioner controller, ``nos_tpu/controllers/partitioner_controller.py``
for the port (reference
internal/controllers/gpupartitioner/partitioner_controller.go:81-239),
one instance per partitioning kind, as the reference runs one for MIG
and one for MPS:

- a pod event counts only if a repartition could help the pod schedule
  (``extra_resources_could_help_scheduling``) and some node has the
  kind enabled;
- such pods feed a ``Batcher`` (timeout and idle windows);
- once the batch is ready and every node has reported the previous plan
  (the spec against status plan-id handshake, :212-232), the controller
  lists every pending pod, snapshots the cluster, plans and applies.

Plan cycles run at most once per replan epoch (the batch's idle
window).  A rescan every batch timeout replans pending demand whose
trigger was consumed or lost.  When no node is plannable the drained
trigger is restored.

The handshake wait is per failure domain: a node that does not report a
written plan within the plan deadline (3 x the batch timeout) is
quarantined, left out of the wait and of the next snapshot, and
released once its report catches up.  An actuation-quarantined node
is released for one half-open probe after one deadline of cool-down.
The handshake journal records the lagging set's transitions only.  Each
node's plan write starts an actuation clock, observed as
``nos_tpu_actuation_latency_seconds{kind,pool}`` when its status plan
id catches up; the same stamp holds the node's free GPUs as
``actuation`` in the chip-second ledger (``obs/ledger.py``) until then.

The recovery plane (``partitioning/core/failure.py``: heartbeat
suspicion, warm-spare promotion, drain-then-migrate), when the factory
builds one, steps on every poll before the plan path, so a suspect node
is out of the snapshot and a promoted spare in it by the next plan;
without one, the migration drains a recovery-enabled predecessor left
are healed once, at the first poll.  Warm spares and nodes under a
migration drain are left out of the snapshot as quarantined nodes are.

The plan deadline, the rescan interval and the replan epoch are
constructor arguments; None keeps the defaults above: three batch
timeouts, one batch timeout and the batch's idle window.  The
partitioner main sets the deadline and the epoch from its config
(``cmd/assembly.py``), as JAX's does.

The background defragmenter (``partitioning/core/defrag.py``), when the
factory builds one (the MIG family's, with ``defrag_enabled``), steps
after every plan on the plan's unmutated snapshot and its pending pods:
demand still frag-blocked after the carve-only answer is what it may
move pods for.
"""

from __future__ import annotations

import logging
import time
from typing import Callable

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.exporter.metrics import REGISTRY
from nos_tpu_torch.kube.client import APIServer, KIND_POD
from nos_tpu_torch.kube.objects import PENDING, Pod
from nos_tpu_torch.obs import journal as J
from nos_tpu_torch.obs.journal import MAX_JOURNAL_NODES, record as journal_record
from nos_tpu_torch.obs.ledger import ACTUATION as LEDGER_ACTUATION, get_ledger
from nos_tpu_torch.obs.trace import span as obs_span
from nos_tpu_torch.partitioning.core import (
    Actuator, DefragProposer, Planner, QuarantineList, REASON_ACTUATION,
    REASON_PLAN_DEADLINE, REASON_SUSPECT, SelfHealingPolicy, SnapshotTaker,
    heal_stray_migration_drains,
)
from nos_tpu_torch.partitioning.state import ClusterState
from nos_tpu_torch.topology.annotations import spec_plan_id, status_plan_id
from nos_tpu_torch.utils.batcher import Batcher
from nos_tpu_torch.utils.pod_util import extra_resources_could_help_scheduling

logger = logging.getLogger(__name__)

REGISTRY.describe("nos_tpu_plan_seconds",
                  "Partitioning plan computation time")
REGISTRY.describe("nos_tpu_plans_total", "Partitioning plans computed")
REGISTRY.describe("nos_tpu_plan_pending_pods",
                  "Pending pods the last plan tried to place")
REGISTRY.describe("nos_tpu_replan_epoch_deferred_total",
                  "Ready batches held back to the next replan epoch")
REGISTRY.describe("nos_tpu_actuation_latency_seconds",
                  "Plan write to actuation-landed (status plan id "
                  "caught up) per node, labelled by pool")

# The default plan deadline in batch timeouts: a healthy agent reports
# within one report interval, so three batch windows of silence after a
# plan write mean a dead or wedged agent, not a slow one.
PLAN_DEADLINE_FACTOR = 3.0


class PartitionerController:
    def __init__(self, api: APIServer, cluster_state: ClusterState,
                 kind: str, planner: Planner, actuator: Actuator,
                 snapshot_taker: SnapshotTaker,
                 batcher: Batcher[Pod], quarantine: QuarantineList,
                 plan_deadline_s: float | None = None,
                 rescan_interval_s: float | None = None,
                 replan_epoch_s: float | None = None,
                 defrag: DefragProposer | None = None,
                 recovery: SelfHealingPolicy | None = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self._api = api
        self._state = cluster_state
        self._kind = kind
        self._planner = planner
        self._actuator = actuator
        self._snapshot_taker = snapshot_taker
        self._batcher = batcher
        self._quarantine = quarantine
        self._plan_deadline_s = (
            plan_deadline_s if plan_deadline_s is not None
            else PLAN_DEADLINE_FACTOR * batcher.timeout_s)
        self._rescan_interval_s = (
            rescan_interval_s if rescan_interval_s is not None
            else batcher.timeout_s)
        # Plan cycles run at most once per epoch however fast triggers
        # come: pods marked unschedulable inside the running epoch gather
        # in the batcher and ride the next cycle.  The idle window as the
        # default epoch keeps the batcher's own cadence.
        self._replan_epoch_s = (replan_epoch_s if replan_epoch_s is not None
                                else batcher.idle_s)
        # the recovery plane, None when every recovery knob is off; a
        # controller without it heals a predecessor's migration drains
        # once (a clean cluster sees no write)
        self._recovery = recovery
        # the background defragmenter, None unless the factory built one
        self._defrag = defrag
        self._stray_migrations_healed = recovery is not None
        self._clock = clock
        self._last_scan = clock()
        # the first plan is never deferred: the epoch starts one period ago
        self._last_plan = clock() - self._replan_epoch_s
        self._epoch_deferring = False
        # node -> (unreported spec plan id, first seen lagging at)
        self._lag_since: dict[str, tuple[str, float]] = {}
        # the last journaled lagging set: the wait is polled every tick,
        # so only its transitions are decisions
        self._last_lagging: frozenset[str] = frozenset()
        # node -> (spec plan id, plan write time): actuations in flight
        self._actuation_started: dict[str, tuple[str, float]] = {}

    @property
    def quarantine(self) -> QuarantineList:
        return self._quarantine

    # -- event path ---------------------------------------------------------
    def reconcile_pod(self, pod: Pod) -> None:
        if not self._state.is_partitioning_enabled(self._kind):
            return
        if not extra_resources_could_help_scheduling(pod):
            return
        self._batcher.add(pod.key, pod)

    def bind(self) -> None:
        self._api.watch(
            KIND_POD,
            lambda ev, pod: self.reconcile_pod(pod) if ev != "DELETED" else None,
        )

    # -- batch path ---------------------------------------------------------
    def process_if_ready(self) -> bool:
        """Polled from the run loop; True if a plan cycle ran."""
        self._reconcile_quarantine()
        if self._recovery is not None:
            self._recovery.step(self._state.nodes())
        elif not self._stray_migrations_healed:
            self._stray_migrations_healed = True
            heal_stray_migration_drains(self._api, self._kind)
        self._refresh_lagging_journal()
        self._observe_landed_actuations()
        if self._clock() - self._last_plan < self._replan_epoch_s:
            # inside the running epoch: triggers gather in the batcher
            if not self._epoch_deferring and self._batcher.ready():
                self._epoch_deferring = True
                REGISTRY.inc("nos_tpu_replan_epoch_deferred_total",
                             labels={"kind": self._kind})
            return False
        self._epoch_deferring = False
        rescan_pods = None
        if not self._batcher.ready():
            # a filling batch carries a live trigger and its windows
            # govern; the rescan is for demand whose trigger is gone
            if len(self._batcher):
                return False
            rescan_pods = self._rescan_due()
            if rescan_pods is None:
                return False
        if self._waiting_for_nodes_to_report_plan():
            # reference :118-124 requeues after 10 s
            logger.debug("partitioner[%s]: waiting for plan reports",
                         self._kind)
            return False
        # Drain before planning: events landing while the plan runs go
        # to the next batch.  Against a real API server a repeated
        # unschedulable mark writes nothing and sends no event, so a
        # dropped trigger would be dropped for good.
        items = self._batcher.drain()
        self._last_scan = self._clock()
        if not self.process_pending_pods(pods=rescan_pods):
            # nothing plannable (every node of the kind quarantined, say):
            # restore the trigger so the demand replans once a node
            # recovers.  No plan ran, so the epoch is not stamped.
            for pod in items:
                self._batcher.add(pod.key, pod)
            return False
        self._last_plan = self._clock()
        return True

    def process_pending_pods(self, pods: list[Pod] | None = None) -> bool:
        """False when no snapshot node was there to plan on (the caller
        keeps its trigger); True once a plan cycle ran.  A rescan passes
        the ``pods`` it listed."""
        if pods is None:
            pods = [
                p for p in self._api.pods_by_phase(PENDING)
                if extra_resources_could_help_scheduling(p)
            ]
        # a warm spare joins no plan until it is promoted, and a node
        # under a migration drain takes no pod (MigrationDrainGuard): both
        # are left out with the quarantined nodes
        exclude = set(self._quarantine.names())
        for name, node in self._state.nodes().items():
            if C.is_warm_spare_labels(node.metadata.labels) \
                    or C.is_migration_drain(node.metadata.annotations):
                exclude.add(name)
        snapshot = self._snapshot_taker.take_snapshot(
            self._state, exclude=exclude)
        if not snapshot.nodes():
            return False
        with obs_span("partitioner.plan_cycle", kind=self._kind,
                      pods=len(pods),
                      excluded=len(self._quarantine.names())):
            with REGISTRY.time("nos_tpu_plan_seconds",
                               labels={"kind": self._kind}):
                desired = self._planner.plan(snapshot.clone(), pods)
                actuated = self._actuator.apply(snapshot, desired)
            journal_record(J.PLAN_CYCLE, self._kind, pods=len(pods),
                           actuated=actuated)
        REGISTRY.inc("nos_tpu_plans_total", labels={"kind": self._kind})
        REGISTRY.set("nos_tpu_plan_pending_pods",
                     float(len(pods)), labels={"kind": self._kind})
        self._start_actuation_clocks()
        if self._defrag is not None:
            # the plan above is the carve-only answer; the snapshot is the
            # cycle's unmutated state (the planner ran on a clone)
            self._defrag.step(snapshot, pods)
        return True

    # -- actuation-landed latency -------------------------------------------
    def _start_actuation_clocks(self) -> None:
        """After a plan cycle, stamp the clock of every node of the kind
        whose spec plan id is ahead of its status, and hold its free GPUs
        as actuation in the ledger.  A node replanned in flight restarts
        its clock: the latency runs to the plan its agent will
        report."""
        now = self._clock()
        for node in self._state.nodes().values():
            if not self._my_kind(node):
                continue
            annots = node.metadata.annotations
            spec_id = spec_plan_id(annots, family=self._kind)
            if not spec_id or status_plan_id(annots,
                                             family=self._kind) == spec_id:
                continue
            name = node.metadata.name
            entry = self._actuation_started.get(name)
            if entry is None or entry[0] != spec_id:
                self._actuation_started[name] = (spec_id, now)
                get_ledger().set_hold(name, LEDGER_ACTUATION,
                                      owner=self._kind, kind=self._kind,
                                      plan_id=spec_id)

    def _observe_landed_actuations(self) -> None:
        """A node whose status plan id caught up with its stamped spec
        observes one ``nos_tpu_actuation_latency_seconds`` sample.  A
        node that left and a superseded plan drop their entry (the next
        plan cycle stamps again).  Each dropped entry clears its ledger
        hold."""
        if not self._actuation_started:
            return
        now = self._clock()
        nodes = self._state.nodes()
        for name, (plan_id, t0) in list(self._actuation_started.items()):
            node = nodes.get(name)
            if node is None or not self._my_kind(node):
                del self._actuation_started[name]
                get_ledger().clear_hold(name, LEDGER_ACTUATION,
                                        owner=self._kind)
                continue
            annots = node.metadata.annotations
            if spec_plan_id(annots, family=self._kind) != plan_id:
                del self._actuation_started[name]     # superseded
                get_ledger().clear_hold(name, LEDGER_ACTUATION,
                                        owner=self._kind)
                continue
            if status_plan_id(annots, family=self._kind) == plan_id:
                del self._actuation_started[name]
                get_ledger().clear_hold(name, LEDGER_ACTUATION,
                                        owner=self._kind)
                # the pool is the node's NVLink domain, "-" unlabelled
                pool = node.metadata.labels.get(
                    C.LABEL_NVLINK_DOMAIN, "") or "-"
                REGISTRY.observe(
                    "nos_tpu_actuation_latency_seconds",
                    max(0.0, now - t0),
                    labels={"kind": self._kind, "pool": pool})

    def _rescan_due(self) -> list[Pod] | None:
        """The level-triggered backstop of the event-triggered batch
        (the reference requeues every 10 s whatever the events,
        partitioner_controller.go:118-124): at most one listing of the
        pending pods per rescan interval, returned so that the plan
        cycle it triggers does not list again; None for no rescan."""
        if self._clock() - self._last_scan < self._rescan_interval_s:
            return None
        # the listing is the scan: stamp it first, so an empty or
        # blocked outcome still waits a whole interval
        self._last_scan = self._clock()
        if not self._state.is_partitioning_enabled(self._kind):
            return None
        pods = [p for p in self._api.pods_by_phase(PENDING)
                if extra_resources_could_help_scheduling(p)]
        return pods or None

    # -- failure-domain bookkeeping -----------------------------------------
    def _my_kind(self, node) -> bool:
        return node.metadata.labels.get(C.LABEL_PARTITIONING, "") in (
            self._kind, C.HYBRID_KIND)

    def _node_reported(self, node) -> bool:
        annots = node.metadata.annotations
        spec_id = spec_plan_id(annots, family=self._kind)
        return not spec_id or status_plan_id(annots, family=self._kind) == spec_id

    def _reconcile_quarantine(self) -> None:
        """Each poll, over the quarantine set only, release: a node that
        left the cluster or the kind; a deadline-quarantined node whose
        report caught up; an actuation-quarantined node after one
        deadline of cool-down, for a half-open probe (its spec equals
        its status trivially, so only a fresh apply can prove it).  A
        suspect is left to the failure detector: a wedged agent wrote
        nothing new, so a caught-up report proves nothing."""
        items = self._quarantine.items()
        if not items:
            return
        now = self._clock()
        nodes = self._state.nodes()
        for name, (reason, since) in items.items():
            node = nodes.get(name)
            if node is None or not self._my_kind(node):
                self._lag_since.pop(name, None)
                self._quarantine.unquarantine(name)
            elif reason == REASON_ACTUATION:
                if now - since >= self._plan_deadline_s:
                    self._quarantine.release_for_probe(
                        name, self._plan_deadline_s)
            elif reason == REASON_SUSPECT:
                pass
            elif self._node_reported(node):
                self._lag_since.pop(name, None)
                self._quarantine.unquarantine(name)

    def _refresh_lagging_journal(self) -> None:
        """Each tick, drop from the journaled lagging set the nodes that
        reported, left or were quarantined since: the blocking check
        that journals new waits is skipped on idle ticks, and the newest
        record must not name a node that no longer blocks.  Only ever
        shrinks the set."""
        if not self._last_lagging:
            return
        nodes = self._state.nodes()
        still = set()
        for name in self._last_lagging:
            node = nodes.get(name)
            if node is None or not self._my_kind(node):
                continue
            if self._quarantine.is_quarantined(name):
                continue
            if not self._node_reported(node):
                still.add(name)
        self._journal_lagging_transition(frozenset(still))

    def _journal_lagging_transition(self, lagging: frozenset[str]) -> None:
        """Journal the lagging set when it changes, the empty set
        included (the newest record must show the wait resolved), with
        at most MAX_JOURNAL_NODES names."""
        if lagging == self._last_lagging:
            return
        self._last_lagging = lagging
        journal_record(J.HANDSHAKE_WAIT, self._kind,
                       lagging=sorted(lagging)[:MAX_JOURNAL_NODES],
                       lagging_count=len(lagging))

    def _waiting_for_nodes_to_report_plan(self) -> bool:
        """Spec against status plan id per node (reference :212-232),
        with a deadline per plan: a node lagging longer than
        the plan deadline on the same plan id is quarantined and stops
        blocking."""
        now = self._clock()
        waiting = False
        lagging: set[str] = set()
        live = set()
        for node in self._state.nodes().values():
            if not self._my_kind(node):
                continue
            name = node.metadata.name
            live.add(name)
            if self._node_reported(node):
                self._lag_since.pop(name, None)
                continue
            if self._quarantine.is_quarantined(name):
                continue
            spec_id = spec_plan_id(node.metadata.annotations,
                                   family=self._kind)
            entry = self._lag_since.get(name)
            if entry is None or entry[0] != spec_id:
                # first sight of this plan lagging: arm its deadline
                self._lag_since[name] = (spec_id, now)
                lagging.add(name)
                waiting = True
            elif now - entry[1] >= self._plan_deadline_s:
                del self._lag_since[name]
                REGISTRY.inc("nos_tpu_plan_deadline_exceeded_total",
                             labels={"kind": self._kind})
                self._quarantine.quarantine(name, REASON_PLAN_DEADLINE)
                logger.warning(
                    "partitioner[%s]: node %s missed plan %s deadline "
                    "(%.1fs), quarantined, replanning without it",
                    self._kind, name, spec_id, self._plan_deadline_s)
                # quarantined this tick: no longer blocks the handshake
            else:
                lagging.add(name)
                waiting = True
        # a node that left must not pin a stale deadline
        for name in [n for n in self._lag_since if n not in live]:
            del self._lag_since[name]
        self._journal_lagging_transition(frozenset(lagging))
        return waiting
