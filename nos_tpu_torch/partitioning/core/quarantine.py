"""Per-node quarantine, ``nos_tpu/partitioning/core/quarantine.py`` for
the port: the failure-domain boundary of the partitioner controller.

One dead or wedged node agent must degrade that node, not the cluster.
Without quarantine the plan handshake (one plan in flight per family)
waits forever on a node whose ``status-partitioning-plan`` never
catches up, and every later plan for every other node waits behind it.

Two paths put a node here, both reversible:

- **plan-deadline**: the node did not report a written plan within the
  controller's deadline (3 x the batch timeout);
- **actuation-failures**: ``apply_partitioning`` failed on the node
  ``FAILURE_THRESHOLD`` times in a row (the actuator's breaker).

A quarantined node is skipped by the handshake wait and left out of the
next snapshot.  The controller releases it once its report catches up;
the actuator once an apply succeeds.  An actuation-quarantined node
cannot prove itself by a report (its spec write failed, so spec equals
status trivially), so the controller releases it for one probe after a
cool-down: a half-open breaker.  The set lives in memory only: a
restarted controller derives laggards again from the same annotations.
The JAX package also stamps a quarantine hold in its chip-second ledger
(``obs/ledger.py``); the ledger comes with ROADMAP item 9.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable

from nos_tpu_torch.exporter.metrics import REGISTRY
from nos_tpu_torch.obs import journal as J
from nos_tpu_torch.obs.journal import record as journal_record
from nos_tpu_torch.utils.guards import guarded_by

logger = logging.getLogger(__name__)

REASON_PLAN_DEADLINE = "plan-deadline"
REASON_ACTUATION = "actuation-failures"

FAILURE_THRESHOLD = 3

REGISTRY.describe("nos_tpu_quarantined_nodes",
                  "Nodes currently quarantined from planning, per kind")
REGISTRY.describe("nos_tpu_plan_deadline_exceeded_total",
                  "Plans whose node missed the report deadline")
REGISTRY.describe("nos_tpu_actuation_breaker_open_total",
                  "Actuation circuit-breaker openings (failure streaks)")


@guarded_by("_lock", "_quarantined", "_streaks", "_probe_until")
class QuarantineList:
    """The quarantine set and per-node failure streaks of one
    partitioning kind, shared by the controller (deadline path) and the
    actuator (breaker path)."""

    def __init__(self, kind: str = "",
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.kind = kind
        self._clock = clock
        self._lock = threading.Lock()
        # node -> (reason, quarantined at)
        self._quarantined: dict[str, tuple[str, float]] = {}
        self._streaks: dict[str, int] = {}        # node -> failures in a row
        self._probe_until: dict[str, float] = {}  # half-open probe windows

    # -- membership ---------------------------------------------------------
    def quarantine(self, node: str, reason: str) -> bool:
        """True if the node was newly quarantined."""
        with self._lock:
            if node in self._quarantined:
                return False
            self._quarantined[node] = (reason, self._clock())
            self._set_gauge_locked()
        journal_record(J.QUARANTINED, node, kind=self.kind, reason=reason)
        logger.warning("quarantine[%s]: node %s quarantined (%s)",
                       self.kind, node, reason)
        return True

    def unquarantine(self, node: str) -> bool:
        with self._lock:
            entry = self._quarantined.pop(node, None)
            if entry is None:
                return False
            self._streaks.pop(node, None)
            self._probe_until.pop(node, None)
            self._set_gauge_locked()
        journal_record(J.QUARANTINE_RELEASED, node, kind=self.kind,
                       was=entry[0])
        logger.info("quarantine[%s]: node %s released (was: %s)",
                    self.kind, node, entry[0])
        return True

    def release_for_probe(self, node: str, window_s: float) -> bool:
        """Half-open release after the actuation cool-down: the node
        plans again, and one failed apply within ``window_s`` reopens the
        breaker at once (else a node that always fails would cost
        ``FAILURE_THRESHOLD`` doomed cycles after every cool-down).  A
        failure after the window starts a fresh streak of one; a
        successful apply clears everything (``record_success``)."""
        with self._lock:
            entry = self._quarantined.pop(node, None)
            if entry is None:
                return False
            self._streaks.pop(node, None)
            self._probe_until[node] = self._clock() + window_s
            self._set_gauge_locked()
        journal_record(J.QUARANTINE_RELEASED, node, kind=self.kind,
                       was=entry[0], probe=True)
        logger.info("quarantine[%s]: node %s released for a half-open "
                    "probe (was: %s)", self.kind, node, entry[0])
        return True

    def is_quarantined(self, node: str) -> bool:
        with self._lock:
            return node in self._quarantined

    def names(self) -> frozenset[str]:
        with self._lock:
            return frozenset(self._quarantined)

    def items(self) -> dict[str, tuple[str, float]]:
        """node -> (reason, quarantined at), a copy."""
        with self._lock:
            return dict(self._quarantined)

    # -- liveness signals ---------------------------------------------------
    def record_failure(self, node: str) -> int:
        """One failed actuation.  ``FAILURE_THRESHOLD`` failures in a
        row, or one inside an open probe window, open the breaker (the
        node is quarantined).  Returns the streak."""
        with self._lock:
            probe_until = self._probe_until.pop(node, None)
            if probe_until is not None and self._clock() <= probe_until:
                streak = FAILURE_THRESHOLD    # a failed probe
            else:
                streak = self._streaks.get(node, 0) + 1
            self._streaks[node] = streak
        if streak >= FAILURE_THRESHOLD:
            if self.quarantine(node, REASON_ACTUATION):
                REGISTRY.inc("nos_tpu_actuation_breaker_open_total",
                             labels={"kind": self.kind})
        return streak

    def record_success(self, node: str) -> None:
        with self._lock:
            self._streaks.pop(node, None)
            self._probe_until.pop(node, None)
            entry = self._quarantined.get(node)
            if entry is None or entry[0] != REASON_ACTUATION:
                return
        # an actuation-quarantined node healed by an apply; a deadline
        # quarantine waits for the report instead
        self.unquarantine(node)

    def _set_gauge_locked(self) -> None:
        REGISTRY.set("nos_tpu_quarantined_nodes",
                     float(len(self._quarantined)),
                     labels={"kind": self.kind})
