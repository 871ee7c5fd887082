"""The decision journal, ``nos_tpu/obs/journal.py`` for the port: a
bounded, append-only log of the planner's, the actuator's and the
partitioner controller's decisions (a node's geometry committed or
reverted, a node actuated or failed, a plan cycle, a node quarantined or
released, the handshake's lagging nodes), each with the ambient trace
context so a record links back to its span.

``record()`` takes the journal lock for the append only and calls
nothing under it; timestamps come from the journal's injectable clock.
The parallel planner's capture-and-replay waits for its slice.
"""

from __future__ import annotations

import time
from typing import Callable

from nos_tpu_torch.exporter.metrics import REGISTRY
from nos_tpu_torch.utils.guards import guarded_by

from ._ring import BoundedRing
from .trace import current_span

REGISTRY.describe("nos_tpu_journal_records_total",
                  "Decision-journal records appended, per category")
REGISTRY.describe("nos_tpu_journal_dropped_total",
                  "Decision records evicted from the bounded journal")

# A record naming many nodes keeps at most this many of them.
MAX_JOURNAL_NODES = 32

# -- the categories the planner, the actuator and the controller record ---
PLAN_NODE_COMMITTED = "plan-node-committed"
PLAN_NODE_REVERTED = "plan-node-reverted"
NODE_ACTUATED = "node-actuated"
ACTUATION_FAILED = "actuation-failed"
PLAN_CYCLE = "plan-cycle"
QUARANTINED = "quarantined"
QUARANTINE_RELEASED = "quarantine-released"
HANDSHAKE_WAIT = "handshake-wait"


class DecisionRecord:
    """One decision about ``subject`` (a node name or a pod key), with
    category-specific ``attrs``."""

    __slots__ = ("seq", "ts", "category", "subject", "attrs",
                 "trace_id", "span_id")

    def __init__(self, seq: int, ts: float, category: str, subject: str,
                 attrs: dict, trace_id: str, span_id: str) -> None:
        self.seq = seq
        self.ts = ts
        self.category = category
        self.subject = subject
        self.attrs = attrs
        self.trace_id = trace_id
        self.span_id = span_id

    def to_dict(self) -> dict:
        return {
            "seq": self.seq,
            "ts": self.ts,
            "category": self.category,
            "subject": self.subject,
            "attrs": dict(self.attrs),
            "trace_id": self.trace_id,
            "span_id": self.span_id,
        }


@guarded_by("_lock", "_seq")
class DecisionJournal(BoundedRing):
    """Bounded, totally ordered decision log."""

    def __init__(self, maxlen: int = 4096,
                 clock: Callable[[], float] = time.monotonic) -> None:
        super().__init__(maxlen)
        self._clock = clock
        self._seq = 0

    def record(self, category: str, subject: str,
               **attrs: object) -> DecisionRecord:
        """Append one decision; never raises."""
        span = current_span()
        rec = DecisionRecord(
            0, self._clock(), category, subject, attrs,
            span.trace_id if span is not None else "",
            span.span_id if span is not None else "")
        with self._lock:
            self._seq += 1
            rec.seq = self._seq
            evicted = self._push_locked(rec)
        REGISTRY.inc("nos_tpu_journal_records_total",
                     labels={"category": category})
        if evicted:
            REGISTRY.inc("nos_tpu_journal_dropped_total")
        return rec

    def events(self, category: str | None = None,
               subject: str | None = None,
               limit: int | None = None) -> list[DecisionRecord]:
        """Matching records, oldest first (``limit`` keeps the newest N)."""
        with self._lock:
            records = list(self._items)
        if category is not None:
            records = [r for r in records if r.category == category]
        if subject is not None:
            records = [r for r in records if r.subject == subject]
        if limit is not None:
            records = records[-limit:]
        return records


_journal = DecisionJournal()


def set_journal(journal: DecisionJournal) -> DecisionJournal:
    global _journal
    prev = _journal
    _journal = journal
    return prev


def record(category: str, subject: str, **attrs: object) -> DecisionRecord:
    """Record a decision in the process journal."""
    return _journal.record(category, subject, **attrs)
