"""The decision journal, ``nos_tpu/obs/journal.py`` for the port: a
bounded, append-only log of the planner's, the actuator's and the
partitioner controller's decisions (a node's geometry committed or
reverted, a node actuated or failed, a plan cycle, a node quarantined or
released, the handshake's lagging nodes), each with the ambient trace
context so a record links back to its span.

``record()`` takes the journal lock for the append only and calls
nothing under it; timestamps come from the journal's injectable clock.
Under ``capture_records`` a context's records go to a ``JournalCapture``
instead, which the parallel planner replays in pool-key order, so the
journal is the same whatever the shards' thread timing.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Callable, Iterator

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
PLAN_SHARD_MERGED = "plan-shard-merged"
# the NVLink block group pass's (``partitioning/slicepart/group.py``): a
# block carved over an aligned window of clean nodes, or a free block
# given back to the per-node loop (subject the block profile; domain,
# nodes), the JAX package's "group pass" log lines
PLAN_BLOCK_CARVED = "plan-block-carved"
PLAN_BLOCK_RECLAIMED = "plan-block-reclaimed"
QUARANTINED = "quarantined"
QUARANTINE_RELEASED = "quarantine-released"
HANDSHAKE_WAIT = "handshake-wait"
# -- the scheduler's, the capacity plugin's and the quota reconcilers' ---
POD_REJECTED = "pod-rejected"
POD_BOUND = "pod-bound"
POD_NOMINATED = "pod-nominated"
GANG_ADMITTED = "gang-admitted"
GANG_REJECTED = "gang-rejected"
QUOTA_HOL_CLAIM = "quota-hol-claim"
QUOTA_BORROW = "quota-borrow"
QUOTA_RECLAIM = "quota-reclaim"
PREEMPTION = "preemption"
PREEMPTION_NONE = "preemption-none"
JOB_REBOUND = "job-rebound"
# -- the recovery plane's ------------------------------------------------
JOB_DISPLACED = "job-displaced"
SPARE_PROMOTED = "spare-promoted"
# -- the SLO engine's verdict transitions ---------------------------------
SLO_BREACH = "slo-breach"
SLO_RECOVERED = "slo-recovered"
# -- the defragmentation plane's (``partitioning/core/defrag.py``): a
# proposal is PROPOSED when the what-if fork proves every victim
# relocatable, APPLIED when it clears the payback threshold and its
# evictions fire, REJECTED on payback, PDB allowance or a drain past its
# deadline; GANG_RESIZED records an elastic gang's dp grow or shrink
DEFRAG_PROPOSED = "defrag-proposed"
DEFRAG_APPLIED = "defrag-applied"
DEFRAG_REJECTED = "defrag-rejected"
GANG_RESIZED = "gang-resized"
# -- the capacity plane's (``capacity/provisioner.py``): a create is
# REQUESTED when the provisioner asks the cloud for a node, LANDED when
# the node joined and became usable (latency from the request), FAILED
# when it was abandoned (stockout, quota, zombie reap, deadline; reason
# recorded); STOCKOUT records a (machine class, zone) breaker transition
# (state: open, half-open, closed); SPARE_BORROWED a sibling pool's warm
# spare promoted into a vacancy under a stockout; SCALE_DOWN an empty
# top-index node released back to the cloud
PROVISION_REQUESTED = "provision-requested"
PROVISION_LANDED = "provision-landed"
PROVISION_FAILED = "provision-failed"
PROVISION_STOCKOUT = "provision-stockout"
SPARE_BORROWED = "spare-borrowed"
SCALE_DOWN = "scale-down"
# -- the serving tier's: AUTOSCALE is an executed replica scale (service
# key; direction, count: ``serving/autoscaler.py``); REQUEST_SHED a
# request dropped after the router's retry budget (service key; rid,
# session, retries, phase); SESSION_MIGRATED a live session re-homed
# because its replica vanished (service key; session, from_replica,
# was_affine: ``requests/router.py``)
AUTOSCALE = "autoscale"
REQUEST_SHED = "request-shed"
SESSION_MIGRATED = "session-migrated"


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

# The capture of the running context, None to record straight to the
# process journal (``capture_records``).
_capture: "contextvars.ContextVar[JournalCapture | None]" = \
    contextvars.ContextVar("nos_tpu_journal_capture", default=None)


class JournalCapture:
    """An ordered buffer of ``record()`` calls for a later replay.  It
    stamps no sequence number or time and counts nothing: the replay
    into the ambient journal does that once, so a captured decision
    reads as one recorded inline."""

    def __init__(self) -> None:
        self.calls: list[tuple[str, str, dict]] = []

    def record(self, category: str, subject: str,
               **attrs: object) -> DecisionRecord:
        self.calls.append((category, subject, attrs))
        return DecisionRecord(0, 0.0, category, subject, attrs, "", "")

    def replay(self) -> None:
        """Record every captured decision, in capture order."""
        for category, subject, attrs in self.calls:
            record(category, subject, **attrs)


@contextlib.contextmanager
def capture_records(capture: JournalCapture) -> Iterator[JournalCapture]:
    """Send this context's ``record()`` calls to ``capture`` (a context
    variable, so a worker under ``contextvars.copy_context()`` captures
    without touching its submitter's journal)."""
    token = _capture.set(capture)
    try:
        yield capture
    finally:
        _capture.reset(token)


def get_journal() -> DecisionJournal:
    return _journal


def set_journal(journal: DecisionJournal) -> DecisionJournal:
    global _journal
    prev = _journal
    _journal = journal
    return prev


def record(category: str, subject: str, **attrs: object) -> DecisionRecord:
    """Record a decision in the process journal, or in the running
    context's capture."""
    capture = _capture.get()
    if capture is not None:
        return capture.record(category, subject, **attrs)
    return _journal.record(category, subject, **attrs)
