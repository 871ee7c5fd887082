"""Decision-plane observability, ``nos_tpu/obs`` for the port:

- ``trace``: spans and counters over the planner, the actuator and the
  scheduler;
- ``journal``: the bounded log of decisions;
- ``ledger``: the chip-second waste ledger (a chip is one GPU), every
  GPU-second of the fleet booked to one category;
- ``timeseries`` and ``slo``: windowed registry samples and the SLO
  engine's burn-rate verdicts;
- ``explain``: "why is this pod pending?" and "where did this plan's
  time go?" from a flight snapshot.

``flight_snapshot`` is the flight recorder the runtime's health server
serves at ``/debug/flightrecorder``; ``python -m nos_tpu_torch.obs`` is
the CLI that reads it.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Callable, Iterator

from .explain import explain_plan, explain_pod
from .journal import (
    DecisionJournal, DecisionRecord, get_journal, record, set_journal,
)
from .ledger import ChipSecondLedger, get_ledger, set_ledger
from .slo import SLOEngine, SLOObjective, get_engine, set_engine
from .timeseries import TimeSeriesSampler
from .trace import (
    RingExporter, Span, Tracer, bump, current_span, detail_span,
    get_tracer, set_tracer, span,
)

__all__ = [
    "ChipSecondLedger", "DecisionJournal", "DecisionRecord",
    "RingExporter", "SLOEngine", "SLOObjective", "Span",
    "TimeSeriesSampler", "Tracer",
    "bump", "current_span", "detail_span", "explain_plan", "explain_pod",
    "flight_snapshot", "get_engine", "get_journal", "get_ledger",
    "get_tracer", "record", "scoped", "set_engine", "set_flight_block",
    "set_journal", "set_ledger", "set_tracer", "span",
]

# Named blocks a component adds to the flight snapshot (the capacity
# provisioner registers its report here): a provider is a callable with
# no arguments returning a JSON-ready dict.
_flight_blocks: dict[str, Callable[[], dict]] = {}


def set_flight_block(name: str, provider: Callable[[], dict] | None = None
                     ) -> Callable[[], dict] | None:
    """Register, or with None remove, a named snapshot block; returns the
    previous provider."""
    prev = _flight_blocks.get(name)
    if provider is None:
        _flight_blocks.pop(name, None)
    else:
        _flight_blocks[name] = provider
    return prev


def flight_snapshot() -> dict:
    """Every finished span in the ring and the whole journal as plain
    dicts (JSON-ready), with the count each ring evicted; the SLO
    engine's report under ``slo`` when one is installed; the ledger's
    waterfall under ``waste``, in the same payload as the journal, so
    ``obs waste`` joins a culprit to its record from one fetch; then
    each registered block.  A block whose provider raises is left out of
    this snapshot with a warning; no other key is."""
    tracer = get_tracer()
    journal = get_journal()
    snapshot = {
        "spans": tracer.ring.dump(),
        "spans_dropped": tracer.ring.dropped,
        "journal": journal.dump(),
        "journal_dropped": journal.dropped,
    }
    engine = get_engine()
    if engine is not None:
        snapshot["slo"] = engine.report()
    snapshot["waste"] = get_ledger().report()
    for name, provider in list(_flight_blocks.items()):
        try:
            snapshot[name] = provider()
        except Exception:  # noqa: BLE001 — a sick block must not kill the dump
            logging.getLogger(__name__).warning(
                "flight snapshot block %r raised; omitted", name)
    return snapshot


@contextlib.contextmanager
def scoped(tracer: Tracer | None = None,
           journal: DecisionJournal | None = None,
           engine: SLOEngine | None = None,
           ledger: ChipSecondLedger | None = None) -> Iterator[None]:
    """Install a tracer, a journal, an SLO engine and a ledger (each
    optional) for the block, and restore the previous ones on exit: an
    isolated run that leaks nothing into the process's."""
    prev_tracer = set_tracer(tracer) if tracer is not None else None
    prev_journal = set_journal(journal) if journal is not None else None
    prev_engine = set_engine(engine) if engine is not None else None
    prev_ledger = set_ledger(ledger) if ledger is not None else None
    try:
        yield
    finally:
        if prev_tracer is not None:
            set_tracer(prev_tracer)
        if prev_journal is not None:
            set_journal(prev_journal)
        if engine is not None:
            set_engine(prev_engine)
        if prev_ledger is not None:
            set_ledger(prev_ledger)
