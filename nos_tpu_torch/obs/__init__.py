"""Decision-plane observability, ``nos_tpu/obs`` for the port: spans and
counters over the planner and actuator (``trace``), the decision
journal (``journal``), and ``flight_snapshot``, the flight recorder the
runtime's health server serves at ``/debug/flightrecorder``."""

from __future__ import annotations

from .journal import get_journal
from .trace import get_tracer


def flight_snapshot() -> dict:
    """Every finished span in the ring and the whole journal, as plain
    dicts (JSON-ready), with the count each ring evicted.  The JAX
    package adds its SLO engine's report when one is installed and its
    chip-second ledger's waste report; the port has neither yet (ROADMAP
    item 9 part 1), so neither key is here."""
    tracer = get_tracer()
    journal = get_journal()
    return {
        "spans": tracer.ring.dump(),
        "spans_dropped": tracer.ring.dropped,
        "journal": journal.dump(),
        "journal_dropped": journal.dropped,
    }
