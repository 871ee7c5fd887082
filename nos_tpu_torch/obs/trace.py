"""Causal tracing for the decision plane, ``nos_tpu/obs/trace.py`` for
the port: spans over the planner and the actuator.

- **Span**: a named interval with attributes, counters (``bump``) and
  parent/trace linkage; its times come from the tracer's injectable
  clock.
- **Context** via ``contextvars``: the active span follows the call
  stack; a thread started mid-span starts a fresh trace.
- **RingExporter**: a bounded ring of finished spans (``dump()`` is the
  flight recorder's snapshot).
- Every finished span is observed as ``nos_tpu_span_seconds{span=...}``
  in ``exporter/metrics.py``'s registry.

The hot loops (Filter per pod × node) bump counters on the enclosing
span, a ContextVar read and a dict add; ``detail_span`` becomes a real
child span only on a ``detailed`` tracer.  The planner's ``forks``,
``commits`` and ``reverts`` are such counters on its ``planner.plan``
span.
"""

from __future__ import annotations

import contextvars
import itertools
import time
from types import TracebackType
from typing import Callable

from nos_tpu_torch.exporter.metrics import REGISTRY

from ._ring import BoundedRing

REGISTRY.describe("nos_tpu_span_seconds",
                  "Decision-path span latency (count/sum/max per span)")
REGISTRY.describe("nos_tpu_trace_spans_dropped_total",
                  "Finished spans evicted from the bounded ring exporter")

_current: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "nos_tpu_obs_span", default=None)


class Span:
    """One named interval: ``set()`` attaches attributes and ``bump()``
    increments counters while it is open."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start",
                 "end", "attrs", "counts", "status")

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: str, start: float,
                 attrs: dict | None = None) -> None:
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = start
        self.end: float | None = None
        self.attrs: dict = attrs or {}
        self.counts: dict[str, int] = {}
        self.status = "ok"

    @property
    def duration(self) -> float | None:
        return None if self.end is None else self.end - self.start

    def set(self, key: str, value: object) -> None:
        self.attrs[key] = value

    def bump(self, key: str, n: int = 1) -> None:
        self.counts[key] = self.counts.get(key, 0) + n

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start": self.start,
            "end": self.end,
            "duration": self.duration,
            "status": self.status,
            "attrs": dict(self.attrs),
            "counts": dict(self.counts),
        }


class RingExporter(BoundedRing):
    """Bounded ring of finished spans, newest last."""

    def __init__(self, maxlen: int = 2048) -> None:
        super().__init__(maxlen)

    def export(self, span: Span) -> None:
        with self._lock:
            evicted = self._push_locked(span)
        if evicted:
            REGISTRY.inc("nos_tpu_trace_spans_dropped_total")


class _SpanHandle:
    """Context manager binding one span into the ambient context."""

    __slots__ = ("_tracer", "_span", "_token")

    def __init__(self, tracer: "Tracer", span: Span) -> None:
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> Span:
        self._token = _current.set(self._span)
        return self._span

    def __exit__(self, exc_type: type[BaseException] | None,
                 exc: BaseException | None,
                 tb: TracebackType | None) -> bool:
        _current.reset(self._token)
        span = self._span
        span.end = self._tracer.clock()
        if exc_type is not None:
            span.status = f"error:{exc_type.__name__}"
        self._tracer.ring.export(span)
        REGISTRY.observe("nos_tpu_span_seconds", span.duration or 0.0,
                         labels={"span": span.name})
        return False


class _NoopHandle:
    """Shared do-nothing handle: a detail span that is a counter bump, or
    any span of a disabled tracer."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc: object) -> bool:
        return False


_NOOP = _NoopHandle()


class Tracer:
    """Span factory with an injectable clock and a bounded ring.
    ``detailed=True`` makes ``detail_span`` a real child span (tests,
    post-mortem captures); otherwise it is a counter bump.
    ``enabled=False`` makes every span the do-nothing handle (its
    ``with`` binds None), so journal records carry empty trace ids."""

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 ring: RingExporter | None = None,
                 enabled: bool = True, detailed: bool = False) -> None:
        self.clock = clock
        # `is not None`: an empty ring is falsy (__len__)
        self.ring = ring if ring is not None else RingExporter()
        self.enabled = enabled
        self.detailed = detailed
        # per tracer: a fresh tracer gives the same ids on every run
        self._ids = itertools.count(1)

    def span(self, name: str, **attrs: object) -> "_SpanHandle | _NoopHandle":
        """Open a span as the child of the ambient span (if any)."""
        if not self.enabled:
            return _NOOP
        parent = _current.get()
        if parent is None:
            trace_id = f"t{next(self._ids)}"
            parent_id = ""
        else:
            trace_id = parent.trace_id
            parent_id = parent.span_id
        span = Span(name, trace_id, f"s{next(self._ids)}", parent_id,
                    self.clock(), attrs or None)
        return _SpanHandle(self, span)

    def detail_span(self, name: str,
                    **attrs: object) -> "_SpanHandle | _NoopHandle":
        """A real child span in detailed mode; one counter bump on the
        enclosing span otherwise."""
        if self.detailed and self.enabled:
            return self.span(name, **attrs)
        parent = _current.get()
        if parent is not None:
            parent.bump(name)
        return _NOOP


_tracer = Tracer()


def get_tracer() -> Tracer:
    return _tracer


def set_tracer(tracer: Tracer) -> Tracer:
    """Install ``tracer`` as the process tracer; returns the previous one."""
    global _tracer
    prev = _tracer
    _tracer = tracer
    return prev


def span(name: str, **attrs: object) -> "_SpanHandle | _NoopHandle":
    return _tracer.span(name, **attrs)


def detail_span(name: str, **attrs: object) -> "_SpanHandle | _NoopHandle":
    return _tracer.detail_span(name, **attrs)


def current_span() -> Span | None:
    return _current.get()


def bump(key: str, n: int = 1) -> None:
    """Increment a counter on the ambient span, if any."""
    s = _current.get()
    if s is not None:
        s.bump(key, n)
