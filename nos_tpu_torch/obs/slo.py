"""Declarative SLOs over the sampled registry, ``nos_tpu/obs/slo.py`` for
the port: error-budget burn rates.

An ``SLOObjective`` states a promise ("a class's p99 schedule latency
stays under 30 s"), and ``SLOEngine`` judges it on error-budget burn
over two windows, not on one sample.  With compliance ``c`` (default
0.99) the budget is the ``1 - c`` share of events allowed to be bad;
the burn rate is how many times faster than that a window spent it.  A
breach needs both the fast window (is it happening now?) and the slow
one (does it matter?) to burn at or above the threshold.

Kinds:

- ``latency``: events are a histogram's observations; bad is above
  ``target`` seconds, judged at the largest bucket bound at or below
  it.  ``each_label`` fans an objective out to one verdict per value
  of that label;
- ``gauge_floor``: events are a gauge's samples; bad is below
  ``target``;
- ``rate_ceiling``: a counter's increase per second over ``target``.

Verdict transitions are journaled as ``slo-breach`` and
``slo-recovered`` with the ambient trace, so ``python -m
nos_tpu_torch.obs slo`` can name the breaching class and, through the
journal's rejections, the rejecting plugin.  One run loop drives the
engine (``Main.attach_slo``): ``tick()`` samples, then judges.  It
holds no lock of its own and reaches the journal only through
``record()``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

from nos_tpu_torch.exporter.metrics import histogram_quantile

from . import journal as J
from .journal import record as journal_record
from .timeseries import SamplePoint, TimeSeriesSampler
from .trace import span as obs_span

#: (start, end) spanning one window, None while it is not observable
Bracket = tuple[SamplePoint, SamplePoint] | None
#: (burn rate, reported value, budget remaining); Nones without data
BurnTriple = tuple[float | None, float | None, float | None]

LATENCY = "latency"
GAUGE_FLOOR = "gauge_floor"
RATE_CEILING = "rate_ceiling"


@dataclass(frozen=True)
class SLOObjective:
    """One objective (the module docstring has the kinds)."""

    name: str
    kind: str                      # latency | gauge_floor | rate_ceiling
    metric: str                    # the base name, no derived suffix
    target: float                  # seconds / floor / rate per second
    labels: tuple = ()             # series selector ((key, value), ...)
    each_label: str = ""           # one verdict per value of this label
    compliance: float = 0.99      # the good share the objective promises
    quantile: float = 0.99        # the reported quantile (latency)
    # events a window needs before it is judged (latency): one slow
    # event in a quiet class reads "not yet observable", not a breach
    min_events: int = 1

    def __post_init__(self) -> None:
        if self.kind not in (LATENCY, GAUGE_FLOOR, RATE_CEILING):
            raise ValueError(f"unknown SLO kind {self.kind!r}")
        if not (0.0 < self.compliance < 1.0):
            raise ValueError("compliance must be in (0, 1)")
        if self.target <= 0.0:
            # a zero ceiling makes the burn infinite, which json.dumps
            # writes as the non-JSON token Infinity
            raise ValueError("target must be > 0 (zero-tolerance "
                             "ceilings: use a tiny positive target)")
        if isinstance(self.labels, dict):
            object.__setattr__(self, "labels",
                               tuple(sorted(self.labels.items())))


def _parse_series(series: str) -> dict[str, str]:
    """"k=v,k2=v2" -> dict ("" -> {}), the registry's series key read
    back."""
    if not series:
        return {}
    out: dict[str, str] = {}
    for part in series.split(","):
        k, _, v = part.partition("=")
        out[k] = v
    return out


def _matches(labels: dict[str, str], selector: tuple) -> bool:
    return all(labels.get(k) == str(v) for k, v in selector)


class SLOEngine:
    """Judges objectives on the sampler's windows and journals verdict
    transitions.  One loop calls ``tick()`` or ``evaluate()`` (the
    breach latch is not locked); readers take ``report()``."""

    def __init__(self, sampler: TimeSeriesSampler,
                 objectives: list[SLOObjective],
                 fast_window_s: float = 60.0,
                 slow_window_s: float = 300.0,
                 burn_threshold: float = 2.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self._sampler = sampler
        self._objectives = list(objectives)
        self._fast_s = fast_window_s
        self._slow_s = slow_window_s
        self._burn_threshold = burn_threshold
        self._clock = clock
        # (objective name, fan-out value) -> breached now
        self._breached: dict[tuple[str, str], bool] = {}
        # each judged key's (objective, fan-out, selector): a breached
        # class whose series vanish is judged again, and recovers,
        # instead of dropping out of the report with its latch stuck
        self._judged_ctx: dict[tuple[str, str],
                               tuple[SLOObjective, str, tuple]] = {}
        self._last_verdicts: list[dict] = []

    @property
    def sampler(self) -> TimeSeriesSampler:
        return self._sampler

    @property
    def objectives(self) -> list[SLOObjective]:
        return list(self._objectives)

    def tick(self) -> list[dict]:
        """Sample the registry, then judge every objective."""
        self._sampler.tick()
        return self.evaluate()

    # -- evaluation ----------------------------------------------------------
    def evaluate(self) -> list[dict]:
        """One verdict per objective and fan-out value; a transition is
        journaled inside the ``slo.evaluate`` span."""
        fast = self._sampler.bracket(self._fast_s)
        slow = self._sampler.bracket(self._slow_s)
        verdicts: list[dict] = []
        seen: set[tuple[str, str]] = set()
        with obs_span("slo.evaluate", objectives=len(self._objectives)):
            for obj in self._objectives:
                for fanout, selector in self._expand(obj):
                    seen.add((obj.name, fanout))
                    verdicts.append(
                        self._judge(obj, fanout, selector, fast, slow))
            # breached keys whose series vanished: judged anyway, so the
            # breach resolves (no data burns nothing) in journal and
            # report
            for key in [k for k, br in self._breached.items()
                        if k not in seen]:
                if self._breached[key]:
                    obj, fanout, selector = self._judged_ctx[key]
                    verdicts.append(
                        self._judge(obj, fanout, selector, fast, slow))
                else:
                    del self._breached[key]
                    del self._judged_ctx[key]
        self._last_verdicts = verdicts
        return verdicts

    def _expand(self, obj: SLOObjective) -> list[tuple[str, tuple]]:
        """(fan-out value, full selector) pairs: the static selector
        alone, or one per value of ``each_label`` in the newest
        sample."""
        if not obj.each_label:
            return [("", obj.labels)]
        latest = self._sampler.latest()
        if latest is None:
            return []
        suffix = "_count" if obj.kind == LATENCY else ""
        seen: set[str] = set()
        out: list[tuple[str, tuple]] = []
        for series in latest.values.get(obj.metric + suffix, {}):
            labels = _parse_series(series)
            value = labels.get(obj.each_label)
            if value is None or value in seen:
                continue
            if not _matches(labels, obj.labels):
                continue
            seen.add(value)
            out.append((value, obj.labels + ((obj.each_label, value),)))
        return sorted(out)

    def _judge(self, obj: SLOObjective, fanout: str, selector: tuple,
               fast: Bracket, slow: Bracket) -> dict:
        if obj.kind == LATENCY:
            burn_fast, _, _ = self._latency_burn(obj, selector, fast)
            burn_slow, quantile, budget = self._latency_burn(
                obj, selector, slow)
            value = quantile
        elif obj.kind == GAUGE_FLOOR:
            burn_fast, _, _ = self._gauge_burn(obj, selector, fast)
            burn_slow, value, budget = self._gauge_burn(
                obj, selector, slow)
        else:   # RATE_CEILING
            burn_fast, _, _ = self._rate_burn(obj, selector, fast)
            burn_slow, value, budget = self._rate_burn(
                obj, selector, slow)

        # a window that is not observable (None) is never a breach and
        # never a recovery either
        breached = (burn_fast is not None and burn_slow is not None
                    and burn_fast >= self._burn_threshold
                    and burn_slow >= self._burn_threshold)
        verdict = {
            "objective": obj.name,
            "kind": obj.kind,
            "metric": obj.metric,
            "labels": dict(selector),
            "class": fanout or dict(selector).get("class", ""),
            "target": obj.target,
            "value": value,
            "burn_fast": burn_fast,
            "burn_slow": burn_slow,
            "budget_remaining": budget,
            "breached": breached,
        }
        key = (obj.name, fanout)
        self._judged_ctx[key] = (obj, fanout, selector)
        was = self._breached.get(key, False)
        if breached != was:
            self._breached[key] = breached
            journal_record(
                J.SLO_BREACH if breached else J.SLO_RECOVERED,
                obj.name + (f"/{fanout}" if fanout else ""),
                kind=obj.kind, metric=obj.metric,
                slo_class=verdict["class"], target=obj.target,
                value=value, burn_fast=burn_fast, burn_slow=burn_slow,
                budget_remaining=budget)
        return verdict

    # -- per-kind window arithmetic -----------------------------------------
    @staticmethod
    def _each_series_delta(name: str, selector: tuple,
                           start: SamplePoint, end: SamplePoint
                           ) -> list[tuple[str | None, float]]:
        """(le label, delta) per series of ``name`` matching
        ``selector`` between the bracket's ends.  A negative delta means
        the registry was reset inside the window: the end value is the
        delta then."""
        out: list[tuple[str | None, float]] = []
        for series, v_end in end.values.get(name, {}).items():
            labels = _parse_series(series)
            le = labels.pop("le", None)
            if not _matches(labels, selector):
                continue
            v_start = start.values.get(name, {}).get(series, 0.0)
            delta = v_end - v_start
            if delta < 0:
                delta = v_end
            out.append((le, delta))
        return out

    def _delta_total(self, name: str, selector: tuple,
                     bracket: Bracket) -> float | None:
        if bracket is None:
            return None
        return sum(d for _, d in self._each_series_delta(
            name, selector, *bracket))

    def _delta_by_le(self, name: str, selector: tuple,
                     bracket: Bracket) -> dict[str, float]:
        assert bracket is not None
        out: dict[str, float] = {}
        for le, delta in self._each_series_delta(name, selector,
                                                 *bracket):
            if le is not None:
                out[le] = out.get(le, 0.0) + delta
        return out

    def _latency_burn(self, obj: SLOObjective, selector: tuple,
                      bracket: Bracket) -> BurnTriple:
        """(burn, quantile, budget remaining) of a histogram over one
        window."""
        if bracket is None:
            return None, None, None
        total = self._delta_total(obj.metric + "_count", selector,
                                  bracket)
        if not total or total < obj.min_events:
            return None, None, None
        by_le = self._delta_by_le(obj.metric + "_bucket", selector,
                                  bracket)
        bounds = sorted((float(le) for le in by_le if le != "+Inf"))
        cumulative = [by_le[f"{b:g}"] for b in bounds]
        # the good events, conservatively: those at or below the largest
        # bound at or below the target
        good = 0.0
        for b, c in zip(bounds, cumulative):
            if b <= obj.target:
                good = c
            else:
                break
        bad_fraction = max(0.0, 1.0 - good / total)
        allowed = 1.0 - obj.compliance
        burn = bad_fraction / allowed
        budget = 1.0 - burn
        per_bucket = [cumulative[0]] + [
            cumulative[i] - cumulative[i - 1]
            for i in range(1, len(cumulative))]
        quantile = histogram_quantile(tuple(bounds), per_bucket, total,
                                      obj.quantile)
        return burn, quantile, budget

    def _gauge_burn(self, obj: SLOObjective, selector: tuple,
                    bracket: Bracket) -> BurnTriple:
        """The share of sample points below the floor, as a burn."""
        if bracket is None:
            return None, None, None
        start, end = bracket
        pts = [p for p in self._sampler.points()
               if start.ts <= p.ts <= end.ts]
        total = 0
        bad = 0
        newest: float | None = None
        for p in pts:
            for series, v in p.values.get(obj.metric, {}).items():
                if not _matches(_parse_series(series), selector):
                    continue
                total += 1
                newest = v
                if v < obj.target:
                    bad += 1
        if total == 0:
            return None, None, None
        burn = (bad / total) / (1.0 - obj.compliance)
        return burn, newest, 1.0 - burn

    def _rate_burn(self, obj: SLOObjective, selector: tuple,
                   bracket: Bracket) -> BurnTriple:
        """A counter's increase per second against the ceiling."""
        if bracket is None:
            return None, None, None
        start, end = bracket
        seconds = end.ts - start.ts
        if seconds <= 0:
            return None, None, None
        delta = self._delta_total(obj.metric, selector, bracket)
        rate = (delta or 0.0) / seconds
        burn = rate / obj.target
        return burn, rate, 1.0 - burn

    # -- surfaces ------------------------------------------------------------
    def report(self) -> dict:
        """The ``/debug/slo`` payload: the configuration and the latest
        verdicts (a flight snapshot's ``slo`` block)."""
        return {
            "ts": self._clock(),
            "fast_window_s": self._fast_s,
            "slow_window_s": self._slow_s,
            "burn_threshold": self._burn_threshold,
            "objectives": [
                {"name": o.name, "kind": o.kind, "metric": o.metric,
                 "target": o.target, "labels": dict(o.labels),
                 "each_label": o.each_label, "compliance": o.compliance}
                for o in self._objectives],
            "verdicts": list(self._last_verdicts),
        }


# The process engine, swappable like the tracer: a main installs one so
# that /debug/slo and the flight snapshot serve it.
_engine: SLOEngine | None = None


def get_engine() -> SLOEngine | None:
    return _engine


def set_engine(engine: SLOEngine | None) -> SLOEngine | None:
    global _engine
    prev = _engine
    _engine = engine
    return prev


def default_objectives() -> list[SLOObjective]:
    """The objectives a main installs when SLOs are on and none are
    configured, the JAX package's three: per-class p99 schedule latency,
    per-pool actuation latency and per-service request latency.  The
    port has no request router yet (ROADMAP item 9 part 2), so the last
    observes nothing and reads "not yet observable", as it does in a
    JAX deployment without the router."""
    return [
        SLOObjective(
            name="schedule-latency", kind=LATENCY,
            metric="nos_tpu_schedule_latency_seconds",
            target=30.0, each_label="class"),
        SLOObjective(
            name="actuation-latency", kind=LATENCY,
            metric="nos_tpu_actuation_latency_seconds",
            target=30.0, each_label="pool"),
        SLOObjective(
            name="request-latency", kind=LATENCY,
            metric="nos_tpu_request_latency_seconds",
            target=10.0, labels={"phase": "total"},
            each_label="service", min_events=5),
    ]
