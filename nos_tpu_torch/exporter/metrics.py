"""In-process metrics, ``nos_tpu/exporter/metrics.py`` for the port:
counters, gauges and histograms with a Prometheus text dump.

Components call ``inc``, ``set`` and ``observe`` on the process-global
``REGISTRY``, under the JAX package's names (dashboards and SLO
objectives read them); the runtime's health server
(``cmd/_runtime.py``) serves ``render()`` at ``/metrics``.  ``value``
and ``summary`` read a series back in-process.

``observe`` records a histogram: per-series bucket counts (log-spaced
bounds from 1 ms to 60 s unless ``describe(..., buckets=...)`` or the
first ``observe(..., buckets=...)`` gives others), count, sum and a
windowed max.  ``render()`` emits ``_bucket{le=...}``, ``_sum`` and
``_count`` under ``# TYPE <name> histogram``, then the max as the gauge
``<name>_max``; ``quantile()`` estimates a quantile from the buckets.
The max is the largest observation since the last ``reset_window()``.

A histogram ``foo`` owns ``foo_bucket``, ``foo_sum``, ``foo_count`` and
``foo_max``: a counter or gauge under one of those names, or a
histogram whose derived names collide with a counter or gauge, raises.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from collections import defaultdict

from nos_tpu_torch.utils.guards import guarded_by

DEFAULT_BUCKETS: tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

_DERIVED_SUFFIXES = ("_bucket", "_sum", "_count", "_max")


def histogram_quantile(bounds: tuple[float, ...], bucket_counts,
                       count: float, q: float,
                       observed_max: float = 0.0) -> float | None:
    """Prometheus-style quantile from per-bucket (non-cumulative) counts:
    linear interpolation inside the bucket holding rank ``q * count``.
    In the +Inf bucket the estimate is max(last bound, observed max).
    None with no samples."""
    if count <= 0:
        return None
    rank = q * count
    cumulative = 0.0
    for i, n in enumerate(bucket_counts):
        if n <= 0:
            continue
        if cumulative + n >= rank:
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i]
            frac = (rank - cumulative) / n
            return lo + (hi - lo) * min(1.0, max(0.0, frac))
        cumulative += n
    return max(bounds[-1] if bounds else 0.0, observed_max)


@guarded_by("_lock", "_counters", "_gauges", "_timers", "_help",
            "_buckets", "_scalar_names")
class Registry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[tuple[str, tuple], float] = defaultdict(float)
        self._gauges: dict[tuple[str, tuple], float] = {}
        # per series: [count, sum, windowed max, non-cumulative bucket
        # counts parallel to _buckets[name]]
        self._timers: dict[tuple[str, tuple], list] = {}
        self._help: dict[str, str] = {}
        # bucket bounds per metric name: every series of a metric shares them
        self._buckets: dict[str, tuple[float, ...]] = {}
        self._scalar_names: set[str] = set()

    @staticmethod
    def _key(name: str, labels: dict | None) -> tuple[str, tuple]:
        return name, tuple(sorted((labels or {}).items()))

    def describe(self, name: str, help_text: str,
                 buckets: tuple[float, ...] | list[float] | None = None
                 ) -> None:
        """Register a metric's HELP text (and a histogram's bounds).
        Idempotent for the same text; a conflicting re-registration
        raises."""
        with self._lock:
            existing = self._help.get(name)
            if existing is not None and existing != help_text:
                raise ValueError(
                    f"metric {name!r} already registered with different "
                    f"help text ({existing!r} != {help_text!r})")
            self._help[name] = help_text
            if buckets is not None:
                self._guard_histogram_locked(name)
                self._register_buckets_locked(name, buckets)

    def _register_buckets_locked(self, name: str, buckets) -> tuple:
        bounds = tuple(float(b) for b in buckets)
        if not bounds or any(b2 <= b1 for b1, b2
                             in zip(bounds, bounds[1:])):
            raise ValueError(
                f"metric {name!r}: buckets must be non-empty and "
                f"strictly increasing, got {bounds}")
        existing = self._buckets.get(name)
        if existing is not None and existing != bounds:
            raise ValueError(
                f"metric {name!r} already has buckets {existing}, "
                f"conflicting registration {bounds}")
        self._buckets[name] = bounds
        return bounds

    def _guard_scalar_locked(self, name: str) -> None:
        if name in self._buckets:
            raise ValueError(
                f"metric {name!r} is already a histogram — scalar and "
                "histogram kinds cannot share a name")
        for suffix in _DERIVED_SUFFIXES:
            if name.endswith(suffix) \
                    and name[: -len(suffix)] in self._buckets:
                raise ValueError(
                    f"scalar metric {name!r} collides with histogram "
                    f"{name[: -len(suffix)]!r}'s derived {suffix} "
                    "series — pick a non-derived name")
        self._scalar_names.add(name)

    def _guard_histogram_locked(self, name: str) -> None:
        if name in self._scalar_names:
            raise ValueError(
                f"metric {name!r} is already a counter/gauge — scalar "
                "and histogram kinds cannot share a name")
        for suffix in _DERIVED_SUFFIXES:
            if (name + suffix) in self._scalar_names:
                raise ValueError(
                    f"histogram {name!r} would derive {name + suffix!r}, "
                    "which is already a scalar metric — pick another "
                    "name")

    def inc(self, name: str, value: float = 1.0,
            labels: dict | None = None) -> None:
        with self._lock:
            self._guard_scalar_locked(name)
            self._counters[self._key(name, labels)] += value

    def set(self, name: str, value: float,
            labels: dict | None = None) -> None:
        with self._lock:
            self._guard_scalar_locked(name)
            self._gauges[self._key(name, labels)] = value

    def observe(self, name: str, seconds: float,
                labels: dict | None = None,
                buckets: tuple[float, ...] | list[float] | None = None
                ) -> None:
        """Record one observation into ``name``'s histogram; ``buckets``
        (the first call's or describe's; a conflict raises) overrides
        DEFAULT_BUCKETS."""
        with self._lock:
            bounds = self._buckets.get(name)
            if bounds is None:
                self._guard_histogram_locked(name)
                bounds = self._register_buckets_locked(
                    name, buckets if buckets is not None
                    else DEFAULT_BUCKETS)
            elif buckets is not None:
                self._register_buckets_locked(name, buckets)
            agg = self._timers.get(key := self._key(name, labels))
            if agg is None:
                agg = self._timers[key] = [0.0, 0.0, 0.0,
                                           [0] * len(bounds)]
            agg[0] += 1
            agg[1] += seconds
            agg[2] = max(agg[2], seconds)
            idx = bisect_left(bounds, seconds)
            if idx < len(bounds):
                agg[3][idx] += 1
            # past the last bound: only the implicit +Inf bucket, whose
            # cumulative count is agg[0]

    def quantile(self, name: str, q: float,
                 labels: dict | None = None) -> float | None:
        """Quantile estimate (e.g. q=0.99) over one series' observations;
        None with no samples."""
        with self._lock:
            agg = self._timers.get(self._key(name, labels))
            if agg is None:
                return None
            bounds = self._buckets.get(name, DEFAULT_BUCKETS)
            count, _, mx, per_bucket = agg
            return histogram_quantile(bounds, per_bucket, count, q,
                                      observed_max=mx)

    def time(self, name: str, labels: dict | None = None) -> "_Timer":
        """``with REGISTRY.time("nos_tpu_plan_seconds"): ...`` observes
        the block's seconds on the host's performance counter."""
        return _Timer(self, name, labels)

    def value(self, name: str, labels: dict | None = None) -> float | None:
        """The gauge's last value or the counter's total, None if the
        series was never written."""
        key = self._key(name, labels)
        with self._lock:
            if key in self._gauges:
                return self._gauges[key]
            return self._counters[key] if key in self._counters else None

    def summary(self, name: str,
                labels: dict | None = None) -> tuple[int, float, float] | None:
        """(count, sum, windowed max) of a histogram series, None if
        never observed."""
        with self._lock:
            agg = self._timers.get(self._key(name, labels))
            return None if agg is None else (int(agg[0]), agg[1], agg[2])

    def gauge_label_values(self, name: str, key: str) -> list[str]:
        """The values label ``key`` takes across ``name``'s gauge series:
        a publisher deriving per-label gauges from live state finds the
        series to reset to 0 here."""
        with self._lock:
            values = {dict(labels).get(key)
                      for (n, labels) in self._gauges if n == name}
        return sorted(v for v in values if v is not None)

    def reset_window(self) -> None:
        """Start a new max window: zero every histogram's max (counts,
        sums and buckets are cumulative and stay)."""
        with self._lock:
            for agg in self._timers.values():
                agg[2] = 0.0

    def snapshot(self) -> dict:
        """Every series as a plain dict: histogram ``foo`` gives
        ``foo_count``, ``foo_sum``, ``foo_max`` and ``foo_bucket``, whose
        series carry a trailing ``le=`` label (cumulative counts,
        ``le=+Inf`` the count)."""
        with self._lock:
            out: dict[str, dict] = {}
            for (name, labels), v in self._counters.items():
                out.setdefault(name, {})[_series(labels)] = v
            for (name, labels), v in self._gauges.items():
                out.setdefault(name, {})[_series(labels)] = v
            for (name, labels), agg in self._timers.items():
                cnt, total, mx, per_bucket = agg
                series = _series(labels)
                out.setdefault(name + "_count", {})[series] = cnt
                out.setdefault(name + "_sum", {})[series] = total
                out.setdefault(name + "_max", {})[series] = mx
                bounds = self._buckets.get(name, DEFAULT_BUCKETS)
                bucket_out = out.setdefault(name + "_bucket", {})
                cumulative = 0
                for le, n in zip(bounds, per_bucket):
                    cumulative += n
                    bucket_out[_series_le(labels, _le_str(le))] = cumulative
                bucket_out[_series_le(labels, "+Inf")] = cnt
            return out

    def render(self) -> str:
        """Prometheus text exposition: counters, gauges, then histograms
        (``_bucket{le=}``, ``_sum``, ``_count``), then each histogram's
        ``_max`` gauge."""
        lines: list[str] = []
        with self._lock:
            seen_types: set[str] = set()

            def head(name: str, typ: str, help_name: str | None = None
                     ) -> None:
                if name in seen_types:
                    return
                seen_types.add(name)
                help_text = self._help.get(help_name or name)
                if help_text is not None:
                    lines.append(f"# HELP {name} {help_text}")
                lines.append(f"# TYPE {name} {typ}")

            for (name, labels), v in sorted(self._counters.items()):
                head(name, "counter")
                lines.append(f"{name}{_render_labels(labels)} {v}")
            for (name, labels), v in sorted(self._gauges.items()):
                head(name, "gauge")
                lines.append(f"{name}{_render_labels(labels)} {v}")
            for (name, labels), agg in sorted(self._timers.items()):
                cnt, total, mx, per_bucket = agg
                bounds = self._buckets.get(name, DEFAULT_BUCKETS)
                head(name, "histogram")
                cumulative = 0
                for le, n in zip(bounds, per_bucket):
                    cumulative += n
                    lset = labels + (("le", _le_str(le)),)
                    lines.append(
                        f"{name}_bucket{_render_labels(lset)} {cumulative}")
                lset = labels + (("le", "+Inf"),)
                lines.append(f"{name}_bucket{_render_labels(lset)} "
                             f"{int(cnt)}")
                lines.append(f"{name}_sum{_render_labels(labels)} {total}")
                lines.append(f"{name}_count{_render_labels(labels)} "
                             f"{int(cnt)}")
            # the max gauges after every histogram block, so no metric's
            # TYPE lines interleave with another's
            for (name, labels), agg in sorted(self._timers.items()):
                head(name + "_max", "gauge", help_name=name)
                lines.append(f"{name}_max{_render_labels(labels)} "
                             f"{agg[2]}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Drop every series' data; help texts, bucket layouts and the
        scalar/histogram kinds stay."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._timers.clear()


def _escape_label(val) -> str:
    """Label-value escaping of the text format: backslash, double quote
    and newline."""
    return str(val).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _le_str(bound: float) -> str:
    return f"{bound:g}"


def _render_labels(labels: tuple) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label(val)}"' for k, val in labels)
    return "{" + inner + "}"


def _series(labels: tuple) -> str:
    return ",".join(f"{k}={v}" for k, v in labels) or ""


def _series_le(labels: tuple, le: str) -> str:
    base = _series(labels)
    return f"{base},le={le}" if base else f"le={le}"


class _Timer:
    def __init__(self, reg: Registry, name: str, labels: dict | None) -> None:
        self._reg, self._name, self._labels = reg, name, labels

    def __enter__(self) -> "_Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self._reg.observe(self._name, time.perf_counter() - self._t0,
                          self._labels)
        return False


REGISTRY = Registry()
