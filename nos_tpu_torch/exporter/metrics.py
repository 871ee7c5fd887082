"""In-process metrics, the part of ``nos_tpu/exporter/metrics.py``'s
``Registry`` the port sets: ``describe`` a metric once; ``set`` a gauge,
``inc`` a counter, ``observe`` a duration (count, sum and max per
series) or time a block with ``time``; read them back with ``value``
and ``summary``.  ``REGISTRY`` is the process's registry, under the JAX
package's names (dashboards and SLO objectives read them): the train
main's gauges, the actuator's, the quarantine's, the controller's and
the retry's counters, the plan and actuation clocks, the tracer's span
seconds.  Serving it at ``/metrics`` needs the control plane's health
server, which the port does not have yet.
"""

from __future__ import annotations

import threading
import time


class Registry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._gauges: dict[tuple[str, tuple], float] = {}
        self._counters: dict[tuple[str, tuple], float] = {}
        # per series: [count, sum, max]
        self._observed: dict[tuple[str, tuple], list[float]] = {}
        self._help: dict[str, str] = {}

    @staticmethod
    def _key(name: str, labels: dict | None) -> tuple[str, tuple]:
        return name, tuple(sorted((labels or {}).items()))

    def describe(self, name: str, help_text: str) -> None:
        """Register a metric's HELP text.  Idempotent for the same text;
        a conflicting re-registration raises."""
        with self._lock:
            existing = self._help.get(name)
            if existing is not None and existing != help_text:
                raise ValueError(
                    f"metric {name!r} already registered with different "
                    f"help text ({existing!r} != {help_text!r})")
            self._help[name] = help_text

    def set(self, name: str, value: float,
            labels: dict | None = None) -> None:
        with self._lock:
            self._gauges[self._key(name, labels)] = value

    def inc(self, name: str, amount: float = 1.0,
            labels: dict | None = None) -> None:
        key = self._key(name, labels)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + amount

    def observe(self, name: str, value: float,
                labels: dict | None = None) -> None:
        key = self._key(name, labels)
        with self._lock:
            s = self._observed.setdefault(key, [0, 0.0, value])
            s[0] += 1
            s[1] += value
            s[2] = max(s[2], value)

    def time(self, name: str, labels: dict | None = None) -> "_Timer":
        """``with REGISTRY.time("nos_tpu_plan_seconds"): ...`` observes
        the block's seconds on the host's performance counter."""
        return _Timer(self, name, labels)

    def value(self, name: str, labels: dict | None = None) -> float | None:
        """The gauge's last value or the counter's total, None if the
        series was never written."""
        key = self._key(name, labels)
        with self._lock:
            return self._gauges.get(key, self._counters.get(key))

    def summary(self, name: str,
                labels: dict | None = None) -> tuple[int, float, float] | None:
        """(count, sum, max) of an observed series, None if never observed."""
        with self._lock:
            s = self._observed.get(self._key(name, labels))
            return None if s is None else (int(s[0]), s[1], s[2])


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
