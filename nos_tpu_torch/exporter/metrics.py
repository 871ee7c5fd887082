"""In-process gauges, the gauge part of ``nos_tpu/exporter/metrics.py``'s
``Registry``: ``describe`` a metric once, ``set`` it, read it back with
``value``.  ``REGISTRY`` is the process's registry, which the train main
sets under the JAX package's names (dashboards and SLO objectives read
them).  Serving it at ``/metrics`` needs the control plane's health
server, which the port does not have yet.
"""

from __future__ import annotations

import threading


class Registry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._gauges: dict[tuple[str, tuple], float] = {}
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

    def value(self, name: str, labels: dict | None = None) -> float | None:
        """The gauge's last value, None if it was never set."""
        with self._lock:
            return self._gauges.get(self._key(name, labels))


REGISTRY = Registry()
