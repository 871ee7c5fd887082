"""Retry on conflict for the planner's writes, ``nos_tpu/utils/retry.py``
for the port (the ``retry.RetryOnConflict`` the reference leans on at
its patch sites, k8s.io/client-go/util/retry).

``mutate`` re-reads the object on every attempt (``api.patch`` re-fetches
before calling it), so a retried patch is computed against the winner's
state.  Transport errors (OSError) are retried too, so every mutate
passed here must be idempotent against current state.  ``Backoff`` paces
the REST client's watch reconnects (``kube/rest.py``).
"""

from __future__ import annotations

import logging
import random
import time
from typing import Any, Callable

from nos_tpu_torch.exporter.metrics import REGISTRY
from nos_tpu_torch.kube.client import Conflict, TransientAPIError

logger = logging.getLogger(__name__)

# Test seam: tests replace it so injected conflicts retry at once.
sleep: Callable[[float], None] = time.sleep

# The JAX package's defaults, the only values its planner passes.
ATTEMPTS = 8
BASE_DELAY_S = 0.02
MAX_DELAY_S = 1.0
JITTER = 0.5

REGISTRY.describe("nos_tpu_retry_total",
                  "Write attempts retried after Conflict/transient errors")
REGISTRY.describe("nos_tpu_retry_exhausted_total",
                  "Writes abandoned after exhausting retry attempts")

# NotFound is not here: a vanished object is a state change, and every
# call site has its own NotFound policy.
RETRYABLE = (Conflict, OSError, TransientAPIError)


def delay_s(attempt: int) -> float:
    """Capped exponential backoff with full jitter: BASE_DELAY_S * 2^n up
    to MAX_DELAY_S, jittered over [cap * (1 - JITTER), cap]."""
    cap = min(MAX_DELAY_S, BASE_DELAY_S * (2.0 ** attempt))
    return cap * (1.0 - JITTER * random.random())


class Backoff:
    """Capped exponential backoff with full jitter for a reconnect loop:
    ``next_delay()`` grows ``base_s * factor^n`` up to ``cap_s``,
    jittered over [cap * (1 - jitter), cap], so reconnecting watchers do
    not all hit the apiserver at once; ``reset()`` after a success."""

    def __init__(self, base_s: float = 0.2, cap_s: float = 30.0,
                 factor: float = 2.0, jitter: float = 0.5,
                 rng: random.Random | None = None) -> None:
        self.base_s = base_s
        self.cap_s = cap_s
        self.factor = factor
        self.jitter = jitter
        self._rng = rng or random.Random()
        self._n = 0

    def next_delay(self) -> float:
        raw = min(self.cap_s, self.base_s * (self.factor ** self._n))
        self._n += 1
        if not self.jitter:
            return raw
        return raw * (1.0 - self.jitter * self._rng.random())

    def reset(self) -> None:
        self._n = 0


def retry_on_conflict(api, kind: str, name: str,
                      mutate: Callable[[Any], None],
                      namespace: str = "", *, component: str = "") -> Any:
    """``api.patch(kind, name, namespace, mutate=mutate)`` with jittered
    exponential backoff on Conflict and transient errors; counts each
    retried attempt in ``nos_tpu_retry_total`` and, when ATTEMPTS are
    spent, ``nos_tpu_retry_exhausted_total`` before re-raising."""
    labels = {"component": component or kind}
    last: Exception | None = None
    for attempt in range(ATTEMPTS):
        try:
            return api.patch(kind, name, namespace, mutate=mutate)
        except RETRYABLE as e:  # noqa: PERF203 — retry loop
            last = e
            REGISTRY.inc("nos_tpu_retry_total", labels=labels)
            if attempt == ATTEMPTS - 1:
                break
            delay = delay_s(attempt)
            logger.debug("retry %s %s/%s (%s, attempt %d/%d, %.3fs): %s",
                         kind, namespace, name, labels["component"],
                         attempt + 1, ATTEMPTS, delay, e)
            sleep(delay)
    REGISTRY.inc("nos_tpu_retry_exhausted_total", labels=labels)
    logger.warning("retry exhausted after %d attempts: %s %s/%s (%s): %s",
                   ATTEMPTS, kind, namespace, name, labels["component"],
                   last)
    assert last is not None
    raise last
