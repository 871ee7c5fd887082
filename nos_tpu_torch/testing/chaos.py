"""A seeded chaos substrate over the in-memory API server,
``nos_tpu/testing/chaos.py``'s ``ChaosAPIServer`` for the port.

The control plane's robustness claims (retry on conflict at every write
site, quarantine in place of a cluster-wide stall, recovery from lost
watch events) are exercised by soak runs against this substrate.  Every
fault is drawn from one ``random.Random(seed)``, so a failing soak
reproduces from its seed alone, and the same seed and operations draw
the same faults as the JAX package's substrate.

Faults, as a loaded kube-apiserver gives them:

- **Conflict** on update and patch: the optimistic-concurrency 409 that
  every writer must retry (``utils/retry.py``);
- **transient errors** (``ConnectionError``) on update and patch: a
  reset connection or a timeout, retried the same way;
- **watch-event drops**: an event is withheld from one watcher, and the
  object's current state is replayed a few operations later, as an
  informer resyncs after a reconnect.  Level-triggered watchers must
  converge through it.

Faults fire on update and patch only: creates and deletes are a test's
own set-up, and the failures above are read-modify-write races.  Reads
stay exact, so a test's assertions see the true state.  It subclasses
``APIServer`` so that code gated on the in-memory substrate (the
kubelet's admission) walks through its gates.  The JAX substrate's
injected latency and its per-kind fault filter have no caller in the
port and are left out; the chaotic cloud API of the capacity plane
comes with ``capacity/`` (ROADMAP item 9).
"""

from __future__ import annotations

import random
import threading
from typing import Any, Callable

from nos_tpu_torch.kube.client import APIServer, Conflict, WatchFn


class ChaosAPIServer(APIServer):
    """An APIServer that injects faults, deterministic per seed while
    one thread drives the control plane."""

    def __init__(self, seed: int = 0, *,
                 conflict_rate: float = 0.0,
                 transient_rate: float = 0.0,
                 drop_watch_rate: float = 0.0,
                 replay_after_ops: int = 8) -> None:
        super().__init__()
        self.seed = seed
        self._rng = random.Random(seed)
        self._conflict_rate = conflict_rate
        self._transient_rate = transient_rate
        self._drop_watch_rate = drop_watch_rate
        self._replay_after_ops = max(1, replay_after_ops)
        self._chaos_lock = threading.RLock()
        self._ops = 0
        # (watcher, kind, name, namespace, the event's object)
        self._dropped: list[tuple[WatchFn, str, str, str, Any]] = []
        self.stats = {"conflicts": 0, "transients": 0, "drops": 0,
                      "replays": 0}

    # -- fault machinery ----------------------------------------------------
    def _pre_write(self, kind: str, op: str) -> None:
        with self._chaos_lock:
            roll = self._rng.random()
            if roll < self._conflict_rate:
                self.stats["conflicts"] += 1
                raise Conflict(
                    f"chaos(seed={self.seed}): injected conflict on "
                    f"{op} {kind}")
            if roll < self._conflict_rate + self._transient_rate:
                self.stats["transients"] += 1
                raise ConnectionError(
                    f"chaos(seed={self.seed}): injected transient error "
                    f"on {op} {kind}")

    def _tick_ops(self) -> None:
        with self._chaos_lock:
            self._ops += 1
            due = self._ops % self._replay_after_ops == 0
        if due:
            self.replay_dropped()

    def replay_dropped(self) -> None:
        """The reconnect: each withheld event's object is read again and
        delivered at its current state (MODIFIED), or as DELETED if it
        is gone.  Delivered under the store lock, as the live bus
        delivers.  In the middle of a delivery the events stay withheld:
        delivering now would hand a watcher newer state before older
        events still queued; the next boundary delivers them.  Like the
        bus, it drains fully and raises the first watcher error after."""
        with self._lock:
            if self._delivering:
                return
            with self._chaos_lock:
                pending, self._dropped = self._dropped, []
            first_exc: BaseException | None = None
            for fn, kind, name, namespace, obj in pending:
                cur = self.try_get(kind, name, namespace)
                self.stats["replays"] += 1
                try:
                    if cur is not None:
                        fn("MODIFIED", cur)
                    else:
                        fn("DELETED", obj)
                except BaseException as e:
                    if first_exc is None:
                        first_exc = e
            if first_exc is not None:
                raise first_exc

    # -- the APIServer surface ----------------------------------------------
    def update(self, kind: str, obj: Any) -> Any:
        self._pre_write(kind, "update")
        out = super().update(kind, obj)
        self._tick_ops()
        return out

    def patch(self, kind: str, name: str, namespace: str = "", *,
              mutate: Callable[[Any], None]) -> Any:
        self._pre_write(kind, "patch")
        out = super().patch(kind, name, namespace, mutate=mutate)
        self._tick_ops()
        return out

    def create(self, kind: str, obj: Any) -> Any:
        out = super().create(kind, obj)
        self._tick_ops()
        return out

    def delete(self, kind: str, name: str, namespace: str = "") -> None:
        super().delete(kind, name, namespace)
        self._tick_ops()

    def watch(self, kind: str, fn: WatchFn,
              selector: Callable[[Any], bool] | None = None
              ) -> Callable[[], None]:
        def chaotic(event: str, obj: Any) -> None:
            with self._chaos_lock:
                drop = self._rng.random() < self._drop_watch_rate
                if drop:
                    self.stats["drops"] += 1
                    self._dropped.append((
                        fn, kind, obj.metadata.name,
                        getattr(obj.metadata, "namespace", ""), obj))
            if not drop:
                fn(event, obj)

        # the selector runs before the drop, so a replayed event had
        # passed it
        return super().watch(kind, chaotic, selector=selector)
