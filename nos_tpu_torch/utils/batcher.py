"""A batcher with a timeout and an idle window, ``nos_tpu/utils/batcher.py``
for the port (reference pkg/util/batcher.go:25-130, ``util.Batcher[T]``).

A batch is ready once ``timeout_s`` has passed since its first add, or
``idle_s`` since its last.  The reference runs goroutines and channels;
here the clock is injected and the controller's loop polls ``ready()``,
which keeps the loop deterministic under a test's clock.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Generic, TypeVar

from nos_tpu_torch.utils.guards import guarded_by

T = TypeVar("T")


@guarded_by("_lock", "_items", "_first_add", "_last_add")
class Batcher(Generic[T]):
    def __init__(self, timeout_s: float, idle_s: float,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.timeout_s = timeout_s
        self.idle_s = idle_s
        self._clock = clock
        self._lock = threading.Lock()
        self._items: dict[str, T] = {}
        self._first_add: float | None = None
        self._last_add: float | None = None

    def add(self, key: str, item: T) -> None:
        """A duplicate key refreshes the item; the idle window restarts
        either way (batcher.go Add).  Watch callbacks add while the
        controller's loop reads and drains."""
        with self._lock:
            now = self._clock()
            if self._first_add is None:
                self._first_add = now
            self._last_add = now
            self._items[key] = item

    def ready(self) -> bool:
        with self._lock:
            if self._first_add is None:
                return False
            now = self._clock()
            if now - self._first_add >= self.timeout_s:
                return True
            last = self._last_add if self._last_add is not None else now
            return now - last >= self.idle_s

    def drain(self) -> list[T]:
        with self._lock:
            items = list(self._items.values())
            self._items.clear()
            self._first_add = None
            self._last_add = None
            return items

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)
