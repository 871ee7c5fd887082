"""The bounded ring shared by the span ring and the decision journal,
``nos_tpu/obs/_ring.py`` for the port: the newest ``maxlen`` items are
kept and the evicted ones counted."""

from __future__ import annotations

import threading
from collections import deque

from nos_tpu_torch.utils.guards import guarded_by


@guarded_by("_lock", "_items", "_dropped")
class BoundedRing:
    """Lock-guarded ``deque(maxlen)`` with an eviction counter.  A
    subclass appends through ``_push_locked`` with ``self._lock`` held and
    bumps its eviction metric outside the lock.  Items expose
    ``to_dict()``."""

    def __init__(self, maxlen: int) -> None:
        self.maxlen = maxlen
        self._lock = threading.Lock()
        self._items: deque = deque(maxlen=maxlen)
        self._dropped = 0

    def _push_locked(self, item: object) -> bool:
        """Append (caller holds ``self._lock``); True if one was evicted."""
        evicted = len(self._items) == self.maxlen
        if evicted:
            self._dropped += 1
        self._items.append(item)
        return evicted

    def dump(self) -> list[dict]:
        with self._lock:
            items = list(self._items)
        return [i.to_dict() for i in items]

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)
