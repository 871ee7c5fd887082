"""SliceTracker: requested and lacking profiles of a pod batch,
``nos_tpu/partitioning/core/tracker.py`` for the port (reference
internal/partitioning/core/tracker.go:26-88).
"""

from __future__ import annotations

from nos_tpu_torch.kube.objects import Pod

from .interfaces import SliceCalculator
from .snapshot import ClusterSnapshot


class SliceTracker:
    def __init__(self, snapshot: ClusterSnapshot, calculator: SliceCalculator,
                 pods: list[Pod]) -> None:
        self._calculator = calculator
        self._requested: dict[str, int] = {}
        self._lacking: dict[str, int] = {}
        self._pod_lacking: dict[str, dict[str, int]] = {}
        # Against one unchanged snapshot a pod's lacking table depends
        # only on its requested profiles: one derivation per distinct
        # request.  The shared tables are read-only (remove() pops).
        class_lacking: dict[frozenset, dict[str, int]] = {}
        for pod in pods:
            requested = calculator.requested_profiles(pod)
            if not requested:
                continue
            for profile, qty in requested.items():
                self._requested[profile] = self._requested.get(profile, 0) + qty
            key = frozenset(requested.items())
            lacking = class_lacking.get(key)
            if lacking is None:
                lacking = snapshot.get_lacking_slices(pod)
                class_lacking[key] = lacking
            if lacking:
                self._pod_lacking[pod.key] = lacking
                for profile, qty in lacking.items():
                    self._lacking[profile] = self._lacking.get(profile, 0) + qty
        self._total_lacking = sum(v for v in self._lacking.values() if v > 0)

    @property
    def requested(self) -> dict[str, int]:
        return dict(self._requested)

    @property
    def lacking(self) -> dict[str, int]:
        return {k: v for k, v in self._lacking.items() if v > 0}

    @property
    def empty(self) -> bool:
        # read once per pod in the planner's loop: an O(1) total
        return self._total_lacking <= 0

    def remove(self, pod: Pod) -> None:
        """Decrement on a placement (tracker.go Remove)."""
        lacking = self._pod_lacking.pop(pod.key, None)
        if not lacking:
            return
        for profile, qty in lacking.items():
            current = self._lacking.get(profile, 0)
            self._total_lacking -= min(qty, max(0, current))
            self._lacking[profile] = max(0, current - qty)
