"""Pod order for the planner, ``nos_tpu/partitioning/core/sorter.py`` for
the port (reference internal/partitioning/core/util.go:34-71): priority
descending, then the smallest requested profile first (small pods pack
before large ones fragment the geometry), then creation time, then key.
"""

from __future__ import annotations

from nos_tpu_torch.kube.objects import Pod
from nos_tpu_torch.topology.profile import profile_sort_key

from .interfaces import SliceCalculator, Sorter


class ProfileAwareSorter(Sorter):
    def __init__(self, calculator: SliceCalculator) -> None:
        self._calculator = calculator

    def sort(self, pods: list[Pod]) -> list[Pod]:
        def key(pod: Pod):
            requested = self._calculator.requested_profiles(pod)
            smallest = min(
                (profile_sort_key(p) for p in requested), default=(0, "")
            )
            return (
                -pod.spec.priority,
                smallest,
                pod.metadata.creation_timestamp,
                pod.key,
            )

        return sorted(pods, key=key)
