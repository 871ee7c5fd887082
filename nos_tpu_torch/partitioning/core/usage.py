"""Bound-pod usage claiming, ``nos_tpu/partitioning/core/usage.py`` for
the port.

A pod bound since the node's last report holds a profile the status
annotations still show as free; before planning, the snapshot node marks
that demand used, so a geometry update never sacrifices an allocated
profile.  The node's next report makes it authoritative.
"""

from __future__ import annotations

from typing import Callable, Iterable, Mapping

from nos_tpu_torch.kube.objects import Pod
from nos_tpu_torch.kube.resources import pod_request


def claim_bound_pod_usage(units: Iterable, pods: Iterable[Pod],
                          extract: Callable[[Mapping], Mapping]) -> None:
    """``units`` expose ``.used`` (profile key -> count) and
    ``.allocate(key) -> bool``; ``extract`` maps a resource list to the
    strategy's profile requests."""
    units = list(units)
    demand: dict = {}
    for pod in pods:
        for key, qty in extract(pod_request(pod)).items():
            demand[key] = demand.get(key, 0) + qty
    for key, wanted in demand.items():
        reported = sum(u.used.get(key, 0) for u in units)
        for _ in range(max(0, wanted - reported)):
            for unit in units:
                if unit.allocate(key):
                    break
