"""Resource-list arithmetic, ``nos_tpu/kube/resources.py`` for the port.

A ResourceList is a plain ``dict[str, float]``; the helpers are pure
functions returning new dicts (reference pkg/resource/resource.go:57-146).
"""

from __future__ import annotations

from typing import Mapping

ResourceList = dict[str, float]


def sum_resources(a: Mapping[str, float], b: Mapping[str, float]) -> ResourceList:
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0.0) + v
    return out


def subtract(a: Mapping[str, float], b: Mapping[str, float]) -> ResourceList:
    """a - b, keeping negative values (lacking-resource detection)."""
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0.0) - v
    return out


def subtract_non_negative(a: Mapping[str, float],
                          b: Mapping[str, float]) -> ResourceList:
    """a - b, negative values clamped to 0."""
    return {k: max(0.0, v) for k, v in subtract(a, b).items()}


def max_resources(a: Mapping[str, float], b: Mapping[str, float]) -> ResourceList:
    out = dict(a)
    for k, v in b.items():
        out[k] = max(out.get(k, 0.0), v)
    return out


def negatives_only(a: Mapping[str, float]) -> ResourceList:
    """Keep only strictly negative entries, as positive magnitudes."""
    return {k: -v for k, v in a.items() if v < 0}


def fits(request: Mapping[str, float], available: Mapping[str, float]) -> bool:
    return all(available.get(k, 0.0) >= v for k, v in request.items() if v > 0)


def pod_request(pod) -> ResourceList:
    """Effective pod request: max(max(initContainers), sum(containers))
    + overhead (reference pkg/resource/resource.go:127-146)."""
    total: ResourceList = {}
    for c in pod.spec.containers:
        total = sum_resources(total, c.resources)
    for ic in pod.spec.init_containers:
        total = max_resources(total, ic.resources)
    if pod.spec.overhead:
        total = sum_resources(total, pod.spec.overhead)
    return total
