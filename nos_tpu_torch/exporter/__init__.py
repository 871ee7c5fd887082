"""The telemetry exporter's payload, ``nos_tpu/exporter/__init__.py`` for
the port (the reference's metricsexporter, cmd/metricsexporter/
metricsexporter.go:33-91, its schema metrics/metrics.go:24-42): a
one-shot description of the cluster (nodes and GPUs by partitioning
kind), the enabled components and this process's metric series.
``python -m nos_tpu_torch.cmd.metricsexporter`` posts or writes it.
"""

from __future__ import annotations

import time as _time

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.exporter.metrics import REGISTRY, Registry
from nos_tpu_torch.kube.client import APIServer, KIND_NODE, KIND_POD

__all__ = ["REGISTRY", "Registry", "collect"]


def collect(api: APIServer, components: dict[str, bool] | None = None,
            registry: Registry | None = None) -> dict:
    """The payload: the cluster's shape without names (nodes and GPUs
    per partitioning kind, the GPUs from ``nvidia.com/gpu.count``), the
    enabled components and the registry's series."""
    nodes = api.list(KIND_NODE)
    by_kind: dict[str, dict[str, float]] = {}
    for node in nodes:
        kind = node.metadata.labels.get(C.LABEL_PARTITIONING, "none")
        agg = by_kind.setdefault(kind, {"nodes": 0, "gpus": 0.0})
        agg["nodes"] += 1
        agg["gpus"] += float(
            node.metadata.labels.get(C.LABEL_GPU_COUNT, "0") or 0)
    pods = api.list(KIND_POD)
    return {
        "timestamp": _time.time(),
        "cluster": {
            "nodes_total": len(nodes),
            "pods_total": len(pods),
            "partitioning": by_kind,
        },
        "components": components or {},
        "metrics": (registry or REGISTRY).snapshot(),
    }
