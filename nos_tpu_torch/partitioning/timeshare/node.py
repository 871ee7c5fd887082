"""TimeshareNode: a PartitionableNode whose GPUs are shared by memory
(MPS), ``nos_tpu/partitioning/timeshare/node.py`` for the port (reference
pkg/gpu/slicing/node.go:26-215).

One TimeshareUnit per GPU the MPS family owns, its memory the node's
GPU model's; state rebuilt from the node's status annotations; the
node's allocatable kept in step with the hypothetical geometry for the
scheduler simulation.  A TPU host's chip count follows from its
generation; a GPU node states its own (``nvidia.com/gpu.count``).
"""

from __future__ import annotations

import re

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.kube.objects import Node, Pod
from nos_tpu_torch.kube.resources import pod_request
from nos_tpu_torch.scheduler.framework import NodeInfo
from nos_tpu_torch.topology.annotations import parse_status_annotations
from nos_tpu_torch.topology.hybrid import gpu_count, timeshare_gpus
from nos_tpu_torch.topology.known import DEFAULT_REGISTRY, GpuModelRegistry
from nos_tpu_torch.topology.profile import (
    extract_timeshare_requests, is_timeshare_resource, timeshare_resource_name,
)
from nos_tpu_torch.topology.timeshare_unit import TimeshareUnit

from ..core.interfaces import PartitionableNode, ProfileRequest
from ..core.usage import claim_bound_pod_usage

# an MPS share's profile; a MIG profile ("1g.10gb") is the other family
_SHARE_RE = re.compile(r"^(\d+)gb$")


def units_from_node(node: Node,
                    registry: GpuModelRegistry = DEFAULT_REGISTRY
                    ) -> list[TimeshareUnit]:
    labels = node.metadata.labels
    model = registry.get(labels.get(C.LABEL_ACCELERATOR, ""))
    count = gpu_count(labels)
    if count is None:
        raise ValueError(f"node {node.name}: no GPU count "
                         f"({C.LABEL_GPU_COUNT}={labels.get(C.LABEL_GPU_COUNT)!r})")
    # Hybrid node: only the GPUs the MPS family owns become units
    # (topology/hybrid.py).  None = all GPUs.
    owned = timeshare_gpus(labels, count)
    units = {
        i: TimeshareUnit(memory_gb=model.memory_gb, index=i)
        for i in range(count)
        if owned is None or i in owned
    }
    for a in parse_status_annotations(node.metadata.annotations):
        m = _SHARE_RE.match(a.profile)
        if m is None:
            continue  # MIG annotation on a hybrid node
        if owned is not None and a.index not in owned:
            continue  # stale share report on a MIG-family GPU
        unit = units.setdefault(
            a.index, TimeshareUnit(memory_gb=model.memory_gb, index=a.index))
        gb = int(m.group(1))
        table = unit.used if a.status == "used" else unit.free
        table[gb] = table.get(gb, 0) + a.quantity
    return [units[i] for i in sorted(units)]


class TimeshareNode(PartitionableNode):
    def __init__(self, node: Node, node_info: NodeInfo,
                 registry: GpuModelRegistry = DEFAULT_REGISTRY) -> None:
        self._name = node.metadata.name
        self._node_info = node_info
        self.units = units_from_node(node, registry)
        self._claim_bound_pod_usage()
        self._sync_allocatable()

    # -- PartitionableNode --------------------------------------------------
    @property
    def name(self) -> str:
        return self._name

    def node_info(self) -> NodeInfo:
        return self._node_info

    def update_geometry_for(self, lacking: ProfileRequest) -> bool:
        remaining = {}
        for p, q in lacking.items():
            m = _SHARE_RE.match(p)
            if m is not None and q > 0:
                remaining[int(m.group(1))] = q
        changed = False
        for unit in self.units:
            if not remaining:
                break
            if unit.update_geometry_for(remaining):
                changed = True
            for gb in list(remaining):
                provided = unit.free.get(gb, 0)
                if provided:
                    remaining[gb] -= provided
                    if remaining[gb] <= 0:
                        del remaining[gb]
        if changed:
            self._sync_allocatable()
        return changed

    def add_pod(self, pod: Pod) -> bool:
        requests = extract_timeshare_requests(pod_request(pod))
        staged: list[tuple[TimeshareUnit, int]] = []
        for gb, qty in requests.items():
            for _ in range(qty):
                for unit in self.units:
                    if unit.allocate(gb):
                        staged.append((unit, gb))
                        break
                else:
                    for u, g in staged:
                        u.release(g)
                    return False
        self._node_info.add_pod(pod)
        return True

    def geometries(self) -> dict[int, dict[str, int]]:
        return {u.index: u.geometry_names() for u in self.units}

    def clone(self) -> "TimeshareNode":
        c = object.__new__(TimeshareNode)
        c._name = self._name
        c._node_info = self._node_info.clone()
        # direct unit copies: clone() is the unit of a fork's cost
        c.units = [u.__deepcopy__(None) for u in self.units]
        return c

    # -- internals ----------------------------------------------------------
    def _claim_bound_pod_usage(self) -> None:
        claim_bound_pod_usage(self.units, self._node_info.pods,
                              extract_timeshare_requests)

    def _sync_allocatable(self) -> None:
        alloc = self._node_info.node.status.allocatable
        for res in [r for r in alloc if is_timeshare_resource(r)]:
            del alloc[res]
        totals: dict[str, int] = {}
        for unit in self.units:
            for profile, qty in unit.geometry_names().items():
                res = timeshare_resource_name(int(profile[:-2]))
                totals[res] = totals.get(res, 0) + qty
        alloc.update(totals)
