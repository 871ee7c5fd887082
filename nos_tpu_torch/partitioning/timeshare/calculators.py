"""MPS strategy calculators and filter,
``nos_tpu/partitioning/timeshare/calculators.py`` for the port (reference
internal/partitioning/mps/{slice_calculator.go, slice_filter.go,
partition_calculator.go})."""

from __future__ import annotations

from nos_tpu_torch.kube.objects import Pod
from nos_tpu_torch.kube.resources import ResourceList, pod_request
from nos_tpu_torch.topology.profile import (
    extract_timeshare_requests, timeshare_resource_name,
)

from ..core.interfaces import (
    PartitionableNode, PartitionCalculator, ProfileRequest,
    SliceCalculator, SliceFilter,
)
from ..state import NodePartitioning, UnitPartitioning


class TimeshareProfileCalculator(SliceCalculator):
    def requested_profiles(self, pod: Pod) -> ProfileRequest:
        return {
            f"{gb}gb": q
            for gb, q in extract_timeshare_requests(pod_request(pod)).items()
        }


class TimeshareProfileFilter(SliceFilter):
    def extract_profiles(self, resources: ResourceList) -> ProfileRequest:
        return {
            f"{gb}gb": int(q)
            for gb, q in extract_timeshare_requests(dict(resources)).items()
        }


class TimesharePartitionCalculator(PartitionCalculator):
    def node_partitioning(self, node: PartitionableNode) -> NodePartitioning:
        units = []
        for idx, geometry in sorted(node.geometries().items()):
            units.append(UnitPartitioning(
                index=idx,
                resources={
                    timeshare_resource_name(int(profile[:-2])): qty
                    for profile, qty in geometry.items() if qty > 0
                },
            ))
        return NodePartitioning(units=units)
