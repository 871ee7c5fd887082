"""MIG strategy calculators and filter,
``nos_tpu/partitioning/slicepart/calculators.py`` for the port (reference
internal/partitioning/mig/{slice_calculator.go:30-37,
slice_filter.go:30-39, partitition_calculator.go:30-46}), over the
``nvidia.com/mig-<profile>`` resources."""

from __future__ import annotations

from nos_tpu_torch.kube.objects import Pod
from nos_tpu_torch.kube.resources import ResourceList, pod_request
from nos_tpu_torch.topology.profile import (
    extract_slice_requests, slice_resource_name,
)

from ..core.interfaces import (
    PartitionableNode, PartitionCalculator, ProfileRequest,
    SliceCalculator, SliceFilter,
)
from ..state import NodePartitioning, UnitPartitioning


class SliceProfileCalculator(SliceCalculator):
    def requested_profiles(self, pod: Pod) -> ProfileRequest:
        return extract_slice_requests(pod_request(pod))


class SliceProfileFilter(SliceFilter):
    def extract_profiles(self, resources: ResourceList) -> ProfileRequest:
        return {p: int(q)
                for p, q in extract_slice_requests(dict(resources)).items()}


class SlicePartitionCalculator(PartitionCalculator):
    def node_partitioning(self, node: PartitionableNode) -> NodePartitioning:
        return NodePartitioning(units=[
            UnitPartitioning(index=idx, resources={
                slice_resource_name(profile): qty
                for profile, qty in geometry.items() if qty > 0})
            for idx, geometry in sorted(node.geometries().items())])
