"""The strategy seam of the partitioning engine,
``nos_tpu/partitioning/core/interfaces.py`` for the port (reference
internal/partitioning/core/interface.go:27-77).  Nothing in ``core/``
imports a concrete strategy: the MPS strategy (``timeshare/``) plugs in
here, and so does the MIG strategy (``slicepart/``).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import TYPE_CHECKING, Collection

from nos_tpu_torch.kube.objects import Pod
from nos_tpu_torch.kube.resources import ResourceList

from ..state import NodePartitioning

if TYPE_CHECKING:
    from nos_tpu_torch.scheduler.framework import NodeInfo
    from ..state import PartitioningState
    from .snapshot import ClusterSnapshot

# Profile names are strings: a MIG profile ("3g.40gb") or a share ("24gb").
ProfileRequest = dict[str, int]


class PartitionableNode(ABC):
    """A node whose GPUs' geometry can be re-carved."""

    @property
    @abstractmethod
    def name(self) -> str: ...

    @abstractmethod
    def node_info(self) -> "NodeInfo":
        """The scheduling view; update_geometry_for must rewrite its
        allocatable so the simulation sees the hypothetical geometry
        (reference pkg/gpu/mig/node.go:171-195)."""

    @abstractmethod
    def update_geometry_for(self, lacking: ProfileRequest) -> bool: ...

    @abstractmethod
    def add_pod(self, pod: Pod) -> bool:
        """First-fit the pod's profile requests onto free devices."""

    @abstractmethod
    def geometries(self) -> dict[int, dict[str, int]]:
        """GPU index -> profile -> quantity (the desired geometry)."""

    @abstractmethod
    def clone(self) -> "PartitionableNode": ...


class SliceCalculator(ABC):
    """Pod -> requested profiles (reference mig/slice_calculator.go:30-37)."""

    @abstractmethod
    def requested_profiles(self, pod: Pod) -> ProfileRequest: ...


class SliceFilter(ABC):
    """Restrict a resource list to this strategy's profile resources
    (reference mig/slice_filter.go:30-39)."""

    @abstractmethod
    def extract_profiles(self, resources: ResourceList) -> ProfileRequest: ...


class PartitionCalculator(ABC):
    """Node geometry -> desired NodePartitioning
    (reference mig/partitition_calculator.go:30-46)."""

    @abstractmethod
    def node_partitioning(self, node: PartitionableNode) -> NodePartitioning: ...


class Partitioner(ABC):
    """Actuation strategy: write the desired partitioning where the node
    side picks it up (reference mig/partitioner.go:43-75,
    mps/partitioner.go:61-157)."""

    @abstractmethod
    def apply_partitioning(self, node_name: str, plan_id: str,
                           partitioning: NodePartitioning) -> None: ...


class NodeInitializer(ABC):
    """Give a virgin node its first geometry (reference
    mig/initializer.go:44-83)."""

    @abstractmethod
    def init_node_partitioning(self, node_name: str) -> None: ...


class SnapshotTaker(ABC):
    """Build a strategy's snapshot from cluster state (reference
    mig/snapshot_taker.go:31-53).  ``exclude`` names nodes that must not
    appear in it."""

    @abstractmethod
    def take_snapshot(self, cluster_state,
                      exclude: Collection[str] = ()) -> "ClusterSnapshot": ...


class Sorter(ABC):
    @abstractmethod
    def sort(self, pods: list[Pod]) -> list[Pod]: ...


class Planner(ABC):
    @abstractmethod
    def plan(self, snapshot: "ClusterSnapshot",
             pending_pods: list[Pod]) -> "PartitioningState": ...


class Actuator(ABC):
    @abstractmethod
    def apply(self, snapshot: "ClusterSnapshot",
              desired: "PartitioningState") -> bool: ...
