"""SliceNode: a PartitionableNode whose GPUs are carved into MIG
instances, ``nos_tpu/partitioning/slicepart/node.py`` for the port
(reference pkg/gpu/mig/node.go:26-222).

One ``SliceUnit`` per GPU the MIG family owns: every GPU of a ``mig``
node, the leading half of a ``hybrid`` one (``topology/hybrid.py``).
The count comes from the node's ``nvidia.com/gpu.count`` label, so a
virgin node has a unit per GPU, where the JAX package's virgin host
has the one unit of its chip block.  The units' state is rebuilt from
the node agent's status annotations and placement records, bound
pods' usage is claimed, and the node's allocatable follows the
(possibly hypothetical) geometry so the scheduler simulation sees it
(node.go:171-195).

A node may instead be a shard of an NVLink block "NxG" (N nodes of G
GPUs in one aligned window of its domain, ``group.py``): GPU 0 carries
the block's profile at quantity 1 and the others nothing, so the node
advertises ``nos.nebuly.com/nvlink-block-NxG: 1`` and the whole node is
the shard, as the JAX package's host is the shard of a multi-host slice.
Only the group pass makes or breaks shards; the per-node re-carve leaves
a member alone.
"""

from __future__ import annotations

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.kube.objects import Node, Pod
from nos_tpu_torch.kube.resources import pod_request
from nos_tpu_torch.scheduler.framework import NodeInfo
from nos_tpu_torch.topology.annotations import (
    parse_placement_annotations, parse_status_annotations,
)
from nos_tpu_torch.topology.hybrid import gpu_count, mig_gpus
from nos_tpu_torch.topology.known import (
    DEFAULT_REGISTRY, GpuModel, GpuModelRegistry,
)
from nos_tpu_torch.topology.profile import (
    PROFILE_RE, extract_slice_requests, is_block_profile, is_slice_resource,
    slice_resource_name,
)
from nos_tpu_torch.topology.slice_unit import SliceUnit

from ..core.interfaces import PartitionableNode, ProfileRequest
from ..core.usage import claim_bound_pod_usage


def _placement_fits(model: GpuModel, pl) -> bool:
    prof = model.profile(pl.profile)
    return (prof is not None and pl.size == prof.memory_slices
            and pl.start + pl.size <= model.memory_slices)


def units_from_node(node: Node,
                    registry: GpuModelRegistry = DEFAULT_REGISTRY
                    ) -> list[SliceUnit]:
    labels = node.metadata.labels
    model = registry.get(labels.get(C.LABEL_ACCELERATOR, ""))
    count = gpu_count(labels)
    if count is None:
        raise ValueError(f"node {node.name}: no GPU count "
                         f"({C.LABEL_GPU_COUNT}={labels.get(C.LABEL_GPU_COUNT)!r})")
    units = {i: SliceUnit(model=model, index=i)
             for i in mig_gpus(labels, count)}
    for a in parse_status_annotations(node.metadata.annotations):
        if not PROFILE_RE.match(a.profile) \
                and not is_block_profile(a.profile):
            continue  # an MPS share on a hybrid node
        unit = units.get(a.index)
        if unit is None:
            continue  # a stale report on a GPU the MIG family does not own
        table = unit.used if a.status == "used" else unit.free
        table[a.profile] = table.get(a.profile, 0) + a.quantity
    # Placements pin the packer, so the planner refuses geometries the
    # agent could never carve around the used instances.
    for idx, records in parse_placement_annotations(
            node.metadata.annotations).items():
        unit = units.get(idx)
        if unit is None or not records:
            continue
        if not all(_placement_fits(model, pl) for _, pl in records):
            continue  # not this model's placements: do not trust them
        unit.placed_used = [pl for st, pl in records if st == "u"]
        unit.placed_free = [pl for st, pl in records if st == "f"]
        if not unit.has_placement_data():
            unit.drop_placement_data()  # stale against the counts
    return [units[i] for i in sorted(units)]


class SliceNode(PartitionableNode):
    def __init__(self, node: Node, node_info: NodeInfo,
                 registry: GpuModelRegistry = DEFAULT_REGISTRY) -> None:
        self._name = node.metadata.name
        self._node_info = node_info
        self.units = units_from_node(node, registry)
        labels = node.metadata.labels
        self.model = registry.get(labels.get(C.LABEL_ACCELERATOR, ""))
        self.gpus = gpu_count(labels) or 0
        self._domain = labels.get(C.LABEL_NVLINK_DOMAIN, "")
        try:
            self._host_index = int(labels.get(C.LABEL_HOST_INDEX, "0"))
        except ValueError:
            self._host_index = 0
        self._claim_bound_pod_usage()
        self._sync_allocatable()

    # -- PartitionableNode --------------------------------------------------
    @property
    def name(self) -> str:
        return self._name

    @property
    def domain(self) -> str:
        """The node's NVLink domain ("" when unlabelled)."""
        return self._domain

    @property
    def host_index(self) -> int:
        return self._host_index

    def node_info(self) -> NodeInfo:
        return self._node_info

    def has_used_slices(self) -> bool:
        return any(c > 0 for u in self.units for c in u.used.values())

    def is_block_member(self) -> bool:
        """Some GPU of the node is a shard of an NVLink block."""
        return any(u.is_block_shard() for u in self.units)

    def make_member_of(self, profile: str) -> None:
        """Dedicate the node as one shard of the block ``profile``: GPU 0
        carries it, the other GPUs go empty (the whole node belongs to
        the block)."""
        for u in self.units[1:]:
            if any(c > 0 for c in u.used.values()):
                raise ValueError(
                    f"node {self._name} has used instances on GPU {u.index}")
            u.free = {}
            u.drop_placement_data()
        self.units[0].make_member_of(profile)
        self._sync_allocatable()

    def reset_virgin(self) -> None:
        for u in self.units:
            u.reset_virgin()
        self._sync_allocatable()

    def update_geometry_for(self, lacking: ProfileRequest) -> bool:
        if self.is_block_member():
            # shards are carved and broken only by the group pass: a
            # re-carve here would orphan the partner nodes' shards
            return False
        remaining = {p: q for p, q in lacking.items()
                     if q > 0 and PROFILE_RE.match(p)}
        changed = False
        for unit in self.units:
            if not remaining:
                break
            if unit.update_geometry_for(remaining):
                changed = True
            for profile in list(remaining):
                provided = unit.free.get(profile, 0)
                if provided:
                    remaining[profile] -= provided
                    if remaining[profile] <= 0:
                        del remaining[profile]
        if changed:
            self._sync_allocatable()
        return changed

    def add_pod(self, pod: Pod) -> bool:
        """All or nothing, first fit across the GPUs (reference node.go
        AddPod)."""
        staged: list[tuple[SliceUnit, str]] = []
        for profile, qty in extract_slice_requests(pod_request(pod)).items():
            for _ in range(qty):
                for unit in self.units:
                    if unit.allocate(profile):
                        staged.append((unit, profile))
                        break
                else:
                    for u, p in staged:
                        u.release(p)
                    return False
        self._node_info.add_pod(pod)
        return True

    def geometries(self) -> dict[int, dict[str, int]]:
        return {u.index: u.geometry_names() for u in self.units}

    def clone(self) -> "SliceNode":
        c = object.__new__(SliceNode)
        c._name = self._name
        c._node_info = self._node_info.clone()
        # direct unit copies: clone() is the unit of a fork's cost
        c.units = [u.__deepcopy__(None) for u in self.units]
        c.model = self.model
        c.gpus = self.gpus
        c._domain = self._domain
        c._host_index = self._host_index
        return c

    # -- internals ----------------------------------------------------------
    def _claim_bound_pod_usage(self) -> None:
        claim_bound_pod_usage(self.units, self._node_info.pods,
                              extract_slice_requests)

    def _sync_allocatable(self) -> None:
        alloc = self._node_info.node.status.allocatable
        for res in [r for r in alloc if is_slice_resource(r)]:
            del alloc[res]
        totals: dict[str, int] = {}
        for unit in self.units:
            for profile, qty in unit.geometry_names().items():
                res = slice_resource_name(profile)
                totals[res] = totals.get(res, 0) + qty
        alloc.update(totals)
