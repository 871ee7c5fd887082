"""Forkable in-memory cluster snapshot, copy-on-write,
``nos_tpu/partitioning/core/snapshot.py`` for the port (reference
internal/partitioning/core/snapshot.go:43-191).

The planner forks the snapshot per candidate node, re-carves that node,
simulates scheduling, then commits or reverts.  ``fork()`` copies
nothing: the first write access to a node inside a fork
(``get_node_for_write`` / ``add_pod``) clones exactly that node and keeps
the pristine one in the fork's dirty set; ``revert()`` restores only
the dirty entries and ``commit()`` drops them.

Inside a fork, mutate only through ``get_node_for_write`` or
``add_pod``: ``get_node`` and ``nodes()`` are read views whose mutation
``revert()`` cannot undo.  Every node-object replacement bumps that
node's generation, so ``shared_lister()`` re-reads exactly the changed
NodeInfos.  ``subset()`` gives the parallel planner's shards their own
snapshots over disjoint node sets, sharing the node objects.
"""

from __future__ import annotations

from typing import Iterable, Mapping

from nos_tpu_torch.api.constants import (
    ANNOT_DEFRAG_DRAIN, ANNOT_GANG_LEASE, RESOURCE_GPU,
)
from nos_tpu_torch.kube.objects import Pod
from nos_tpu_torch.kube.resources import negatives_only, pod_request, subtract
from nos_tpu_torch.scheduler.framework import SharedLister
from nos_tpu_torch.topology.profile import (
    PROFILE_RE, block_gpus, is_timeshare_resource, profile_from_resource,
)
from nos_tpu_torch.utils.guards import invalidated_by

from .interfaces import PartitionableNode, SliceFilter

# A MIG instance counts as its share of a card's 7 compute slices.
_COMPUTE_SLICES = 7


class SnapshotError(Exception):
    pass


def _gpu_sevenths(resource: str, qty: float) -> float:
    """Free capacity in sevenths of a GPU, the JAX package's chip
    equivalents: a whole GPU and an MPS share each count 7 per unit (a
    share is not weighed by its GB), a MIG instance its compute slices
    (g/7 of a GPU); any other resource 0.  Sevenths keep the sums
    whole, so the order does not hang on float rounding, nor on the
    order the node lists its resources in."""
    profile = profile_from_resource(resource)
    if profile is not None:
        m = PROFILE_RE.match(profile)
        if m is None:
            # an NVLink block shard: every GPU of the block, as the JAX
            # package counts a multi-host shard at its shape's chips
            return _COMPUTE_SLICES * block_gpus(profile) * qty
        return int(m.group("g")) * qty
    if resource == RESOURCE_GPU or is_timeshare_resource(resource):
        return _COMPUTE_SLICES * qty
    return 0.0


# the epoch is the coherence signal of _candidate_cache and _free_cache
@invalidated_by("_mutation_gen", "_nodes")
class ClusterSnapshot:
    def __init__(self, nodes: Mapping[str, PartitionableNode],
                 slice_filter: SliceFilter) -> None:
        self._nodes: dict[str, PartitionableNode] = dict(nodes)
        self._filter = slice_filter
        # the fork's dirty set, name -> pristine node; None = not forked
        self._forked: dict[str, PartitionableNode] | None = None
        # per node, bumped when its OBJECT is replaced (clone, revert)
        self._node_gen: dict[str, int] = {}
        self._structure_gen = 0
        # bumped on every write access, mutable references included:
        # gates the derived views below
        self._mutation_gen = 0
        self._candidate_cache: tuple[int, list[str]] | None = None
        self._free_cache: tuple[int, dict[str, float]] | None = None
        self.cow_clones = 0

    # -- fork/commit/revert (snapshot.go:85-117) ---------------------------
    def fork(self) -> None:
        if self._forked is not None:
            raise SnapshotError("snapshot already forked")
        self._forked = {}

    def commit(self) -> None:
        self._forked = None

    def revert(self) -> None:
        if self._forked is None:
            raise SnapshotError("snapshot not forked")
        for name, pristine in self._forked.items():
            self._nodes[name] = pristine
            self._bump_node(name)
        self._forked = None
        self._mutation_gen += 1

    def clone(self) -> "ClusterSnapshot":
        """An independent copy, so a controller can diff a plan against
        the unmutated state (partitioner_controller.go:178-193).  Refused
        while forked: it would capture half-applied state."""
        if self._forked is not None:
            raise SnapshotError("cannot clone a forked snapshot")
        return ClusterSnapshot(
            {n: pn.clone() for n, pn in self._nodes.items()}, self._filter
        )

    def subset(self, names: Iterable[str]) -> "ClusterSnapshot":
        """A snapshot of ``names`` alone sharing the node objects (no
        copy): a parallel planner's shard.  It keeps its own fork, dirty
        set and generations, so a fork on it clones into its own map and
        never writes through to this snapshot's entries; an in-place
        mutation does write through, so concurrent subsets are safe when
        their name sets are disjoint, as the pools are.  Refused while
        forked, as ``clone`` is."""
        if self._forked is not None:
            raise SnapshotError("cannot subset a forked snapshot")
        names = sorted(names)
        missing = [n for n in names if n not in self._nodes]
        if missing:
            raise SnapshotError(f"unknown node(s) {missing}")
        return ClusterSnapshot({n: self._nodes[n] for n in names},
                               self._filter)

    # -- write access -------------------------------------------------------
    def _bump_node(self, name: str) -> None:
        self._node_gen[name] = self._node_gen.get(name, 0) + 1
        self._structure_gen += 1

    def _writable(self, name: str) -> PartitionableNode:
        node = self._nodes.get(name)
        if node is None:
            raise SnapshotError(f"unknown node {name}")
        if self._forked is not None and name not in self._forked:
            self._forked[name] = node
            node = node.clone()
            self.cow_clones += 1
            self._nodes[name] = node
            self._bump_node(name)
        self._mutation_gen += 1
        return node

    def get_node_for_write(self, name: str) -> PartitionableNode:
        """The node, safe to mutate: inside a fork the first write access
        clones it, so revert() can restore the original."""
        return self._writable(name)

    def add_pod(self, node_name: str, pod: Pod) -> None:
        """Bind the pod in the snapshot (snapshot.go AddPod)."""
        node = self._writable(node_name)
        if not node.add_pod(pod):
            raise SnapshotError(f"pod {pod.key} does not fit node {node_name}")

    # -- views -------------------------------------------------------------
    def nodes(self) -> dict[str, PartitionableNode]:
        # hands out mutable references: counts as a write access
        self._mutation_gen += 1
        return dict(self._nodes)

    def get_node(self, name: str) -> PartitionableNode:
        return self._nodes[name]

    def node_generation(self, name: str) -> int:
        return self._node_gen.get(name, 0)

    def shared_lister(self) -> "SnapshotLister":
        """A SharedLister over the live NodeInfos, refreshed per node by
        generation: built once per plan, valid across forks."""
        return SnapshotLister(self)

    def get_candidate_nodes(self) -> list[PartitionableNode]:
        """Nodes with any free capacity, best fit first: fewest free
        GPU-equivalents, then name (the reference visits name order,
        snapshot.go:119-130; carving new demand into the fullest node
        that fits keeps empty nodes whole).  Nodes under the scheduler's
        gang-window lease (ANNOT_GANG_LEASE) go last: they are draining
        toward a stuck block gang, and re-carving them for other demand
        would fragment the window again.  Nodes under a defrag drain
        rank the same way: the room a defrag move frees is for the
        demand it was made for.  Memoised on the mutation epoch."""
        cached = self._candidate_cache
        if cached is not None and cached[0] == self._mutation_gen:
            return [self._nodes[n] for n in cached[1]]
        out = []
        for name in sorted(self._nodes):
            node = self._nodes[name]
            ni = node.node_info()
            req = ni.requested
            has_free = False
            sevenths = 0.0
            for k, v in ni.allocatable.items():
                qty = v - req.get(k, 0.0)
                if qty <= 0:
                    continue
                has_free = True
                sevenths += _gpu_sevenths(k, qty)
            if not has_free:
                continue
            annots = ni.node.metadata.annotations
            leased = bool(annots.get(ANNOT_GANG_LEASE)) \
                or bool(annots.get(ANNOT_DEFRAG_DRAIN))
            out.append((leased, sevenths, name, node))
        out.sort(key=lambda t: (t[0], t[1], t[2]))
        self._candidate_cache = (self._mutation_gen, [t[2] for t in out])
        return [t[3] for t in out]

    def get_lacking_slices(self, pod: Pod) -> dict[str, int]:
        """Cluster-wide (allocatable - requested) - request, negatives
        only, restricted to profile resources (snapshot.go:132-165), as
        profile name -> missing quantity.  The cluster's free aggregate
        is memoised on the mutation epoch."""
        cached = self._free_cache
        if cached is not None and cached[0] == self._mutation_gen:
            free = cached[1]
        else:
            free: dict[str, float] = {}
            for pn in self._nodes.values():
                ni = pn.node_info()
                for k, v in ni.allocatable.items():
                    free[k] = free.get(k, 0.0) + v
                for k, v in ni.requested.items():
                    free[k] = free.get(k, 0.0) - v
            free = {k: max(0.0, v) for k, v in free.items()}
            self._free_cache = (self._mutation_gen, free)
        lacking_resources = negatives_only(subtract(free, pod_request(pod)))
        return self._filter.extract_profiles(lacking_resources)


class SnapshotLister(SharedLister):
    """SharedLister view over a ClusterSnapshot: an entry is re-read
    exactly when its node's generation moved; in-place mutations flow
    through the existing NodeInfo reference."""

    def __init__(self, snapshot: ClusterSnapshot) -> None:
        super().__init__(())
        self._snapshot = snapshot
        self._gens: dict[str, int] = {}
        self._seen_structure = -1

    def _refresh(self) -> None:
        snap = self._snapshot
        if snap._structure_gen == self._seen_structure \
                and len(self._infos) == len(snap._nodes):
            return
        for name, pn in snap._nodes.items():
            gen = snap.node_generation(name)
            if self._gens.get(name) != gen:
                self._infos[name] = pn.node_info()
                self._gens[name] = gen
        self._seen_structure = snap._structure_gen

    def list(self):
        self._refresh()
        return list(self._infos.values())

    def get(self, name: str):
        self._refresh()
        return self._infos.get(name)
