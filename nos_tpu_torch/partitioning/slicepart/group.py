"""NVLink block planning: the group pass,
``nos_tpu/partitioning/slicepart/group.py`` for the port.

A block ``NxG`` is N whole nodes of G GPUs inside one NVLink domain
(``topology/profile.py``), the JAX package's multi-host slice: where
JAX carves a v5e 4x4 over two 8-chip hosts of one TPU pod, the port
carves a 2x8 over two 8-GPU nodes of one NVLink Switch system.  The
per-node annotation protocol is kept by carving a block as whole-node
shards: every member node's spec and status carry the block profile at
quantity 1 on GPU 0 (``SliceNode.make_member_of``) and it advertises
``nos.nebuly.com/nvlink-block-NxG: 1``, and a consuming job is a gang of
one pod per node (``scheduler/gang.py`` picks the matching window).

The shard adjacency convention is the gang scheduler's: the member nodes
of one block are a host-index-aligned window of its domain, [i, i + N)
with i % N == 0 (``topology/windows.py``).

The pass runs before the per-node planning loop:

1. reclaim: if MIG profiles are lacking, break fully free blocks back
   to virgin GPUs (never a used shard) so the per-node loop can re-carve
   them;
2. provide: for each lacking block, find an aligned window of clean
   nodes (MIG-family nodes with no used instance that are no shard yet)
   in some domain, and dedicate each as a shard.  A domain offers
   ``NxG`` only where its model offers N-node blocks and every node has
   G GPUs; windows under the scheduler's gang lease are carved first.

Each carve and reclaim is journaled (``plan-block-carved``,
``plan-block-reclaimed``: the profile, the domain, the window's nodes)
where the JAX package only logs it, so a plan's journal shows what the
pass decided.

Only nodes whose every GPU belongs to the MIG family become shards: a
hybrid node's MPS half is not the planner's to give away.
"""

from __future__ import annotations

import logging
from collections import defaultdict

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.kube.objects import Pod
from nos_tpu_torch.obs import journal as J
from nos_tpu_torch.obs.journal import record as journal_record
from nos_tpu_torch.obs.trace import span as obs_span
from nos_tpu_torch.topology.profile import (
    PROFILE_RE, block_dims, block_gpus, is_block_profile,
)
from nos_tpu_torch.topology.windows import aligned_index_windows

from ..core.planner import GeometryPlanner
from ..core.snapshot import ClusterSnapshot
from ..core.tracker import SliceTracker
from ..state import PartitioningState
from .node import SliceNode

logger = logging.getLogger(__name__)

# a GPU's compute slices: the pass's currency is sevenths of a GPU
_SEVENTHS = 7


def aligned_windows(members: list[SliceNode],
                    hosts: int) -> list[list[SliceNode]]:
    """Host-index-aligned windows of ``hosts`` consecutive nodes."""
    by_index = {n.host_index: n for n in members}
    return [[by_index[i] for i in w]
            for w in aligned_index_windows(by_index, hosts)]


def _whole_mig(node: SliceNode) -> bool:
    """Every GPU of the node is the MIG family's."""
    return node.gpus > 0 and len(node.units) == node.gpus


class MultiHostGeometryPlanner(GeometryPlanner):
    """GeometryPlanner plus the NVLink block group pass."""

    def plan(self, snapshot: ClusterSnapshot,
             pending_pods: list[Pod]) -> PartitioningState:
        with obs_span("planner.plan", pods=len(pending_pods)):
            tracker = SliceTracker(snapshot, self._calculator, pending_pods)
            changed = False
            if not tracker.empty:
                with obs_span("planner.group_pass"):
                    changed = self._group_pass(snapshot, tracker.lacking)
            # an untouched snapshot keeps the tracker's lacking exact
            return self._plan(snapshot, pending_pods,
                              tracker=None if changed else tracker)

    # -- the pass -----------------------------------------------------------
    def _group_pass(self, snapshot: ClusterSnapshot,
                    lacking: dict[str, int]) -> bool:
        """True when any node's geometry was carved or reclaimed (the
        caller's tracker is stale exactly then)."""
        mutated = False
        nodes = [n for n in snapshot.nodes().values()
                 if isinstance(n, SliceNode)]
        if not nodes:
            return mutated
        blocks_lacking: dict[str, int] = {}
        mig_lacking = 0
        for profile, qty in lacking.items():
            if qty <= 0:
                continue
            if is_block_profile(profile):
                blocks_lacking[profile] = \
                    blocks_lacking.get(profile, 0) + qty
            else:
                m = PROFILE_RE.match(profile)
                if m is not None:
                    mig_lacking += int(m.group("g")) * qty

        if mig_lacking:
            mutated |= self._reclaim_free_blocks(nodes, mig_lacking)

        by_domain: dict[str, list[SliceNode]] = defaultdict(list)
        for n in nodes:
            if n.domain:
                by_domain[n.domain].append(n)

        # `remaining` counts lacking shards: a window of N member nodes
        # advertises N units, one per pending gang member
        remaining = dict(blocks_lacking)
        # the clean nodes per domain, built once and kept across carves
        # (a carved window's nodes are shards, so no longer clean)
        clean_by_domain: dict[str, list[SliceNode]] = {}
        for profile in sorted(remaining,
                              key=lambda p: (-block_gpus(p), p)):
            hosts, gpus = block_dims(profile)
            for domain in sorted(by_domain):
                if remaining[profile] <= 0:
                    break
                members = by_domain[domain]
                if not members[0].model.offers_block(profile) \
                        or any(m.gpus != gpus for m in members):
                    continue
                clean = clean_by_domain.get(domain)
                if clean is None:
                    clean = clean_by_domain[domain] = [
                        m for m in members
                        if _whole_mig(m) and not m.has_used_slices()
                        and not m.is_block_member()]
                if len(clean) < hosts:
                    continue

                # leased windows first: the scheduler drained these nodes
                # for exactly such a gang (ANNOT_GANG_LEASE)
                def leased_count(window: list[SliceNode]) -> int:
                    return sum(
                        1 for w in window
                        if w.node_info().node.metadata.annotations.get(
                            C.ANNOT_GANG_LEASE))

                carved: set[str] = set()
                for window in sorted(aligned_windows(clean, hosts),
                                     key=lambda w: -leased_count(w)):
                    if remaining[profile] <= 0:
                        break
                    for w in window:
                        w.make_member_of(profile)
                        carved.add(w.name)
                    mutated = True
                    remaining[profile] -= hosts
                    logger.info("group pass: carved %s across %s",
                                profile, [w.name for w in window])
                    journal_record(J.PLAN_BLOCK_CARVED, profile,
                                   domain=domain,
                                   nodes=[w.name for w in window])
                if carved:
                    clean_by_domain[domain] = [
                        m for m in clean if m.name not in carved]
        return mutated

    @staticmethod
    def _reclaim_free_blocks(nodes: list[SliceNode],
                             lacking_sevenths: int) -> bool:
        """Break up blocks whose every shard is free, so the per-node
        loop can re-carve the GPUs for MIG demand.  A block with any used
        shard is untouched, and blocks are reclaimed only while the
        lacking MIG demand exceeds what non-member nodes' free instances
        can supply (a free block kept for an assembling gang must not
        churn under small pods the rest of the fleet can absorb)."""
        mutated = False
        by_domain: dict[str, list[SliceNode]] = defaultdict(list)
        for n in nodes:
            if n.domain and n.is_block_member():
                by_domain[n.domain].append(n)
        if not by_domain:
            return mutated

        deficit = lacking_sevenths
        for n in nodes:
            if deficit <= 0:
                break
            if n.is_block_member():
                continue
            for u in n.units:
                for p, c in u.free.items():
                    m = PROFILE_RE.match(p)
                    if m is not None:
                        deficit -= int(m.group("g")) * c
        if deficit <= 0:
            return mutated

        for domain, members in by_domain.items():
            # group the shards into blocks by profile and aligned window
            by_profile: dict[str, list[SliceNode]] = defaultdict(list)
            for n in members:
                for p, c in n.units[0].geometry_names().items():
                    if c > 0 and is_block_profile(p):
                        by_profile[p].append(n)
            for profile, shards in by_profile.items():
                hosts = block_dims(profile)[0]
                for window in aligned_windows(shards, hosts):
                    if deficit <= 0:
                        return mutated
                    if any(w.has_used_slices() for w in window):
                        continue
                    for w in window:
                        w.reset_virgin()
                    mutated = True
                    deficit -= _SEVENTHS * block_gpus(profile)
                    logger.info("group pass: reclaimed free %s at %s",
                                profile, [w.name for w in window])
                    journal_record(J.PLAN_BLOCK_RECLAIMED, profile,
                                   domain=domain,
                                   nodes=[w.name for w in window])
        return mutated
