"""Plan pools: the planner's decision plane sharded by failure domain,
``nos_tpu/partitioning/core/pools.py`` for the port.

A *plan pool* is the set of snapshot nodes sharing one GPU model (the
accelerator label) and one NVLink domain (``nvidia.com``'s node group,
the JAX package's TPU pod id).  Pools are the planner's natural shards:

- the per-node re-carve never moves capacity between nodes, and a node
  can only offer profiles of its own model: a lacking profile its model
  cannot carve scores zero against every candidate geometry, so another
  pool's entries in the lacking table cannot change a carve;
- a MIG instance or an MPS share lies on one node, and an NVLink block
  on an aligned window of one domain, so no carve crosses a pool.

Pending pods are split by the pools their request can land on.  A MIG
profile is eligible on a pool whose model's MIG table lists it; an MPS
share (``<N>gb``) on a pool whose model holds N GB on one card (shares
are carved per card).  A pod eligible in several pools goes to exactly
one: the pool with the most free capacity left after the demand already
assigned in this split, ties on the pool key, so one snapshot and batch
always give the same shards.  Pods eligible nowhere come back apart: no
re-carve could place them, as the sequential planner would carve nothing
for them.

Capacity is counted in sevenths of a GPU, as the snapshot's candidate
order counts it: a whole GPU and an MPS share 7 a unit, a MIG instance
its compute slices.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.kube.objects import Pod
from nos_tpu_torch.topology.known import (
    DEFAULT_REGISTRY, GpuModel, GpuModelRegistry,
)
from nos_tpu_torch.topology.profile import (
    PROFILE_RE, block_dims, block_gpus, is_block_profile,
    is_timeshare_resource, profile_from_resource,
)

from .interfaces import SliceCalculator
from .snapshot import ClusterSnapshot

# a whole GPU, and an MPS share, in sevenths of a GPU
_GPU_SEVENTHS = 7


@dataclass(frozen=True)
class PlanPool:
    """One shard of the planning plane: GPU model + NVLink domain."""

    key: str                    # "<accelerator>|<nvlink domain>"
    accelerator: str            # LABEL_ACCELERATOR value ("" = unlabelled)
    domain: str                 # LABEL_NVLINK_DOMAIN value ("" = unlabelled)
    nodes: tuple[str, ...]      # member node names, sorted
    free_sevenths: float        # free capacity across the members
    # each member's free MIG capacity, sorted descending: only MIG
    # instances count (a node's whole-GPU resource would count its cards
    # twice and defeat the per-node screen)
    node_slice_free: tuple[float, ...]

    @property
    def max_node_slice_free(self) -> float:
        return self.node_slice_free[0] if self.node_slice_free else 0.0


def _free_sevenths(node) -> tuple[float, float]:
    """(free sevenths, free MIG-instance sevenths) of a snapshot node."""
    ni = node.node_info()
    req = ni.requested
    total = 0.0
    slices = 0.0
    for res, aq in ni.allocatable.items():
        qty = aq - req.get(res, 0.0)
        if qty <= 0:
            continue
        profile = profile_from_resource(res)
        if profile is not None:
            s = _profile_sevenths(profile, qty)
            total += s
            slices += s
        elif res == C.RESOURCE_GPU or is_timeshare_resource(res):
            total += _GPU_SEVENTHS * qty
    return total, slices


def partition_pools(snapshot: ClusterSnapshot) -> list[PlanPool]:
    """The snapshot's nodes grouped into plan pools, sorted by key."""
    members: dict[tuple[str, str], list[str]] = {}
    free: dict[tuple[str, str], float] = {}
    slice_free: dict[tuple[str, str], list[float]] = {}
    for name, node in snapshot.nodes().items():
        labels = node.node_info().node.metadata.labels
        key = (labels.get(C.LABEL_ACCELERATOR, ""),
               labels.get(C.LABEL_NVLINK_DOMAIN, ""))
        total, slices = _free_sevenths(node)
        members.setdefault(key, []).append(name)
        free[key] = free.get(key, 0.0) + total
        slice_free.setdefault(key, []).append(slices)
    return [
        PlanPool(key=f"{accel}|{domain}", accelerator=accel, domain=domain,
                 nodes=tuple(sorted(members[(accel, domain)])),
                 free_sevenths=free[(accel, domain)],
                 node_slice_free=tuple(sorted(
                     slice_free[(accel, domain)], reverse=True)))
        for accel, domain in sorted(members)
    ]


def _profile_sevenths(profile: str, qty: int) -> float:
    """Sevenths of ``qty`` units of a profile: a MIG profile its compute
    slices, an NVLink block every GPU of the block, a share (or an
    unknown spelling) a whole GPU's."""
    m = PROFILE_RE.match(profile)
    if m is not None:
        return float(int(m.group("g")) * qty)
    if is_block_profile(profile):
        return float(_GPU_SEVENTHS * block_gpus(profile) * qty)
    return float(_GPU_SEVENTHS * qty)


@lru_cache(maxsize=8192)
def _profiles_eligible(profiles: tuple[str, ...], model: GpuModel) -> bool:
    """Memoised per (profile tuple, model): the split asks per pod and
    pool, but a batch holds a handful of profile combinations.  A MIG
    profile must be in the model's table; a share must fit one card's
    memory.  An unknown spelling is left to the planner."""
    for profile in profiles:
        if PROFILE_RE.match(profile) is not None:
            if model.profile(profile) is None:
                return False
        elif is_block_profile(profile):
            if not model.offers_block(profile):
                return False
        elif profile.endswith("gb"):
            try:
                if int(profile[:-2]) > model.memory_gb:
                    return False
            except ValueError:
                pass
    return True


def _eligible(profiles: tuple[str, ...], pool: PlanPool,
              registry: GpuModelRegistry) -> bool:
    """Can every requested profile land on this pool's model?  A model
    the registry does not know is eligible: the planner's own simulation
    decides there, as it does sequentially."""
    model = registry.models.get(pool.accelerator)
    if model is None:
        return True
    return _profiles_eligible(profiles, model)


def _capacity_ok(profiles: tuple[str, ...], pool: PlanPool,
                 registry: GpuModelRegistry) -> bool:
    """A necessary capacity condition: a MIG profile needs some member
    with at least its compute slices free in MIG instances (a re-carve
    rearranges a node's free instances, it never creates them).  Used
    to demote hopeless pools in the split, so a pod is not starved on a
    fragmented pool while a capable one sits idle; with no capable pool
    the caller keeps the whole eligible set (a heuristic, never a
    verdict of infeasibility).  An NVLink block "NxG" needs N members
    each wholly free (G GPUs' sevenths in free instances): the group
    pass dedicates only clean nodes as shards, the JAX package's
    multi-host rule.  Alignment is not checked: a necessary screen, not
    a proof."""
    if registry.models.get(pool.accelerator) is None:
        return True
    for profile in profiles:
        dims = block_dims(profile)
        if dims is not None:
            whole = _GPU_SEVENTHS * dims[1]
            if sum(1 for f in pool.node_slice_free if f >= whole) \
                    < dims[0]:
                return False
            continue
        m = PROFILE_RE.match(profile)
        if m is None:
            continue            # shares: screened by _eligible
        if pool.max_node_slice_free < int(m.group("g")):
            return False
    return True


def split_pods(
    pools: list[PlanPool], pods: list[Pod], calculator: SliceCalculator,
    registry: GpuModelRegistry = DEFAULT_REGISTRY,
) -> tuple[dict[str, list[Pod]], list[Pod]]:
    """Each pending pod assigned to exactly one eligible pool.

    Returns (pool key -> pods in batch order, infeasible pods).  The
    eligible pool with the most free sevenths net of the demand already
    assigned in this split wins, ties on the pool key; counting the
    assigned demand spreads a burst of pods that fit anywhere.  A gang's
    members go as one unit with their summed demand: members scattered
    over pools would each be planned by another shard."""
    by_pool: dict[str, list[Pod]] = {p.key: [] for p in pools}
    remaining: dict[str, float] = {p.key: p.free_sevenths for p in pools}
    infeasible: list[Pod] = []
    elig_memo: dict[tuple[str, ...], list[PlanPool]] = {}

    # the units in order of first appearance: single pods alone, a
    # gang's members together
    units: list[list[Pod]] = []
    gang_unit: dict[tuple[str, str], list[Pod]] = {}
    for pod in pods:
        gang = pod.metadata.labels.get(C.LABEL_POD_GROUP, "")
        if not gang:
            units.append([pod])
            continue
        key = (pod.metadata.namespace, gang)
        unit = gang_unit.get(key)
        if unit is None:
            unit = gang_unit[key] = []
            units.append(unit)
        unit.append(pod)

    for unit in units:
        profiles: dict[str, int] = {}
        for pod in unit:
            for pr, qty in calculator.requested_profiles(pod).items():
                profiles[pr] = profiles.get(pr, 0) + qty
        if not profiles:
            # no profile demand: nothing for a shard to plan, as the
            # sequential planner filters these out
            infeasible.extend(unit)
            continue
        screen = tuple(sorted(set(profiles)))
        eligible = elig_memo.get(screen)
        if eligible is None:
            full = [p for p in pools if _eligible(screen, p, registry)]
            capable = [p for p in full
                       if _capacity_ok(screen, p, registry)]
            eligible = capable or full
            elig_memo[screen] = eligible
        if not eligible:
            infeasible.extend(unit)
            continue
        need = sum(_profile_sevenths(pr, q) for pr, q in profiles.items())
        best = max(eligible, key=lambda p: (remaining[p.key], p.key))
        by_pool[best.key].extend(unit)
        remaining[best.key] -= need
    return by_pool, infeasible
