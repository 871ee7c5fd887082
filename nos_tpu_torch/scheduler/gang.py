"""Gang scheduling, ``nos_tpu/scheduler/gang.py`` for the port:
all-or-nothing PodGroup admission inside one NVLink domain.

A multi-GPU training job is useless placed in part, so the pods sharing
a ``nos.nebuly.com/pod-group`` label are one gang: the scheduler
(``Scheduler.schedule_gang``) places the whole gang on clones of its
cycle view, each member taking capacity the next one sees, and binds
only if every member fits; otherwise it marks every member
unschedulable, which hands the partitioner the whole gang's demand at
once.  A gang is all or nothing in death too: ``evict_gang`` takes
every member and resets the PodGroup.

The candidates are whole NVLink domains (``LABEL_NVLINK_DOMAIN``, the
counterpart of the JAX package's TPU pod id), best fit first: the
domain with the least free whole-GPU capacity that still holds the
gang, so large domains stay whole for large gangs.  ``TopologyFilter``
rejects nodes outside the domain pinned in cycle state, and every
labelled domain with fewer GPUs than the PodGroup's ``mesh``.

A gang consuming one NVLink block ``NxG`` (``topology/profile.py``: N
whole nodes of G GPUs, the JAX package's multi-host slice) is placed in
an aligned window of its domain instead, the same windows the
partitioner's group pass carves (``partitioning/slicepart/group.py``):
``gang_slice_windows`` lists them, and ``TopologyFilter`` rejects nodes
outside the window pinned in cycle state.  Every other gang takes the
whole-domain branch.
"""

from __future__ import annotations

import logging
from typing import Any

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.api.podgroup import PHASE_PENDING
from nos_tpu_torch.kube.client import (
    APIServer, KIND_NODE, KIND_POD, KIND_POD_GROUP, NotFound,
)
from nos_tpu_torch.kube.objects import Pod
from nos_tpu_torch.scheduler.framework import (
    CycleState, NodeInfo, SharedLister, Status,
)
from nos_tpu_torch.topology.shape import Shape
from nos_tpu_torch.utils.retry import retry_on_conflict

logger = logging.getLogger(__name__)

# cycle state: the NVLink domain a gang attempt is pinned to, and the
# window's node names when it is pinned to a block window
GANG_DOMAIN_KEY = "gang-pinned-nvlink-domain"
GANG_HOST_SET_KEY = "gang-allowed-hosts"
_MESH_GPUS_KEY = "topo-mesh-gpus"
_DOMAIN_GPUS_KEY = "topo-domain-gpu-counts"


def gang_name(pod: Pod) -> str:
    return pod.metadata.labels.get(C.LABEL_POD_GROUP, "")


def get_pod_group(api: APIServer, name: str, namespace: str) -> Any:
    try:
        return api.get(KIND_POD_GROUP, name, namespace)
    except NotFound:
        return None


def set_pod_group_status(api: APIServer, pg: Any, phase: str,
                         scheduled: int) -> None:
    def mutate(o: Any) -> None:
        o.status.phase = phase
        o.status.scheduled = scheduled

    try:
        retry_on_conflict(api, KIND_POD_GROUP, pg.metadata.name, mutate,
                          pg.metadata.namespace, component="gang")
    except NotFound:
        pass


def requested_mesh_chips(pg: Any) -> int | None:
    """The GPUs the PodGroup's mesh spans, if it names one."""
    if pg is None or not pg.spec.mesh:
        return None
    try:
        return Shape.parse(pg.spec.mesh).chips
    except ValueError:
        logger.warning("pod group %s has unparseable mesh %r",
                       pg.metadata.name, pg.spec.mesh)
        return None


def gang_slice_windows(api: APIServer, members: list[Pod]
                       ) -> list[tuple[str, frozenset[str]]]:
    """The placement candidates of a gang consuming one NVLink block:
    the host-index-aligned windows of the partitioner's shard convention
    (``partitioning/slicepart/group.py``), as (domain, the window's node
    names), domains in name order.  A domain offers the block "NxG" only
    where its model offers N-node blocks and every node has G GPUs; a
    domain whose nodes disagree is skipped with a warning (the JAX
    package's domain spanning generations).  [] when the gang asks for
    no block (or for more than one profile), or no domain offers it:
    the best-fit domain fallback takes it then."""
    from nos_tpu_torch.kube.resources import pod_request
    from nos_tpu_torch.topology.hybrid import gpu_count
    from nos_tpu_torch.topology.known import DEFAULT_REGISTRY
    from nos_tpu_torch.topology.profile import (
        block_dims, extract_slice_requests,
    )
    from nos_tpu_torch.topology.windows import aligned_index_windows

    profiles: set[str] = set()
    for pod in members:
        profiles.update(extract_slice_requests(pod_request(pod)))
    if len(profiles) != 1:
        return []
    profile = min(profiles)     # the only one
    dims = block_dims(profile)
    if dims is None:
        return []       # a MIG instance lies on one node: no window
    hosts_needed, gpus = dims

    by_domain: dict[str, dict[int, str]] = {}
    needed_by_domain: dict[str, int | None] = {}   # None: not offered
    mixed: set[str] = set()     # poisoned for good, not just popped
    for node in api.list(KIND_NODE):
        labels = node.metadata.labels
        domain = labels.get(C.LABEL_NVLINK_DOMAIN, "")
        accel = labels.get(C.LABEL_ACCELERATOR, "")
        if not domain or domain in mixed \
                or accel not in DEFAULT_REGISTRY.models:
            continue
        model = DEFAULT_REGISTRY.get(accel)
        needed = (hosts_needed if model.offers_block(profile)
                  and gpu_count(labels) == gpus else None)
        if domain in needed_by_domain \
                and needed_by_domain[domain] != needed:
            logger.warning("NVLink domain %s spans GPU models or node "
                           "sizes; skipping", domain)
            mixed.add(domain)
            by_domain.pop(domain, None)
            continue
        needed_by_domain[domain] = needed
        try:
            idx = int(labels.get(C.LABEL_HOST_INDEX, "0"))
        except ValueError:
            continue
        by_domain.setdefault(domain, {})[idx] = node.metadata.name
    out: list[tuple[str, frozenset[str]]] = []
    for domain in sorted(by_domain):
        needed = needed_by_domain.get(domain)
        if needed is None:
            continue
        hosts = by_domain[domain]
        for window in aligned_index_windows(hosts, needed):
            out.append((domain, frozenset(hosts[i] for i in window)))
    return out


class TopologyFilter:
    """Filter plugin: a gang member must sit in the gang's pinned NVLink
    domain (and block window, where one is pinned), and a labelled
    domain must hold the PodGroup's mesh.  The
    mesh's GPUs and each domain's GPU total are read once in PreFilter
    into cycle state: Filter runs per member x node and stays O(1)."""

    name = "TopologyFilter"

    def __init__(self, api: APIServer) -> None:
        self._api = api

    def pre_filter(self, state: CycleState, pod: Pod,
                   nodes: SharedLister) -> Status:
        gang = gang_name(pod)
        if not gang:
            return Status.ok()
        if _MESH_GPUS_KEY not in state:
            pg = get_pod_group(self._api, gang, pod.metadata.namespace)
            state[_MESH_GPUS_KEY] = requested_mesh_chips(pg)
        if _DOMAIN_GPUS_KEY not in state:
            counts: dict[str, int] = {}
            for ni in nodes.list():
                labels = ni.node.metadata.labels
                domain = labels.get(C.LABEL_NVLINK_DOMAIN, "")
                if domain:
                    counts[domain] = counts.get(domain, 0) + int(
                        labels.get(C.LABEL_GPU_COUNT, "0"))
            state[_DOMAIN_GPUS_KEY] = counts
        return Status.ok()

    def filter(self, state: CycleState, pod: Pod,
               node_info: NodeInfo) -> Status:
        gang = gang_name(pod)
        if not gang:
            return Status.ok()
        domain = node_info.node.metadata.labels.get(C.LABEL_NVLINK_DOMAIN, "")
        pinned = state.get(GANG_DOMAIN_KEY)
        # "" pins to unlabelled nodes only: a gang never straddles a
        # labelled domain and anything else
        if pinned is not None and domain != pinned:
            return Status.unschedulable(
                f"gang {gang} pinned to NVLink domain "
                f"{pinned or '(unlabeled)'}, node is in "
                f"{domain or '(unlabeled)'}")
        allowed_hosts = state.get(GANG_HOST_SET_KEY)
        if allowed_hosts is not None and node_info.name not in allowed_hosts:
            return Status.unschedulable(
                f"gang {gang} pinned to block nodes "
                f"{sorted(allowed_hosts)}, node {node_info.name} is outside")
        gpus = state.get(_MESH_GPUS_KEY)
        if gpus is not None and domain:
            total = state.get(_DOMAIN_GPUS_KEY, {}).get(domain, 0)
            if total < gpus:
                return Status.unschedulable(
                    f"NVLink domain {domain} has {total} GPUs < mesh "
                    f"requirement {gpus}")
        return Status.ok()


def evict_gang(api: APIServer, victim: Pod) -> list[str]:
    """Delete ``victim`` and, when it is a gang member, every pod of its
    gang (a partial gang would hold its GPUs and never run), and reset
    its PodGroup to Pending/0.  Returns the keys deleted; a pod already
    gone is skipped."""
    gang = gang_name(victim)
    doomed = [victim]
    if gang:
        doomed = api.list(KIND_POD, namespace=victim.metadata.namespace,
                          label_selector={C.LABEL_POD_GROUP: gang})
    deleted = []
    for p in doomed:
        try:
            api.delete(KIND_POD, p.metadata.name, p.metadata.namespace)
            deleted.append(p.key)
        except NotFound:
            pass
    if gang:
        pg = get_pod_group(api, gang, victim.metadata.namespace)
        if pg is not None:
            set_pod_group_status(api, pg, PHASE_PENDING, 0)
    return deleted
