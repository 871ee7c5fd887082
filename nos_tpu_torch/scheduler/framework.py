"""Scheduler framework: plugin pipeline and NodeInfo snapshots,
``nos_tpu/scheduler/framework.py`` for the port.

The reference runs the real kube-scheduler framework in-process against
hypothetical node states inside its partitioning planner (reference
internal/partitioning/core/planner.go:178-207, wired with a fake shared
lister at cmd/gpupartitioner/gpupartitioner.go:294-318).  This module is
that framework: the planner's what-if runs PreFilter and Filter of the
same plugins a scheduler would.  ``SpareGuard`` and
``MigrationDrainGuard`` hold the recovery plane's warm spares and
migrating nodes out of every placement.  The default framework is
``NodeResourcesFit`` alone, as in the JAX package.  The scheduler and the
planner put the native batch fit screen (``scheduler/native_filter.py``)
in front of this pipeline: it replays ``NodeResourcesFit`` and runs only
where NodeResourcesFit is in the chain, so the verdicts stand.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Iterable, Protocol, runtime_checkable

from nos_tpu_torch.api.constants import (
    LABEL_ACCELERATOR, LABEL_POD_GROUP, is_migration_drain,
    is_warm_spare_labels,
)
from nos_tpu_torch.kube.objects import Node, Pod
from nos_tpu_torch.kube.resources import (
    ResourceList, fits, pod_request, subtract, sum_resources,
)
from nos_tpu_torch.obs.trace import (
    bump as obs_bump, get_tracer as obs_tracer, span as obs_span)
from nos_tpu_torch.topology.known import DEFAULT_REGISTRY, GpuModel
from nos_tpu_torch.topology.profile import PROFILE_RE, extract_slice_requests

# ---------------------------------------------------------------------------
# Status codes
# ---------------------------------------------------------------------------

SUCCESS = "Success"
UNSCHEDULABLE = "Unschedulable"
ERROR = "Error"


@dataclass
class Status:
    code: str = SUCCESS
    message: str = ""
    # machine-readable rejection class ("" = unclassified)
    reason: str = ""
    # the plugin that gave a non-success verdict (set by the runners)
    plugin: str = ""

    @property
    def is_success(self) -> bool:
        return self.code == SUCCESS

    @staticmethod
    def ok() -> "Status":
        return Status(SUCCESS)

    @staticmethod
    def unschedulable(msg: str, reason: str = "") -> "Status":
        return Status(UNSCHEDULABLE, msg, reason)

    @staticmethod
    def error(msg: str) -> "Status":
        return Status(ERROR, msg)


# ---------------------------------------------------------------------------
# NodeInfo
# ---------------------------------------------------------------------------


@dataclass
class NodeInfo:
    """Scheduling view of one node (framework.NodeInfo).  ``allocatable``
    includes the extended resources; a strategy rewrites them when it
    simulates a geometry (reference pkg/gpu/mig/node.go:171-195)."""

    node: Node
    pods: list[Pod] = field(default_factory=list)
    requested: ResourceList = field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.node.metadata.name

    @property
    def allocatable(self) -> ResourceList:
        return self.node.status.allocatable

    def free(self) -> ResourceList:
        return subtract(self.allocatable, self.requested)

    def add_pod(self, pod: Pod) -> None:
        self.pods.append(pod)
        self.requested = sum_resources(self.requested, pod_request(pod))

    def remove_pod(self, pod: Pod) -> bool:
        for i, p in enumerate(self.pods):
            if p.metadata.uid == pod.metadata.uid or p.key == pod.key:
                self.pods.pop(i)
                self.requested = subtract(self.requested, pod_request(p))
                return True
        return False

    def clone(self) -> "NodeInfo":
        return NodeInfo(
            node=self.node.__deepcopy__({}),
            pods=list(self.pods),
            requested=dict(self.requested),
        )


def filter_equivalence_key(pod: Pod) -> tuple:
    """A pod's class under the Filter pipeline: its verdict is a pure
    function of (namespace, gang, request) against fixed node state.
    The planner's per-fork memo keys on it; a Filter plugin that reads
    any other pod attribute must extend the key."""
    return (pod.metadata.namespace,
            pod.metadata.labels.get(LABEL_POD_GROUP, ""),
            frozenset(pod_request(pod).items()))


class CycleState(dict):
    """Per-scheduling-cycle scratch space shared across plugins."""


# ---------------------------------------------------------------------------
# Plugin protocols
# ---------------------------------------------------------------------------


@runtime_checkable
class PreFilterPlugin(Protocol):
    name: str

    def pre_filter(self, state: CycleState, pod: Pod,
                   nodes: "SharedLister") -> Status: ...


@runtime_checkable
class FilterPlugin(Protocol):
    name: str

    def filter(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> Status: ...


@runtime_checkable
class PostFilterPlugin(Protocol):
    name: str

    def post_filter(self, state: CycleState, pod: Pod,
                    nodes: "SharedLister") -> tuple[str, Status]: ...


@runtime_checkable
class ReservePlugin(Protocol):
    name: str

    def reserve(self, state: CycleState, pod: Pod, node_name: str) -> Status: ...

    def unreserve(self, state: CycleState, pod: Pod, node_name: str) -> None: ...


@runtime_checkable
class PreFilterExtensions(Protocol):
    """AddPod/RemovePod extensions keeping cycle-state snapshots coherent
    during preemption what-ifs."""

    def add_pod(self, state: CycleState, pod_to_schedule: Pod,
                pod_to_add: Pod, node_info: NodeInfo) -> Status: ...

    def remove_pod(self, state: CycleState, pod_to_schedule: Pod,
                   pod_to_remove: Pod, node_info: NodeInfo) -> Status: ...


# ---------------------------------------------------------------------------
# Shared lister
# ---------------------------------------------------------------------------


class SharedLister:
    """Holds the NodeInfo snapshot the framework schedules against; the
    planner passes hypothetical ones (reference pkg/test/util/fake.go)."""

    def __init__(self, node_infos: Iterable[NodeInfo] = ()) -> None:
        self._infos: dict[str, NodeInfo] = {ni.name: ni for ni in node_infos}

    def list(self) -> list[NodeInfo]:
        return list(self._infos.values())

    def get(self, name: str) -> NodeInfo | None:
        return self._infos.get(name)


# ---------------------------------------------------------------------------
# Built-in plugin: NodeResourcesFit
# ---------------------------------------------------------------------------


def _mig_slots(resources: ResourceList,
               model: GpuModel | None) -> tuple[int, int]:
    """(compute slices, memory slots) held by the MIG profile resources:
    the ``g`` of ``<g>g.<N>gb``, and the profile's ``memory_slices`` in
    the node's model (0 for a profile its table lacks).  A card has 7
    and 8 of them; the JAX package's ``_slice_chips`` counts TPU chips,
    which are compute and memory at once."""
    compute = memory = 0
    for p, qty in extract_slice_requests(resources).items():
        m = PROFILE_RE.match(p)
        if m is None:
            continue    # an NVLink block member: whole GPUs, no MIG slots
        compute += int(m.group("g")) * qty
        prof = model.profile(p) if model is not None else None
        if prof is not None:
            memory += prof.memory_slices * qty
    return compute, memory


class NodeResourcesFit:
    """The pod's request must fit the node's free capacity.

    For MIG resources the per-profile check alone is unsound while a
    repartition is in flight: a bound pod whose profile was re-carved
    away subtracts from no advertised profile.  The aggregate guard
    keeps a node from being bound past its carved compute slices or
    past its carved memory slots, whatever the current geometry says
    per profile: three bound 1g.20gb pods hold 6 of a card's 8 memory
    slots, so a card re-carved to 1g.10gb x 7 under them takes one more
    1g.10gb pod, not four.  The memory slots are the node model's
    (``nos.nebuly.com/accelerator`` in the default registry); a node of
    no known model is held to its compute slices alone."""

    name = "NodeResourcesFit"

    def filter(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> Status:
        req = pod_request(pod)
        if fits(req, node_info.free()):
            model = DEFAULT_REGISTRY.models.get(
                node_info.node.metadata.labels.get(LABEL_ACCELERATOR, ""))
            pod_g, pod_m = _mig_slots(req, model)
            if pod_g:
                cap_g, cap_m = _mig_slots(node_info.allocatable, model)
                used_g, used_m = _mig_slots(node_info.requested, model)
                if used_g + pod_g > cap_g:
                    return Status.unschedulable(
                        f"insufficient MIG compute slices ({used_g}+"
                        f"{pod_g} over {cap_g}; geometry in flux)")
                if used_m + pod_m > cap_m:
                    return Status.unschedulable(
                        f"insufficient MIG memory slots ({used_m}+"
                        f"{pod_m} over {cap_m}; geometry in flux)")
            return Status.ok()
        missing = [
            k for k, v in req.items()
            if v > 0 and node_info.free().get(k, 0.0) < v
        ]
        return Status.unschedulable(
            f"insufficient {', '.join(sorted(missing))}"
        )


# ---------------------------------------------------------------------------
# Built-in plugins: the recovery plane's holds
# ---------------------------------------------------------------------------


class SpareGuard:
    """A node labelled ``spare: "warm"`` is a carved warm replacement
    (``partitioning/core/failure.py``): it takes no pod until the spare
    policy promotes it by taking the label off.  A plain Filter, so every
    placement path (the cycle, gang what-ifs, preemption what-ifs)
    respects the hold.  With no spare in the cluster it rejects
    nothing."""

    name = "SpareGuard"

    def filter(self, state: CycleState, pod: Pod,
               node_info: NodeInfo) -> Status:
        if is_warm_spare_labels(node_info.node.metadata.labels):
            return Status.unschedulable("node held as warm spare")
        return Status.ok()


class MigrationDrainGuard:
    """A node being drain-migrated (``defrag-drain`` with a ``migrate:``
    value, stamped by ``failure.py`` on a suspect or maintenance node)
    takes no new pod: its agent is presumed dying, so a pod bound there
    would be admitted by nobody and lost with the node.  Harder than a
    defrag drain (same annotation, a proposal id), which stays a soft
    avoidance in the score key.  With no migration drain it rejects
    nothing."""

    name = "MigrationDrainGuard"

    def filter(self, state: CycleState, pod: Pod,
               node_info: NodeInfo) -> Status:
        if is_migration_drain(node_info.node.metadata.annotations):
            return Status.unschedulable("node draining for migration")
        return Status.ok()


# ---------------------------------------------------------------------------
# Framework
# ---------------------------------------------------------------------------


class Framework:
    """Ordered plugin runner (schedulerruntime.NewFramework).  Which
    extension points a plugin has is resolved once, at construction:
    a runtime-checkable Protocol check per call would run per pod ×
    node in the planner's simulation."""

    def __init__(self, plugins: Iterable[object] = ()) -> None:
        self._plugins = list(plugins) or [NodeResourcesFit()]
        self._lock = threading.RLock()
        self._pre_filter = [
            p for p in self._plugins
            if isinstance(p, PreFilterPlugin) and hasattr(p, "pre_filter")]
        self._filter = [
            p for p in self._plugins
            if isinstance(p, FilterPlugin) and hasattr(p, "filter")]
        self._post_filter = [
            p for p in self._plugins
            if isinstance(p, PostFilterPlugin) and hasattr(p, "post_filter")]
        self._extensions = [
            p for p in self._plugins
            if isinstance(p, PreFilterExtensions) and hasattr(p, "add_pod")]
        self._reserve = [
            p for p in self._plugins
            if isinstance(p, ReservePlugin) and hasattr(p, "reserve")]

    @property
    def plugins(self) -> list[object]:
        return list(self._plugins)

    @property
    def filter_chain(self) -> list[object]:
        """The Filter plugins in run order."""
        return list(self._filter)

    def run_pre_filter_plugins(self, state: CycleState, pod: Pod,
                               nodes: SharedLister) -> Status:
        obs_bump("prefilter_runs")
        if not self._pre_filter:
            return Status.ok()
        with self._lock:
            for p in self._pre_filter:
                st = p.pre_filter(state, pod, nodes)
                if not st.is_success:
                    st.plugin = getattr(p, "name", type(p).__name__)
                    return st
            return Status.ok()

    def run_filter_plugins(self, state: CycleState, pod: Pod,
                           node_info: NodeInfo) -> Status:
        # a counter bump on the enclosing span always; a child span per
        # pipeline run on a detailed tracer
        obs_bump("filter_runs")
        tracer = obs_tracer()
        if tracer.detailed:
            with tracer.span("framework.filter", pod=pod.key,
                             node=node_info.name) as sp:
                st = self._filter_pipeline(state, pod, node_info)
                if not st.is_success:
                    sp.set("plugin", st.plugin)
                    sp.set("reason", st.message)
                return st
        return self._filter_pipeline(state, pod, node_info)

    def _filter_pipeline(self, state: CycleState, pod: Pod,
                         node_info: NodeInfo) -> Status:
        with self._lock:
            for p in self._filter:
                st = p.filter(state, pod, node_info)
                if not st.is_success:
                    st.plugin = getattr(p, "name", type(p).__name__)
                    return st
            return Status.ok()

    def run_post_filter_plugins(self, state: CycleState, pod: Pod,
                                nodes: SharedLister) -> tuple[str, Status]:
        with obs_span("framework.post_filter", pod=pod.key):
            with self._lock:
                for p in self._post_filter:
                    nominated, st = p.post_filter(state, pod, nodes)
                    if st.is_success:
                        return nominated, st
                return "", Status.unschedulable(
                    "no postfilter plugin succeeded")

    def run_pre_filter_extension_add_pod(
            self, state: CycleState, pod_to_schedule: Pod, pod_to_add: Pod,
            node_info: NodeInfo) -> Status:
        """Book a hypothetically placed pod into every plugin's cycle
        state (preemption what-ifs, gang placement)."""
        with self._lock:
            for p in self._extensions:
                st = p.add_pod(state, pod_to_schedule, pod_to_add,
                               node_info)
                if not st.is_success:
                    return st
            return Status.ok()

    def run_reserve_plugins(self, state: CycleState, pod: Pod,
                            node_name: str) -> Status:
        with self._lock:
            for p in self._reserve:
                st = p.reserve(state, pod, node_name)
                if not st.is_success:
                    return st
            return Status.ok()

    def run_unreserve_plugins(self, state: CycleState, pod: Pod,
                              node_name: str) -> None:
        with self._lock:
            for p in self._reserve:
                if hasattr(p, "unreserve"):
                    p.unreserve(state, pod, node_name)
