"""The partitioning planner: greedy geometry search with scheduler
simulation, ``nos_tpu/partitioning/core/planner.py`` for the port
(reference internal/partitioning/core/planner.go:67-207).

1. Track the profiles the pending batch lacks cluster-wide (SliceTracker).
2. Sort the pods: priority first, smallest profile first.
3. For each candidate node: fork the snapshot, re-carve the node toward
   the lacking profiles (``update_geometry_for``), then run each pending
   pod through the framework's PreFilter and Filter against the
   hypothetical NodeInfo; commit the fork if a pod was placed, else
   revert.
4. Return the desired PartitioningState of every node.

Before a fork's pods are tried, the native batch fit screen
(``scheduler/native_filter.py``) seeds the fork's failed-class memo with
every class NodeResourcesFit rejects on the re-carved node, in one call
(``prescreen_fails`` counts them); the classes are marshalled once a
plan.  A native fail is a pipeline fail, so the decisions are the same
with and without it (``native_prescreen=False``).
"""

from __future__ import annotations

import logging

from nos_tpu_torch.kube.objects import Pod
from nos_tpu_torch.kube.resources import pod_request
from nos_tpu_torch.obs import journal as J
from nos_tpu_torch.obs.journal import record as journal_record
from nos_tpu_torch.obs.trace import bump as obs_bump, span as obs_span
from nos_tpu_torch.scheduler.framework import (
    CycleState, Framework, SharedLister, filter_equivalence_key,
)
from nos_tpu_torch.scheduler.native_filter import FitPrescreen

from ..state import PartitioningState
from .actuator import compute_partitioning_state
from .interfaces import (
    PartitionCalculator, Planner, SliceCalculator, Sorter,
)
from .snapshot import ClusterSnapshot, SnapshotError
from .sorter import ProfileAwareSorter
from .tracker import SliceTracker

logger = logging.getLogger(__name__)


class GeometryPlanner(Planner):
    def __init__(self, framework: Framework, calculator: SliceCalculator,
                 partition_calculator: PartitionCalculator,
                 sorter: Sorter | None = None,
                 native_prescreen: bool = True) -> None:
        self._framework = framework
        self._calculator = calculator
        self._partition_calculator = partition_calculator
        self._sorter = sorter or ProfileAwareSorter(calculator)
        # the native screen, where a native fail is sure to be the
        # pipeline's (NodeResourcesFit in the chain)
        prescreen = FitPrescreen(framework) if native_prescreen else None
        self._prescreen = (prescreen if prescreen is not None
                           and prescreen.verdict_sound else None)

    def plan(self, snapshot: ClusterSnapshot,
             pending_pods: list[Pod]) -> PartitioningState:
        with obs_span("planner.plan", pods=len(pending_pods)):
            return self._plan(snapshot, pending_pods)

    def _plan(self, snapshot: ClusterSnapshot,
              pending_pods: list[Pod],
              tracker: SliceTracker | None = None) -> PartitioningState:
        if tracker is None:
            tracker = SliceTracker(snapshot, self._calculator, pending_pods)
        if tracker.empty:
            return compute_partitioning_state(snapshot, self._partition_calculator)

        pods = [
            p for p in self._sorter.sort(pending_pods)
            if self._calculator.requested_profiles(p)
        ]
        # one generation-gated lister for the whole plan
        lister = snapshot.shared_lister()
        # (pod, key, equivalence class) hoisted for the whole plan: the
        # candidate loop touches every pod per candidate
        entries = [(p, p.key, filter_equivalence_key(p)) for p in pods]
        # the plan's classes marshalled once for the native screen
        class_order: list = []
        compiled = None
        if self._prescreen is not None:
            requests: dict = {}
            for p, _, ekey in entries:
                if ekey not in requests:
                    requests[ekey] = pod_request(p)
            class_order = list(requests)
            compiled = self._prescreen.compile_classes(list(requests.values()))
        # iterate by NAME and re-fetch after fork/revert: revert() swaps
        # the snapshot's node objects
        candidate_names = [n.name for n in snapshot.get_candidate_nodes()]
        for node_name in candidate_names:
            if tracker.empty:
                break
            obs_bump("forks")
            snapshot.fork()
            node = snapshot.get_node_for_write(node_name)
            changed = node.update_geometry_for(tracker.lacking)
            placed: set[str] = set()
            # Pod-equivalence memo, scoped to this fork: the node's
            # capacity only shrinks between placements (the re-carve ran
            # once, above), so a failed verdict holds for every later
            # pod of the same class.  Without it the loop runs the
            # pipeline once per pod per candidate.
            failed: set = set()
            if compiled is not None:
                # the classes NodeResourcesFit rejects on the re-carved
                # node, in one call; a class placed earlier is never
                # looked up again
                verdicts = self._prescreen.screen_compiled(
                    node.node_info(), compiled)
                failed.update(k for k, ok in zip(class_order, verdicts)
                              if not ok)
                obs_bump("prescreen_fails", len(failed))
            for pod, pkey, ekey in entries:
                if tracker.empty:
                    break
                if ekey in failed:
                    continue
                if self._try_add_pod(snapshot, lister, node_name, pod):
                    tracker.remove(pod)
                    placed.add(pkey)
                else:
                    failed.add(ekey)
            if placed:
                obs_bump("commits")
                snapshot.commit()
                journal_record(J.PLAN_NODE_COMMITTED, node_name,
                               placed=len(placed), changed=changed)
                entries = [e for e in entries if e[1] not in placed]
                logger.debug("planner: node %s re-carved (changed=%s, "
                             "placed=%d)", node_name, changed, len(placed))
            else:
                obs_bump("reverts")
                snapshot.revert()
                if changed:
                    journal_record(J.PLAN_NODE_REVERTED, node_name)
        return compute_partitioning_state(snapshot, self._partition_calculator)

    def _try_add_pod(self, snapshot: ClusterSnapshot, lister: SharedLister,
                     node_name: str, pod: Pod) -> bool:
        if not self._can_schedule(snapshot, lister, node_name, pod):
            return False
        try:
            snapshot.add_pod(node_name, pod)
        except SnapshotError:
            # the one failure add_pod defines: the hypothetical bind
            # does not fit the node's devices
            return False
        return True

    def _can_schedule(self, snapshot: ClusterSnapshot, lister: SharedLister,
                      node_name: str, pod: Pod) -> bool:
        """The framework's PreFilter and Filter against the hypothetical
        NodeInfo (reference planner.go:178-207)."""
        node = snapshot.get_node(node_name)
        state = CycleState()
        status = self._framework.run_pre_filter_plugins(state, pod, lister)
        if not status.is_success:
            return False
        status = self._framework.run_filter_plugins(state, pod, node.node_info())
        return status.is_success
