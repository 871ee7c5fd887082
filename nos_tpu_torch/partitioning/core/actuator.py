"""The partitioning actuator: diff desired against current and hand each
changed node to the strategy, ``nos_tpu/partitioning/core/actuator.py``
for the port (reference internal/partitioning/core/actuator.go:39-66).

Nothing is written when the desired state is empty or equals the
current one; otherwise every changed node is applied under one fresh
plan id.  A node whose ``apply_partitioning`` raises does not stop the
others: it is counted (``nos_tpu_actuation_failures_total``), journaled
and left for the next cycle.  The JAX actuator also feeds a failing
node to the controller's quarantine breaker; that waits for the
controller slice, and the actuator runs without it.
"""

from __future__ import annotations

import logging
import uuid

from nos_tpu_torch.exporter.metrics import REGISTRY
from nos_tpu_torch.obs import journal as J
from nos_tpu_torch.obs.journal import record as journal_record
from nos_tpu_torch.obs.trace import detail_span, span as obs_span

from ..state import PartitioningState
from .interfaces import Actuator, PartitionCalculator, Partitioner

REGISTRY.describe("nos_tpu_actuation_failures_total",
                  "Per-node apply_partitioning failures (isolated)")

logger = logging.getLogger(__name__)


def new_plan_id() -> str:
    return uuid.uuid4().hex[:12]


def compute_partitioning_state(
    snapshot, partition_calculator: PartitionCalculator,
) -> PartitioningState:
    """The desired state of every node of ``snapshot``, shared by the
    planner and the actuator so their diff cannot drift."""
    state = PartitioningState()
    for name, node in snapshot.nodes().items():
        state[name] = partition_calculator.node_partitioning(node)
    return state


class GeometryActuator(Actuator):
    def __init__(self, partitioner: Partitioner,
                 partition_calculator: PartitionCalculator,
                 kind: str = "") -> None:
        self._partitioner = partitioner
        self._partition_calculator = partition_calculator
        self._kind = kind

    def current_state(self, snapshot) -> PartitioningState:
        return compute_partitioning_state(snapshot, self._partition_calculator)

    def apply(self, snapshot, desired: PartitioningState) -> bool:
        """True if anything was actuated."""
        if desired.empty:
            logger.debug("actuator: desired state empty, skipping")
            return False
        current = self.current_state(snapshot)
        if desired.equal(current):
            logger.debug("actuator: desired equals current, skipping")
            return False
        plan_id = new_plan_id()
        with obs_span("actuator.apply", kind=self._kind,
                      plan_id=plan_id) as sp:
            changed, failed = self._apply_nodes(current, desired, plan_id)
            if sp is not None:
                sp.set("failed", len(failed))
        if failed:
            logger.warning("actuator: plan %s applied with %d node "
                           "failure(s): %s", plan_id, len(failed), failed)
        return changed

    def _apply_nodes(self, current: PartitioningState,
                     desired: PartitioningState,
                     plan_id: str) -> tuple[bool, list[str]]:
        changed = False
        failed: list[str] = []
        for node_name, node_partitioning in desired.items():
            if node_name in current and current[node_name] == node_partitioning:
                continue
            try:
                with detail_span("actuator.apply_node", node=node_name):
                    self._partitioner.apply_partitioning(
                        node_name, plan_id, node_partitioning)
            except Exception as e:  # noqa: BLE001 — per-node isolation
                failed.append(node_name)
                REGISTRY.inc("nos_tpu_actuation_failures_total",
                             labels={"kind": self._kind})
                journal_record(J.ACTUATION_FAILED, node_name,
                               kind=self._kind, plan_id=plan_id,
                               error=repr(e))
                logger.warning("actuator: node %s apply failed: %s",
                               node_name, e)
                continue
            changed = True
            journal_record(J.NODE_ACTUATED, node_name,
                           kind=self._kind, plan_id=plan_id)
        return changed, failed
