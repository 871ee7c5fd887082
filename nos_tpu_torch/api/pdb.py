"""PodDisruptionBudget, ``nos_tpu/api/pdb.py`` for the port: the
voluntary-eviction protection the preemption reprieve reads (reference
capacity_scheduling.go:628-675, filterPodsWithPDBViolation).  A
namespaced budget selects pods by label and allows ``disruptions_allowed
= healthy - min_available`` evictions, derived from the live pods by
``refresh_pdb_status`` in place of the upstream disruption controller.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from nos_tpu_torch.api.constants import KIND_POD_DISRUPTION_BUDGET
from nos_tpu_torch.kube.objects import FastCopy, ObjectMeta, RUNNING


@dataclass
class PodDisruptionBudgetSpec(FastCopy):
    min_available: int = 0
    selector: dict[str, str] = field(default_factory=dict)  # label match


@dataclass
class PodDisruptionBudgetStatus(FastCopy):
    disruptions_allowed: int = 0
    current_healthy: int = 0
    desired_healthy: int = 0


@dataclass
class PodDisruptionBudget(FastCopy):
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodDisruptionBudgetSpec = field(
        default_factory=PodDisruptionBudgetSpec)
    status: PodDisruptionBudgetStatus = field(
        default_factory=PodDisruptionBudgetStatus)

    def matches(self, pod) -> bool:
        if pod.metadata.namespace != self.metadata.namespace:
            return False
        labels = pod.metadata.labels
        return all(labels.get(k) == v for k, v in self.spec.selector.items())


def refresh_pdb_status(api, pdb: PodDisruptionBudget) -> PodDisruptionBudget:
    """Recompute ``pdb``'s status from the live pods: healthy = the
    Running pods it matches."""
    healthy = sum(
        1 for p in api.list("Pod", namespace=pdb.metadata.namespace)
        if p.status.phase == RUNNING and pdb.matches(p))
    pdb.status.current_healthy = healthy
    pdb.status.desired_healthy = pdb.spec.min_available
    pdb.status.disruptions_allowed = max(
        0, healthy - pdb.spec.min_available)
    return pdb


def list_pdbs(api) -> list[PodDisruptionBudget]:
    """Every budget with its status refreshed."""
    return [refresh_pdb_status(api, pdb)
            for pdb in api.list(KIND_POD_DISRUPTION_BUDGET)]


__all__ = ["KIND_POD_DISRUPTION_BUDGET", "PodDisruptionBudget",
           "PodDisruptionBudgetSpec", "PodDisruptionBudgetStatus",
           "list_pdbs", "refresh_pdb_status"]
