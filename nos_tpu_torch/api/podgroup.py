"""PodGroup, the gang-scheduling unit, ``nos_tpu/api/podgroup.py`` for
the port (modelled, as there, on the kubernetes-sigs scheduler-plugins
coscheduling PodGroup; the reference ``nos`` has none).

Pods join a group through the ``nos.nebuly.com/pod-group`` label; the
scheduler admits the group all or nothing once ``min_member`` of its
pods exist, inside one NVLink domain (``LABEL_NVLINK_DOMAIN``).
``mesh`` optionally names the job's device mesh (e.g. "4x8", 32 GPUs):
a labelled domain with fewer GPUs than that is no candidate.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from nos_tpu_torch.kube.objects import FastCopy, ObjectMeta

PHASE_PENDING = "Pending"
PHASE_SCHEDULED = "Scheduled"


@dataclass
class PodGroupSpec(FastCopy):
    # schedule no member until this many exist, then all at once
    min_member: int = 1
    # the job's device mesh ("2x4"); empty: no size requirement
    mesh: str = ""


@dataclass
class PodGroupStatus(FastCopy):
    phase: str = PHASE_PENDING
    scheduled: int = 0


@dataclass
class PodGroup(FastCopy):
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodGroupSpec = field(default_factory=PodGroupSpec)
    status: PodGroupStatus = field(default_factory=PodGroupStatus)
