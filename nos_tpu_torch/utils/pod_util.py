"""Pod predicates, ``nos_tpu/utils/pod_util.py`` for the port (reference
pkg/util/pod/pod.go:31-101): the one the partitioner controller reads."""

from __future__ import annotations

from nos_tpu_torch.kube.objects import PENDING, Pod


def extra_resources_could_help_scheduling(pod: Pod) -> bool:
    """Pending, marked unschedulable, not preempting (no nominated node)
    and not owned by a DaemonSet (reference pod.go:41-48): the pods a
    repartition could rescue."""
    return (
        pod.status.phase == PENDING
        and pod.is_unschedulable()
        and not pod.status.nominated_node_name
        and pod.metadata.owner_kind != "DaemonSet"
    )
