"""Gang membership, the part of ``nos_tpu/scheduler/gang.py`` the
single-pod path reads: a pod's gang, and whole-gang eviction for the
capacity plugin's preemption.  Pods sharing a
``nos.nebuly.com/pod-group`` label are one gang, all or nothing in
death as in admission.  The gang path itself (``TopologyFilter``, the
windows, pod groups, ``Scheduler.schedule_gang``) is ROADMAP item 7's
next slice; until then ``Scheduler.run_cycle`` refuses a pending gang,
and no PodGroup object exists for ``evict_gang`` to reset.
"""

from __future__ import annotations

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.kube.client import KIND_POD, NotFound
from nos_tpu_torch.kube.objects import Pod


def gang_name(pod: Pod) -> str:
    return pod.metadata.labels.get(C.LABEL_POD_GROUP, "")


def evict_gang(api, victim: Pod) -> list[str]:
    """Delete ``victim`` and, when it is a gang member, every pod of its
    gang (a partial gang would hold its GPUs and never run).  Returns
    the keys deleted; a pod already gone is skipped."""
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
    return deleted
