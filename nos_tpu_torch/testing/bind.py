"""A binder for tests and the smoke run, standing in for the scheduler
until ``nos_tpu/scheduler/scheduler.py`` is ported (ROADMAP item 7).
It is test support, not a scheduler: no scoring, queues, gangs, quotas
or preemption.

``bind_pending`` goes over the pending, unbound pods in name order.  It
runs the port's ``Framework`` filter against each node in name order
(each node's view as ``ClusterState`` builds it: the node and its live
bound pods, with every pod bound in this pass booked) and binds the pod
to the first node that fits.  A pod that fits nowhere gets the JAX
scheduler's ``PodScheduled=False/Unschedulable`` condition (message "no
fit"), written only if the pod does not carry it already: the trigger
that ``extra_resources_could_help_scheduling`` reads.  With one fitting
node per pod, and pods of equal priority created at the same time, it
binds as the JAX scheduler does.
"""

from __future__ import annotations

from nos_tpu_torch.kube.client import APIServer, KIND_NODE, KIND_POD, NotFound
from nos_tpu_torch.kube.objects import FAILED, PENDING, SUCCEEDED, PodCondition
from nos_tpu_torch.scheduler.framework import CycleState, Framework, NodeInfo
from nos_tpu_torch.utils.retry import retry_on_conflict

NO_FIT = "no fit"


def _node_infos(api: APIServer) -> list[NodeInfo]:
    infos = {n.name: NodeInfo(node=n) for n in api.list(KIND_NODE)}
    for pod in api.list(KIND_POD):
        ni = infos.get(pod.spec.node_name)
        if ni is not None and pod.status.phase not in (SUCCEEDED, FAILED):
            ni.add_pod(pod)
    return [infos[name] for name in sorted(infos)]


def _marked(pod) -> bool:
    for c in pod.status.conditions:
        if c.type == "PodScheduled":
            return (c.status == "False" and c.reason == "Unschedulable"
                    and c.message == NO_FIT)
    return False


def bind_pending(api: APIServer, framework: Framework) -> int:
    """Bind what fits, mark the rest unschedulable; returns how many
    pods were bound."""
    nodes = _node_infos(api)
    pending = sorted((p for p in api.pods_by_phase(PENDING)
                      if not p.spec.node_name),
                     key=lambda p: p.metadata.name)
    bound = 0
    for pod in pending:
        fit = next((ni for ni in nodes if framework.run_filter_plugins(
            CycleState(), pod, ni).is_success), None)
        if fit is None:
            if not _marked(pod):
                try:
                    retry_on_conflict(api, KIND_POD, pod.metadata.name,
                                      _mark_unschedulable,
                                      pod.metadata.namespace,
                                      component="bind")
                except NotFound:
                    pass
            continue

        def bind(p, node=fit.name):
            p.spec.node_name = node
            p.status.conditions = [c for c in p.status.conditions
                                   if c.type != "PodScheduled"]
        try:
            retry_on_conflict(api, KIND_POD, pod.metadata.name, bind,
                              pod.metadata.namespace, component="bind")
        except NotFound:
            continue
        fit.add_pod(pod)
        bound += 1
    return bound


def _mark_unschedulable(pod) -> None:
    pod.status.conditions = [c for c in pod.status.conditions
                             if c.type != "PodScheduled"]
    pod.status.conditions.append(
        PodCondition("PodScheduled", "False", "Unschedulable", NO_FIT))
