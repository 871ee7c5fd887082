"""Malleable gangs, ``nos_tpu/scheduler/elastic.py`` for the port: the
control plane's side of the dp-elasticity contract.

A gang whose members carry ``nos.tpu/elastic: "dp"`` and replica bounds
(``api/constants.py``) trades a fixed world size for utilisation:

- **grow**: the scheduler's cycle-end pass (``maybe_grow``, called from
  ``Scheduler.run_cycle``) clones one more member for each elastic gang
  whose members all run, below its max, whose NVLink domain still holds
  a member, up to a budget per cycle.  The clone rides the normal queue
  on the next cycle, so admission, quota and topology all apply as to
  any pod.
- **shrink**: the capacity plugin's victim walk treats members of a gang
  above its min as shrinkable: the cheapest preemption rung, walked
  before even best-effort pods, whose eviction does not take the whole
  gang, so the job loses one dp replica and not its run.  Eligibility is
  unchanged; only the amplification and the order are, so the victim
  prescreen's superset contract holds.

Both directions stamp ``nos.tpu/dp-resize`` (the new member count) on
every surviving member; the training main reads it at each landed
checkpoint and exits there for a restart on the new mesh
(``cmd/train.py``), so a resize costs one checkpoint restart and no
lost work.

The grow probe pins the clone to its template's NVLink domain
(``gang.GANG_DOMAIN_KEY`` with ``LABEL_NVLINK_DOMAIN``, what
``Scheduler.schedule_gang`` pins), where the JAX package pins the
template's TPU pod.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.exporter.metrics import REGISTRY
from nos_tpu_torch.kube.client import APIServer, KIND_POD, NotFound
from nos_tpu_torch.kube.objects import PENDING, RUNNING, Pod, new_uid
from nos_tpu_torch.obs import journal as J
from nos_tpu_torch.utils.pod_util import elastic_replica_bounds
from nos_tpu_torch.utils.retry import retry_on_conflict

logger = logging.getLogger(__name__)

REGISTRY.describe("nos_tpu_gang_resize_total",
                  "Elastic gang dp resizes by direction (grow/shrink)")


def live_gang_members(api: APIServer, namespace: str,
                      gang: str) -> list[Pod]:
    return api.list(
        KIND_POD, namespace=namespace,
        label_selector={C.LABEL_POD_GROUP: gang},
        filter_fn=lambda p: p.status.phase in (PENDING, RUNNING))


def shrink_headroom(members: list[Pod]) -> int:
    """The members the gang may lose before its declared min (0: rigid,
    or already at the floor).  The bounds ride on every member alike, so
    any one gives them."""
    if not members:
        return 0
    bounds = elastic_replica_bounds(members[0])
    if bounds is None:
        return 0
    return max(0, len(members) - bounds[0])


def stamp_resize(api: APIServer, members: list[Pod],
                 new_count: int) -> None:
    """Write the dp replica count after the resize on every member
    (ANNOT_DP_RESIZE), the signal the training main's checkpoint hook
    reads.  Advisory: a failed stamp only delays the re-mesh."""
    value = str(new_count)

    def mutate(p: Pod) -> None:
        p.metadata.annotations[C.ANNOT_DP_RESIZE] = value

    for member in members:
        try:
            retry_on_conflict(api, KIND_POD, member.metadata.name, mutate,
                              member.metadata.namespace,
                              component="elastic-resize")
        except NotFound:
            continue            # the evicted member itself
        except Exception:  # noqa: BLE001 — advisory annotation
            logger.debug("dp-resize stamp failed for %s", member.key)


def record_shrink(api: APIServer, namespace: str, gang: str,
                  evicted: int, **attrs: object) -> None:
    """What every shrink books (the victim walk, the defragmenter): the
    survivors' dp-resize stamp, the resize counter and a GANG_RESIZED
    record.  A gang left with no member was not shrunk but died whole
    (``evict_gang``), so nothing is recorded for it."""
    survivors = live_gang_members(api, namespace, gang)
    if not survivors:
        return
    stamp_resize(api, survivors, len(survivors))
    REGISTRY.inc("nos_tpu_gang_resize_total", float(evicted),
                 labels={"direction": "shrink"})
    J.record(J.GANG_RESIZED, f"{namespace}/{gang}", direction="shrink",
             evicted=evicted, replicas=len(survivors), **attrs)


def clone_member_for_grow(template: Pod, name: str,
                          created: float) -> Pod:
    """A fresh pending replica cloned from a live member: its request,
    labels and contract; identity, binding and status reset, so it rides
    the normal admission queue.  A grown replica is new work: it keeps
    no displaced or migrate stamp of its template (a displaced elastic
    gang would otherwise mint queue-jumping clones up to its max)."""
    pod = template.__deepcopy__({})
    pod.metadata.name = name
    pod.metadata.uid = new_uid()
    pod.metadata.creation_timestamp = created
    pod.metadata.resource_version = 0
    pod.metadata.labels.pop(C.LABEL_UNSCHEDULABLE_CLASS, None)
    for key in (C.ANNOT_JOB_PROGRESS, C.ANNOT_DP_RESIZE, C.ANNOT_DISPLACED,
                C.ANNOT_MIGRATE):
        pod.metadata.annotations.pop(key, None)
    pod.spec.node_name = ""
    pod.status.phase = PENDING
    pod.status.conditions = []
    pod.status.nominated_node_name = ""
    return pod


def maybe_grow(api: APIServer, framework: Any, lister: Any,
               budget: int = 1,
               clock: Callable[[], float] = time.time) -> int:
    """The cycle-end grow pass: for each elastic gang whose members all
    run, below max-replicas, check that one more member fits its NVLink
    domain (PreFilter and Filter on the cycle's view after its binds)
    and create the clone.  Returns the members created.

    A gang with a pending member is skipped: one still assembling, or
    whose last grow has not bound, finishes first, which also limits
    growth to one member per gang per bind."""
    if budget <= 0:
        return 0
    from nos_tpu_torch.scheduler.framework import CycleState
    from nos_tpu_torch.scheduler.gang import GANG_DOMAIN_KEY

    gangs: dict[tuple[str, str], list[Pod]] = {}
    blocked: set[tuple[str, str]] = set()
    for pod in api.list(KIND_POD):
        gang = pod.metadata.labels.get(C.LABEL_POD_GROUP, "")
        if not gang:
            continue
        key = (pod.metadata.namespace, gang)
        if pod.status.phase == PENDING:
            blocked.add(key)
        elif pod.status.phase == RUNNING and pod.spec.node_name:
            gangs.setdefault(key, []).append(pod)
    created = 0
    for key in sorted(gangs):
        if created >= budget:
            break
        if key in blocked:
            continue
        members = gangs[key]
        bounds = elastic_replica_bounds(members[0])
        if bounds is None or len(members) >= bounds[1]:
            continue
        template = min(members, key=lambda p: p.metadata.name)
        ni = lister.get(template.spec.node_name)
        pin = (ni.node.metadata.labels.get(C.LABEL_NVLINK_DOMAIN, "")
               if ni is not None else "")
        state = CycleState({GANG_DOMAIN_KEY: pin})
        probe = clone_member_for_grow(
            template, f"{template.metadata.name}-probe", clock())
        if not framework.run_pre_filter_plugins(
                state, probe, lister).is_success:
            continue
        if not any(framework.run_filter_plugins(state, probe, n).is_success
                   for n in lister.list()):
            continue
        ns, gang = key
        name = _grow_name(api, ns, gang, members)
        pod = clone_member_for_grow(template, name, clock())
        try:
            api.create(KIND_POD, pod)
        except Exception:  # noqa: BLE001 — a name collision or an
            # admission refusal: nothing created, the gang retries next
            # cycle
            logger.debug("elastic grow create failed for %s/%s", ns, gang)
            continue
        created += 1
        new_count = len(members) + 1
        stamp_resize(api, members, new_count)
        REGISTRY.inc("nos_tpu_gang_resize_total",
                     labels={"direction": "grow"})
        J.record(J.GANG_RESIZED, f"{ns}/{gang}", direction="grow",
                 replicas=new_count, member=pod.key)
        logger.info("elastic gang %s/%s grew to %d replicas (%s)",
                    ns, gang, new_count, name)
    return created


def _grow_name(api: APIServer, namespace: str, gang: str,
               members: list[Pod]) -> str:
    """A fresh member name, ``<gang>-e<N>`` with the first N unused:
    deterministic and checked against the live store."""
    taken = {p.metadata.name for p in api.list(
        KIND_POD, namespace=namespace,
        label_selector={C.LABEL_POD_GROUP: gang})}
    n = len(members)
    while f"{gang}-e{n}" in taken:
        n += 1
    return f"{gang}-e{n}"
