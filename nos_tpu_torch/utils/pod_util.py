"""Pod predicates, ``nos_tpu/utils/pod_util.py`` for the port (reference
pkg/util/pod/pod.go:31-101): the one the partitioner controller reads,
and the tier, displacement and quota-standing reads of the scheduler and
the capacity plugin."""

from __future__ import annotations

import math

from nos_tpu_torch.api import constants as C
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


def workload_tier(pod: Pod) -> str:
    """``serving``, ``batch`` or ``best-effort``; an absent or unknown
    tier label reads as batch, so a typo never grants the protected
    serving tier."""
    tier = pod.metadata.labels.get(C.LABEL_TIER, "")
    if tier in (C.TIER_SERVING, C.TIER_BATCH, C.TIER_BEST_EFFORT):
        return tier
    return C.TIER_BATCH


def tier_rank(pod: Pod) -> int:
    """Serving 0, batch 1, best-effort 2."""
    return {C.TIER_SERVING: 0, C.TIER_BATCH: 1,
            C.TIER_BEST_EFFORT: 2}[workload_tier(pod)]


def displaced_value(cause: str, now: float) -> str:
    """The ``displaced`` annotation's value for a workload displaced at
    ``now``, a time of the scheduler's clock (its rebind latency is the
    clock at bind less this stamp)."""
    return f"{cause}@{now:.3f}"


def displacement(pod: Pod) -> tuple[str, float] | None:
    """(cause, stamped at) of a displaced pod; None when it is not
    displaced or its stamp is malformed (a garbage stamp never grants
    the head-of-line slot)."""
    raw = pod.metadata.annotations.get(C.ANNOT_DISPLACED, "")
    if not raw:
        return None
    cause, sep, ts_raw = raw.rpartition("@")
    if not sep or not cause:
        return None
    try:
        ts = float(ts_raw)
    except ValueError:
        return None
    if not math.isfinite(ts):
        return None
    return cause, ts


def is_displaced_fresh(pod: Pod, now: float = 0.0,
                       age_cap_s: float = 0.0) -> bool:
    """A batch or best-effort pod with a displacement stamp no older
    than ``age_cap_s`` (<= 0: no expiry).  The admission queue's slot
    and the capacity plugin's restart-cost walk share this predicate."""
    if tier_rank(pod) == 0:
        return False
    disp = displacement(pod)
    if disp is None:
        return False
    return age_cap_s <= 0.0 or now - disp[1] <= age_cap_s


def admission_rank(pod: Pod, now: float = 0.0,
                   age_cap_s: float = 0.0) -> int:
    """The admission queue's tier: serving 0, freshly displaced batch or
    best-effort 1, batch 2, best-effort 4."""
    rank = 2 * tier_rank(pod)
    if rank >= 2 and is_displaced_fresh(pod, now, age_cap_s):
        rank = 1
    return rank


def job_progress(pod: Pod) -> float:
    """The workload's progress annotation clamped to [0, 1]; absent,
    garbage or non-finite reads 0."""
    raw = pod.metadata.annotations.get(C.ANNOT_JOB_PROGRESS, "")
    try:
        value = float(raw)
    except ValueError:
        return 0.0
    if not math.isfinite(value):
        return 0.0
    return min(1.0, max(0.0, value))


def workload_class(pod: Pod) -> str:
    """The ``class`` label of the scheduler's latency and pending
    series: ``serving`` for the serving tier; otherwise
    ``slice-<profile>`` (``gang-<profile>`` in a pod group) for the
    largest MIG profile asked for, ``ts-<gb>`` for the largest MPS
    share, ``other`` else, with ``be-`` before a best-effort pod's."""
    from nos_tpu_torch.kube.resources import pod_request
    from nos_tpu_torch.topology.profile import (
        extract_slice_requests, extract_timeshare_requests, profile_sort_key,
    )

    tier = workload_tier(pod)
    if tier == C.TIER_SERVING:
        return "serving"
    req = pod_request(pod)
    base = "other"
    profiles = extract_slice_requests(req)
    if profiles:
        kind = ("gang" if pod.metadata.labels.get(C.LABEL_POD_GROUP)
                else "slice")
        base = f"{kind}-{max(profiles, key=profile_sort_key)}"
    else:
        shares = extract_timeshare_requests(req)
        if shares:
            base = f"ts-{max(shares)}"
    if tier == C.TIER_BEST_EFFORT:
        return f"be-{base}"
    return base


def is_elastic_dp(pod: Pod) -> bool:
    """True when the pod takes part in the malleable-gang contract
    (``nos.tpu/elastic: "dp"`` and a pod-group label): the control plane
    may grow or shrink its gang's dp axis within the replica bounds.  An
    elastic annotation without a gang reads rigid."""
    return (pod.metadata.annotations.get(C.ANNOT_ELASTIC, "")
            == C.ELASTIC_DP
            and bool(pod.metadata.labels.get(C.LABEL_POD_GROUP, "")))


def elastic_replica_bounds(pod: Pod) -> tuple[int, int] | None:
    """(min_replicas, max_replicas) of an elastic dp member, or None when
    the pod is not elastic or its bounds are absent, not integers or
    inverted: a malformed contract degrades to rigid, never to
    unbounded."""
    if not is_elastic_dp(pod):
        return None
    annots = pod.metadata.annotations
    try:
        lo = int(annots.get(C.ANNOT_MIN_REPLICAS, ""))
        hi = int(annots.get(C.ANNOT_MAX_REPLICAS, ""))
    except ValueError:
        return None
    if lo < 1 or hi < lo:
        return None
    return lo, hi


def is_over_quota(pod: Pod) -> bool:
    return pod.metadata.labels.get(C.LABEL_CAPACITY) == C.CAPACITY_OVER_QUOTA


def class_tier(cls: str) -> str:
    """The tier of a ``workload_class`` value (the scoreboard folds the
    per-class series into per-tier rows): ``serving``, ``be-*``
    best-effort, the rest batch."""
    if cls == "serving":
        return C.TIER_SERVING
    if cls.startswith("be-"):
        return C.TIER_BEST_EFFORT
    return C.TIER_BATCH
