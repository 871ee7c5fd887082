"""API contracts: labels, annotations, resource names,
``nos_tpu/api/constants.py`` for the port, the part its partitioning
planner, its controller, its node sides, its scheduler and its quotas
read.

The JAX package names its TPU contracts under ``nos.tpu``; the port
uses the reference ``nos``'s GPU vocabulary under ``nos.nebuly.com``
(reference pkg/api/nos.nebuly.com/v1alpha1/{labels.go,annotations.go},
pkg/constant/constants.go) and NVIDIA's own names where a GPU cluster
has them (``nvidia.com/gpu``, the GPU operator's
``nvidia.com/gpu.count``).  Everything that crosses a process boundary
is defined here, but for the resource names of the profiles, which live
in ``topology/profile.py`` with their parsers.
"""

from __future__ import annotations

import re

# the MPS share prefix, nvidia.com/gpu-<N>gb: defined beside its parser
from nos_tpu_torch.topology.profile import RESOURCE_TIMESHARE_PREFIX  # noqa: F401  # noslint: N006 — re-export: readers of the contracts (testing/fleet.py's C.RESOURCE_TIMESHARE_PREFIX) get the share prefix here

GROUP = "nos.nebuly.com"

# ---------------------------------------------------------------------------
# Labels
# ---------------------------------------------------------------------------

# Partitioning mode of a node: "mig", "mps" or "hybrid" (reference label
# nos.nebuly.com/gpu-partitioning, pkg/gpu/partitioning.go:81-135).  The
# JAX package's "slice" / "timeshare" kinds.
LABEL_PARTITIONING = f"{GROUP}/gpu-partitioning"
MIG_KIND = "mig"
MPS_KIND = "mps"
HYBRID_KIND = "hybrid"

# The node's GPU model, a key of ``topology.known.GpuModelRegistry``
# (e.g. "nvidia-h100-80gb-hbm3"), and the GPU operator's count label
# (reference pkg/gpu/util.go:30-73).  A TPU host's chip count follows
# from its generation; a GPU node's is its own.
LABEL_ACCELERATOR = f"{GROUP}/accelerator"
LABEL_GPU_COUNT = "nvidia.com/gpu.count"

# The MPS plan a node's sharing config belongs to.  The value is the plan
# id alone, as in the JAX package: a label value caps at 63 characters,
# and the whole ConfigMap key ("<node>.<plan id>") would bound node
# names.  Its reader is the port's timeshare plugin
# (device/timeshare_plugin.py), which derives the key
# ``config_key(node, plan id)`` from its own node name; NVIDIA's device
# plugin, which reads the key itself from nvidia.com/device-plugin.config
# (reference internal/partitioning/mps/partitioner.go:103-110), is not
# its reader.
LABEL_DEVICE_PLUGIN_CONFIG = f"{GROUP}/device-plugin.config"

# Gang membership: pods with the same value are admitted all or nothing;
# part of a pod's Filter equivalence class.
LABEL_POD_GROUP = f"{GROUP}/pod-group"

# The node's NVLink domain, the counterpart of the JAX package's
# nos.tpu/pod-id (a TPU pod's ICI domain): a gang's members all bind
# inside one domain, so its collectives stay on NVLink.  An HGX H100
# board is one domain per node; an NVLink Switch system (a DGX H100
# SuperPOD: up to 32 nodes, 256 GPUs) is one domain over many nodes,
# every node of it carrying the same value.  Unlabelled nodes form the
# "" domain, a domain of their own: a gang pinned there takes only
# unlabelled nodes.  A domain's GPUs are the sum of its nodes'
# LABEL_GPU_COUNT.
LABEL_NVLINK_DOMAIN = f"{GROUP}/nvlink-domain"

# The node's ordinal inside its NVLink domain (the JAX package's
# nos.tpu/host-index): a domain's nodes are indexed contiguously from 0,
# so a missing index is a vacancy, and a promoted warm spare takes over
# the vanished node's index (partitioning/core/failure.py).
LABEL_HOST_INDEX = f"{GROUP}/host-index"

# Warm-spare hold: a node labelled ``nos.nebuly.com/spare: "warm"`` is a
# pre-carved replacement kept out of scheduling (the SpareGuard filter
# rejects every pod) and out of demand-driven planning (the partitioner
# leaves it out of its snapshot).  Its geometry is already actuated, so
# promoting it after a node loss is one label patch: the label comes off
# and the vanished node's host index goes on (partitioning/core/
# failure.py).
LABEL_SPARE = f"{GROUP}/spare"
SPARE_WARM = "warm"


def is_warm_spare_labels(labels: dict) -> bool:
    """The warm-spare predicate, shared by SpareGuard, the partitioner's
    snapshot exclusion and the spare policy."""
    return labels.get(LABEL_SPARE, "") == SPARE_WARM

# The cloud zone a node was provisioned in (``capacity/``): the stockout
# breaker keys on (machine class, zone), so a stockout of one zone stops
# no create for the same class elsewhere.  Absent reads "-" (one unnamed
# zone), so a cluster from before the capacity plane needs no relabel.
LABEL_ZONE = f"{GROUP}/zone"

# Quota standing of a running pod, stamped by the ElasticQuota
# reconciler (reference nos.nebuly.com/capacity, labels.go:19-24): the
# label the preemption walk keys on.
LABEL_CAPACITY = f"{GROUP}/capacity"
CAPACITY_IN_QUOTA = "in-quota"
CAPACITY_OVER_QUOTA = "over-quota"

# Machine-readable class of an Unschedulable verdict (e.g. "quota"),
# stamped by the scheduler beside the PodScheduled condition, whose
# reason stays the exact "Unschedulable" that external tooling matches.
LABEL_UNSCHEDULABLE_CLASS = f"{GROUP}/unschedulable-class"

# Workload tier: "serving" is scheduled first each cycle and is never a
# victim while in quota; "batch" may borrow and be reclaimed;
# "best-effort" is scheduled last and walked first.  Absent or unknown
# reads as batch.
LABEL_TIER = f"{GROUP}/tier"
TIER_SERVING = "serving"
TIER_BATCH = "batch"
TIER_BEST_EFFORT = "best-effort"

# The serving service a replica pod belongs to (``serving/autoscaler.py``
# creates and counts the pods of a ``ServingService`` by it; the request
# router, ``requests/router.py``, keeps a replica model per live pod of
# it).  The JAX package's nos.tpu/service.
LABEL_SERVICE = f"{GROUP}/service"

# ---------------------------------------------------------------------------
# Annotations
# ---------------------------------------------------------------------------

# Desired partitioning, per node:
#   nos.nebuly.com/spec-gpu-<index>-<profile> = <quantity>
# <profile> is a MIG profile ("1g.10gb") or a memory share ("24gb").
ANNOT_SPEC_PREFIX = f"{GROUP}/spec-gpu-"
SPEC_ANNOT_RE = re.compile(
    rf"^{re.escape(ANNOT_SPEC_PREFIX)}(?P<index>\d+)-(?P<profile>[0-9a-z.]+)$"
)

# Observed partitioning, reported per node by the node agent:
#   nos.nebuly.com/status-gpu-<index>-<profile>-<free|used> = <quantity>
ANNOT_STATUS_PREFIX = f"{GROUP}/status-gpu-"
STATUS_ANNOT_RE = re.compile(
    rf"^{re.escape(ANNOT_STATUS_PREFIX)}(?P<index>\d+)-(?P<profile>[0-9a-z.]+)"
    r"-(?P<status>free|used)$"
)

# Observed MIG placements, per GPU:
#   nos.nebuly.com/status-gpu-placements-<index> = "<u|f>|<profile>|<start>|<size>;..."
ANNOT_PLACEMENTS_PREFIX = f"{GROUP}/status-gpu-placements-"
PLACEMENT_ANNOT_RE = re.compile(
    rf"^{re.escape(ANNOT_PLACEMENTS_PREFIX)}(?P<index>\d+)$"
)

# Plan-id handshake between the planner and the node, one key per
# profile family ("mig" / "mps") so the two strategies of a hybrid node
# cannot overwrite each other's.
ANNOT_SPEC_PLAN_PREFIX = f"{GROUP}/spec-partitioning-plan"
ANNOT_STATUS_PLAN_PREFIX = f"{GROUP}/status-partitioning-plan"


def spec_plan_annotation(family: str = MIG_KIND) -> str:
    return f"{ANNOT_SPEC_PLAN_PREFIX}.{family}"


def status_plan_annotation(family: str = MIG_KIND) -> str:
    return f"{ANNOT_STATUS_PLAN_PREFIX}.{family}"


# The node agent's liveness heartbeat: its reporter stamps a per-process
# counter with every report, so a dead or wedged agent (value frozen)
# can be told from a healthy one whose geometry is not changing.  One
# key per family, like the plan handshake: a hybrid node runs both
# agents.
ANNOT_AGENT_HEARTBEAT_PREFIX = f"{GROUP}/agent-heartbeat"


def heartbeat_annotation(family: str = MIG_KIND) -> str:
    return f"{ANNOT_AGENT_HEARTBEAT_PREFIX}.{family}"


# A workload displaced by node loss or a drain migration, as
# "<cause>@<unix seconds>": it is admitted between serving and batch
# until the stamp is older than the scheduler's age cap, and the bind
# that places it consumes the stamp.
ANNOT_DISPLACED = f"{GROUP}/displaced"

DISPLACED_NODE_LOSS = "node-loss"
DISPLACED_DRAIN_MIGRATE = "drain-migrate"

# The workload's own progress fraction in [0, 1], written by the
# training main after each landed checkpoint: a displaced preemptor
# walks equal victims least progress first.
ANNOT_JOB_PROGRESS = f"{GROUP}/job-progress"

# The elasticity contract (malleable gangs, ``scheduler/elastic.py``):
# a gang whose members carry ``nos.tpu/elastic: "dp"`` declares its data
# parallel axis malleable.  The control plane may grow the gang by
# creating extra replica pods (the scheduler's cycle-end pass, up to
# max-replicas) when capacity frees up in its domain, and shrink it by
# evicting single members (down to min-replicas) when a quota reclaim or
# a higher-tier pod needs the room: a cheaper preemption rung than
# killing a whole rigid gang.  The bounds ride on the same pods; absent
# or garbage bounds read rigid, never unbounded.
ANNOT_ELASTIC = f"{GROUP}/elastic"
ELASTIC_DP = "dp"
ANNOT_MIN_REPLICAS = f"{GROUP}/min-replicas"
ANNOT_MAX_REPLICAS = f"{GROUP}/max-replicas"

# Desired dp replica count after a resize, stamped on every surviving
# member of a gang.  The training main reads it back at each landed
# checkpoint, on the same pod read as ANNOT_MIGRATE, and exits there
# when it differs from its boot-time world size, so the restart picks
# up the new mesh.
ANNOT_DP_RESIZE = f"{GROUP}/dp-resize"

# A serving replica's load signal, on its own pod: the request router
# publishes the replica's reserved KV fraction (a prefill-only replica's
# queue saturation), or, routerless, the workload self-reports its
# requests in flight (the downward-API pattern of ANNOT_JOB_PROGRESS).
# The replica autoscaler sums it over a service's live replicas and
# scales toward ``target_load_per_replica``.  Absent or garbage reads 0.
ANNOT_SERVING_LOAD = f"{GROUP}/serving-load"

# A serving replica's live sessions, published by the router beside the
# load: the autoscaler's scale-down takes drained (zero-session) replicas
# before the least loaded, so scale-in cuts no live stream while an idle
# replica exists.  Absent or garbage reads 0, which keeps a routerless
# deployment's pending-first, least-loaded order.
ANNOT_SERVING_SESSIONS = f"{GROUP}/serving-sessions"

# Defragmentation drain: a host a defrag proposal is emptying (the value
# is the proposal id).  The scheduler's score key avoids such hosts
# whenever another fits, and the planner's candidate order visits them
# last, so the freed room is not refilled by the pods just moved off it.
ANNOT_DEFRAG_DRAIN = f"{GROUP}/defrag-drain"

# Gang window lease: stamped by the scheduler on every node of the
# aligned window a stuck block gang is draining toward (value
# "<namespace>/<gang>").  The partitioner reads it: the per-node loop
# re-carves leased nodes last and the group pass carves the leased window
# first, so both planes drain the same window.
ANNOT_GANG_LEASE = f"{GROUP}/gang-window-lease"

# The mesh a workload pod will build, "<nodes>x<GPUs per node>": a pod
# asking for ``nvidia.com/gpu: N*G`` with ``mesh: NxG`` (N >= 2) is
# rewritten at admission into one NVLink block member
# (``nos.nebuly.com/nvlink-block-NxG: 1``, ``api/mesh.py``).
ANNOT_MESH = f"{GROUP}/mesh"

# Migration drains share the annotation with a "migrate:<kind>:<cause>"
# value (partitioning/core/failure.py).  Unlike a defrag drain, soft
# avoidance of a healthy host, a migration drain is a hard scheduling
# rejection: the host is presumed dying.
MIGRATION_DRAIN_PREFIX = "migrate:"


def is_migration_drain(annotations: dict) -> bool:
    """The migration-drain predicate, shared by MigrationDrainGuard, the
    partitioner's snapshot exclusion and the recovery plane's heal."""
    return annotations.get(ANNOT_DEFRAG_DRAIN, "").startswith(
        MIGRATION_DRAIN_PREFIX)


def migration_drain_value(kind: str, cause: str) -> str:
    """``migrate:<kind>:<cause>``: the kind is the owning family, the
    only one allowed to retract the drain (on a hybrid node both the MIG
    and the MPS recovery planes may want it)."""
    return f"{MIGRATION_DRAIN_PREFIX}{kind}:{cause}"


def migration_drain_owner(annotations: dict) -> str:
    """The family owning a node's migration drain, or "" when it carries
    none (a defrag drain is not a migration drain)."""
    raw = annotations.get(ANNOT_DEFRAG_DRAIN, "")
    if not raw.startswith(MIGRATION_DRAIN_PREFIX):
        return ""
    kind, sep, _cause = raw[len(MIGRATION_DRAIN_PREFIX):].partition(":")
    return kind if sep else ""


# Migration request, stamped on a resident pod by drain-then-migrate
# when its node is suspected of failing or marked for maintenance; the
# value is the cause.  A workload that reads it exits cleanly at its
# next checkpoint (the training main's signal checker); one that does
# not is evicted after the migrate grace.
ANNOT_MIGRATE = f"{GROUP}/migrate"

# Maintenance signal: an operator stamps a node to ask for
# drain-then-migrate ahead of planned work.  The value is free-form.
ANNOT_MAINTENANCE = f"{GROUP}/maintenance"


# The timeshare plugin's generation, bumped with every config it applies,
# and the ConfigMap key it applied last: the readiness signal the MPS
# node's reporter turns into status-partitioning-plan.mps, in place of
# the reference's blind sleep (mps/partitioner.go:99-100).
ANNOT_PLUGIN_GENERATION = f"{GROUP}/device-plugin-generation"
ANNOT_PLUGIN_APPLIED_CONFIG = f"{GROUP}/device-plugin-applied-config"


# ---------------------------------------------------------------------------
# Resource names
# ---------------------------------------------------------------------------

# Whole GPUs, the device plugin's resource (the JAX package's
# google.com/tpu).
RESOURCE_GPU = "nvidia.com/gpu"

CPU = "cpu"
MEMORY = "memory"

# The quota currency: GB of GPU memory, derived from a pod's GPU, MIG
# and MPS requests (reference pkg/gpu/util/resource.go:28-86).
RESOURCE_GPU_MEMORY = f"{GROUP}/gpu-memory"

# ---------------------------------------------------------------------------
# Kinds
# ---------------------------------------------------------------------------

KIND_ELASTIC_QUOTA = "ElasticQuota"
KIND_COMPOSITE_ELASTIC_QUOTA = "CompositeElasticQuota"
KIND_POD_DISRUPTION_BUDGET = "PodDisruptionBudget"
KIND_POD_GROUP = "PodGroup"
