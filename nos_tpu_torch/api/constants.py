"""API contracts: labels, annotations, resource names,
``nos_tpu/api/constants.py`` for the port, the part its partitioning
planner, its controller and its MPS node side read.

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
from nos_tpu_torch.topology.profile import RESOURCE_TIMESHARE_PREFIX  # noqa: F401

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
