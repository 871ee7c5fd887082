"""The MPS planner's fleet and backlog, built from a seed: the size the
JAX package's planner bench sets (``bench_plan.py:44-56``: 64 hosts × 8
chips, half of them full, 200 pending pods), as 32 nodes × 8 H100 80GB.

- Nodes 0-15 are full: each GPU reports one used ``80gb`` share, held by
  a bound filler pod that requests the node's whole allocatable (as
  ``bench_plan.py:156-165``'s filler holds its host).
- Nodes 16-31 report one free ``80gb`` share on each GPU (as
  ``bench_plan.py:166-170``'s hosts show a free 2x4), so every placement
  sacrifices a free share and re-carves the card.
- The backlog is 200 pods in ``make_pending_batch``'s round-robin order
  (``bench_plan.py:173``, priority ``i % 3``) over POD_MIX, the bench's
  mix with a chip's share of an 8-chip host mapped to the same share of
  an 80 GB card (1x1 → 10gb, 1x2 → 20gb, 2x2 → 40gb, 2x4 → 80gb); its
  multi-host 4x4 is dropped, since no MPS share spans cards.  The seed
  draws each pod's creation time (whole seconds in the last hour).

The MIG fleet (``mig_fleet_spec``) is the same bench in MIG instances:
32 nodes × 8 H100 80GB labelled ``mig``; nodes 0-15 hold a used
7g.80gb on each GPU (a filler pod), nodes 16-31 a free one; the
backlog is the same 200 pods over MIG_POD_MIX, a chip's share of the
8-chip host mapped to the profile with the same count per card (1x1 →
1g.10gb, 1x2 → 2g.20gb, 2x2 → 3g.40gb, two a card as two 2x2 a 2x4,
2x4 → 7g.80gb), the multi-host 4x4 dropped.

A cluster is described by a plain spec (``fleet_spec``), so a test can
build the same cluster for the JAX package.  ``plan_summary`` reduces a
plan to what both packages must agree on, and ``plan_digest`` hashes it;
``FLEET_DIGEST`` and ``MIG_FLEET_DIGEST`` pin seed 0's.
"""

from __future__ import annotations

import hashlib
import json

import numpy as np

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.kube.objects import Pod
from nos_tpu_torch.partitioning.core import SliceTracker
from nos_tpu_torch.partitioning.core.interfaces import SliceCalculator
from nos_tpu_torch.partitioning.state import ClusterState
from nos_tpu_torch.partitioning.timeshare import TimeshareProfileCalculator
from nos_tpu_torch.topology.annotations import encode_placement_records
from nos_tpu_torch.topology.known import H100_80GB, GpuModel
from nos_tpu_torch.topology.packing import Placement
from nos_tpu_torch.topology.profile import slice_resource_name

from .factory import make_gpu_node, make_mig_pod, make_pod, make_timeshare_pod

NODES = 32
GPUS_PER_NODE = 8
FULL_NODES = 16
PENDING_PODS = 200
POD_MIX = ((10, 8), (20, 6), (40, 4), (80, 2))   # (share GB, weight)
MIG_POD_MIX = (("1g.10gb", 8), ("2g.20gb", 6), ("3g.40gb", 4),
               ("7g.80gb", 2))                   # (profile, weight)

# plan_digest(plan_summary(...)) of seed 0's fleet plan
FLEET_DIGEST = "616e0e1d35e1feb696e6d51d9d41ad8c0edf68b6c7e05b9cd963f1ed97980bd2"
# plan_digest(plan_summary(...)) of seed 0's MIG fleet plan
MIG_FLEET_DIGEST = "980eab5231ae4a40855784e10b6053d44c6ab1323f418878854de910795d560b"


def fleet_spec(seed: int = 0, nodes: int = NODES,
               full_nodes: int = FULL_NODES,
               pending: int = PENDING_PODS) -> dict:
    """The fleet's spec: ``nodes`` entries {name, kind, gpus, status
    {GPU index: {"used" | "free": {profile: qty}}}, bound [{name,
    shares {gb: qty}, filler}]} and ``pending`` entries {name, gb, qty,
    priority, created}."""
    return _spec(seed, C.MPS_KIND, "80gb", "gb", POD_MIX, nodes,
                 full_nodes, pending)


def mig_fleet_spec(seed: int = 0, nodes: int = NODES,
                   full_nodes: int = FULL_NODES,
                   pending: int = PENDING_PODS) -> dict:
    """The MIG fleet's spec: as ``fleet_spec``, each GPU holding one
    7g.80gb, the ``pending`` entries {name, profile, qty, priority,
    created}."""
    return _spec(seed, C.MIG_KIND, "7g.80gb", "profile", MIG_POD_MIX, nodes,
                 full_nodes, pending)


def _spec(seed: int, kind: str, whole: str, key: str, mix, nodes: int,
          full_nodes: int, pending: int) -> dict:
    rng = np.random.default_rng(seed)
    node_specs = []
    for i in range(nodes):
        full = i < full_nodes
        status = {g: {"used" if full else "free": {whole: 1}}
                  for g in range(GPUS_PER_NODE)}
        bound = [{"name": f"filler-{i}", "shares": {}, "filler": True}] \
            if full else []
        node_specs.append({"name": f"gpu-node-{i}", "kind": kind,
                           "gpus": GPUS_PER_NODE, "status": status,
                           "bound": bound})
    pods = []
    i = 0
    while len(pods) < pending:
        for profile, weight in mix:
            for _ in range(weight):
                if len(pods) >= pending:
                    break
                pods.append({"name": f"pending-{i}", key: profile, "qty": 1,
                             "priority": i % 3,
                             "created": float(rng.integers(0, 3600))})
                i += 1
    return {"nodes": node_specs, "pending": pods}


def build_cluster(spec: dict, model: GpuModel = H100_80GB) -> ClusterState:
    """The spec's nodes and bound pods as a ClusterState.  A node may
    give its MIG placement records (``placements`` {GPU index:
    [[status "u" | "f", profile, start, size]]}).  A filler pod requests
    its node's whole allocatable; another bound pod, its shares
    (``shares`` {gb: qty}) or MIG instances (``profiles`` {profile:
    qty}) and one CPU."""
    state = ClusterState()
    for n in spec["nodes"]:
        node = make_gpu_node(n["name"], model=model, gpus=n["gpus"],
                             partitioning=n["kind"],
                             status_geometry=n["status"])
        for index, records in n.get("placements", {}).items():
            node.metadata.annotations[f"{C.ANNOT_PLACEMENTS_PREFIX}{index}"] = \
                encode_placement_records(
                    (st, Placement(p, start, size))
                    for st, p, start, size in records)
        bound = []
        for b in n["bound"]:
            if b["filler"]:
                res = dict(node.status.allocatable)
            else:
                res = {f"{C.RESOURCE_TIMESHARE_PREFIX}{gb}gb": float(q)
                       for gb, q in b.get("shares", {}).items()} | {
                    slice_resource_name(p): float(q)
                    for p, q in b.get("profiles", {}).items()} | {C.CPU: 1.0}
            bound.append(make_pod(name=b["name"], node_name=n["name"],
                                  resources=res))
        state.update_node(node, bound)
    return state


def build_pending(spec: dict) -> list[Pod]:
    """The pending pods: MPS shares (``gb``) or MIG instances
    (``profile``)."""
    out = []
    for p in spec["pending"]:
        kw = {"name": p["name"], "priority": p["priority"],
              "creation_timestamp": p["created"]}
        if "profile" in p:
            out.append(make_mig_pod(p["profile"], p["qty"], **kw))
        else:
            out.append(make_timeshare_pod(p["gb"], p["qty"], **kw))
    return out


def plan_summary(snapshot, pending: list[Pod], bound: set[str],
                 calculator: SliceCalculator | None = None) -> dict:
    """What a plan decided: every node's geometry per GPU, the pending
    pods it placed on each node, and what the unplaced pods still lack
    (a fresh tracker on the planned snapshot, with ``calculator``, the
    MPS strategy's by default).  ``bound`` names the pods bound before
    the plan."""
    geometries, placed = {}, {}
    for name in sorted(snapshot.nodes()):
        node = snapshot.get_node(name)
        geometries[name] = {str(i): dict(sorted(g.items()))
                            for i, g in sorted(node.geometries().items())}
        names = sorted(p.metadata.name for p in node.node_info().pods
                       if p.metadata.name not in bound)
        if names:
            placed[name] = names
    done = {n for names in placed.values() for n in names}
    left = [p for p in pending if p.metadata.name not in done]
    lacking = SliceTracker(snapshot,
                           calculator or TimeshareProfileCalculator(),
                           left).lacking
    return {"geometries": geometries, "placed": placed,
            "lacking": dict(sorted(lacking.items()))}


def plan_digest(summary: dict) -> str:
    return hashlib.sha256(
        json.dumps(summary, sort_keys=True).encode()).hexdigest()
