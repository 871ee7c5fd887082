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

The MIG fleet (``mig_fleet_spec``) is the bench in MIG instances at its
own size: 64 nodes × 8 H100 80GB labelled ``mig`` (a v5e host an 8-GPU
node), in the bench's 4 NVLink domains of 16 hosts (node i in
``nvl-<i // 16>`` at host index ``i % 16``); nodes 0-31 hold a used
7g.80gb on each GPU (a filler pod), nodes 32-63 a free one; the backlog
is the same 200 pods over MIG_POD_MIX, a chip's share of the 8-chip
host mapped to the profile with the same count per card (1x1 → 1g.10gb,
1x2 → 2g.20gb, 2x2 → 3g.40gb, two a card as two 2x2 a 2x4, 2x4 →
7g.80gb), and the multi-host 4x4 (two v5e hosts) the NVLink block 2x8
(two 8-GPU nodes), each such pod in a pod group of its own as the bench
labels it.  The group pass carves the 18 block gangs' 9 windows over
the virgin domain nvl-2 and the first window of nvl-3, and the per-node
pass re-carves nvl-3's other virgin nodes for the sub-host demand.  The
MPS fleet above stays at its 32 nodes.

The quota fleet (``quota_fleet_spec``) is the same 32 nodes x 8 H100
80GB on the MPS family, every node carved alike (GPUs 0-3 one 80gb
share each, 4-5 two 40gb, 6 four 20gb, 7 eight 10gb: 640 GB a node,
20,480 GB in all), under ``bench_utilization.py:155-162``'s quotas
scaled to it, their mins summing to its memory: train-a 7,680 to
15,360 GB, train-b 5,120 to 12,800, serve 3,840 to 7,680, and the
composite research (res-a, res-b) 3,840 to 10,240.  Wave 1: train-a
submits 128 pods of 80gb, past its min, borrowing.  Wave 2: serve and
research submit up to their mins, in ``bench_utilization.py:172-188``'s
single-pod mixes mapped as the MPS fleet's (serve 10gb:4, 40gb:2,
20gb:2, the serving tier; res-a 40gb:3, 80gb:2; res-b 40gb:2); their
80gb pods fit only where train-a's over-quota pods are preempted.  The
bench's gang jobs are cut.  ``drive_quota_fleet`` runs it on either
package through callables; ``run_quota_fleet`` is the port's run.

The gang fleet (``gang_fleet_spec``) is the quota fleet with the bench's
NVLink layout and its gang jobs.  Nodes 0-15 are NVLink domain nvl-0
and 16-27 nvl-1, ``bench_utilization.py:113``'s ``SLICE_DOMAINS``
(pod-0: 16 hosts, pod-1: 12) node for node; nodes 28-31 are unlabelled,
standing for its timeshare and hybrid hosts.  After wave 2 settles, a
third wave submits the bench's gang jobs (``JOB_MIX``, :171-180) at its
``GANG_PRIORITY`` 10 (:220), a host of a multi-host slice mapped to an
80gb share as the fleets map a 2x4 host: train-a two 4x8 gangs (4
members) and two 4x4 (2 members), train-b three 4x4, res-b one 4x4;
besides, train-b's "train-b-wait", whose PodGroup wants three members
and gets two (it waits), and train-a's "train-a-mesh" of four members
with mesh 8x16 (128 GPUs: only nvl-0 holds it).  Nothing of the quota
fleet is cut further; ``run_quota_fleet`` runs it too.  Both run under a
chip-second waste ledger of their own (``obs/ledger.py``) whose clock
moves QUOTA_FLEET_CYCLE_S a cycle, the scheduler's standing still at the
spec's ``now``; ``waste_summary`` reduces its report to what both
packages must agree on.

The recovery fleet (``recovery_fleet_spec``, ``run_recovery_fleet``) is
``bench_nodeloss.py``'s trace on the gang fleet's layout through the MPS
loop: the 32 nodes start virgin, each with its host index in its NVLink
domain, and nvl-0 and nvl-1 hold a warm spare each; jobs of the bench's
classes (2-member gangs and single pods of an 80gb share, small pods of
a 40gb one) keep ~92% of the GPUs in flight; three kills alternate the
domains, a wedged agent in nvl-0 dies later, and a fresh spare joins a
domain 30 s after each kill.  The bench's 300 s on a 0.25 s tick are
cut to 150 s on a 1 s tick.  As in the bench, the run keeps a waste
ledger on its clock, and ``run_recovery_fleet`` runs the same kill
schedule again with every recovery step off (no spare, no suspicion, no
displaced stamp): the recovery run must lose at most
RECOVERY_LOST_HALVING of the baseline's GPU-seconds (the non-spare
nodes' GPUs short of the fleet's, integrated past RECOVERY_WARMUP_S).

The defrag fleet (``defrag_fleet_spec``, ``run_defrag_fleet``) is
``bench_defrag.py``'s trace on the MIG stand-in (the H100 restricted to
{7g.80gb, 3g.40gb} and to two-node blocks, ``defrag_standin``, on which
the JAX package's v5e restricted to {2x4, 2x2, 4x4} decides alike),
through the MIG loop: 24 virgin one-GPU nodes in one NVLink domain (one
JAX host block a GPU), a SliceAgent over ``FakeGpuRuntime`` on each, the
MIG partitioner controller with the defragmenter at the bench's knobs,
and the scheduler with its grow pass, drain preemption after the
bench's 40 cycles of one lease (the trace's progress its progress
function) and a block shard charged the node's one GPU of quota (the
bench's ``shard_chips_per_host``: a host's 8 chips).  The bench's
classes map as the stand-in allows: its 1x2 filler and burst are
3g.40gb (a 2x2: the stand-in has no 1x2), its 2x4 big a 7g.80gb, its
2-host 4x4 gang of two members a 2x1 block gang (two one-GPU nodes of
an aligned window); two elastic sponge gangs of 3g.40gb members (min 2,
max 60) run the whole trace.  Its phases, in-flight targets (in the
bench's chip equivalents: a 3g.40gb 4, a GPU 8, a block member its
node's 8) and durations are the bench's.  Cut: the bench's 0.25 s
tick, which is 1 s here (its 300 s trace kept, the drain's 40 cycles
40 s), so the CPU test that holds it to JAX stays under a minute.  As
in the bench it runs three times: defrag and grow on; the baseline with
both off; and propose-only (an infinite payback threshold, grow off),
whose decisions must equal the baseline's.

The scale fleets are ``bench_fleet.py``'s 1024 hosts in MIG profiles,
JAX's three TPU generations cut to the one H100 model the port knows
and a v5e host an 8-GPU node, so its multi-host rows are NVLink blocks:
the 4x4 a 2x8, the 8x8 an 8x8.  ``scale_plan_spec``: 16 NVLink domains
of 64 8-GPU nodes at host indices 0-63; in each, nodes 0-31 full (every
GPU a used 7g.80gb, a filler pod holding the node's allocatable) and
32-63 virgin (every GPU a free 7g.80gb); 40 pending pods per 64 nodes
over ``BATCH_MIX["v5e"]``'s weights (SCALE_MIX, the 4x4 row 2x8 block
pods in pod groups of their own), priority ``i % 3``.
``scale_cycle_api``: the scale tier's converged fleet, every GPU carved
to 1g.10gb x 7, SCALE_BOUND 1g.10gb pods bound round-robin and Running,
and SCALE_RESIDENTS pending pods that never fit (bench_fleet.py's 8x8
residents as 8x8 blocks).

A cluster is described by a plain spec (``fleet_spec``), so a test can
build the same cluster for the JAX package.  ``plan_summary`` reduces a
plan to what both packages must agree on, and ``plan_digest`` hashes it;
``FLEET_DIGEST`` and ``MIG_FLEET_DIGEST`` pin seed 0's.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import time

import numpy as np

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.kube.objects import Pod
from nos_tpu_torch.obs import scoped as obs_scoped
from nos_tpu_torch.obs.ledger import ChipSecondLedger, check_conservation
from nos_tpu_torch.partitioning.core import SliceTracker
from nos_tpu_torch.partitioning.core.interfaces import SliceCalculator
from nos_tpu_torch.partitioning.state import ClusterState
from nos_tpu_torch.partitioning.timeshare import TimeshareProfileCalculator
from nos_tpu_torch.topology.annotations import encode_placement_records
from nos_tpu_torch.topology.known import H100_80GB, GpuModel
from nos_tpu_torch.topology.packing import Placement
from nos_tpu_torch.topology.profile import (
    gb_from_resource, slice_resource_name,
)

from .factory import make_gpu_node, make_mig_pod, make_pod, make_timeshare_pod

NODES = 32
GPUS_PER_NODE = 8
FULL_NODES = 16
PENDING_PODS = 200
POD_MIX = ((10, 8), (20, 6), (40, 4), (80, 2))   # (share GB, weight)
MIG_POD_MIX = (("1g.10gb", 8), ("2g.20gb", 6), ("3g.40gb", 4),
               ("7g.80gb", 2), ("2x8", 2))       # (profile, weight)
# bench_plan.py's 4x4 row: a pod of one 2x8 block shard, a gang of its own
MIG_BLOCK = "2x8"
# bench_plan.py's hosts, its full hosts and its ICI domains: 16 hosts
# each, host indices 0-15
MIG_NODES = 64
MIG_FULL_NODES = 32
MIG_HOSTS_PER_DOMAIN = 16

# plan_digest(plan_summary(...)) of seed 0's fleet plan
FLEET_DIGEST = "616e0e1d35e1feb696e6d51d9d41ad8c0edf68b6c7e05b9cd963f1ed97980bd2"
# plan_digest(plan_summary(...)) of seed 0's MIG fleet plan
MIG_FLEET_DIGEST = "1a5ddff9c84eb1fc854c63efc83d9c6fd51964f20324edba2eb2d6f09cf37778"


def fleet_spec(seed: int = 0, nodes: int = NODES,
               full_nodes: int = FULL_NODES,
               pending: int = PENDING_PODS) -> dict:
    """The fleet's spec: ``nodes`` entries {name, kind, gpus, status
    {GPU index: {"used" | "free": {profile: qty}}}, bound [{name,
    shares {gb: qty}, filler}]} and ``pending`` entries {name, gb, qty,
    priority, created}."""
    return _spec(seed, C.MPS_KIND, "80gb", "gb", POD_MIX, nodes,
                 full_nodes, pending)


def domain_fleet_spec(seed: int = 0) -> dict:
    """``fleet_spec(seed)`` with the gang fleet's NVLink layout: each
    node's ``domain`` and, in a domain, its ``host_index``.  The parallel
    planner shards it into three plan pools (nvl-0, nvl-1 and the
    unlabelled nodes)."""
    spec = fleet_spec(seed)
    for node, (domain, index) in zip(spec["nodes"], _domain_layout()):
        node["domain"] = domain
        if index is not None:
            node["host_index"] = index
    return spec


def mig_fleet_spec(seed: int = 0, nodes: int = MIG_NODES,
                   full_nodes: int = MIG_FULL_NODES,
                   pending: int = PENDING_PODS) -> dict:
    """The MIG fleet's spec: as ``fleet_spec`` at ``bench_plan.py``'s
    64 hosts, 32 of them full, each GPU holding one 7g.80gb, each node in
    NVLink domain ``nvl-<i // 16>`` at host index ``i % 16`` (its
    domains of 16 hosts), the ``pending``
    entries {name, profile, qty, priority, created}; a MIG_BLOCK pod
    carries ``gang`` ``gang-<i>``, a pod group of its own, as
    ``bench_plan.py:183-184`` labels its 4x4 pods."""
    spec = _spec(seed, C.MIG_KIND, "7g.80gb", "profile", MIG_POD_MIX, nodes,
                 full_nodes, pending)
    for i, node in enumerate(spec["nodes"]):
        node["domain"] = f"nvl-{i // MIG_HOSTS_PER_DOMAIN}"
        node["host_index"] = i % MIG_HOSTS_PER_DOMAIN
    for p in spec["pending"]:
        if p["profile"] == MIG_BLOCK:
            p["gang"] = f"gang-{p['name'].rsplit('-', 1)[1]}"
    return spec


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
                             status_geometry=n["status"],
                             domain=n.get("domain", ""),
                             host_index=n.get("host_index"))
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
    """The pending pods: MPS shares (``gb``) or MIG instances or block
    shards (``profile``), each in its pod group ``gang`` where one is
    given."""
    out = []
    for p in spec["pending"]:
        kw = {"name": p["name"], "priority": p["priority"],
              "creation_timestamp": p["created"]}
        if p.get("gang"):
            kw["labels"] = {C.LABEL_POD_GROUP: p["gang"]}
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


def block_windows(records) -> list[list]:
    """The group pass's carves in a plan's journal, from its (category,
    subject, attrs) rows: [profile, domain, nodes] each."""
    from nos_tpu_torch.obs import journal as J

    return [[s, a["domain"], list(a["nodes"])] for c, s, a in records
            if c == J.PLAN_BLOCK_CARVED]


def block_plan_problems(spec: dict, windows: list, geometries: dict,
                        placed: dict | None = None,
                        lacking: dict | None = None) -> list[str]:
    """What is wrong with a plan's NVLink blocks, independent of its
    digest: each carved window (``block_windows``) lies in one domain at
    host indices [i, i + N) with i % N == 0, no node is in two windows,
    and the nodes whose planned ``geometries`` hold a block on GPU 0 are
    exactly the windows' nodes.  With ``placed`` (node -> pod names) no
    node holds two block pods (each of the fleets' block pods is a gang
    of its own) and a block pod lies on a window's node; with ``lacking``
    no block is lacking while a clean aligned window is left, a clean
    node being one the spec left virgin, outside every window, with
    nothing placed on it."""
    from nos_tpu_torch.topology.profile import block_dims, is_block_profile
    from nos_tpu_torch.topology.windows import aligned_index_windows

    nodes = {n["name"]: n for n in spec["nodes"]}
    block_pods = {p["name"]: p["profile"] for p in spec["pending"]
                  if is_block_profile(p.get("profile", ""))}
    problems: list[str] = []
    members: dict[str, str] = {}
    for profile, domain, names in windows:
        hosts = block_dims(profile)[0]
        index = [nodes[n].get("host_index") for n in names]
        aligned = (len(names) == hosts and None not in index
                   and index[0] % hosts == 0
                   and index == list(range(index[0], index[0] + hosts)))
        if not aligned or any(nodes[n].get("domain") != domain
                              for n in names):
            problems.append(f"{profile} over {names} is not an aligned "
                            f"window of {domain}")
        for n in names:
            if n in members:
                problems.append(f"{n} is in two windows")
            members[n] = profile
    carved = {name for name, gpus in geometries.items()
              if any(is_block_profile(p) for g in gpus.values() for p in g)}
    if carved != set(members):
        problems.append(f"block members {sorted(carved ^ set(members))} "
                        f"are not the carved windows'")
    if placed is not None:
        for name, pods in placed.items():
            held = [p for p in pods if p in block_pods]
            if len(held) > 1:
                problems.append(f"{name} holds the gangs of {held}")
            if held and name not in members:
                problems.append(f"{held} lies on {name}, outside a window")
    if placed is not None and lacking is not None:
        for profile in sorted(p for p in lacking if is_block_profile(p)):
            hosts = block_dims(profile)[0]
            clean: dict[str, list[int]] = {}
            for name, n in nodes.items():
                if n.get("domain") and not n["bound"] \
                        and name not in members and not placed.get(name):
                    clean.setdefault(n["domain"], []).append(n["host_index"])
            left = {d: w for d, ix in sorted(clean.items())
                    if (w := aligned_index_windows(ix, hosts))}
            if left:
                problems.append(f"{lacking[profile]} {profile} lacking while "
                                f"aligned windows are clean: {left}")
    return problems


# -- the quota fleet -------------------------------------------------------

# per GPU index, the shares it is carved to
QUOTA_FLEET_CARVING = {0: {"80gb": 1}, 1: {"80gb": 1}, 2: {"80gb": 1},
                       3: {"80gb": 1}, 4: {"40gb": 2}, 5: {"40gb": 2},
                       6: {"20gb": 4}, 7: {"10gb": 8}}
# (name, namespace, the namespaces it covers, min GB, max GB)
QUOTA_FLEET_QUOTAS = (
    ("train-a", "train-a", ("train-a",), 7680.0, 15360.0),
    ("train-b", "train-b", ("train-b",), 5120.0, 12800.0),
    ("serve", "serve", ("serve",), 3840.0, 7680.0),
    ("research", "research", ("res-a", "res-b"), 3840.0, 10240.0),
)
QUOTA_FLEET_TRAIN_PODS = 128
SERVE_MIX = ((10, 4), (40, 2), (20, 2))          # (share GB, weight)
RESEARCH_MIX = (("res-a", 40, 3), ("res-a", 80, 2), ("res-b", 40, 2))
# the scheduler's clock in the fleet's runs: after every creation time
QUOTA_FLEET_NOW = 7200.0
QUOTA_FLEET_MAX_CYCLES = 64
# the waste ledger's seconds per fleet cycle
QUOTA_FLEET_CYCLE_S = 1.0

# (NVLink domain, nodes) from node 0 on; the rest are unlabelled
GANG_FLEET_DOMAINS = (("nvl-0", 16), ("nvl-1", 12))
GANG_PRIORITY = 10
# (namespace, gang name prefix, mesh, members, min_member, jobs); a
# member is one 80gb share
GANG_FLEET_JOBS = (
    ("train-a", "train-a-4x8", "", 4, 4, 2),
    ("train-a", "train-a-4x4", "", 2, 2, 2),
    ("train-b", "train-b-4x4", "", 2, 2, 3),
    ("res-b", "res-b-4x4", "", 2, 2, 1),
    ("train-b", "train-b-wait", "", 2, 3, 1),
    ("train-a", "train-a-mesh", "8x16", 16, 16, 1),
)
# after the third wave's creation times
GANG_FLEET_NOW = 10800.0


def quota_fleet_spec(seed: int = 0) -> dict:
    """The quota fleet's spec: ``nodes`` as ``fleet_spec``'s, ``quotas``
    {name, namespace, namespaces, min, max} and two ``waves`` of pods
    {name, namespace, gb, priority, created, tier}; creation times are
    distinct, drawn from ``seed`` (wave 1 in the first hour, wave 2 in
    the second), priorities ``i % 3``."""
    rng = np.random.default_rng(seed)
    nodes = [{"name": f"gpu-node-{i}", "kind": C.MPS_KIND,
              "gpus": GPUS_PER_NODE,
              "status": {g: {"free": dict(t)}
                         for g, t in QUOTA_FLEET_CARVING.items()},
              "bound": []} for i in range(NODES)]
    quotas = [{"name": n, "namespace": ns, "namespaces": list(cover),
               "min": lo, "max": hi}
              for n, ns, cover, lo, hi in QUOTA_FLEET_QUOTAS]
    mins = {q["name"]: q["min"] for q in quotas}
    wave1 = [("train-a", 80, "")] * QUOTA_FLEET_TRAIN_PODS
    wave2 = []
    for quota, mix, tier in (
            ("serve", [("serve", gb, w) for gb, w in SERVE_MIX],
             C.TIER_SERVING),
            ("research", RESEARCH_MIX, "")):
        rows = [(ns, gb) for ns, gb, w in mix for _ in range(w)]
        total = 0.0
        for i in itertools.count():
            ns, gb = rows[i % len(rows)]
            if total + gb > mins[quota]:
                break
            wave2.append((ns, gb, tier))
            total += gb
    waves = []
    for w, rows, offset in ((0, wave1, 0.0), (1, wave2, 3600.0)):
        times = rng.permutation(3600)[:len(rows)]
        waves.append([{"name": f"{ns}-{w}-{i}", "namespace": ns, "gb": gb,
                       "priority": i % 3,
                       "created": offset + float(times[i]),
                       "tier": tier}
                      for i, (ns, gb, tier) in enumerate(rows)])
    return {"nodes": nodes, "quotas": quotas, "waves": waves}


def _domain_layout(nodes: int = NODES) -> list[tuple[str, int | None]]:
    """(NVLink domain, host index) of each node from node 0: the
    GANG_FLEET_DOMAINS in order, each indexed from 0, then unlabelled
    nodes with no index."""
    out: list[tuple[str, int | None]] = [
        (d, i) for d, n in GANG_FLEET_DOMAINS for i in range(n)]
    return (out + [("", None)] * nodes)[:nodes]


def gang_fleet_spec(seed: int = 0) -> dict:
    """The gang fleet's spec: ``quota_fleet_spec(seed)`` with each node's
    ``domain`` (GANG_FLEET_DOMAINS, "" past them) and, in a domain, its
    ``host_index`` there (a tie of headroom breaks on it), the PodGroups
    (``groups`` {name, namespace, min, mesh}), a third wave of gang
    members {..., gang} at GANG_PRIORITY, created in the third hour in
    an order drawn from ``seed``, and the scheduler's clock ``now``."""
    spec = quota_fleet_spec(seed)
    rng = np.random.default_rng(seed + 1)
    for node, (domain, index) in zip(spec["nodes"], _domain_layout()):
        node["domain"] = domain
        if index is not None:
            node["host_index"] = index
    groups, rows = [], []
    for ns, prefix, mesh, members, need, jobs in GANG_FLEET_JOBS:
        for j in range(jobs):
            name = f"{prefix}-{j}" if jobs > 1 else prefix
            groups.append({"name": name, "namespace": ns, "min": need,
                           "mesh": mesh})
            rows.extend((ns, name, m) for m in range(members))
    times = 7200.0 + rng.permutation(3600)[:len(rows)]
    spec["waves"].append([
        {"name": f"{gang}-{m}", "namespace": ns, "gb": 80,
         "priority": GANG_PRIORITY, "created": float(t), "tier": "",
         "gang": gang}
        for (ns, gang, m), t in zip(rows, times)])
    spec["groups"] = groups
    spec["now"] = GANG_FLEET_NOW
    return spec


def waste_summary(report: dict) -> dict:
    """A waste report as both packages must agree on it: per pool its
    capacity and its GPU-seconds per category, rounded to 1e-6."""
    return {pool: {"capacity": p["capacity_chips"],
                   "seconds": {c: round(v, 6) for c, v
                               in sorted(p["chip_seconds"].items())}}
            for pool, p in sorted(report["pools"].items())}


def drive_quota_fleet(spec: dict, create, cycle, admit, reconcile, pods,
                      quotas, groups=None, ledger_now=None) -> dict:
    """Submit each wave (``create(pod spec)``) and run ``cycle()``, then
    ``admit()`` (the kubelet) and ``reconcile()``, until a cycle binds
    and evicts nothing; ``ledger_now`` (a one-element list, the waste
    ledger's clock) moves QUOTA_FLEET_CYCLE_S before each cycle.  ``pods()`` gives (name, node, capacity label,
    phase) rows, ``quotas()`` each quota's status.used, ``groups()``,
    when given, each PodGroup's [phase, scheduled] by "namespace/name".
    Returns the summary both packages must agree on ({"cycles": [wave,
    bound, evicted] per cycle, the final "labels", "pending", "used" and
    "groups"}) and each cycle's and reconcile's host ms."""
    cycles, cycle_ms, reconcile_ms = [], [], []
    for w, wave in enumerate(spec["waves"]):
        for p in wave:
            create(p)
        prev = {name: node for name, node, _, _ in pods()}
        while True:
            if len(cycles) >= QUOTA_FLEET_MAX_CYCLES:
                raise RuntimeError("the quota fleet did not settle in "
                                   f"{QUOTA_FLEET_MAX_CYCLES} cycles")
            if ledger_now is not None:
                ledger_now[0] += QUOTA_FLEET_CYCLE_S
            t0 = time.perf_counter()
            cycle()
            cycle_ms.append((time.perf_counter() - t0) * 1e3)
            admit()
            t0 = time.perf_counter()
            reconcile()
            reconcile_ms.append((time.perf_counter() - t0) * 1e3)
            now = {name: node for name, node, _, _ in pods()}
            bound = sorted(n for n, node in now.items()
                           if node and not prev.get(n))
            evicted = sorted(set(prev) - set(now))
            cycles.append([w, bound, evicted])
            prev = now
            if not bound and not evicted:
                break
    rows = pods()
    summary = {"cycles": cycles,
               "labels": {n: label for n, _, label, _ in sorted(rows)},
               "pending": sorted(n for n, node, _, _ in rows if not node),
               "used": quotas()}
    if groups is not None:
        summary["groups"] = groups()
    return {"summary": summary, "cycle_ms": cycle_ms,
            "reconcile_ms": reconcile_ms}


def run_quota_fleet(spec: dict) -> dict:
    """``drive_quota_fleet`` on the port: an API server with the quota
    webhooks, ``build_scheduler`` (its clock the spec's ``now``, else
    QUOTA_FLEET_NOW), both reconcilers, the spec's PodGroups created
    first and its nodes in their NVLink domains (the gang fleet's), under
    a waste ledger of the run's own (``waste``, its report; a report that
    does not conserve raises).
    Adds the binds, the preemptions, the victims by their capacity label
    when chosen, and per quota the GB its bound pods hold against its
    status.used and max; from a journal of the run's own, the gangs
    admitted and rejected, and the host ms of each ``schedule_gang``
    call; after every cycle, the gangs bound in part (``partial``) or
    over more than one domain (``spanning``); the preemptions a gang
    member made, the victims neither over-quota nor of the preemptor's
    namespace with its quota over min with the preemptor's whole gang
    (``victims_other``), and the domains each gang was bound in at any
    cycle's end (``domains``)."""
    from nos_tpu_torch.api.elasticquota import (
        CompositeElasticQuota, CompositeElasticQuotaSpec, ElasticQuota,
        ElasticQuotaSpec, install_quota_webhooks,
    )
    from nos_tpu_torch.cmd.assembly import build_scheduler
    from nos_tpu_torch.controllers.elasticquota import (
        CompositeElasticQuotaReconciler, ElasticQuotaReconciler,
    )
    from nos_tpu_torch.controllers.kubelet import admit_bound_pods
    from nos_tpu_torch.kube.client import APIServer, KIND_POD_GROUP
    from nos_tpu_torch.kube.objects import ObjectMeta, RUNNING
    from nos_tpu_torch.obs import journal as J

    from .factory import make_pod_group

    now = spec.get("now", QUOTA_FLEET_NOW)
    api = APIServer()
    install_quota_webhooks(api)
    sched = build_scheduler(api, clock=lambda: now)
    recs = (ElasticQuotaReconciler(api), CompositeElasticQuotaReconciler(api))
    victims: list[tuple] = []

    def gang_request(pod) -> dict:
        from nos_tpu_torch.kube.resources import sum_resources

        g = pod.metadata.labels.get(C.LABEL_POD_GROUP, "")
        mates = api.list("Pod", namespace=pod.metadata.namespace,
                         label_selector={C.LABEL_POD_GROUP: g}) if g \
            else [pod]
        total: dict = {}
        for m in mates:
            total = sum_resources(
                total, sched._capacity.calculator.compute_pod_request(m))
        return total

    def on_preempt(pod, vs) -> None:
        ns = pod.metadata.namespace
        info = sched._capacity.elastic_quota_infos.get(ns)
        over_min = info is not None and info.used_over_min_with(
            gang_request(pod))
        victims.extend(
            (pod.metadata.name, v.metadata.name,
             v.metadata.labels.get(C.LABEL_CAPACITY),
             bool(pod.metadata.labels.get(C.LABEL_POD_GROUP)),
             bool(v.metadata.labels.get(C.LABEL_POD_GROUP)),
             v.metadata.namespace == ns and over_min) for v in vs)

    sched._capacity.on_preempt = on_preempt
    for q in spec["quotas"]:
        mem = C.RESOURCE_GPU_MEMORY
        meta = ObjectMeta(name=q["name"], namespace=q["namespace"])
        lo, hi = {mem: q["min"]}, {mem: q["max"]}
        if q["namespaces"] == [q["namespace"]]:
            api.create(C.KIND_ELASTIC_QUOTA, ElasticQuota(
                metadata=meta, spec=ElasticQuotaSpec(min=lo, max=hi)))
        else:
            api.create(C.KIND_COMPOSITE_ELASTIC_QUOTA, CompositeElasticQuota(
                metadata=meta, spec=CompositeElasticQuotaSpec(
                    namespaces=q["namespaces"], min=lo, max=hi)))
    for g in spec.get("groups", ()):
        api.create(KIND_POD_GROUP, make_pod_group(
            g["name"], g["min"], g["mesh"], g["namespace"]))
    domain_of = {}
    for n in spec["nodes"]:
        domain_of[n["name"]] = n.get("domain", "")
        api.create("Node", make_gpu_node(
            n["name"], gpus=n["gpus"], partitioning=n["kind"],
            status_geometry=n["status"], domain=n.get("domain", ""),
            host_index=n.get("host_index")))

    def create(p):
        labels = {C.LABEL_TIER: p["tier"]} if p["tier"] else {}
        if p.get("gang"):
            labels[C.LABEL_POD_GROUP] = p["gang"]
        api.create("Pod", make_timeshare_pod(
            p["gb"], name=p["name"], namespace=p["namespace"],
            priority=p["priority"], creation_timestamp=p["created"],
            labels=labels))

    partial: list[str] = []
    spanning: list[str] = []
    # gang -> every domain it was bound in at a cycle's end
    placed: dict[str, set[str]] = {}

    def admit():
        for g in spec.get("groups", ()):
            members = api.list("Pod", namespace=g["namespace"],
                               label_selector={C.LABEL_POD_GROUP: g["name"]})
            on = {domain_of[m.spec.node_name] for m in members
                  if m.spec.node_name}
            bound = sum(bool(m.spec.node_name) for m in members)
            if 0 < bound < len(members):
                partial.append(g["name"])
            if len(on) > 1:
                spanning.append(g["name"])
            if on:
                placed.setdefault(g["name"], set()).update(on)
        for n in spec["nodes"]:
            admit_bound_pods(api, n["name"])

    def reconcile():
        for r in recs:
            r.reconcile_all()

    def pods():
        return [(p.metadata.name, p.spec.node_name,
                 p.metadata.labels.get(C.LABEL_CAPACITY), p.status.phase)
                for p in api.list("Pod")]

    def quotas():
        return {q.metadata.name: dict(q.status.used)
                for kind in (C.KIND_ELASTIC_QUOTA,
                             C.KIND_COMPOSITE_ELASTIC_QUOTA)
                for q in api.list(kind)}

    def groups():
        return {f"{g.metadata.namespace}/{g.metadata.name}":
                [g.status.phase, g.status.scheduled]
                for g in api.list(KIND_POD_GROUP)}

    gang_ms: list[tuple[float, bool]] = []
    schedule_gang = sched.schedule_gang

    def timed(members):
        t0 = time.perf_counter()
        bound = schedule_gang(members)
        gang_ms.append(((time.perf_counter() - t0) * 1e3, bound > 0))
        return bound

    sched.schedule_gang = timed
    journal = J.DecisionJournal(maxlen=1 << 16)
    ledger_now = [0.0]
    ledger = ChipSecondLedger(clock=lambda: ledger_now[0])
    with obs_scoped(journal=journal, ledger=ledger):
        out = drive_quota_fleet(spec, create, sched.run_cycle, admit,
                                reconcile, pods, quotas,
                                groups if "groups" in spec else None,
                                ledger_now=ledger_now)
    out["waste"] = check_conservation(ledger.report(), "the quota fleet")
    held = {}
    for q in spec["quotas"]:
        held[q["name"]] = sum(
            gb_from_resource(r) * v for p in api.list("Pod")
            if p.metadata.namespace in q["namespaces"] and p.spec.node_name
            and p.status.phase == RUNNING
            for r, v in p.spec.containers[0].resources.items()
            if gb_from_resource(r))
    sched.close()
    out.update({
        "binds": sum(len(c[1]) for c in out["summary"]["cycles"]),
        "preemptions": len({v[0] for v in victims}),
        "victims": len(victims),
        "victims_over_quota": sum(v[2] == C.CAPACITY_OVER_QUOTA
                                  for v in victims),
        "victims_in_quota": sum(v[2] != C.CAPACITY_OVER_QUOTA
                                for v in victims),
        "held_gb": held,
        "max_gb": {q["name"]: q["max"] for q in spec["quotas"]},
        "gangs_admitted": len(journal.events(J.GANG_ADMITTED)),
        "gangs_rejected": len(journal.events(J.GANG_REJECTED)),
        "gang_ms": gang_ms, "partial": partial, "spanning": spanning,
        "gang_preemptions": len({v[0] for v in victims if v[3]}),
        "gang_victims": sum(v[4] for v in victims),
        "victims_same_ns_over_min": sum(
            v[5] and v[2] != C.CAPACITY_OVER_QUOTA for v in victims),
        "victims_other": sum(not v[5] and v[2] != C.CAPACITY_OVER_QUOTA
                             for v in victims),
        "domains": {g: sorted(d) for g, d in sorted(placed.items())},
    })
    return out


# -- the recovery fleet ------------------------------------------------------

# bench_nodeloss.py's trace on the gang fleet's layout, on a one-second
# tick: three kills alternating nvl-0 and nvl-1, a wedged agent in nvl-0
# that later dies, a fresh spare RECOVERY_REFILL_S after each kill
RECOVERY_TICK_S = 1.0
RECOVERY_TRACE_S = 150.0
RECOVERY_SETTLE_S = 30.0
RECOVERY_KILLS = ((50.0, "nvl-0"), (80.0, "nvl-1"), (110.0, "nvl-0"))
RECOVERY_WEDGE = (65.0, "nvl-0")
RECOVERY_WEDGE_DEATH_T = 95.0
RECOVERY_REFILL_S = 30.0
RECOVERY_SPARE_INDEX = 100
RECOVERY_SUSPECT_AFTER_S = 5.0
RECOVERY_GRACE_S = 3.0
RECOVERY_BATCH_IDLE_S = 0.5
RECOVERY_BATCH_TIMEOUT_S = 2.0
RECOVERY_NAMESPACE = "work"
# bench_nodeloss.py's gate: the lost GPU-seconds (non-spare GPUs short of
# the fleet's, integrated after the warm-up) of the recovery run at most
# this share of the baseline's on the same kill schedule
RECOVERY_WARMUP_S = 40.0
RECOVERY_LOST_HALVING = 0.50
# class -> (share GB, members, priority), a slice host mapped to an 80gb
# share and a 2x2 to a 40gb one, as the fleets map them
RECOVERY_CLASSES = {"gang": (80, 2, 5), "slice": (80, 1, 0),
                    "small": (40, 1, 0)}
RECOVERY_DURATION_S = {"gang": (50.0, 90.0), "slice": (30.0, 60.0),
                       "small": (20.0, 40.0)}
# GPUs in flight (pending and running) per class: 236 of the 256, the
# bench's ~92% of its active chips
RECOVERY_TARGETS = {"gang": 96.0, "slice": 80.0, "small": 60.0}
# the journal's records the recovery fleet's summary keeps
RECOVERY_RECORDS = ("quarantined", "quarantine-released", "spare-promoted",
                    "job-displaced", "job-rebound")


def recovery_fleet_spec(seed: int = 0) -> dict:
    """The recovery fleet's spec: the gang fleet's 32 x 8 H100 80GB
    nodes on the MPS family, virgin (the planner carves them for
    demand), each with its NVLink domain and host index, and one warm
    spare per labelled domain (``spares``, host index parked at
    RECOVERY_SPARE_INDEX).  ``seed`` draws the jobs' durations."""
    nodes = [{"name": f"gpu-node-{i}", "domain": d, "host_index": idx}
             for i, (d, idx) in enumerate(_domain_layout())]
    spares = [{"name": f"spare-{d}-0", "domain": d,
               "host_index": RECOVERY_SPARE_INDEX, "spare": True}
              for d, _ in GANG_FLEET_DOMAINS]
    return {"seed": seed, "nodes": nodes, "spares": spares}


def _percentile(xs: list[float], q: float) -> float | None:
    if not xs:
        return None
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


class _RecoveryTrace:
    """bench_nodeloss.py's ``Sim`` over an ``ops`` object: the workload
    (jobs spawned up to each class's target, finished after their
    duration), the kill and wedge schedule, and the workload controller
    that recreates lost pods with the ``displaced`` stamp.  ``ops`` is
    one package's loop; the trace decides only from what ``ops`` shows,
    so two packages that decide alike run the same trace."""

    def __init__(self, spec: dict, ops, recovery: bool = True) -> None:
        self.ops = ops
        # off: the baseline, whose workload controller recreates lost
        # pods with no displaced stamp
        self.recovery = recovery
        self.rng = np.random.default_rng(spec["seed"])
        self.jobs: dict[str, dict] = {}
        self.pod_job: dict[str, dict] = {}
        self.pod_node: dict[str, str] = {}
        self.killed: set[str] = set()
        self.wedged: set[str] = set()
        self.affected: set[str] = set()
        self.displaced_at: dict[str, float] = {}
        self.rebind_s: list[float] = []
        self.episodes = 0
        self.completed = 0
        self.seq = 0
        self.spare_seq = {d: 0 for d, _ in GANG_FLEET_DOMAINS}
        self.ticks: list[list] = []
        self.poll_ms: list[float] = []
        # the slowest poll: (ms, trace time, journal categories it wrote)
        self.slowest_poll: tuple[float, float, list[str]] = (-1.0, 0.0, [])
        self.active_gpus = len(spec["nodes"]) * GPUS_PER_NODE
        self.lost_gpu_seconds = 0.0
        self.prev: dict[str, str] = {}
        for n in spec["nodes"] + spec["spares"]:
            ops.add_node(n)

    def now(self) -> float:
        return self.ops.now[0]

    # -- faults ---------------------------------------------------------
    def busiest(self, domain: str, exclude=()) -> str | None:
        """The active node of ``domain`` hosting the most distinct jobs
        (ties: the most GPUs), first by name."""
        residents: dict[str, list[str]] = {}
        for name, node, _ in self.ops.pods():
            if node:
                residents.setdefault(node, []).append(name)
        best, best_key = None, (-1, -1.0)
        for name, (dom, _, spare) in sorted(self.ops.nodes().items()):
            if dom != domain or spare or name in exclude:
                continue
            pods = residents.get(name, [])
            jobs = {self.pod_job[p]["name"] for p in pods
                    if p in self.pod_job}
            key = (len(jobs), sum(self.pod_job[p]["gb"] / 80.0
                                  for p in pods if p in self.pod_job))
            if key > best_key:
                best, best_key = name, key
        return best

    def kill(self, name: str) -> None:
        for pod, node, _ in self.ops.pods():
            if node == name:
                self.killed.add(pod)
        self.ops.kill(name)
        self.wedged.discard(name)

    def add_spare(self, domain: str) -> None:
        self.spare_seq[domain] += 1
        seq = self.spare_seq[domain]
        self.ops.add_node({"name": f"spare-{domain}-{seq}",
                           "domain": domain,
                           "host_index": RECOVERY_SPARE_INDEX + seq,
                           "spare": True})

    def faults(self, t: float, refills: list) -> None:
        for kt, domain in RECOVERY_KILLS:
            if kt == t:
                victim = self.busiest(domain)
                if victim is not None:
                    self.kill(victim)
                    refills.append((t + RECOVERY_REFILL_S, domain))
        if RECOVERY_WEDGE[0] == t:
            victim = self.busiest(RECOVERY_WEDGE[1], exclude=self.wedged)
            if victim is not None:
                self.wedged.add(victim)     # its agent stops ticking
        if RECOVERY_WEDGE_DEATH_T == t:
            for name in sorted(self.wedged):
                if name in self.ops.nodes():
                    self.kill(name)
        for due, domain in [r for r in refills if r[0] == t]:
            refills.remove((due, domain))
            self.add_spare(domain)

    # -- the workload ---------------------------------------------------
    def spawn(self) -> None:
        footprint = {cls: 0.0 for cls in RECOVERY_TARGETS}
        for name, _, _ in self.ops.pods():
            job = self.pod_job.get(name)
            if job is not None:
                footprint[job["kind"]] += job["gb"] / 80.0
        for cls, target in RECOVERY_TARGETS.items():
            while footprint[cls] < target:
                footprint[cls] += self.spawn_job(cls)

    def spawn_job(self, cls: str) -> float:
        gb, members, priority = RECOVERY_CLASSES[cls]
        lo, hi = RECOVERY_DURATION_S[cls]
        self.seq += 1
        name = f"{cls}-{self.seq}"
        # distinct creation times: the admission order never falls to a
        # tie
        job = {"name": name, "kind": cls, "gb": gb, "priority": priority,
               "duration": float(self.rng.uniform(lo, hi)),
               "created": self.now() + self.seq * 1e-4, "bound_at": None,
               "pods": [f"{name}-{i}" for i in range(members)]}
        if members > 1:
            self.ops.create_group(name, members)
        for pod in job["pods"]:
            self.create(job, pod, "")
            self.pod_job[pod] = job
        self.jobs[name] = job
        return members * gb / 80.0

    def create(self, job: dict, pod: str, displaced: str) -> None:
        self.ops.create_pod({
            "name": pod, "gb": job["gb"], "priority": job["priority"],
            "created": job["created"],
            "gang": job["name"] if len(job["pods"]) > 1 else "",
            "displaced": displaced})

    def complete(self) -> None:
        for job in list(self.jobs.values()):
            if job["bound_at"] is None \
                    or self.now() < job["bound_at"] + job["duration"]:
                continue
            for pod in job["pods"]:
                self.ops.delete_pod(pod)
                self.pod_job.pop(pod, None)
            if len(job["pods"]) > 1:
                self.ops.delete_group(job["name"])
            del self.jobs[job["name"]]
            self.affected.discard(job["name"])
            self.displaced_at.pop(job["name"], None)
            self.completed += 1

    def requeue(self) -> None:
        """The workload controller: a live job's missing pods come back,
        with the displaced stamp (cause and time) when node loss or a
        migration took them."""
        from nos_tpu_torch.utils.pod_util import displaced_value

        live = {name for name, _, _ in self.ops.pods()}
        for job in self.jobs.values():
            missing = [p for p in job["pods"] if p not in live]
            if not missing:
                continue
            job["bound_at"] = None
            for pod in missing:
                cause = None
                if pod in self.killed:
                    self.killed.discard(pod)
                    cause = C.DISPLACED_NODE_LOSS
                elif self.pod_node.get(pod) in self.wedged:
                    cause = C.DISPLACED_DRAIN_MIGRATE
                stamp = ""
                if cause is not None:
                    if job["name"] not in self.affected:
                        self.affected.add(job["name"])
                        self.episodes += 1
                        self.displaced_at[job["name"]] = self.now()
                    if self.recovery:
                        stamp = displaced_value(
                            cause, self.displaced_at[job["name"]])
                self.pod_node.pop(pod, None)
                self.create(job, pod, stamp)

    def record_binds(self) -> None:
        rows = self.ops.pods()
        bound = {name: node for name, node, phase in rows
                 if node and phase == "Running"}
        self.pod_node.update(bound)
        for job in self.jobs.values():
            if job["bound_at"] is None and all(p in bound
                                               for p in job["pods"]):
                job["bound_at"] = self.now()
                if job["name"] in self.affected:
                    self.affected.discard(job["name"])
                    self.rebind_s.append(
                        self.now() - self.displaced_at.pop(job["name"]))
        now = {name: node for name, node, _ in rows}
        binds = sorted(n for n, node in now.items()
                       if node and not self.prev.get(n))
        gone = sorted(set(self.prev) - set(now))
        if binds or gone:
            self.ticks.append([self.now(), binds, gone])
        self.prev = now

    def tick(self, spawn: bool = True) -> None:
        self.complete()
        if spawn:
            self.spawn()
        self.ops.cycle()
        self.requeue()
        seen = len(self.ops.journal)
        t0 = time.perf_counter()
        self.ops.poll()
        ms = (time.perf_counter() - t0) * 1e3
        self.poll_ms.append(ms)
        if ms > self.slowest_poll[0]:
            wrote = self.ops.journal.events()[seen:] \
                if len(self.ops.journal) > seen else []
            self.slowest_poll = (ms, self.now(),
                                 sorted({r.category for r in wrote}))
        self.ops.tick(sorted(n for n in self.ops.agents()
                             if n not in self.wedged))
        self.record_binds()
        if self.now() >= RECOVERY_WARMUP_S:
            live = GPUS_PER_NODE * sum(
                not spare for _, _, spare in self.ops.nodes().values())
            self.lost_gpu_seconds += max(0, self.active_gpus - live) \
                * RECOVERY_TICK_S

    def run(self) -> dict:
        refills: list[tuple[float, str]] = []
        steps = int(round(RECOVERY_TRACE_S / RECOVERY_TICK_S))
        for i in range(steps + 1):
            t = i * RECOVERY_TICK_S
            self.ops.now[0] = t
            self.faults(t, refills)
            self.tick()
        # the tail: no kill and no new job; a job displaced just before
        # the end gets its rebind before never_rebound is read
        t = RECOVERY_TRACE_S
        while self.affected and t < RECOVERY_TRACE_S + RECOVERY_SETTLE_S:
            t += RECOVERY_TICK_S
            self.ops.now[0] = t
            self.tick(spawn=False)
        records = self.ops.records()
        summary = {
            "ticks": self.ticks,
            "nodes": {n: list(v) for n, v in sorted(self.ops.nodes().items())},
            "records": records,
            "episodes": self.episodes,
            "rebound": len(self.rebind_s),
            "never_rebound": sorted(self.affected),
            "rebind_s": self.rebind_s,
            "completed": self.completed,
            "drain_migrations": self.ops.drain_migrations(),
        }
        return {
            "summary": summary, "poll_ms": self.poll_ms,
            "ticks": len(self.poll_ms),
            "suspicions": sum(r[0] == "quarantined"
                              and r[2].get("reason") == "heartbeat-suspect"
                              for r in records),
            "promotions": sum(r[0] == "spare-promoted" for r in records),
            "migrations": len({r[2]["node"] for r in records
                               if r[0] == "job-displaced"}),
            "straggler_evictions": summary["drain_migrations"],
            "displaced_episodes": self.episodes,
            "never_rebound": len(self.affected),
            "rebind_p50_s": _percentile(self.rebind_s, 0.5),
            "rebind_p90_s": _percentile(self.rebind_s, 0.9),
            "lost_gpu_seconds": self.lost_gpu_seconds,
            "poll_max_ms": max(self.poll_ms),
            "poll_p99_ms": _percentile(self.poll_ms, 0.99),
            "poll_max_at_s": self.slowest_poll[1],
            "poll_max_records": self.slowest_poll[2],
        }


def drive_recovery_fleet(spec: dict, ops, recovery: bool = True) -> dict:
    """The recovery fleet's trace over one package's loop.  ``ops`` gives
    ``now`` (a one-element list, the loop's clock), ``add_node(n)`` (a
    node and its agent), ``kill(name)`` (its agent stopped, its pods and
    the node deleted), ``create_group(name, members)``,
    ``delete_group(name)``, ``create_pod(p)``, ``delete_pod(name)``,
    ``cycle()`` (the scheduler), ``poll()`` (the controller),
    ``agents()``, ``tick(names)``, ``pods()`` ((name, node, phase)
    rows), ``nodes()`` (name -> (domain, host index label, spare)),
    ``records()`` (the RECOVERY_RECORDS as (category, subject, attrs),
    in the port's names), ``drain_migrations()`` (the straggler
    evictions) and ``journal`` (the run's).  ``recovery`` False is the
    baseline's trace (lost pods recreated with no displaced stamp), for
    ops built with every recovery knob at 0.  Returns the summary both
    packages must agree on and the run's figures."""
    return _RecoveryTrace(spec, ops, recovery).run()


class PortRecoveryOps:
    """The port's loop for ``drive_recovery_fleet``: node and pod
    controllers, the MPS partitioner controller from its factory with
    the recovery plane on (one spare a domain; ``recovery`` False: every
    recovery knob at 0), a ChipAgent a node and ``build_scheduler``, all
    on one virtual clock."""

    def __init__(self, recovery: bool = True) -> None:
        from nos_tpu_torch.cmd.assembly import build_scheduler
        from nos_tpu_torch.controllers.node_controller import NodeController
        from nos_tpu_torch.controllers.pod_controller import PodController
        from nos_tpu_torch.exporter.metrics import REGISTRY
        from nos_tpu_torch.kube.client import APIServer
        from nos_tpu_torch.obs import journal as J
        from nos_tpu_torch.partitioning.timeshare import (
            new_timeshare_partitioner_controller)

        self.now = [0.0]
        clock = lambda: self.now[0]  # noqa: E731
        # the run's own journal: the caller installs it for the run
        self.journal = J.DecisionJournal(maxlen=1 << 18, clock=clock)
        self.drain0 = REGISTRY.value("nos_tpu_drain_migrations_total",
                                     {"kind": C.MPS_KIND}) or 0.0
        self.api = APIServer()
        state = ClusterState()
        NodeController(self.api, state).bind()
        PodController(self.api, state).bind()
        self.controller = new_timeshare_partitioner_controller(
            self.api, state, batch_timeout_s=RECOVERY_BATCH_TIMEOUT_S,
            batch_idle_s=RECOVERY_BATCH_IDLE_S,
            spare_hosts_per_pool=1 if recovery else 0,
            node_suspect_after_s=RECOVERY_SUSPECT_AFTER_S if recovery
            else 0.0,
            migrate_grace_s=RECOVERY_GRACE_S, clock=clock)
        self.controller.bind()
        self.sched = build_scheduler(self.api, clock=clock)
        self._agents: dict = {}

    def add_node(self, n: dict) -> None:
        from nos_tpu_torch.controllers.chipagent import ChipAgent

        self.api.create("Node", make_gpu_node(
            n["name"], domain=n["domain"], host_index=n["host_index"],
            spare=n.get("spare", False)))
        agent = ChipAgent(self.api, n["name"])
        agent.start()
        self._agents[n["name"]] = agent

    def kill(self, name: str) -> None:
        from nos_tpu_torch.kube.client import NotFound

        self._agents.pop(name, None)
        for pod in self.api.pods_on_node(name):
            try:
                self.api.delete("Pod", pod.metadata.name,
                                pod.metadata.namespace)
            except NotFound:
                pass
        self.api.delete("Node", name)

    def create_group(self, name: str, members: int) -> None:
        from .factory import make_pod_group

        self.api.create("PodGroup", make_pod_group(
            name, members, namespace=RECOVERY_NAMESPACE))

    def delete_group(self, name: str) -> None:
        self.api.delete("PodGroup", name, RECOVERY_NAMESPACE)

    def create_pod(self, p: dict) -> None:
        labels = {C.LABEL_POD_GROUP: p["gang"]} if p["gang"] else None
        annots = {C.ANNOT_DISPLACED: p["displaced"]} if p["displaced"] \
            else None
        self.api.create("Pod", make_timeshare_pod(
            p["gb"], name=p["name"], namespace=RECOVERY_NAMESPACE,
            priority=p["priority"], creation_timestamp=p["created"],
            labels=labels, annotations=annots))

    def delete_pod(self, name: str) -> None:
        from nos_tpu_torch.kube.client import NotFound

        try:
            self.api.delete("Pod", name, RECOVERY_NAMESPACE)
        except NotFound:
            pass

    def cycle(self) -> None:
        self.sched.run_cycle()

    def poll(self) -> None:
        self.controller.process_if_ready()

    def agents(self) -> list[str]:
        return list(self._agents)

    def tick(self, names: list[str]) -> None:
        for name in names:
            self._agents[name].tick()

    def pods(self) -> list[tuple[str, str, str]]:
        return sorted((p.metadata.name, p.spec.node_name, p.status.phase)
                      for p in self.api.list("Pod"))

    def nodes(self) -> dict[str, tuple[str, str, bool]]:
        return {n.metadata.name: (
                    n.metadata.labels.get(C.LABEL_NVLINK_DOMAIN, ""),
                    n.metadata.labels.get(C.LABEL_HOST_INDEX, ""),
                    C.is_warm_spare_labels(n.metadata.labels))
                for n in self.api.list("Node")}

    def records(self) -> list:
        return [[r.category, r.subject, dict(sorted(r.attrs.items()))]
                for r in self.journal.events()
                if r.category in RECOVERY_RECORDS]

    def drain_migrations(self) -> float:
        from nos_tpu_torch.exporter.metrics import REGISTRY

        return (REGISTRY.value("nos_tpu_drain_migrations_total",
                               {"kind": C.MPS_KIND}) or 0.0) \
            - self.drain0


def _recovery_run(spec: dict, recovery: bool) -> dict:
    """One ``drive_recovery_fleet`` on the port, under a journal and a
    waste ledger of its own on the run's clock (``waste``, the ledger's
    report; one that does not conserve raises)."""
    ops = PortRecoveryOps(recovery)
    ledger = ChipSecondLedger(clock=lambda: ops.now[0])
    try:
        with obs_scoped(journal=ops.journal, ledger=ledger):
            out = drive_recovery_fleet(spec, ops, recovery)
    finally:
        ops.sched.close()
    out["waste"] = check_conservation(
        ledger.report(), "the recovery fleet" if recovery
        else "the recovery fleet's baseline")
    return out


def run_recovery_fleet(spec: dict) -> dict:
    """The recovery fleet on the port, then its baseline (``baseline``:
    the same kill schedule with every recovery step off), each under a
    journal and a waste ledger of its own.  ``lost_ratio`` is the
    recovery run's lost GPU-seconds over the baseline's; over
    RECOVERY_LOST_HALVING raises, as bench_nodeloss.py's gate fails."""
    out = _recovery_run(spec, True)
    base = _recovery_run(spec, False)
    out["baseline"] = {k: base[k] for k in (
        "lost_gpu_seconds", "never_rebound", "displaced_episodes",
        "promotions", "suspicions", "waste")}
    lost, base_lost = out["lost_gpu_seconds"], base["lost_gpu_seconds"]
    out["lost_ratio"] = lost / base_lost if base_lost > 0 else None
    if base_lost > 0 and lost > RECOVERY_LOST_HALVING * base_lost:
        raise RuntimeError(
            f"the recovery fleet lost {lost} GPU-seconds, over "
            f"{RECOVERY_LOST_HALVING} x the baseline's {base_lost}")
    return out


def parallel_plan_summary(desired, records) -> dict:
    """What a parallel plan decided, as both packages must agree on it:
    each node's desired shares per GPU (profile names, which the two
    packages spell alike) and the planner's journal ((category, subject,
    attrs) rows; the merge record without its wall time)."""
    geometries = {}
    for name in sorted(desired):
        rows = {}
        for u in desired[name].units:
            table = rows.setdefault(str(u.index), {})
            for res, qty in u.resources.items():
                profile = res.rsplit("-", 1)[1]
                table[profile] = table.get(profile, 0) + qty
        geometries[name] = {i: dict(sorted(t.items()))
                            for i, t in sorted(rows.items())}
    return {"geometries": geometries,
            "journal": [[c, s, {k: v for k, v in sorted(a.items())
                                if k != "wall_ms"}]
                        for c, s, a in records]}


# -- the scale fleets --------------------------------------------------------

SCALE_DOMAINS = 16
SCALE_HOSTS_PER_DOMAIN = 64
SCALE_PODS_PER_64_HOSTS = 40
SCALE_MIX = (("1g.10gb", 8), ("2g.20gb", 6), ("3g.40gb", 4),
             ("4g.40gb", 2), ("2x8", 2))         # (profile, weight)
SCALE_BOUND = 8192
# (bench_fleet.py's generation, profile, count): its RESIDENT_PENDING,
# eight a generation; v5e's and v6e's 8x8 (eight 8-chip hosts) an 8x8
# block, v5p's 4x4x4 (sixteen 4-chip hosts, which no 8-GPU node's block
# reproduces host for host) the 4g.40gb it was mapped to before blocks
SCALE_RESIDENTS = (("v5e", "8x8", 8), ("v5p", "4g.40gb", 8),
                   ("v6e", "8x8", 8))
SCALE_SLICE = "1g.10gb"


def scale_plan_spec(domains: int = SCALE_DOMAINS,
                    hosts: int = SCALE_HOSTS_PER_DOMAIN) -> dict:
    """``bench_fleet.py``'s plan fleet (``make_fleet_state``,
    ``make_fleet_batch``) as a MIG spec in ``fleet_spec``'s format; a
    block pod (its 4x4 row) carries ``gang`` ``fleet-gang-<i>``, a pod
    group of its own, as ``bench_fleet.py:166-170`` labels it."""
    nodes = []
    for d in range(domains):
        for h in range(hosts):
            full = h < hosts // 2
            name = f"nvl-{d}-h{h}"
            nodes.append({
                "name": name, "kind": C.MIG_KIND, "gpus": GPUS_PER_NODE,
                "status": {g: {"used" if full else "free": {"7g.80gb": 1}}
                           for g in range(GPUS_PER_NODE)},
                "bound": [{"name": f"filler-{name}", "shares": {},
                           "filler": True}] if full else [],
                "domain": f"nvl-{d}", "host_index": h})
    want = SCALE_PODS_PER_64_HOSTS * domains * hosts // 64
    pods = []
    while len(pods) < want:
        for profile, weight in SCALE_MIX:
            for _ in range(weight):
                if len(pods) < want:
                    i = len(pods)
                    pods.append({"name": f"fleet-{i}", "profile": profile,
                                 "qty": 1, "priority": i % 3,
                                 "created": 0.0})
                    if profile == MIG_BLOCK:
                        pods[-1]["gang"] = f"fleet-gang-{i}"
    return {"nodes": nodes, "pending": pods}


def scale_cycle_api(nodes: int = SCALE_DOMAINS * SCALE_HOSTS_PER_DOMAIN,
                    bound: int = SCALE_BOUND,
                    residents=SCALE_RESIDENTS):
    """``bench_fleet.py``'s scale tier (``build_scale_api``) on an
    APIServer: ``nodes`` MIG nodes of 8 GPUs in NVLink domains of
    SCALE_HOSTS_PER_DOMAIN, each GPU carved to 1g.10gb x 7, ``bound``
    1g.10gb pods bound round-robin over the nodes (and over each node's
    GPUs) and Running, then ``residents`` ((generation, profile, count))
    pending pods ``resident-<generation>-<k>`` no node advertises, with
    no pod group (``bench_fleet.py:403-408``: so in both packages they
    take the single-pod path)."""
    from nos_tpu_torch.kube.client import APIServer, KIND_NODE, KIND_POD
    from nos_tpu_torch.kube.objects import RUNNING

    api = APIServer()
    for i in range(nodes):
        name = f"gpu-node-{i}"
        held = bound // nodes + (1 if i < bound % nodes else 0)
        status = {}
        for g in range(GPUS_PER_NODE):
            used = held // GPUS_PER_NODE + (1 if g < held % GPUS_PER_NODE
                                           else 0)
            if used > 7:
                raise ValueError(f"{bound} pods do not fit {nodes} nodes")
            status[g] = {"free": {SCALE_SLICE: 7 - used}}
            if used:
                status[g]["used"] = {SCALE_SLICE: used}
        api.create(KIND_NODE, make_gpu_node(
            name, gpus=GPUS_PER_NODE, partitioning=C.MIG_KIND,
            status_geometry=status,
            domain=f"nvl-{i // SCALE_HOSTS_PER_DOMAIN}",
            host_index=i % SCALE_HOSTS_PER_DOMAIN))
        for k in range(held):
            api.create(KIND_POD, make_mig_pod(
                SCALE_SLICE, 1, name=f"sf-{name}-{k}", node_name=name,
                phase=RUNNING))
    for gen, profile, count in residents:
        for k in range(count):
            api.create(KIND_POD, make_mig_pod(
                profile, 1, name=f"resident-{gen}-{k}"))
    return api


# -- the defrag fleet --------------------------------------------------------

# bench_defrag.py's trace on the MIG stand-in (24 one-GPU nodes, one a JAX
# host block) on a one-second tick; its knobs as the bench sets them
DEFRAG_NODES = 24
DEFRAG_TICK_S = 1.0
DEFRAG_TRACE_S = 300.0
DEFRAG_WARMUP_S = 60.0
DEFRAG_BATCH_IDLE_S = 0.5
DEFRAG_BATCH_TIMEOUT_S = 2.0
DEFRAG_INTERVAL_S = 6.0
DEFRAG_PAYBACK_MIN = 1.2
DEFRAG_DRAIN_TIMEOUT_S = 30.0
DEFRAG_NAMESPACE = "work"
DEFRAG_DOMAIN = "nvl-0"
# the scheduler's drain preemption after this many cycles of one lease,
# sparing a job past DEFRAG_SPARE_PROGRESS, and a block shard charged the
# stand-in node's GPUs (bench_defrag.py: 40, and its 8 chips a host)
DEFRAG_DRAIN_AFTER_CYCLES = 40
DEFRAG_SPARE_PROGRESS = 0.75
DEFRAG_SHARD_GPUS = 1
# the bench's gates: the frag halving, the churn bounds and the floor
FRAG_HALVING_TARGET = 0.50
MAX_MIGRATIONS_PER_JOB = 2
MAX_TOTAL_MIGRATIONS = 40
UTILIZATION_MIN_TARGET = 0.95
# the bench's 3 s of samples for the utilisation floor's rolling mean
DEFRAG_UTIL_WINDOW_S = 5.0
# the elastic sponge gangs: 3g.40gb members, min 2, max sized to the pod
DEFRAG_ELASTIC_MIN, DEFRAG_ELASTIC_MAX = 2, 60
DEFRAG_SPONGES = ("sponge-a", "sponge-b")
DEFRAG_WHOLE, DEFRAG_HALF = "7g.80gb", "3g.40gb"
# the bench's 4x4 over two 8-chip hosts: an NVLink block of two one-GPU
# nodes
DEFRAG_BLOCK = "2x1"
# class -> (profile, members, priority, duration range s), the bench's
# CLASS_SPECS: its 1x2 filler and burst are 3g.40gb (the stand-in has no
# 1x2), its 2x4 big 7g.80gb, its 2-host 4x4 gang a 2x1 block gang of two
DEFRAG_CLASSES = {"filler": (DEFRAG_HALF, 1, 0, (120.0, 240.0)),
                  "big": (DEFRAG_WHOLE, 1, 5, (50.0, 90.0)),
                  "burst": (DEFRAG_HALF, 1, 10, (10.0, 20.0)),
                  "gang": (DEFRAG_BLOCK, 2, 10, (60.0, 100.0))}
# phase start -> {class: in-flight target}, the bench's, in its chip
# equivalents (DEFRAG_UNITS)
DEFRAG_PHASES = ((0.0, {"filler": 150.0, "big": 0.0, "burst": 0.0,
                        "gang": 0.0}),
                 (40.0, {"filler": 0.0, "big": 56.0, "burst": 0.0,
                         "gang": 0.0}),
                 (190.0, {"filler": 0.0, "big": 40.0, "burst": 12.0,
                          "gang": 16.0}))
# the trace's unit, the bench's chip: a GPU (a host block) 8, a 3g.40gb
# 4 (a 2x2), a block member its node's GPU, 8 (the bench's member owns
# its host's 8 chips of the 4x4); the targets and the utilisation are
# counted in it
DEFRAG_UNITS = {DEFRAG_WHOLE: 8.0, DEFRAG_HALF: 4.0, DEFRAG_BLOCK: 8.0}
# the journal's records the defrag fleet's summary keeps, and the
# weighted figures it leaves out (each package weighs in its own unit)
DEFRAG_RECORDS = ("defrag-proposed", "defrag-applied", "defrag-rejected",
                  "gang-resized")
DEFRAG_WEIGHED = ("unlocked_chips", "cost_chips")


def defrag_standin() -> GpuModel:
    """The H100 80GB restricted to {7g.80gb, 3g.40gb} and to blocks of two
    nodes, the MIG stand-in on which the JAX package's v5e restricted to
    {2x4, 2x2, 4x4} decides alike."""
    import dataclasses

    return dataclasses.replace(H100_80GB, mig_profiles=tuple(
        p for p in H100_80GB.mig_profiles
        if p.name in (DEFRAG_WHOLE, DEFRAG_HALF)), block_node_counts=(2,))


def defrag_fleet_spec(seed: int = 0) -> dict:
    """The defrag fleet's spec: DEFRAG_NODES virgin one-GPU nodes in one
    NVLink domain, each with its host index; ``seed`` draws the jobs'
    durations."""
    return {"seed": seed,
            "nodes": [{"name": f"host-{i}", "host_index": i}
                      for i in range(DEFRAG_NODES)]}


class _DefragTrace:
    """bench_defrag.py's ``Sim`` over an ``ops`` object: the sponge
    gangs, the phases' in-flight targets, completions, the workload
    controller (a moved job comes back with its creation time; a sponge
    is held at its min) and the utilisation samples.  The trace decides
    only from what ``ops`` shows, so two packages that decide alike run
    the same trace."""

    def __init__(self, spec: dict, ops) -> None:
        self.ops = ops
        self.rng = np.random.default_rng(spec["seed"])
        self.jobs: dict[str, dict] = {}
        self.pod_job: dict[str, dict] = {}
        self.seq = 0
        self.completed = 0
        self.latencies: list[float] = []
        self.util_raw: list[float] = []
        self.util: list[float] = []
        self.total = DEFRAG_UNITS[DEFRAG_WHOLE] * len(spec["nodes"])
        self.window = max(1, int(round(DEFRAG_UTIL_WINDOW_S
                                       / DEFRAG_TICK_S)))
        self.ticks: list[list] = []
        self.prev: dict[str, str] = {}
        self.seen_records = 0
        # every pod a defrag proposal moved: (pod, its job's progress
        # then, its job's class)
        self.evictions: list[tuple[str, float, str]] = []
        # every block gang bound: [job, time, its nodes, whether each of
        # them was under the gang's lease a tick before]; every change of
        # the gang lease: [time, its holders, its nodes]
        self.gangs: list[list] = []
        self.leases: dict[str, str] = {}
        self.lease_log: list[list] = []
        self.cycle_ms: list[float] = []
        self.poll_ms: list[float] = []
        for n in spec["nodes"]:
            ops.add_node(n)
        for name in DEFRAG_SPONGES:
            ops.create_group(name, DEFRAG_ELASTIC_MIN)
            job = {"name": name, "kind": "elastic", "pods": [],
                   "duration": 2 * DEFRAG_TRACE_S, "created": 0.0,
                   "profile": DEFRAG_HALF, "members": DEFRAG_ELASTIC_MIN,
                   "priority": 0, "bound_at": None}
            for i in range(DEFRAG_ELASTIC_MIN):
                pod = f"{name}-{i}"
                self.create(job, pod)
                job["pods"].append(pod)
                self.pod_job[pod] = job
            self.jobs[name] = job

    def now(self) -> float:
        return self.ops.now[0]

    def create(self, job: dict, pod: str) -> None:
        elastic = job["kind"] == "elastic"
        self.ops.create_pod({
            "name": pod, "profile": job["profile"],
            "priority": job["priority"], "created": job["created"],
            "gang": job["name"] if job["members"] > 1 else "",
            "elastic": (DEFRAG_ELASTIC_MIN, DEFRAG_ELASTIC_MAX)
            if elastic else None})

    def progress(self, name: str) -> float:
        """The defragmenter's restart-cost signal, the bench's: the
        fraction of its job's duration since it bound."""
        job = self.pod_job.get(name)
        if job is None or job["bound_at"] is None or job["duration"] <= 0:
            return 0.0
        return min(1.0, max(0.0, (self.now() - job["bound_at"])
                            / job["duration"]))

    def targets(self) -> dict[str, float]:
        current = DEFRAG_PHASES[0][1]
        for start, targets in DEFRAG_PHASES:
            if self.now() >= start:
                current = targets
        return current

    def spawn(self) -> None:
        targets = self.targets()
        footprint = {cls: 0.0 for cls in targets}
        for name, _, _, _ in self.ops.pods():
            job = self.pod_job.get(name)
            if job is not None and job["kind"] in footprint:
                footprint[job["kind"]] += DEFRAG_UNITS[job["profile"]]
        for cls, target in targets.items():
            while footprint[cls] < target:
                footprint[cls] += self.spawn_job(cls)

    def spawn_job(self, cls: str) -> float:
        """One job of ``cls``: a gang's PodGroup first, then its members,
        as the bench spawns them."""
        profile, members, priority, (lo, hi) = DEFRAG_CLASSES[cls]
        self.seq += 1
        name = f"{cls}-{self.seq}"
        job = {"name": name, "kind": cls,
               "pods": [f"{name}-{i}" for i in range(members)],
               "duration": float(self.rng.uniform(lo, hi)),
               "created": self.now(), "profile": profile,
               "members": members, "priority": priority, "bound_at": None}
        if members > 1:
            self.ops.create_group(name, members)
        for pod in job["pods"]:
            self.create(job, pod)
            self.pod_job[pod] = job
        self.jobs[name] = job
        return DEFRAG_UNITS[profile] * members

    def complete(self) -> None:
        for job in list(self.jobs.values()):
            if job["bound_at"] is None \
                    or self.now() < job["bound_at"] + job["duration"]:
                continue
            doomed = set(job["pods"]) | {
                name for name, _, _, gang in self.ops.pods()
                if gang == job["name"]}
            for name in sorted(doomed):
                self.ops.delete_pod(name)
                self.pod_job.pop(name, None)
            if job["members"] > 1:
                self.ops.delete_group(job["name"])
            del self.jobs[job["name"]]
            self.completed += 1

    def requeue(self) -> None:
        """The workload controller: a moved or preempted job comes back
        with its creation time and loses its progress; a sponge is only
        kept at its min (losing a member is the shrink contract)."""
        rows = self.ops.pods()
        live = {name for name, _, _, _ in rows}
        for job in self.jobs.values():
            if job["kind"] == "elastic":
                alive = sum(gang == job["name"] for _, _, _, gang in rows)
                for name in job["pods"]:
                    if alive >= DEFRAG_ELASTIC_MIN:
                        break
                    if name not in live:
                        self.create(job, name)
                        self.pod_job[name] = job
                        alive += 1
                        job["bound_at"] = None
                continue
            missing = [n for n in job["pods"] if n not in live]
            if not missing:
                continue
            job["bound_at"] = None
            for name in missing:
                self.create(job, name)
                self.pod_job[name] = job

    def record_binds(self) -> None:
        rows = self.ops.pods()
        bound = {name for name, node, phase, _ in rows
                 if node and phase == "Running"}
        now = {name: node for name, node, _, _ in rows}
        for job in self.jobs.values():
            if job["bound_at"] is None and all(n in bound
                                               for n in job["pods"]):
                job["bound_at"] = self.now()
                if job["kind"] != "elastic":
                    self.latencies.append(self.now() - job["created"])
                if job["kind"] != "elastic" and job["members"] > 1:
                    nodes = sorted(now[n] for n in job["pods"])
                    lease = f"{DEFRAG_NAMESPACE}/{job['name']}"
                    self.gangs.append([
                        job["name"], self.now(), nodes,
                        [self.leases.get(n) == lease for n in nodes]])
        leases = self.ops.leases()
        if leases != self.leases:
            self.lease_log.append([self.now(), sorted(set(leases.values())),
                                   sorted(leases)])
        self.leases = leases
        binds = sorted(n for n, node in now.items()
                       if node and not self.prev.get(n))
        gone = sorted(set(self.prev) - set(now))
        if binds or gone:
            self.ticks.append([self.now(), binds, gone])
        self.prev = now
        # a pod outside the job table is a grown sponge member: a half
        used = sum(DEFRAG_UNITS[self.pod_job[n]["profile"]]
                   if n in self.pod_job else DEFRAG_UNITS[DEFRAG_HALF]
                   for n in bound)
        self.util_raw.append(min(1.0, used / self.total))
        if self.now() >= DEFRAG_WARMUP_S:
            window = self.util_raw[-self.window:]
            self.util.append(sum(window) / len(window))

    def note_evictions(self) -> None:
        """Each defrag record the poll wrote; a move's victim with its
        job's progress at that moment (the spare-progress screen)."""
        records = self.ops.records()
        for category, _, attrs in records[self.seen_records:]:
            if category != "defrag-applied":
                continue
            for key in attrs.get("moved", []):
                name = key.split("/", 1)[1]
                job = self.pod_job.get(name)
                self.evictions.append((name, self.progress(name),
                                       job["kind"] if job else ""))
        self.seen_records = len(records)

    def tick(self) -> None:
        self.complete()
        self.spawn()
        t0 = time.perf_counter()
        self.ops.cycle()
        self.cycle_ms.append((time.perf_counter() - t0) * 1e3)
        self.requeue()
        t0 = time.perf_counter()
        self.ops.poll()
        self.poll_ms.append((time.perf_counter() - t0) * 1e3)
        self.note_evictions()
        self.ops.tick()
        self.record_binds()

    def run(self) -> dict:
        while self.now() < DEFRAG_TRACE_S:
            self.ops.now[0] += DEFRAG_TICK_S
            self.tick()
        records = self.ops.records()
        by_job: dict[str, int] = {}
        moved = 0
        for category, _, attrs in records:
            if category != "defrag-applied":
                continue
            for key in attrs.get("moved", []):
                moved += 1
                job = key.split("/", 1)[1].rsplit("-", 1)[0]
                by_job[job] = by_job.get(job, 0) + 1
        resizes = [a for c, _, a in records if c == "gang-resized"]
        count = {c: sum(r[0] == c for r in records) for c in DEFRAG_RECORDS}
        summary = {
            "ticks": self.ticks,
            "records": [[c, s, {k: v for k, v in sorted(a.items())
                                if k not in DEFRAG_WEIGHED}]
                        for c, s, a in records],
            "completed": self.completed,
            "latencies": self.latencies,
            "utilization": self.util,
            "gangs": self.gangs,
            "leases": self.lease_log,
        }
        return {
            "summary": summary,
            "proposed": count["defrag-proposed"],
            "applied": count["defrag-applied"],
            "rejected": count["defrag-rejected"],
            "migrated_pods": moved,
            "migrations_by_job_max": max(by_job.values(), default=0),
            "gpus_unlocked": sum(a.get("unlocked_chips", 0.0)
                                 for c, _, a in records
                                 if c == "defrag-applied"),
            "grows": sum(a.get("direction") == "grow" for a in resizes),
            "shrinks": sum(a.get("direction") == "shrink" for a in resizes),
            "evictions": self.evictions,
            "utilization_min": min(self.util) if self.util else 0.0,
            "utilization_mean": (sum(self.util) / len(self.util)
                                 if self.util else 0.0),
            "jobs_completed": self.completed,
            "jobs_bound": len(self.latencies),
            "gangs_bound": self.gangs,
            "lease_log": self.lease_log,
            "cycle_ms": self.cycle_ms, "poll_ms": self.poll_ms,
            "ticks": len(self.poll_ms),
        }


def drive_defrag_fleet(spec: dict, ops) -> dict:
    """The defrag fleet's trace over one package's loop.  ``ops`` gives
    ``now`` (a one-element list, the loop's clock), ``add_node(n)`` (a
    virgin node and its agent), ``create_group(name, min_member)``,
    ``delete_group(name)``, ``create_pod(p)`` (``p``: name, profile,
    priority, created, gang, elastic (min, max) or None),
    ``delete_pod(name)``, ``cycle()`` (the scheduler), ``poll()`` (the
    controller, the defragmenter inside it), ``tick()`` (every agent),
    ``pods()`` ((name, node, phase, gang) rows), ``leases()`` (node ->
    its gang lease, "<namespace>/<gang>", where one is set) and
    ``records()`` (the DEFRAG_RECORDS as (category, subject, attrs), in
    the port's names).  ``ops`` is built with ``progress`` (pod name ->
    the trace's restart cost signal) as its defragmenter's and its drain
    preemption's progress function.  Returns the summary both packages
    must agree on and the run's figures."""
    return _DefragTrace(spec, ops).run()


class PortDefragOps:
    """The port's loop for ``drive_defrag_fleet``: node controller with
    the virgin-node initializer, pod controller, the MIG partitioner
    controller from its factory on the stand-in (the defragmenter on
    with ``defrag``, at ``payback_min``, or never built), a SliceAgent
    over ``FakeGpuRuntime`` on each node, and ``build_scheduler`` (its
    grow pass on with ``grow``), all on one virtual clock.  It times each
    plan cycle (``plan_ms``, the controller's plan and actuation, the
    defragmenter's step left out) and each defragmenter step
    (``defrag_ms``) on the host's counter.  The scheduler drains a
    leased window after DEFRAG_DRAIN_AFTER_CYCLES with the trace's
    ``progress`` and charges a block shard DEFRAG_SHARD_GPUS."""

    def __init__(self, progress, defrag: bool = True,
                 payback_min: float = DEFRAG_PAYBACK_MIN,
                 grow: bool = True) -> None:
        from nos_tpu_torch.cmd.assembly import build_scheduler
        from nos_tpu_torch.controllers.node_controller import NodeController
        from nos_tpu_torch.controllers.pod_controller import PodController
        from nos_tpu_torch.kube.client import APIServer
        from nos_tpu_torch.obs import journal as J
        from nos_tpu_torch.partitioning.slicepart import (
            SliceNodeInitializer, new_slice_partitioner_controller)
        from nos_tpu_torch.topology.known import GpuModelRegistry

        self.model = defrag_standin()
        registry = GpuModelRegistry(models={self.model.name: self.model})
        self.now = [0.0]
        clock = lambda: self.now[0]  # noqa: E731
        self.journal = J.DecisionJournal(maxlen=1 << 19, clock=clock)
        self.api = APIServer()
        state = ClusterState()
        NodeController(self.api, state,
                       SliceNodeInitializer(self.api, registry)).bind()
        PodController(self.api, state).bind()
        self.controller = new_slice_partitioner_controller(
            self.api, state, batch_timeout_s=DEFRAG_BATCH_TIMEOUT_S,
            batch_idle_s=DEFRAG_BATCH_IDLE_S, defrag_enabled=defrag,
            defrag_payback_min=payback_min,
            defrag_interval_s=DEFRAG_INTERVAL_S,
            defrag_drain_timeout_s=DEFRAG_DRAIN_TIMEOUT_S,
            defrag_progress_fn=lambda pod: progress(pod.metadata.name),
            registry=registry, clock=clock)
        self.controller.bind()
        self.sched = build_scheduler(
            self.api, elastic_grow_budget_per_cycle=1 if grow else 0,
            clock=clock,
            drain_preempt_after_cycles=DEFRAG_DRAIN_AFTER_CYCLES,
            drain_preempt_spare_progress=DEFRAG_SPARE_PROGRESS,
            drain_preempt_progress_fn=lambda pod: progress(
                pod.metadata.name),
            shard_chips_per_host=DEFRAG_SHARD_GPUS)
        self._agents: dict = {}
        self.plan_ms: list[float] = []
        self.defrag_ms: list[float] = []
        proposer = self.controller._defrag
        if proposer is not None:
            step = proposer.step

            def timed_step(snapshot, pending):
                t0 = time.perf_counter()
                try:
                    return step(snapshot, pending)
                finally:
                    self.defrag_ms.append((time.perf_counter() - t0) * 1e3)

            proposer.step = timed_step
        plan = self.controller.process_pending_pods

        def timed_plan(pods=None):
            t0, n = time.perf_counter(), len(self.defrag_ms)
            try:
                return plan(pods)
            finally:
                ms = (time.perf_counter() - t0) * 1e3
                self.plan_ms.append(ms - sum(self.defrag_ms[n:]))

        self.controller.process_pending_pods = timed_plan

    def add_node(self, n: dict) -> None:
        from nos_tpu_torch.controllers.sliceagent import SliceAgent
        from nos_tpu_torch.device.fake import FakeGpuRuntime, FakePodResources

        self.api.create("Node", make_gpu_node(
            n["name"], model=self.model, gpus=1, partitioning=C.MIG_KIND,
            domain=DEFRAG_DOMAIN, host_index=n["host_index"]))
        agent = SliceAgent(self.api, n["name"],
                           FakeGpuRuntime(self.model, 1), FakePodResources())
        agent.start()
        self._agents[n["name"]] = agent

    def create_group(self, name: str, min_member: int) -> None:
        from .factory import make_pod_group

        self.api.create("PodGroup", make_pod_group(
            name, min_member, namespace=DEFRAG_NAMESPACE))

    def delete_group(self, name: str) -> None:
        from nos_tpu_torch.kube.client import NotFound

        try:
            self.api.delete("PodGroup", name, DEFRAG_NAMESPACE)
        except NotFound:
            pass

    def create_pod(self, p: dict) -> None:
        labels = {C.LABEL_POD_GROUP: p["gang"]} if p["gang"] else None
        annots = None
        if p["elastic"]:
            lo, hi = p["elastic"]
            annots = {C.ANNOT_ELASTIC: C.ELASTIC_DP,
                      C.ANNOT_MIN_REPLICAS: str(lo),
                      C.ANNOT_MAX_REPLICAS: str(hi)}
        self.api.create("Pod", make_mig_pod(
            p["profile"], name=p["name"], namespace=DEFRAG_NAMESPACE,
            priority=p["priority"], creation_timestamp=p["created"],
            labels=labels, annotations=annots))

    def delete_pod(self, name: str) -> None:
        from nos_tpu_torch.kube.client import NotFound

        try:
            self.api.delete("Pod", name, DEFRAG_NAMESPACE)
        except NotFound:
            pass

    def cycle(self) -> None:
        self.sched.run_cycle()

    def poll(self) -> None:
        self.controller.process_if_ready()

    def tick(self) -> None:
        for name in sorted(self._agents):
            self._agents[name].tick()

    def pods(self) -> list[tuple[str, str, str, str]]:
        return sorted((p.metadata.name, p.spec.node_name, p.status.phase,
                       p.metadata.labels.get(C.LABEL_POD_GROUP, ""))
                      for p in self.api.list("Pod"))

    def leases(self) -> dict[str, str]:
        return {n.metadata.name: n.metadata.annotations[C.ANNOT_GANG_LEASE]
                for n in self.api.list("Node")
                if n.metadata.annotations.get(C.ANNOT_GANG_LEASE)}

    def records(self) -> list:
        return [[r.category, r.subject, dict(sorted(r.attrs.items()))]
                for r in self.journal.events()
                if r.category in DEFRAG_RECORDS]


def _defrag_run(spec: dict, defrag: bool = True,
                payback_min: float = DEFRAG_PAYBACK_MIN,
                grow: bool = True) -> dict:
    """One ``drive_defrag_fleet`` on the port under a journal and a waste
    ledger of its own on the run's clock (``waste``, the ledger's
    report; one that does not conserve raises), with the journal's
    decisions (``decisions``: every record but the defragmenter's, plan
    ids out) for the identity of the baseline and the propose-only run."""
    trace = {}
    ops = PortDefragOps(lambda name: trace["t"].progress(name), defrag,
                        payback_min, grow)
    ledger = ChipSecondLedger(clock=lambda: ops.now[0])
    try:
        with obs_scoped(journal=ops.journal, ledger=ledger):
            trace["t"] = _DefragTrace(spec, ops)
            out = trace["t"].run()
    finally:
        ops.sched.close()
    out["waste"] = check_conservation(ledger.report(), "the defrag fleet")
    out["plan_ms"], out["defrag_ms"] = ops.plan_ms, ops.defrag_ms
    out["decisions"] = [
        [r.category, r.subject, sorted((k, str(v)) for k, v in r.attrs.items()
                                       if k != "plan_id")]
        for r in ops.journal.events()
        if r.category not in DEFRAG_RECORDS[:3]]
    return out


def run_defrag_fleet(spec: dict) -> dict:
    """The defrag fleet on the port three times, as bench_defrag.py runs
    it: defrag and grow on; the baseline (``baseline``) with both off;
    and propose-only (``propose_only``: defrag on at an infinite payback
    threshold, grow off), whose decisions must equal the baseline's.
    ``frag_ratio`` is the defrag run's frag_stranded GPU-seconds over
    the baseline's."""
    out = _defrag_run(spec)
    base = _defrag_run(spec, defrag=False, grow=False)
    only = _defrag_run(spec, payback_min=float("inf"), grow=False)
    frag = out["waste"]["fleet"]["chip_seconds"].get("frag_stranded", 0.0)
    base_frag = base["waste"]["fleet"]["chip_seconds"].get(
        "frag_stranded", 0.0)
    out["baseline"] = {k: base[k] for k in (
        "waste", "utilization_min", "utilization_mean", "jobs_completed",
        "jobs_bound", "gangs_bound", "lease_log", "cycle_ms", "poll_ms",
        "plan_ms")}
    out["propose_only"] = {k: only[k] for k in (
        "proposed", "applied", "rejected", "cycle_ms", "poll_ms", "plan_ms",
        "defrag_ms")}
    out["identical"] = base["decisions"] == only["decisions"]
    out["decisions"] = len(base["decisions"])
    out["frag_ratio"] = frag / base_frag if base_frag > 0 else None
    return out


# -- the serving fleets ----------------------------------------------------

# The mapped cluster (module docstring): the trace's "chip" is a fourth of
# an H100 (20 GB), which is the JAX stand-in's chip and the bench's unit.
SERVING_MIG_NODES = 24
SERVING_MPS_NODES = 2
SERVING_MPS_GPUS = 2
SERVING_CHIP_GB = 20
SERVING_DOMAIN = "pod-0"
SERVING_DECODE, SERVING_HALF, SERVING_WHOLE = "1g.20gb", "3g.40gb", "7g.80gb"
SERVING_PROFILES = (SERVING_DECODE, SERVING_HALF, SERVING_WHOLE)
# the trace's units of each profile (memory slots over 2: the stand-in's
# chips) and of an MPS share (GB over SERVING_CHIP_GB)
SERVING_UNITS = {SERVING_DECODE: 1, SERVING_HALF: 2, SERVING_WHOLE: 4}
SERVING_TOTAL_UNITS = (SERVING_MIG_NODES * 4 + SERVING_MPS_NODES
                       * SERVING_MPS_GPUS * 80 // SERVING_CHIP_GB)
# bench_serving.py's clock, cut: its 0.04 s tick kept, its 240 s trace
# and 40 s warm-up cut to SERVING_TRACE_S and SERVING_WARMUP_S
SERVING_TICK_S = 0.04
SERVING_TRACE_S = 30.0
SERVING_WARMUP_S = 10.0
SERVING_BATCH_IDLE_S = 0.5
SERVING_BATCH_TIMEOUT_S = 2.0
SERVING_STAMP_EVERY_TICKS = 5
SERVING_PREEMPT_BUDGET = 4
SERVING_P99_TARGET_S = 0.1
REQUEST_P99_TARGET_S = 10.0
SERVING_OCC_CEILING = 0.9
SERVING_OCC_WITHIN = 0.9
SERVING_TRACK_WITHIN = 0.9
# the bench's quotas in its chips (a chip 16 GB there), here at
# SERVING_CHIP_GB a chip: the mins still sum to the cluster's GB
SERVING_QUOTAS = (("serve", 40, 56), ("batch", 48, 64),
                  ("besteffort", 24, 112))
# bench_serving.py's mixes in the trace's units: batch 2x4 -> 7g.80gb,
# 2x2 -> 3g.40gb; the best-effort fillers sized like the serving units
SERVING_BATCH_MIX = ((SERVING_WHOLE, 2.0), (SERVING_HALF, 2.0))
SERVING_BE_MIX = ((SERVING_DECODE, 1.0),)
SERVING_BE_TS_MIX = ((8, 1.0),)
SERVING_BATCH_TARGET = 20.0
SERVING_BE_TARGET = 28.0
SERVING_BE_TS_TARGET = 8.0
SERVING_DURATION_S = {"batch": (20.0, 45.0), "besteffort": (8.0, 20.0)}
SERVING_TS_DURATION_S = (12.0, 30.0)
# bench_serving.py's SERVICES: chat on the decode unit, embed on 8 GB
# MPS shares
SERVING_SERVICES = (
    {"name": "chat", "namespace": "serve", "slice_shape": SERVING_DECODE,
     "min_replicas": 2, "max_replicas": 12, "target_load_per_replica": 8.0,
     "scale_up_cooldown_s": 0.2, "scale_down_cooldown_s": 10.0,
     "down_hysteresis": 0.2},
    {"name": "embed", "namespace": "serve", "timeshare_gb": 8,
     "min_replicas": 1, "max_replicas": 8, "target_load_per_replica": 16.0,
     "scale_up_cooldown_s": 0.2, "scale_down_cooldown_s": 12.0,
     "down_hysteresis": 0.2},
)
# bench_requests.py's ROUTER_AUTOSCALED: chat-prefill on 3g.40gb (the
# bench's 1x2, more compute), chat-decode on 1g.20gb (its 1x1)
REQUEST_AUTOSCALED = (
    {"name": "chat-prefill", "namespace": "serve",
     "slice_shape": SERVING_HALF, "min_replicas": 1, "max_replicas": 3,
     "target_load_per_replica": 0.5, "scale_up_cooldown_s": 0.2,
     "scale_down_cooldown_s": 10.0, "down_hysteresis": 0.2},
    {"name": "chat-decode", "namespace": "serve",
     "slice_shape": SERVING_DECODE, "min_replicas": 2, "max_replicas": 12,
     "target_load_per_replica": 0.55, "scale_up_cooldown_s": 0.2,
     "scale_down_cooldown_s": 10.0, "down_hysteresis": 0.2},
    {"name": "embed", "namespace": "serve", "timeshare_gb": 8,
     "min_replicas": 1, "max_replicas": 8, "target_load_per_replica": 0.55,
     "scale_up_cooldown_s": 0.2, "scale_down_cooldown_s": 12.0,
     "down_hysteresis": 0.2},
)
SERVING_CARD = "NVIDIA H100 80GB HBM3"
# bench_requests.py's models: chat KV-heavy (full MHA, 12 GB of weights,
# which a 1g.20gb holds with 8 GB of KV beside), embed a small encoder
CHAT_MODEL = {"name": "chat-7b-mha", "num_layers": 32, "num_heads": 32,
              "num_kv_heads": 32, "head_dim": 128,
              "intermediate_size": 14336, "weights_gb": 12.0}
EMBED_MODEL = {"name": "embed-1b", "num_layers": 12, "num_heads": 16,
               "num_kv_heads": 16, "head_dim": 64,
               "intermediate_size": 4096, "weights_gb": 2.0}
# bench_requests.py's ROUTER_SERVICES, each cost block on its replica's
# unit: the prefill pool's 3g.40gb, the decode pool's 1g.20gb, embed's
# 8 GB MPS share (the whole GPU time-shared)
REQUEST_ROUTED = (
    {"name": "chat", "namespace": "serve", "prefill_service": "chat-prefill",
     "decode_service": "chat-decode", "model": CHAT_MODEL,
     "prefill": {"device_kind": SERVING_CARD, "hbm_gb": 40.0,
                 "mig_profile": SERVING_HALF, "mfu": 0.4},
     "decode": {"device_kind": SERVING_CARD, "hbm_gb": 20.0,
                "mig_profile": SERVING_DECODE},
     "max_queue_per_replica": 16, "max_retries": 5, "retry_backoff_s": 0.3,
     "session_idle_s": 30.0},
    {"name": "embed", "namespace": "serve", "model": EMBED_MODEL,
     "prefill": {"device_kind": SERVING_CARD, "hbm_gb": 8.0, "mfu": 0.2,
                 "hbm_efficiency": 0.4},
     "max_queue_per_replica": 32, "max_retries": 3, "retry_backoff_s": 0.25,
     "session_idle_s": 20.0},
)
REQUEST_CHAT_PROMPT = (64, 512)
REQUEST_CHAT_OUTPUT = (16, 96)
REQUEST_CHAT_SESSIONS = 600
REQUEST_EMBED_PROMPT = (32, 256)
REQUEST_SERVICE_TIME_S = {"chat": 0.5, "embed": 1.0}
# the journal's records the serving fleets' summary keeps
SERVING_RECORDS = ("autoscale", "request-shed", "session-migrated")


def serving_standin() -> GpuModel:
    """The H100 80GB restricted to {1g.20gb, 3g.40gb, 7g.80gb}: a GPU's
    memory slots in pairs, each pair the JAX stand-in's chip (a 1x4 host
    of 20 GB chips: 1x1, 1x2 and 1x4 at its aligned offsets), on which
    the two packages' MIG planners decide alike.  It offers no NVLink
    block, as the JAX stand-in's largest pod is one host: the scheduler
    reading it (``registry``) scores no window term."""
    import dataclasses

    return dataclasses.replace(H100_80GB, mig_profiles=tuple(
        p for p in H100_80GB.mig_profiles if p.name in SERVING_PROFILES),
        block_node_counts=())


def serving_fleet_spec(seed: int = 0, router: bool = False) -> dict:
    """The serving fleet's spec: SERVING_MIG_NODES one-GPU MIG nodes of
    the stand-in in one NVLink domain, each at its host index, and
    SERVING_MPS_NODES MPS nodes of SERVING_MPS_GPUS GPUs; the quotas in
    GB; the autoscaled services (``router``: bench_requests.py's per-role
    ones and its routed services).  ``seed`` draws the jobs, the load
    curves and the requests."""
    return {
        "seed": seed, "router": router,
        "mig_nodes": [{"name": f"host-{i}", "host_index": i}
                      for i in range(SERVING_MIG_NODES)],
        "mps_nodes": [{"name": f"ts-{i}", "host_index": i}
                      for i in range(SERVING_MPS_NODES)],
        "quotas": [{"namespace": ns, "min_gb": float(lo * SERVING_CHIP_GB),
                    "max_gb": float(hi * SERVING_CHIP_GB)}
                   for ns, lo, hi in SERVING_QUOTAS],
        "autoscaled": list(REQUEST_AUTOSCALED if router
                           else SERVING_SERVICES),
        "routed": list(REQUEST_ROUTED) if router else [],
    }


def serving_traces(seed: int, router: bool) -> dict[str, dict]:
    """Each service's DiurnalTrace knobs, bench_serving.py's
    ``make_traces`` (router off: requests in flight) or
    bench_requests.py's ``request_traces`` (router on: the arrival
    rate's curve)."""
    if router:
        return {
            "serve/chat": dict(
                seed=seed * 11 + 3, period_s=120.0, base_users=150_000.0,
                peak_users=900_000.0, requests_per_user_per_s=2e-5,
                service_time_s=0.5, burst_rate_per_s=1.0 / 40.0,
                burst_multiplier=3.0, burst_duration_s=8.0),
            "serve/embed": dict(
                seed=seed * 11 + 4, period_s=150.0, phase_s=60.0,
                base_users=800_000.0, peak_users=4_800_000.0,
                requests_per_user_per_s=1e-5, service_time_s=1.0,
                burst_rate_per_s=1.0 / 55.0, burst_multiplier=2.5,
                burst_duration_s=10.0)}
    return {
        "serve/chat": dict(
            seed=seed * 7 + 1, period_s=120.0, base_users=400_000.0,
            peak_users=3_200_000.0, requests_per_user_per_s=2e-5,
            service_time_s=0.5, burst_rate_per_s=1.0 / 40.0,
            burst_multiplier=3.0, burst_duration_s=8.0),
        "serve/embed": dict(
            seed=seed * 7 + 2, period_s=150.0, phase_s=60.0,
            base_users=800_000.0, peak_users=4_800_000.0,
            requests_per_user_per_s=1e-5, service_time_s=1.0,
            burst_rate_per_s=1.0 / 55.0, burst_multiplier=2.5,
            burst_duration_s=10.0)}


def serving_units(p: dict) -> float:
    """A pod's size in the trace's units (a fourth of a GPU)."""
    if p.get("profile"):
        return float(SERVING_UNITS[p["profile"]])
    return p["gb"] / SERVING_CHIP_GB


def _read_pods(api, read) -> list:
    """``read(pod)`` of every stored pod, without the copies ``list``
    makes: ``read`` runs as the listing's filter, on the stored object,
    and must not change it."""
    out: list = []
    api.list("Pod", filter_fn=lambda p: out.append(read(p)))
    return out


def _rounded_percentile(xs: list[float], q: float, digits: int):
    """``_percentile`` rounded as the serving benches round it."""
    value = _percentile(xs, q)
    return None if value is None else round(value, digits)


class _ServingTrace:
    """bench_serving.py's ``Sim`` (and, with the router, bench_requests.py's
    overlay) over an ``ops`` object: the batch and best-effort backlogs,
    completions, the workload controller's requeue of evicted jobs, the
    load stamps (router off) or the routed arrivals (router on), and the
    samples.  It decides only from what ``ops`` shows, so two packages
    that decide alike run the same trace."""

    def __init__(self, spec: dict, ops) -> None:
        import random

        self.spec = spec
        self.ops = ops
        self.router = spec["router"]
        self.seed = spec["seed"]
        self.rng = random.Random(self.seed)
        self.traces = {key: ops.trace(**kw) for key, kw in
                       serving_traces(self.seed, self.router).items()}
        for n in spec["mig_nodes"]:
            ops.add_mig_node(n)
        for n in spec["mps_nodes"]:
            ops.add_mps_node(n)
        for q in spec["quotas"]:
            ops.create_quota(q)
        ops.build(spec)
        self.jobs: dict[str, dict] = {}
        self.job_seq = 0
        self.completed = 0
        self.serving_latencies: list[float] = []
        self.serving_seen: set[str] = set()
        self.batch_latencies: list[float] = []
        self.replica_series = {f"{s['namespace']}/{s['name']}": []
                               for s in spec["autoscaled"]}
        self.occ_series = {f"{s['namespace']}/{s['name']}": []
                           for s in spec["routed"]}
        self.ticks: list[list] = []
        self.prev: dict[str, str] = {}
        self.util_area = self.batch_util_area = self.util_time = 0.0
        self.util: list[float] = []
        self.cycle_ms: list[float] = []
        self.reconcile_ms: list[float] = []
        self.router_ms: list[float] = []
        self.tick_no = 0
        self.rid = 0
        self.req_rng = {s["name"]: random.Random(self.seed * 1000 + i * 7)
                        for i, s in enumerate(spec["routed"])}

    def now(self) -> float:
        return self.ops.now()

    # -- batch and best effort --------------------------------------------
    def spawn_job(self, ns: str, unit: dict, lo: float, hi: float,
                  tier: str = "") -> float:
        self.job_seq += 1
        name = f"{ns}-j{self.job_seq}"
        p = {"name": name, "namespace": ns, "tier": tier,
             "created": self.now(), **unit}
        self.ops.create_pod(p)
        self.jobs[name] = {"pod": p, "duration": self.rng.uniform(lo, hi),
                           "bound_at": None}
        return serving_units(p)

    def spawn(self, rows: list[dict]) -> None:
        backlog = {"batch": 0.0, "besteffort": 0.0, "besteffort-ts": 0.0}
        for r in rows:
            if r["node"] or r["namespace"] not in ("batch", "besteffort"):
                continue
            key = r["namespace"]
            if key == "besteffort" and not r.get("profile"):
                key = "besteffort-ts"
            backlog[key] += serving_units(r)
        lo, hi = SERVING_DURATION_S["batch"]
        while backlog["batch"] < SERVING_BATCH_TARGET:
            shape = self.rng.choices([m[0] for m in SERVING_BATCH_MIX],
                                     [m[1] for m in SERVING_BATCH_MIX])[0]
            backlog["batch"] += self.spawn_job("batch", {"profile": shape},
                                               lo, hi)
        lo, hi = SERVING_DURATION_S["besteffort"]
        while backlog["besteffort"] < SERVING_BE_TARGET:
            shape = self.rng.choices([m[0] for m in SERVING_BE_MIX],
                                     [m[1] for m in SERVING_BE_MIX])[0]
            backlog["besteffort"] += self.spawn_job(
                "besteffort", {"profile": shape}, lo, hi,
                tier=C.TIER_BEST_EFFORT)
        lo, hi = SERVING_TS_DURATION_S
        while backlog["besteffort-ts"] < SERVING_BE_TS_TARGET:
            gb = self.rng.choices([m[0] for m in SERVING_BE_TS_MIX],
                                  [m[1] for m in SERVING_BE_TS_MIX])[0]
            backlog["besteffort-ts"] += self.spawn_job(
                "besteffort", {"gb": gb}, lo, hi, tier=C.TIER_BEST_EFFORT)

    def complete_finished(self) -> None:
        for name, job in list(self.jobs.items()):
            if job["bound_at"] is None \
                    or self.now() < job["bound_at"] + job["duration"]:
                continue
            self.ops.delete_pod(name, job["pod"]["namespace"])
            del self.jobs[name]
            self.completed += 1

    def requeue_evicted(self) -> None:
        """Evicted jobs come back with their original creation time."""
        live = self.ops.pod_names()
        for name, job in self.jobs.items():
            if name in live:
                continue
            job["bound_at"] = None
            self.ops.create_pod(job["pod"])

    # -- serving ---------------------------------------------------------
    def stamp_loads(self) -> None:
        for s in self.spec["autoscaled"]:
            key = f"{s['namespace']}/{s['name']}"
            self.ops.stamp(s, self.traces[key].load_at(self.now()))

    def record_binds(self, rows: list[dict]) -> None:
        services = {s["name"] for s in self.spec["autoscaled"]}
        for r in rows:
            if r["service"] not in services or not r["node"] \
                    or r["name"] in self.serving_seen:
                continue
            self.serving_seen.add(r["name"])
            if self.now() < SERVING_WARMUP_S:
                continue
            self.serving_latencies.append(self.now() - r["created"])
        bound = {r["name"] for r in rows
                 if r["node"] and r["phase"] == "Running"}
        for name, job in self.jobs.items():
            if job["bound_at"] is None and name in bound:
                job["bound_at"] = self.now()
                self.batch_latencies.append(self.now()
                                            - job["pod"]["created"])
        now = {r["name"]: r["node"] for r in rows}
        binds = sorted([n, node] for n, node in now.items()
                       if node and not self.prev.get(n))
        gone = sorted(set(self.prev) - set(now))
        if binds or gone:
            self.ticks.append([self.now(), binds, gone])
        self.prev = now

    def track_replicas(self, rows: list[dict]) -> None:
        import math

        for s in self.spec["autoscaled"]:
            key = f"{s['namespace']}/{s['name']}"
            live = [r for r in rows if r["service"] == s["name"]
                    and r["phase"] in ("Pending", "Running")]
            if self.router:
                load = sum(r["load"] for r in live)
            else:
                load = self.traces[key].load_at(self.now())
            desired = min(s["max_replicas"], max(
                s["min_replicas"],
                math.ceil(load / s["target_load_per_replica"])))
            self.replica_series[key].append(
                [round(self.now(), 2), round(load, 2), len(live), desired])
        for s in self.spec["routed"]:
            key = f"{s['namespace']}/{s['name']}"
            occs = self.ops.router.pool_occupancies(key)
            pool = occs.get("decode") or occs.get("prefill") or []
            if pool:
                self.occ_series[key].append(
                    [round(self.now(), 2), round(sum(pool) / len(pool), 4)])

    def sample_utilization(self, rows: list[dict]) -> None:
        used = serving_used = 0.0
        for r in rows:
            if r["node"] and r["phase"] == "Running":
                units = serving_units(r)
                used += units
                if r["namespace"] == "serve":
                    serving_used += units
        utilization = min(1.0, used / SERVING_TOTAL_UNITS)
        if self.now() < SERVING_WARMUP_S:
            return
        self.util.append(utilization)
        self.util_area += utilization * SERVING_TICK_S
        self.batch_util_area += min(
            1.0, (used - serving_used) / SERVING_TOTAL_UNITS) * SERVING_TICK_S
        self.util_time += SERVING_TICK_S

    # -- requests --------------------------------------------------------
    def arrive(self, svc: dict, t: float) -> None:
        rng = self.req_rng[svc["name"]]
        self.rid += 1
        if svc["name"] == "chat":
            req = ("chat", f"chat-r{self.rid}",
                   f"chat-s{rng.randrange(REQUEST_CHAT_SESSIONS)}",
                   rng.randrange(*REQUEST_CHAT_PROMPT),
                   rng.randrange(*REQUEST_CHAT_OUTPUT), t)
        else:
            req = ("embed", f"embed-r{self.rid}", f"embed-r{self.rid}",
                   rng.randrange(*REQUEST_EMBED_PROMPT), 1, t)
        self.ops.router.submit(f"{svc['namespace']}/{svc['name']}",
                               self.ops.request(*req))

    def arrival_sources(self) -> list:
        out = []
        for svc in self.spec["routed"]:
            trace = self.traces[f"{svc['namespace']}/{svc['name']}"]
            scale = 1.0 / REQUEST_SERVICE_TIME_S[svc["name"]]

            def rate(t: float, trace=trace, scale=scale) -> float:
                return trace.load_at(t) * scale

            peak = max(rate(i * 0.5) for i in
                       range(int(SERVING_TRACE_S * 2) + 2)) * 1.05
            out.append(self.ops.sim.ArrivalSource(
                seed=self.seed * 31 + len(out), rate_fn=rate,
                fn=(lambda t, svc=svc: self.arrive(svc, t)),
                peak_rate=peak, until=SERVING_TRACE_S,
                label=f"req-{svc['name']}"))
        return out

    # -- the tick --------------------------------------------------------
    def tick(self) -> None:
        self.tick_no += 1
        self.complete_finished()
        self.spawn(self.ops.pods())
        if self.router:
            t0 = time.perf_counter()
            self.ops.router.tick(SERVING_TICK_S)
            self.router_ms.append((time.perf_counter() - t0) * 1e3)
        elif self.tick_no % SERVING_STAMP_EVERY_TICKS == 1:
            self.stamp_loads()
        t0 = time.perf_counter()
        self.ops.reconcile_autoscaler()
        self.reconcile_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        self.ops.cycle()
        self.cycle_ms.append((time.perf_counter() - t0) * 1e3)
        self.requeue_evicted()
        self.ops.poll()
        self.ops.tick_agents()
        self.ops.reconcile_quotas()
        rows = self.ops.pods()
        self.record_binds(rows)
        if self.tick_no % SERVING_STAMP_EVERY_TICKS == 0:
            self.track_replicas(rows)
        self.sample_utilization(rows)

    def tracking(self) -> dict:
        out = {}
        for key, series in self.replica_series.items():
            rows = [r for r in series if r[0] >= SERVING_WARMUP_S]
            within = sum(1 for _, _, live, desired in rows
                         if live >= desired - 1)
            out[key] = {"samples": len(rows),
                        "within_one": within / len(rows) if rows else None,
                        "replicas_min": min((r[2] for r in rows), default=0),
                        "replicas_max": max((r[2] for r in rows), default=0)}
        return out

    def request_stats(self) -> dict:
        out = {}
        stats = self.ops.router.stats()
        for svc in self.spec["routed"]:
            key = f"{svc['namespace']}/{svc['name']}"
            reqs = [r for r in self.ops.router.completed_requests(key)
                    if r.finished is not None
                    and r.created >= SERVING_WARMUP_S]
            total = [r.finished - r.created for r in reqs]
            ttft = [r.prefill_done - r.created for r in reqs
                    if r.prefill_done is not None]
            decode = [r.finished - r.prefill_done for r in reqs
                      if r.prefill_done is not None]
            occ = [o for t, o in self.occ_series[key]
                   if t >= SERVING_WARMUP_S]
            # bench_requests.py's row (``obs top`` reads it), the
            # phases' percentiles beside it
            pct = _rounded_percentile
            out[key] = {
                **stats[key], "completed_post_warmup": len(reqs),
                "p50_s": pct(total, 0.5, 3), "p99_s": pct(total, 0.99, 3),
                "ttft_p99_s": pct(ttft, 0.99, 3),
                "p50_s_by_phase": {"total": pct(total, 0.5, 6),
                                   "prefill": pct(ttft, 0.5, 6),
                                   "decode": pct(decode, 0.5, 6)},
                "p99_s_by_phase": {"total": pct(total, 0.99, 6),
                                   "prefill": pct(ttft, 0.99, 6),
                                   "decode": pct(decode, 0.99, 6)},
                "occupancy_mean_max": max(occ) if occ else None,
                "occupancy_under_ceiling": (
                    sum(1 for o in occ if o <= SERVING_OCC_CEILING)
                    / len(occ) if occ else None)}
        return out

    def run(self) -> dict:
        eng = self.ops.eng
        if self.router:
            for src in self.arrival_sources():
                src.install(eng)
        eng.tick_loop(SERVING_TICK_S, self.tick, until=SERVING_TRACE_S,
                      label="ctl-tick")
        eng.run()
        records = self.ops.records()
        preemptions = self.ops.preemptions
        summary = {
            "ticks": self.ticks, "records": records,
            "preemptions": preemptions,
            "replicas": self.replica_series,
            "serving_latencies": self.serving_latencies,
            "batch_latencies": self.batch_latencies,
            "completed": self.completed, "utilization": self.util,
        }
        lat_ms = [x * 1e3 for x in self.serving_latencies]
        out = {
            "summary": summary,
            "utilization_pct": (self.util_area / self.util_time
                                if self.util_time else 0.0),
            "utilization_min": min(self.util) if self.util else 0.0,
            "batch_utilization_pct": (self.batch_util_area / self.util_time
                                      if self.util_time else 0.0),
            "serving": {
                "binds": len(lat_ms),
                "p50_ms": _rounded_percentile(lat_ms, 0.5, 3),
                "p99_ms": _rounded_percentile(lat_ms, 0.99, 3),
                "max_ms": max(lat_ms) if lat_ms else None,
                "preempted": sum(1 for _, _, v in preemptions
                                 for _, tier in v
                                 if tier == C.TIER_SERVING),
                "tracking": self.tracking()},
            "batch": {"jobs_completed": self.completed,
                      "p50_schedule_latency_s": _rounded_percentile(
                          self.batch_latencies, 0.5, 3),
                      "preemptions": len(preemptions),
                      "preempted_pods": sum(len(v) for _, _, v
                                            in preemptions)},
            "scale_events": {d: sum(1 for r in records if r[0] == "autoscale"
                                    and r[2]["direction"] == d)
                             for d in ("up", "down")},
            "cycle_ms": self.cycle_ms, "reconcile_ms": self.reconcile_ms,
            "router_ms": self.router_ms, "ticks": self.tick_no,
        }
        if self.router:
            out["requests"] = summary["requests"] = self.request_stats()
            summary["occupancy"] = self.occ_series
        return out


def drive_serving_fleet(spec: dict, ops) -> dict:
    """The serving fleet's trace over one package's loop.  ``ops`` gives
    ``eng`` (its package's SimEngine, whose clock ``now()`` is the loop's),
    ``sim`` (its package's ``sim`` module), ``trace(**kw)`` (its
    DiurnalTrace), ``request(...)`` (its Request), ``add_mig_node(n)``,
    ``add_mps_node(n)``, ``create_quota(q)``, ``build(spec)`` (the
    controllers, the scheduler, the autoscaler on ``spec["autoscaled"]``
    and, with ``spec["routed"]``, ``router``), ``create_pod(p)`` (``p``:
    name, namespace, tier, created and a port ``profile`` or an MPS
    ``gb``), ``delete_pod(name, ns)``, ``stamp(service, load)`` (the
    service's load split over its live replicas), ``reconcile_autoscaler
    ()``, ``cycle()``, ``poll()`` (both partitioner controllers),
    ``tick_agents()``, ``reconcile_quotas()``, ``pods()`` (rows: name,
    namespace, node, phase, created, service, load, profile, gb),
    ``preemptions`` ([time, preemptor, [[victim, tier]...]]) and
    ``records()`` (SERVING_RECORDS as [category, subject, attrs])."""
    return _ServingTrace(spec, ops).run()


class PortServingOps:
    """The port's loop for ``drive_serving_fleet``: node controller with
    the virgin-node initializer on the stand-in, pod controller, the MIG
    and MPS partitioner controllers from their factories, a SliceAgent
    over ``FakeGpuRuntime`` on each MIG node and a ChipAgent on each MPS
    node, the ElasticQuota reconciler, ``build_scheduler`` (preemption
    budget SERVING_PREEMPT_BUDGET), the replica autoscaler and, for a
    routed spec, the ServingRouter (``workers`` threads), all on one
    virtual clock (the SimEngine's)."""

    def __init__(self, workers: int = 0) -> None:
        from nos_tpu_torch import sim
        from nos_tpu_torch.api.elasticquota import install_quota_webhooks
        from nos_tpu_torch.controllers.node_controller import NodeController
        from nos_tpu_torch.controllers.pod_controller import PodController
        from nos_tpu_torch.kube.client import APIServer
        from nos_tpu_torch.obs import journal as J
        from nos_tpu_torch.partitioning.slicepart import SliceNodeInitializer
        from nos_tpu_torch.topology.known import GpuModelRegistry

        self.sim = sim
        self.eng = sim.SimEngine()
        self.now = self.eng.now
        self.workers = workers
        self.model = serving_standin()
        self.registry = GpuModelRegistry(models={self.model.name: self.model})
        self.journal = J.DecisionJournal(maxlen=1 << 20, clock=self.now)
        self.api = APIServer()
        install_quota_webhooks(self.api)
        self.state = ClusterState()
        NodeController(self.api, self.state,
                       SliceNodeInitializer(self.api, self.registry)).bind()
        PodController(self.api, self.state).bind()
        self._agents: dict = {}
        self.preemptions: list = []
        self.router = None

    # -- the cluster -----------------------------------------------------
    def add_mig_node(self, n: dict) -> None:
        from nos_tpu_torch.controllers.sliceagent import SliceAgent
        from nos_tpu_torch.device.fake import FakeGpuRuntime, FakePodResources

        self.api.create("Node", make_gpu_node(
            n["name"], model=self.model, gpus=1, partitioning=C.MIG_KIND,
            domain=SERVING_DOMAIN, host_index=n["host_index"]))
        agent = SliceAgent(self.api, n["name"], FakeGpuRuntime(self.model, 1),
                           FakePodResources())
        agent.start()
        self._agents[n["name"]] = agent

    def add_mps_node(self, n: dict) -> None:
        from nos_tpu_torch.controllers.chipagent import ChipAgent

        self.api.create("Node", make_gpu_node(
            n["name"], gpus=SERVING_MPS_GPUS, partitioning=C.MPS_KIND,
            host_index=n["host_index"]))
        agent = ChipAgent(self.api, n["name"])
        agent.start()
        self._agents[n["name"]] = agent

    def create_quota(self, q: dict) -> None:
        from nos_tpu_torch.api.elasticquota import (
            ElasticQuota, ElasticQuotaSpec)
        from nos_tpu_torch.kube.objects import ObjectMeta

        mem = C.RESOURCE_GPU_MEMORY
        self.api.create("ElasticQuota", ElasticQuota(
            metadata=ObjectMeta(name=q["namespace"],
                                namespace=q["namespace"]),
            spec=ElasticQuotaSpec(min={mem: q["min_gb"]},
                                  max={mem: q["max_gb"]})))

    def build(self, spec: dict) -> None:
        from nos_tpu_torch.cmd.assembly import build_scheduler
        from nos_tpu_torch.controllers.elasticquota.controller import (
            ElasticQuotaReconciler)
        from nos_tpu_torch.partitioning.slicepart import (
            new_slice_partitioner_controller)
        from nos_tpu_torch.partitioning.timeshare.factory import (
            new_timeshare_partitioner_controller)
        from nos_tpu_torch.quota import GPUResourceCalculator
        from nos_tpu_torch.requests import RouterService, ServingRouter
        from nos_tpu_torch.scheduler.capacityscheduling import (
            CapacityScheduling)
        from nos_tpu_torch.serving import ReplicaAutoscaler, ServingService
        from nos_tpu_torch.utils.pod_util import workload_tier

        self.slice_ctl = new_slice_partitioner_controller(
            self.api, self.state, batch_timeout_s=SERVING_BATCH_TIMEOUT_S,
            batch_idle_s=SERVING_BATCH_IDLE_S, registry=self.registry,
            clock=self.now)
        self.slice_ctl.bind()
        self.ts_ctl = new_timeshare_partitioner_controller(
            self.api, self.state, batch_timeout_s=SERVING_BATCH_TIMEOUT_S,
            batch_idle_s=SERVING_BATCH_IDLE_S, clock=self.now)
        self.ts_ctl.bind()
        self.eq = ElasticQuotaReconciler(self.api, GPUResourceCalculator())
        self.sched = build_scheduler(
            self.api, preempt_budget_per_cycle=SERVING_PREEMPT_BUDGET,
            clock=self.now, registry=self.registry)
        capacity = next(p for p in self.sched._framework.plugins
                        if isinstance(p, CapacityScheduling))

        def on_preempt(preemptor, victims) -> None:
            self.preemptions.append([self.now(), preemptor.key, sorted(
                [v.key, workload_tier(v)] for v in victims)])

        capacity.on_preempt = on_preempt
        self.autoscaler = ReplicaAutoscaler(
            self.api, [ServingService.from_mapping(s)
                       for s in spec["autoscaled"]], clock=self.now)
        if spec["routed"]:
            self.router = ServingRouter(
                self.api, [RouterService.from_mapping(s)
                           for s in spec["routed"]],
                clock=self.now, workers=self.workers,
                publish_every_ticks=SERVING_STAMP_EVERY_TICKS,
                keep_completed=True)

    def trace(self, **kw):
        from nos_tpu_torch.serving import DiurnalTrace

        return DiurnalTrace(**kw)

    def request(self, *args):
        from nos_tpu_torch.requests import Request

        return Request(*args)

    # -- the pods --------------------------------------------------------
    def create_pod(self, p: dict) -> None:
        labels = {C.LABEL_TIER: p["tier"]} if p["tier"] else None
        kw = dict(name=p["name"], namespace=p["namespace"], labels=labels,
                  creation_timestamp=p["created"])
        if p.get("profile"):
            pod = make_mig_pod(p["profile"], **kw)
        else:
            pod = make_timeshare_pod(p["gb"], **kw)
        self.api.create("Pod", pod)

    def delete_pod(self, name: str, namespace: str) -> None:
        from nos_tpu_torch.kube.client import NotFound

        try:
            self.api.delete("Pod", name, namespace)
        except NotFound:
            pass

    def stamp(self, svc: dict, demand: float) -> None:
        from nos_tpu_torch.kube.client import NotFound
        from nos_tpu_torch.utils.retry import retry_on_conflict

        replicas = self.api.list(
            "Pod", namespace=svc["namespace"],
            label_selector={C.LABEL_SERVICE: svc["name"]},
            filter_fn=lambda p: p.status.phase in ("Pending", "Running"))
        if not replicas:
            return
        share = demand / len(replicas)

        def mutate(p) -> None:
            p.metadata.annotations[C.ANNOT_SERVING_LOAD] = f"{share:.3f}"

        for p in replicas:
            try:
                retry_on_conflict(self.api, "Pod", p.metadata.name, mutate,
                                  p.metadata.namespace,
                                  component="serving-load")
            except NotFound:
                pass

    def pod_names(self) -> set[str]:
        return set(_read_pods(self.api, lambda p: p.metadata.name))

    def pods(self) -> list[dict]:
        from nos_tpu_torch.kube.resources import pod_request
        from nos_tpu_torch.serving import replica_load
        from nos_tpu_torch.topology.profile import (
            extract_slice_requests, extract_timeshare_requests)

        def row(p) -> dict:
            req = pod_request(p)
            return {
                "name": p.metadata.name, "namespace": p.metadata.namespace,
                "node": p.spec.node_name, "phase": p.status.phase,
                "created": p.metadata.creation_timestamp,
                "service": p.metadata.labels.get(C.LABEL_SERVICE, ""),
                "load": replica_load(p),
                "profile": next(iter(sorted(extract_slice_requests(req))),
                                ""),
                "gb": next(iter(sorted(extract_timeshare_requests(req))),
                           0)}

        return sorted(_read_pods(self.api, row),
                      key=lambda r: (r["namespace"], r["name"]))

    # -- the loop --------------------------------------------------------
    def reconcile_autoscaler(self) -> None:
        self.autoscaler.reconcile()

    def cycle(self) -> None:
        self.sched.run_cycle()

    def poll(self) -> None:
        self.slice_ctl.process_if_ready()
        self.ts_ctl.process_if_ready()

    def tick_agents(self) -> None:
        for agent in self._agents.values():
            agent.tick()

    def reconcile_quotas(self) -> None:
        self.eq.reconcile_all()

    def records(self) -> list:
        return [[r.category, r.subject,
                 {k: str(v) for k, v in sorted(r.attrs.items())}]
                for r in self.journal.events()
                if r.category in SERVING_RECORDS]

    def close(self) -> None:
        self.sched.close()


def run_serving_fleet(spec: dict, workers: int = 0) -> dict:
    """One ``drive_serving_fleet`` on the port under a journal and a waste
    ledger of its own on the trace's clock (``waste``, the ledger's
    report, which must conserve)."""
    ops = PortServingOps(workers)
    ledger = ChipSecondLedger(clock=ops.now)
    try:
        with obs_scoped(journal=ops.journal, ledger=ledger):
            out = drive_serving_fleet(spec, ops)
    finally:
        ops.close()
    out["waste"] = check_conservation(ledger.report(), "the serving fleet")
    out["journal"] = [
        [r.category, r.subject, sorted((k, str(v)) for k, v in r.attrs.items()
                                       if k != "plan_id")]
        for r in ops.journal.events()]
    return out


# -- the capacity fleets ---------------------------------------------------

# bench_capacity.py's runs on H100 nodes: a JAX host is a v5e host of 8
# chips whose one 2x4 a job takes whole; here a node is 8 H100 80GB in
# MIG mode, each GPU one free 7g.80gb (the MIG stand-in's whole-host
# profile, as the 2x4 has been throughout), and a job asks for 8 of
# them: ``pod_chip_equiv`` 8 GPUs, one whole node.  MIG and not eight
# 80 GB MPS shares because the JAX job is a slice, the kind the port
# maps to MIG.  Every other figure is the bench's.
CAPACITY_PROFILE = "7g.80gb"
CAPACITY_GPUS = 8
CAPACITY_TICK_S = 0.5
CAPACITY_WARMUP_S = 30.0
CAPACITY_SETTLE_S = 90.0
CAPACITY_JOIN_LAG_S = 6.0
CAPACITY_PROVISION_DELAY_S = 8.0
CAPACITY_SWING_TRACE_S = 600.0
CAPACITY_SWING_SHIFTS = (200.0, 400.0)
CAPACITY_SWING_ADAPT_S = 90.0
CAPACITY_BASE_HOSTS = 4
CAPACITY_UTIL_TARGET = 0.95
CAPACITY_STORM_TRACE_S = 420.0
CAPACITY_STORM_START = 120.0
CAPACITY_STORM_DURATION_S = 160.0
CAPACITY_STORM_ADAPT_S = 40.0
CAPACITY_STORM_POOL_HOSTS = 3
CAPACITY_STORM_SPARES = 2
CAPACITY_QUIET_TRACE_S = 120.0
CAPACITY_DURATION_S = (15.0, 25.0)
CAPACITY_POOLS = ("nvl-0", "nvl-1")
CAPACITY_ZONES = ("us-a", "us-b")
CAPACITY_NAMESPACE = "work"
# bench_capacity.py's PROV_KNOBS
CAPACITY_KNOBS = dict(
    scale_up_deficit_chips=8.0, scale_up_after_s=4.0,
    scale_up_cooldown_s=6.0, max_pending_creates=4,
    scale_down_idle_s=15.0, scale_down_cooldown_s=8.0,
    min_hosts_per_pool=1, provision_deadline_s=60.0,
    join_grace_s=CAPACITY_JOIN_LAG_S + 4.0, vacancy_grace_s=2.0,
    breaker_threshold=2, breaker_open_s=40.0, spare_target_per_pool=0,
)
CAPACITY_SCENARIOS = ("swing", "storm", "quiet")


class _CapacityJob:
    __slots__ = ("name", "duration", "created", "bound_at")

    def __init__(self, name: str, duration: float, created: float) -> None:
        self.name = name
        self.duration = duration
        self.created = created
        self.bound_at: float | None = None


class CapacityFleet:
    """One of ``bench_capacity.py``'s trace runs (its ``Sim``) on the port:
    an in-memory API server, ``build_scheduler``, a waste ledger and a
    journal on the SimEngine's clock and, with ``plane``, the
    provisioner at CAPACITY_KNOBS over ``CloudGPUAPI`` (the storm:
    ``ChaosCloudGPUAPI`` with every random rate 0, its one fault the
    injected stockout).  The plane-off run never constructs the plane.
    ``scenario``: swing (4 nodes' demand, then 8, then 4 again, one
    pool), storm (two pools of 3 and two warm spares in nvl-1, a zonal
    stockout of nvl-0's zone as demand steps up by two nodes) or quiet
    (capacity equal to steady demand)."""

    def __init__(self, seed: int = 0, plane: bool = True,
                 scenario: str = "swing") -> None:
        import random

        from nos_tpu_torch.capacity import CapacityProvisioner, CloudGPUAPI
        from nos_tpu_torch.cmd.assembly import build_scheduler
        from nos_tpu_torch.kube.client import APIServer
        from nos_tpu_torch.obs.journal import DecisionJournal
        from nos_tpu_torch.sim import SimEngine
        from nos_tpu_torch.testing.chaos import ChaosCloudGPUAPI

        if scenario not in CAPACITY_SCENARIOS:
            raise ValueError(f"scenario must be one of {CAPACITY_SCENARIOS}")
        self.seed = seed
        self.plane = plane
        self.scenario = scenario
        self.rng = random.Random(seed)
        self.eng = SimEngine()
        clock = self.eng.now
        self.api = APIServer()
        self.scheduler = build_scheduler(self.api, clock=clock)
        self.ledger = ChipSecondLedger(clock=clock)
        self.journal = DecisionJournal(maxlen=200_000, clock=clock)
        self.trace_s = {"swing": CAPACITY_SWING_TRACE_S,
                        "storm": CAPACITY_STORM_TRACE_S,
                        "quiet": CAPACITY_QUIET_TRACE_S}[scenario]
        self._join_queue: list[tuple[float, str]] = []
        self.cloud = None
        self.prov = None
        self.reconcile_ms: list[float] = []
        if plane:
            if scenario == "storm":
                self.cloud = ChaosCloudGPUAPI(
                    seed, clock=clock,
                    provision_delay_s=CAPACITY_PROVISION_DELAY_S)
            else:
                self.cloud = CloudGPUAPI(
                    clock=clock, provision_delay_s=CAPACITY_PROVISION_DELAY_S)
            self.cloud.set_joiner(self._cloud_join)
            self.prov = CapacityProvisioner(self.api, self.cloud,
                                            clock=clock, **CAPACITY_KNOBS)
        pool0, pool1 = CAPACITY_POOLS
        if scenario == "storm":
            for h in range(CAPACITY_STORM_POOL_HOSTS):
                self._add_node(pool0, h, CAPACITY_ZONES[0])
                self._add_node(pool1, h, CAPACITY_ZONES[1])
            for s in range(CAPACITY_STORM_SPARES):
                self._add_node(pool1, 100 + s, CAPACITY_ZONES[1], spare=True)
        else:
            for h in range(CAPACITY_BASE_HOSTS):
                self._add_node(pool0, h, CAPACITY_ZONES[0])
        self.jobs: dict[str, _CapacityJob] = {}
        self._job_seq = 0
        self.completed = 0
        self.waits: list[float] = []
        self._util_area = 0.0
        self._util_time = 0.0
        self._util_min = 1.0

    # -- the cluster ---------------------------------------------------------
    def _serving_geometry(self) -> dict:
        return {g: {"free": {CAPACITY_PROFILE: 1}}
                for g in range(CAPACITY_GPUS)}

    def _add_node(self, pool: str, host_index: int, zone: str,
                  spare: bool = False) -> None:
        from nos_tpu_torch.kube.client import KIND_NODE

        from .factory import make_gpu_node

        name = f"{pool}-spare{host_index}" if spare else f"{pool}-h{host_index}"
        self.api.create(KIND_NODE, make_gpu_node(
            name, gpus=CAPACITY_GPUS, partitioning=C.MIG_KIND,
            status_geometry=self._serving_geometry(), domain=pool,
            host_index=host_index, spare=spare,
            extra_labels={C.LABEL_ZONE: zone}))

    def _cloud_join(self, cloud_node) -> None:
        """The kubelet's join: the Node appears bare (the create's labels,
        no geometry: its agent is still starting) and serves
        CAPACITY_JOIN_LAG_S later; until then its GPUs are booked as
        ``provisioning`` (the provisioner's hold), not idle."""
        from nos_tpu_torch.kube.client import KIND_NODE

        from .factory import make_gpu_node

        labels = dict(cloud_node.labels)
        pool = labels.pop(C.LABEL_NVLINK_DOMAIN, CAPACITY_POOLS[0])
        idx = int(labels.pop(C.LABEL_HOST_INDEX, "0"))
        for managed in (C.LABEL_ACCELERATOR, C.LABEL_PARTITIONING,
                        C.LABEL_GPU_COUNT):
            labels.pop(managed, None)
        self.api.create(KIND_NODE, make_gpu_node(
            cloud_node.name, gpus=CAPACITY_GPUS, partitioning=C.MIG_KIND,
            domain=pool, host_index=idx, extra_labels=labels))
        self._join_queue.append((self.eng.now() + CAPACITY_JOIN_LAG_S,
                                 cloud_node.name))

    def _land_joins(self) -> None:
        from nos_tpu_torch.kube.client import KIND_NODE, NotFound
        from nos_tpu_torch.utils.retry import retry_on_conflict

        res = slice_resource_name(CAPACITY_PROFILE)
        for due, name in [e for e in self._join_queue
                          if e[0] <= self.eng.now()]:
            self._join_queue.remove((due, name))

            def mutate(node) -> None:
                for g in range(CAPACITY_GPUS):
                    node.metadata.annotations[
                        f"{C.ANNOT_STATUS_PREFIX}{g}-{CAPACITY_PROFILE}"
                        f"-free"] = "1"
                node.status.allocatable[res] = float(CAPACITY_GPUS)
                node.status.capacity[res] = float(CAPACITY_GPUS)

            try:
                retry_on_conflict(self.api, KIND_NODE, name, mutate,
                                  component="fleet-join")
            except NotFound:
                pass        # released or reaped before it ever served

    # -- demand --------------------------------------------------------------
    def _target_gpus(self) -> float:
        t = self.eng.now()
        if self.scenario == "swing":
            lo, hi = CAPACITY_SWING_SHIFTS
            base = CAPACITY_BASE_HOSTS * CAPACITY_GPUS
            return float(2 * base if lo <= t < hi else base)
        if self.scenario == "storm":
            base = 2 * CAPACITY_STORM_POOL_HOSTS * CAPACITY_GPUS
            return float(base + CAPACITY_STORM_SPARES * CAPACITY_GPUS
                         if t >= CAPACITY_STORM_START else base)
        return float(CAPACITY_BASE_HOSTS * CAPACITY_GPUS)

    def _install_faults(self) -> None:
        """The storm at CAPACITY_STORM_START as a fault event, which fires
        before the control tick of the same instant."""
        if self.scenario == "storm" and self.cloud is not None:
            self.eng.at(
                CAPACITY_STORM_START,
                lambda: self.cloud.inject_stockout(
                    H100_80GB.name, CAPACITY_ZONES[0],
                    duration_s=CAPACITY_STORM_DURATION_S),
                label="stockout-storm")

    def _in_adaptation(self) -> bool:
        t = self.eng.now()
        if t < CAPACITY_WARMUP_S:
            return True
        if self.scenario == "swing":
            return any(s <= t < s + CAPACITY_SWING_ADAPT_S
                       for s in CAPACITY_SWING_SHIFTS)
        if self.scenario == "storm":
            return (CAPACITY_STORM_START <= t
                    < CAPACITY_STORM_START + CAPACITY_STORM_ADAPT_S)
        return False

    def _spawn(self, target: float | None = None) -> None:
        from nos_tpu_torch.kube.client import KIND_POD

        from .factory import make_mig_pod

        target = self._target_gpus() if target is None else target
        inflight = len(self.jobs) * float(CAPACITY_GPUS)
        while inflight < target:
            self._job_seq += 1
            name = f"job-{self._job_seq}"
            self.jobs[name] = _CapacityJob(
                name, self.rng.uniform(*CAPACITY_DURATION_S), self.eng.now())
            self.api.create(KIND_POD, make_mig_pod(
                CAPACITY_PROFILE, CAPACITY_GPUS, name=name,
                namespace=CAPACITY_NAMESPACE,
                creation_timestamp=self.eng.now()))
            inflight += CAPACITY_GPUS

    def _complete_finished(self) -> None:
        from nos_tpu_torch.kube.client import KIND_POD, NotFound

        for job in list(self.jobs.values()):
            if job.bound_at is None \
                    or self.eng.now() < job.bound_at + job.duration:
                continue
            try:
                self.api.delete(KIND_POD, job.name, CAPACITY_NAMESPACE)
            except NotFound:
                pass
            del self.jobs[job.name]
            self.completed += 1

    def _record_binds(self) -> None:
        from nos_tpu_torch.kube.client import KIND_POD

        for p in self.api.list(KIND_POD):
            if not p.spec.node_name:
                continue
            job = self.jobs.get(p.metadata.name)
            if job is not None and job.bound_at is None:
                job.bound_at = self.eng.now()
                self.waits.append(self.eng.now() - job.created)

    # -- measurement ---------------------------------------------------------
    def _serving_gpus(self) -> float:
        from nos_tpu_torch.kube.client import KIND_NODE

        gpus = 0.0
        for node in self.api.list(KIND_NODE):
            labels = node.metadata.labels
            if C.is_warm_spare_labels(labels):
                continue
            if not any(k.startswith(C.ANNOT_STATUS_PREFIX)
                       for k in node.metadata.annotations):
                continue        # joined, not serving yet
            gpus += float(labels.get(C.LABEL_GPU_COUNT, "0") or 0.0)
        return gpus

    def _sample_utilization(self) -> None:
        from nos_tpu_torch.kube.client import KIND_POD

        if self._in_adaptation():
            return
        live = self._serving_gpus()
        if live <= 0:
            return
        used = sum(CAPACITY_GPUS for p in self.api.list(KIND_POD)
                   if p.spec.node_name)
        util = min(1.0, used / live)
        self._util_area += util * CAPACITY_TICK_S
        self._util_time += CAPACITY_TICK_S
        self._util_min = min(self._util_min, util)

    def _active_hosts(self) -> int:
        from nos_tpu_torch.kube.client import KIND_NODE

        return sum(1 for n in self.api.list(KIND_NODE)
                   if not C.is_warm_spare_labels(n.metadata.labels))

    # -- the loop ------------------------------------------------------------
    def _tick(self, spawn_target: float | None = None) -> None:
        from .factory import admit_all

        self._complete_finished()
        self._land_joins()
        self._spawn(target=spawn_target)
        self.scheduler.run_cycle()
        if self.prov is not None:
            t0 = time.perf_counter()
            self.prov.reconcile()
            self.reconcile_ms.append((time.perf_counter() - t0) * 1e3)
        admit_all(self.api)
        self._record_binds()
        self._sample_utilization()

    def run(self) -> dict:
        """The trace, then the settle (demand stops; the backlog must
        drain before the never-bound verdict).  Cloud 429 retries back
        off through ``utils.retry.sleep``, which the run replaces: virtual
        time must not sleep.  Raises if the ledger does not conserve."""
        from nos_tpu_torch.obs import journal as J
        from nos_tpu_torch.obs import ledger as L
        from nos_tpu_torch.utils import retry as retry_mod

        real_sleep, retry_mod.sleep = retry_mod.sleep, lambda s: None
        try:
            with obs_scoped(journal=self.journal, ledger=self.ledger):
                self._install_faults()
                self.eng.tick_loop(CAPACITY_TICK_S, self._tick,
                                   until=self.trace_s, label="ctl-tick")
                self.eng.run(until=self.trace_s)
                self.eng.tick_loop(
                    CAPACITY_TICK_S, lambda: self._tick(spawn_target=0.0),
                    until=self.eng.now() + CAPACITY_SETTLE_S,
                    while_fn=lambda: any(j.bound_at is None
                                         for j in self.jobs.values()),
                    label="settle-tick")
                self.eng.run()
        finally:
            retry_mod.sleep = real_sleep
            self.scheduler.close()
        waste = check_conservation(self.ledger.report(),
                                   f"the capacity fleet ({self.scenario})")
        never_bound = sorted(j.name for j in self.jobs.values()
                             if j.bound_at is None)
        counters = dict(self.prov.report().get("counters", {})) \
            if self.prov is not None else {}
        outstanding = (list(self.cloud.list_operations())
                       if self.cloud is not None else [])
        breaker_opens = len([
            r for r in self.journal.events(category=J.PROVISION_STOCKOUT)
            if r.attrs.get("state") == "open"])
        return {
            "utilization_pct": round(
                self._util_area / self._util_time, 4)
            if self._util_time else 0.0,
            "utilization_min": round(self._util_min, 4),
            "jobs_completed": self.completed,
            "never_bound": len(never_bound),
            "never_bound_jobs": never_bound,
            "bind_wait_p50_s": _rounded_percentile(self.waits, 0.5, 2),
            "bind_wait_p90_s": _rounded_percentile(self.waits, 0.9, 2),
            "hosts_final": self._active_hosts(),
            "provision_landed": counters.get("landed", 0),
            "scale_downs": counters.get("scale_downs", 0),
            "borrows": counters.get("borrows", 0),
            "breaker_opens": breaker_opens,
            "outstanding_ops": len(outstanding),
            "provisioning_chip_seconds": round(
                waste["fleet"]["chip_seconds"].get(L.PROVISIONING, 0.0), 1),
        }

    def decision_trace(self) -> list[list]:
        """[category, subject, [[key, str(value)], ...]] for every record
        (plan ids dropped): the byte-identity basis and the summary's
        journal."""
        return [[r.category, r.subject,
                 [[k, str(v)] for k, v in sorted(r.attrs.items())
                  if k != "plan_id"]]
                for r in self.journal.events()]


def capacity_summary(result: dict, trace: list) -> dict:
    """What both packages must agree on for one capacity run: its figures
    and its whole decision journal."""
    return {"result": result, "journal": trace}


def run_capacity_fleet(scenario: str, seed: int = 0,
                       plane: bool = True) -> dict:
    """One ``CapacityFleet`` run: ``summary`` (``capacity_summary``),
    ``reconcile_ms`` (the provisioner's host ms per reconcile) and the
    wall seconds."""
    t0 = time.perf_counter()
    fleet = CapacityFleet(seed, plane, scenario)
    result = fleet.run()
    return {"summary": capacity_summary(result, fleet.decision_trace()),
            "reconcile_ms": fleet.reconcile_ms,
            "seconds": time.perf_counter() - t0}


def capacity_gates(swing: dict, storm: dict) -> list[str]:
    """``bench_capacity.py``'s gates (its ``assert_gates``) on the two
    runs' results; each failure as a line."""
    base = CAPACITY_BASE_HOSTS
    out = []
    if swing["utilization_pct"] < CAPACITY_UTIL_TARGET:
        out.append(f"swing utilization {swing['utilization_pct']} < "
                   f"{CAPACITY_UTIL_TARGET}")
    if swing["provision_landed"] < base:
        out.append(f"swing landed {swing['provision_landed']} (< {base})")
    if swing["scale_downs"] < base - 1:
        out.append(f"swing released {swing['scale_downs']} (< {base - 1})")
    if swing["hosts_final"] > base + 1:
        out.append(f"swing ended on {swing['hosts_final']} nodes (ratchet)")
    if swing["never_bound"] != 0:
        out.append(f"swing never bound {swing['never_bound_jobs']}")
    if swing["provisioning_chip_seconds"] <= 0.0:
        out.append("swing booked no provisioning GPU-seconds")
    if swing["outstanding_ops"] != 0:
        out.append(f"swing left {swing['outstanding_ops']} cloud operations")
    if storm["breaker_opens"] < 1:
        out.append("the storm never opened the breaker")
    if storm["borrows"] != CAPACITY_STORM_SPARES:
        out.append(f"the storm borrowed {storm['borrows']} spares, not "
                   f"{CAPACITY_STORM_SPARES}")
    if storm["never_bound"] != 0:
        out.append(f"the storm never bound {storm['never_bound_jobs']}")
    if storm["outstanding_ops"] != 0:
        out.append(f"the storm left {storm['outstanding_ops']} cloud "
                   f"operations")
    if storm["utilization_pct"] < CAPACITY_UTIL_TARGET:
        out.append(f"storm utilization {storm['utilization_pct']} < "
                   f"{CAPACITY_UTIL_TARGET}")
    return out
