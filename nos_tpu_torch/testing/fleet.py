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
fleet is cut further; ``run_quota_fleet`` runs it too.

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


def gang_fleet_spec(seed: int = 0) -> dict:
    """The gang fleet's spec: ``quota_fleet_spec(seed)`` with each node's
    ``domain`` (GANG_FLEET_DOMAINS, "" past them), the PodGroups
    (``groups`` {name, namespace, min, mesh}), a third wave of gang
    members {..., gang} at GANG_PRIORITY, created in the third hour in
    an order drawn from ``seed``, and the scheduler's clock ``now``."""
    spec = quota_fleet_spec(seed)
    rng = np.random.default_rng(seed + 1)
    domains = [d for d, n in GANG_FLEET_DOMAINS for _ in range(n)]
    for i, node in enumerate(spec["nodes"]):
        node["domain"] = domains[i] if i < len(domains) else ""
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


def drive_quota_fleet(spec: dict, create, cycle, admit, reconcile, pods,
                      quotas, groups=None) -> dict:
    """Submit each wave (``create(pod spec)``) and run ``cycle()``, then
    ``admit()`` (the kubelet) and ``reconcile()``, until a cycle binds
    and evicts nothing.  ``pods()`` gives (name, node, capacity label,
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
    first and its nodes in their NVLink domains (the gang fleet's).
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
            status_geometry=n["status"], domain=n.get("domain", "")))

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
    prev = J.set_journal(journal)
    try:
        out = drive_quota_fleet(spec, create, sched.run_cycle, admit,
                                reconcile, pods, quotas,
                                groups if "groups" in spec else None)
    finally:
        J.set_journal(prev)
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
