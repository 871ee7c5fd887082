"""The port's Elastic Resource Quotas (nos_tpu_torch/quota/,
api/elasticquota.py, api/pdb.py, controllers/elasticquota/, the API
server's admission hooks) against the JAX package's, on the same
objects built from numpy seeds, compared exactly.

The currencies agree where both sides charge a share at its GB: JAX's
``nos.tpu/tpu-<N>gb`` and the port's MPS ``nvidia.com/gpu-<N>gb``, in
``nos.tpu/tpu-memory`` and ``nos.nebuly.com/gpu-memory`` GB.  Whole GPUs
and MIG profiles, which JAX charges in chips and slices, are held to the
reference's rule written out here.  Creation times are distinct within
a quota: on a tie of time and priority the reconciler's order falls to
the sorted request, whose resource names differ between the packages.

``QuotaTwin`` (also ``tests/test_torch_scheduler.py``'s and
``tests/test_torch_gang.py``'s harness) builds one cluster spec on both
sides: nodes advertising shares or whole GPUs (JAX: chips), in NVLink
domains (JAX: TPU pods), quotas, bound and pending pods, gangs and
their PodGroups, disruption budgets, each side's ``build_scheduler``
and both reconcilers, its journal fresh, on one injected clock.
"""

from __future__ import annotations

import numpy as np
import pytest

import nos_tpu.api.constants as JC
from nos_tpu.api.elasticquota import (
    AdmissionError as JaxAdmissionError,
    CompositeElasticQuota as JaxCEQ,
    CompositeElasticQuotaSpec as JaxCEQSpec,
    ElasticQuota as JaxEQ, ElasticQuotaSpec as JaxEQSpec,
    install_quota_webhooks as jax_install_webhooks,
)
from nos_tpu.api.pdb import (
    PodDisruptionBudget as JaxPDB, PodDisruptionBudgetSpec as JaxPDBSpec,
)
from nos_tpu.api.podgroup import (
    PodGroup as JaxPodGroup, PodGroupSpec as JaxPodGroupSpec,
)
from nos_tpu.cmd.assembly import build_scheduler as jax_build_scheduler
from nos_tpu.controllers.elasticquota import (
    CompositeElasticQuotaReconciler as JaxCEQReconciler,
    ElasticQuotaReconciler as JaxEQReconciler,
)
from nos_tpu.kube.client import APIServer as JaxAPIServer
from nos_tpu.kube.objects import ObjectMeta as JaxMeta
from nos_tpu.obs import journal as jax_journal, ledger as jax_ledger
from nos_tpu.quota import (
    ElasticQuotaInfo as JaxInfo, ElasticQuotaInfos as JaxInfos,
    TPUResourceCalculator,
)
from nos_tpu.testing import factory as jax_factory

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.api.elasticquota import (
    AdmissionError, CompositeElasticQuota, CompositeElasticQuotaSpec,
    ElasticQuota, ElasticQuotaSpec, install_quota_webhooks,
)
from nos_tpu_torch.api.pdb import PodDisruptionBudget, PodDisruptionBudgetSpec
from nos_tpu_torch.cmd.assembly import build_scheduler
from nos_tpu_torch.controllers.elasticquota import (
    CompositeElasticQuotaReconciler, ElasticQuotaReconciler,
)
from nos_tpu_torch.controllers.kubelet import admit_bound_pods
from nos_tpu_torch.kube.client import (
    APIServer, KIND_COMPOSITE_ELASTIC_QUOTA, KIND_ELASTIC_QUOTA, KIND_NODE,
    KIND_POD, KIND_POD_DISRUPTION_BUDGET, KIND_POD_GROUP,
)
from nos_tpu_torch.kube.objects import ObjectMeta, RUNNING
from nos_tpu_torch.obs import journal as port_journal
from nos_tpu_torch.obs import ledger as port_ledger
from nos_tpu_torch.quota import (
    ElasticQuotaInfo, ElasticQuotaInfos, GPUResourceCalculator,
)
from nos_tpu_torch.scheduler import scheduler as port_scheduler
from nos_tpu_torch.testing import factory
from nos_tpu_torch.topology import H100_80GB

JAX_MEM, MEM = JC.RESOURCE_TPU_MEMORY, C.RESOURCE_GPU_MEMORY
JAX_CALC = TPUResourceCalculator(hbm_gb_per_chip=80)
CALC = GPUResourceCalculator()
SIZES = (8, 10, 16, 20, 24, 40, 80)
# the journal categories of the scheduler, the plugin and the reconcilers
JOURNALED = (port_journal.POD_REJECTED, port_journal.POD_BOUND,
             port_journal.POD_NOMINATED, port_journal.GANG_ADMITTED,
             port_journal.GANG_REJECTED, port_journal.QUOTA_HOL_CLAIM,
             port_journal.QUOTA_BORROW, port_journal.QUOTA_RECLAIM,
             port_journal.PREEMPTION, port_journal.PREEMPTION_NONE,
             port_journal.JOB_REBOUND)


def to_port(name: str) -> str:
    """A JAX resource or label name under the port's."""
    if name == JC.RESOURCE_TPU:
        return C.RESOURCE_GPU
    for jax, port in ((JAX_MEM, MEM),
                      (JC.RESOURCE_TIMESHARE_PREFIX,
                       C.RESOURCE_TIMESHARE_PREFIX),
                      (JC.LABEL_CAPACITY, C.LABEL_CAPACITY),
                      (JC.LABEL_UNSCHEDULABLE_CLASS,
                       C.LABEL_UNSCHEDULABLE_CLASS),
                      (JC.LABEL_TIER, C.LABEL_TIER),
                      (JC.LABEL_POD_GROUP, C.LABEL_POD_GROUP),
                      (JC.LABEL_POD_ID, C.LABEL_NVLINK_DOMAIN),
                      (JC.LABEL_CHIP_COUNT, C.LABEL_GPU_COUNT)):
        if name.startswith(jax):
            return port + name[len(jax):]
    return name


def mapped(value):
    """A JAX journal value with every resource name in it the port's."""
    if isinstance(value, str):
        return value.replace(JAX_MEM, MEM).replace(
            JC.RESOURCE_TIMESHARE_PREFIX, C.RESOURCE_TIMESHARE_PREFIX
        ).replace(JC.RESOURCE_TPU, C.RESOURCE_GPU)
    if isinstance(value, dict):
        return {mapped(k): mapped(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(mapped(v) for v in value)
    return value


def port_resources(res: dict) -> dict:
    return {to_port(r): v for r, v in res.items()}


# ---------------------------------------------------------------------------
# Random clusters with quotas, as plain specs
# ---------------------------------------------------------------------------


def cluster_spec(seed: int, pending: tuple[int, int] = (6, 16)) -> dict:
    """2-4 nodes advertising 1-3 share sizes; quotas on ns-a and ns-b,
    on ns-c and ns-d either one composite (even seeds) or a plain quota
    on ns-c; "free" under none; Running pods holding some shares, with
    tiers, priorities and an "app" label a disruption budget selects;
    two waves of pending pods (the second for after the first cycle),
    one that never preempts.  Creation times are distinct."""
    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(int(rng.integers(2, 5))):
        sizes = rng.choice(SIZES, size=int(rng.integers(1, 4)),
                           replace=False)
        shares = {int(gb): int(rng.integers(1, 7)) for gb in sorted(sizes)}
        # the GPUs that carry the shares, labelled for the waste ledger
        nodes.append({"name": f"node-{i}", "shares": shares,
                      "count": -(-sum(g * q for g, q in shares.items())
                                 // 80)})
    grid = [8 * k for k in range(2, 26)]
    quotas = []
    for ns in ("ns-a", "ns-b"):
        lo = int(rng.choice(grid))
        hi = 0 if rng.random() < 0.4 else lo + int(rng.choice(grid))
        quotas.append({"kind": "eq", "name": f"eq-{ns}", "namespace": ns,
                       "namespaces": [ns], "min": lo, "max": hi})
    lo = int(rng.choice(grid))
    if seed % 2 == 0:
        quotas.append({"kind": "ceq", "name": "team",
                       "namespace": "default",
                       "namespaces": ["ns-c", "ns-d"], "min": lo,
                       "max": lo + int(rng.choice(grid))})
    else:
        quotas.append({"kind": "eq", "name": "eq-ns-c", "namespace": "ns-c",
                       "namespaces": ["ns-c"], "min": lo, "max": 0})
    namespaces = ["ns-a", "ns-b", "ns-c", "ns-d", "free"]
    times = iter(rng.permutation(10_000).tolist())

    def pod(name: str, gb: int, node: str = "") -> dict:
        return {"name": name,
                "namespace": str(rng.choice(namespaces, p=[
                    0.3, 0.25, 0.2, 0.1, 0.15])),
                "gb": gb, "qty": 1 if rng.random() < 0.85 else 2,
                "priority": int(rng.integers(0, 4)),
                "tier": str(rng.choice(["", "serving", "batch",
                                        "best-effort"], p=[
                    0.5, 0.15, 0.15, 0.2])),
                "app": str(rng.choice(["web", "job"])),
                "created": float(next(times)), "node": node,
                "never": bool(rng.random() < 0.1)}

    bound = []
    for n in nodes:
        for gb, qty in n["shares"].items():
            held = 0
            while held < qty and rng.random() < 0.75:
                p = pod(f"run-{len(bound)}", gb, n["name"])
                p["qty"] = 1
                p["never"] = False
                bound.append(p)
                held += 1
    sizes = sorted({gb for n in nodes for gb in n["shares"]}) + [24]
    waves = [[pod(f"w{w}-{i}", int(rng.choice(sizes)))
              for i in range(int(rng.integers(*pending)))]
             for w in range(2)]
    pdbs = [{"name": "pdb-web", "namespace": str(rng.choice(namespaces[:3])),
             "selector": {"app": "web"},
             "min_available": int(rng.integers(0, 3))}]
    return {"nodes": nodes, "quotas": quotas, "bound": bound,
            "waves": waves, "pdbs": pdbs}


class Side:
    """One package's objects for a spec: ``jax`` picks the package."""

    def __init__(self, spec: dict, jax: bool, clock, webhooks: bool = True,
                 gb_per_gpu: int = 80, **sched_kw) -> None:
        """``sched_kw``: the JAX scheduler's knobs; the port's scheduler
        runs them as module constants, which QuotaTwin sets."""
        self.jax = jax
        self.api = JaxAPIServer() if jax else APIServer()
        if webhooks:
            (jax_install_webhooks if jax else install_quota_webhooks)(
                self.api)
        self.sched = (
            jax_build_scheduler(self.api, clock=clock,
                                tpu_memory_gb_per_chip=gb_per_gpu,
                                **sched_kw)
            if jax else build_scheduler(self.api, clock=clock,
                                        gpu_memory_gb_per_gpu=gb_per_gpu))
        self.capacity = self.sched._capacity
        calc = (TPUResourceCalculator(hbm_gb_per_chip=gb_per_gpu) if jax
                else GPUResourceCalculator(gb_per_gpu))
        self.reconcilers = (
            (JaxEQReconciler(self.api, calc), JaxCEQReconciler(self.api, calc))
            if jax else (ElasticQuotaReconciler(self.api, calc),
                         CompositeElasticQuotaReconciler(self.api, calc)))
        self.events: list[tuple] = []
        self.api.watch("Pod", self._record)
        for q in spec["quotas"]:
            self.create_quota(q)
        for n in spec["nodes"]:
            self.create_node(n)
        for g in spec.get("groups", ()):
            self.create_pod_group(g)
        for p in spec["bound"]:
            self.create_pod(p, phase=RUNNING)
        for b in spec.get("pdbs", ()):
            self.create_pdb(b)
        self.reconcile()

    def _record(self, event: str, pod) -> None:
        self.events.append((event, pod.metadata.name, pod.spec.node_name,
                            pod.status.phase,
                            pod.status.nominated_node_name))

    # -- building -------------------------------------------------------
    def res(self, gb: int, qty: int = 1) -> dict:
        prefix = (JC.RESOURCE_TIMESHARE_PREFIX if self.jax
                  else C.RESOURCE_TIMESHARE_PREFIX)
        return {f"{prefix}{gb}gb": float(qty), "cpu": 1.0}

    def create_quota(self, q: dict) -> None:
        mem = JAX_MEM if self.jax else MEM
        lo = {mem: float(q["min"])}
        hi = {mem: float(q["max"])} if q.get("max") else {}
        meta = (JaxMeta if self.jax else ObjectMeta)(
            name=q["name"], namespace=q["namespace"])
        if q["kind"] == "eq":
            obj = (JaxEQ(metadata=meta, spec=JaxEQSpec(min=lo, max=hi))
                   if self.jax else
                   ElasticQuota(metadata=meta,
                                spec=ElasticQuotaSpec(min=lo, max=hi)))
            self.api.create(KIND_ELASTIC_QUOTA, obj)
        else:
            obj = (JaxCEQ(metadata=meta, spec=JaxCEQSpec(
                       namespaces=list(q["namespaces"]), min=lo, max=hi))
                   if self.jax else CompositeElasticQuota(
                       metadata=meta, spec=CompositeElasticQuotaSpec(
                           namespaces=list(q["namespaces"]), min=lo,
                           max=hi)))
            self.api.create(KIND_COMPOSITE_ELASTIC_QUOTA, obj)

    def whole(self, gpus: int) -> dict:
        """``gpus`` whole GPUs (JAX: chips) and one CPU."""
        return {JC.RESOURCE_TPU if self.jax else C.RESOURCE_GPU: float(gpus),
                "cpu": 1.0}

    def create_node(self, n: dict) -> None:
        """A node advertising ``shares`` {gb: qty} and ``gpus`` whole
        GPUs, in NVLink domain ``domain`` (JAX: TPU pod; none or "":
        unlabelled) with its GPU count labelled (``gpus``, else
        ``count`` when given), and its ``host_index`` when the spec gives
        one."""
        alloc = {"cpu": 64.0}
        for gb, qty in n.get("shares", {}).items():
            alloc |= {k: v for k, v in self.res(gb, qty).items()
                      if k != "cpu"}
        labels = {}
        if n.get("gpus"):
            alloc |= {k: v for k, v in self.whole(n["gpus"]).items()
                      if k != "cpu"}
            labels[JC.LABEL_CHIP_COUNT if self.jax
                   else C.LABEL_GPU_COUNT] = str(n["gpus"])
        elif n.get("count"):
            labels[JC.LABEL_CHIP_COUNT if self.jax
                   else C.LABEL_GPU_COUNT] = str(n["count"])
        if n.get("domain"):
            labels[JC.LABEL_POD_ID if self.jax
                   else C.LABEL_NVLINK_DOMAIN] = n["domain"]
        if "host_index" in n:
            labels[JC.LABEL_HOST_INDEX if self.jax
                   else C.LABEL_HOST_INDEX] = str(n["host_index"])
        mk = jax_factory.make_node if self.jax else factory.make_node
        self.api.create(KIND_NODE, mk(n["name"], labels=labels,
                                      allocatable=alloc))

    def create_pod_group(self, g: dict) -> None:
        meta = (JaxMeta if self.jax else ObjectMeta)(
            name=g["name"], namespace=g["namespace"])
        pg = (JaxPodGroup(metadata=meta, spec=JaxPodGroupSpec(
                  min_member=g["min"], mesh=g.get("mesh", "")))
              if self.jax else factory.make_pod_group(
                  g["name"], g["min"], g.get("mesh", ""), g["namespace"]))
        self.api.create(KIND_POD_GROUP, pg)

    def create_pod(self, p: dict, phase: str = "Pending") -> None:
        """A pod of ``qty`` shares of ``gb`` GB, or of ``whole`` GPUs,
        in gang ``gang`` when it names one."""
        labels = {"app": p["app"]}
        if p.get("tier"):
            labels[JC.LABEL_TIER if self.jax else C.LABEL_TIER] = p["tier"]
        if p.get("gang"):
            labels[JC.LABEL_POD_GROUP if self.jax
                   else C.LABEL_POD_GROUP] = p["gang"]
        mk = jax_factory.make_pod if self.jax else factory.make_pod
        pod = mk(name=p["name"], namespace=p["namespace"],
                 resources=(self.whole(p["whole"]) if p.get("whole")
                            else self.res(p["gb"], p["qty"])),
                 priority=p["priority"], node_name=p.get("node", ""),
                 phase=phase, labels=labels,
                 creation_timestamp=p["created"])
        if p.get("never"):
            pod.spec.preemption_policy = "Never"
        if p.get("displaced"):
            pod.metadata.annotations[JC.ANNOT_DISPLACED if self.jax
                                     else C.ANNOT_DISPLACED] = p["displaced"]
        self.api.create(KIND_POD, pod)

    def create_pdb(self, b: dict) -> None:
        meta = (JaxMeta if self.jax else ObjectMeta)(
            name=b["name"], namespace=b["namespace"])
        pdb = (JaxPDB(metadata=meta, spec=JaxPDBSpec(
                   min_available=b["min_available"],
                   selector=dict(b["selector"])))
               if self.jax else PodDisruptionBudget(
                   metadata=meta, spec=PodDisruptionBudgetSpec(
                       min_available=b["min_available"],
                       selector=dict(b["selector"]))))
        self.api.create(KIND_POD_DISRUPTION_BUDGET, pdb)

    # -- the loop's steps -------------------------------------------------
    def reconcile(self) -> None:
        for r in self.reconcilers:
            r.reconcile_all()

    def admit(self) -> None:
        """The kubelet's part: bound Pending pods go Running."""
        if self.jax:
            jax_factory.admit_all(self.api)
        else:
            for n in self.api.list(KIND_NODE):
                admit_bound_pods(self.api, n.metadata.name)

    # -- reading ----------------------------------------------------------
    def view(self) -> dict:
        def label(p, key):
            return p.metadata.labels.get(key)

        cap = JC.LABEL_CAPACITY if self.jax else C.LABEL_CAPACITY
        cls = (JC.LABEL_UNSCHEDULABLE_CLASS if self.jax
               else C.LABEL_UNSCHEDULABLE_CLASS)
        pods = {p.metadata.name: (
            p.metadata.namespace, p.spec.node_name, p.status.phase,
            p.status.nominated_node_name,
            [(c.type, c.status, c.reason, c.message)
             for c in p.status.conditions],
            label(p, cap), label(p, cls)) for p in self.api.list(KIND_POD)}
        quotas = {}
        for kind in (KIND_ELASTIC_QUOTA, KIND_COMPOSITE_ELASTIC_QUOTA):
            for q in self.api.list(kind):
                quotas[(kind, q.metadata.namespace, q.metadata.name)] = \
                    port_resources(q.status.used)
        ledger = {ns: (info.resource_name, port_resources(info.used),
                       sorted(info.pods))
                  for ns, info in self.capacity.elastic_quota_infos.items()}
        groups = {(g.metadata.namespace, g.metadata.name):
                  (g.status.phase, g.status.scheduled)
                  for g in self.api.list(KIND_POD_GROUP)}
        return {"pods": pods, "quotas": quotas, "ledger": ledger,
                "groups": groups, "events": list(self.events)}


# the JAX partitioning kinds' names in ledger evidence, as the port's
KIND_NAMES = {"timeshare": C.MPS_KIND, "slice": C.MIG_KIND}


def waste_pools(report: dict, evidence=None) -> dict:
    """A waste report's pools as {pool: (capacity, elapsed, {category:
    GPU-seconds}, evidence)}, each evidence dict passed through
    ``evidence`` (the JAX side's names mapped) when given."""
    out = {}
    for pool, p in report["pools"].items():
        ev = {cat: dict(e) for cat, e in p["evidence"].items()}
        if evidence is not None:
            ev = {cat: evidence(e) for cat, e in ev.items()}
        out[pool] = (p["capacity_chips"], p["elapsed_s"],
                     dict(p["chip_seconds"]), ev)
    return out


def jax_evidence(e: dict) -> dict:
    """A JAX evidence dict in the port's names: its partitioning kind."""
    return {k: KIND_NAMES.get(v, v) if k == "kind" else v
            for k, v in e.items()}


def without_plan_ids(e: dict) -> dict:
    """Evidence with its plan id masked (the packages hash plans
    differently)."""
    return {k: "<plan>" if k == "plan_id" else v for k, v in e.items()}


def assert_same_waste(report: dict, jreport: dict, evidence=jax_evidence,
                      port_evidence=None) -> None:
    """The port's waste report equals JAX's per pool and category within
    1e-9 GPU-seconds, with equal evidence after the name mapping
    (``evidence`` on JAX's, ``port_evidence`` on the port's), and both
    conserve within 1e-6."""
    pools = waste_pools(report, port_evidence)
    jpools = waste_pools(jreport, evidence)
    assert sorted(pools) == sorted(jpools)
    for pool, (cap, elapsed, secs, ev) in pools.items():
        jcap, jelapsed, jsecs, jev = jpools[pool]
        assert cap == jcap and abs(elapsed - jelapsed) <= 1e-9, pool
        assert sorted(secs) == sorted(jsecs), (pool, secs, jsecs)
        for cat, v in secs.items():
            assert abs(v - jsecs[cat]) <= 1e-9, (pool, cat, v, jsecs[cat])
        assert ev == jev, pool
    assert port_ledger.conservation_ok(report)
    assert jax_ledger.conservation_ok(jreport)


class QuotaTwin:
    """A spec on both sides, on one clock; ``compare`` holds every write,
    the journals and the waste ledgers' reports equal."""

    def __init__(self, monkeypatch, spec: dict, jax_native: bool = True,
                 webhooks: bool = True, side=Side, **sched_kw) -> None:
        self.spec = spec
        self.now = [20_000.0]
        clock = lambda: self.now[0]  # noqa: E731
        self.jax_journal = jax_journal.DecisionJournal(clock=clock)
        self.journal = port_journal.DecisionJournal(clock=clock)
        monkeypatch.setattr(jax_journal, "_journal", self.jax_journal)
        monkeypatch.setattr(port_journal, "_journal", self.journal)
        monkeypatch.setattr(jax_ledger, "_ledger",
                            jax_ledger.ChipSecondLedger(clock=clock))
        monkeypatch.setattr(port_ledger, "_ledger",
                            port_ledger.ChipSecondLedger(clock=clock))
        for knob, value in sched_kw.items():
            if knob != "gb_per_gpu":
                monkeypatch.setattr(port_scheduler, knob.upper(), value)
        self.jside = side(spec, True, clock, webhooks, **sched_kw)
        self.side = side(spec, False, clock, webhooks, **sched_kw)
        if not jax_native:
            set_jax_python_path(monkeypatch, self.jside.sched)
        self.compare()

    def journals(self) -> tuple[list, list]:
        def rows(j, jax):
            return [(r.category, r.subject,
                     mapped(r.attrs) if jax else r.attrs)
                    for r in j.events() if r.category in JOURNALED]
        return rows(self.jax_journal, True), rows(self.journal, False)

    def compare(self) -> None:
        assert self.side.view() == self.jside.view()
        jrows, rows = self.journals()
        assert rows == jrows
        assert_same_waste(port_ledger.get_ledger().report(),
                          jax_ledger.get_ledger().report())

    def both(self, fn) -> tuple:
        return fn(self.jside), fn(self.side)

    def cycle(self) -> int:
        jbound, bound = self.both(lambda s: s.sched.run_cycle())
        assert bound == jbound
        self.compare()
        return bound

    def step(self, seconds: float = 10.0) -> int:
        """A cycle, then the kubelet and the reconcilers."""
        self.now[0] += seconds
        bound = self.cycle()
        self.both(lambda s: s.admit())
        self.both(lambda s: s.reconcile())
        self.compare()
        return bound

    def submit(self, wave: list[dict]) -> None:
        for p in wave:
            self.both(lambda s: s.create_pod(p))
        self.compare()


def set_jax_python_path(monkeypatch, sched) -> None:
    """The JAX scheduler and plugin without their native shim: the
    Filter prescreen, the score's argmin and the victim screen in
    Python."""
    from nos_tpu.device import native
    from nos_tpu.scheduler.scheduler import Scheduler as JaxScheduler

    sched._prescreen = None
    monkeypatch.setattr(JaxScheduler, "_native_choose",
                        lambda self, pod, nis, lister: None)
    monkeypatch.setattr(native, "victim_prescreen", lambda *a, **k: None)


# ---------------------------------------------------------------------------
# The calculator
# ---------------------------------------------------------------------------


class TestCalculator:
    @pytest.mark.parametrize("gb", [5, 8, 10, 16, 20, 24, 40, 80])
    def test_an_mps_share_is_its_gb_as_in_jax(self, gb):
        for qty in (1, 2, 3):
            pod = factory.make_timeshare_pod(gb, qty)
            jpod = jax_factory.make_timeshare_pod(gb, qty)
            req = CALC.compute_pod_request(pod)
            jreq = JAX_CALC.compute_pod_request(jpod)
            assert req[MEM] == jreq[JAX_MEM] == float(gb * qty)
            assert port_resources(jreq) == req

    def test_whole_gpus_by_the_reference_rule(self):
        """resource.go:28-86: nvidia.com/gpu x the GB a GPU is given."""
        for gb_per_gpu in (16, 40, 80):
            calc = GPUResourceCalculator(gb_per_gpu)
            for n in (1, 2, 8):
                pod = factory.make_pod(resources={C.RESOURCE_GPU: n,
                                                  "cpu": 2.0})
                assert calc.compute_pod_request(pod)[MEM] == n * gb_per_gpu
        assert CALC.gb_per_gpu == 80

    def test_mig_profiles_at_their_memory(self):
        """The reference charges a MIG profile the GB in its name
        (GetMemoryGB); H100 80GB's table gives the same, so the two
        rules agree on every profile of the card."""
        for row in H100_80GB.mig_profiles:
            # "<g>g.<N>gb", a media-extension profile with "+me" after
            want = int(row.name.split(".")[1].split("gb")[0])
            assert CALC.profile_gb(row.name) == row.memory_gb == want
            pod = factory.make_mig_pod(row.name, 2)
            assert CALC.compute_pod_request(pod)[MEM] == 2 * want
        assert CALC.profile_gb("3g.40gb") == 40

    def test_mixed_and_unknown_requests(self):
        req = {C.RESOURCE_GPU: 1, "nvidia.com/mig-3g.40gb": 2,
               "nvidia.com/gpu-24gb": 1, "cpu": 4, "memory": 1e9,
               "nvidia.com/gpu-banana": 3, "nvidia.com/mig-1g.10gb": 0}
        assert CALC.compute_required_gpu_memory_gb(req) == 80 + 80 + 24


# ---------------------------------------------------------------------------
# The ledger: ElasticQuotaInfo(s), every operation against JAX's
# ---------------------------------------------------------------------------


def _info_pair(name, ns, namespaces, lo, hi, composite=False):
    port = ElasticQuotaInfo(name, ns, namespaces, {MEM: float(lo)},
                            {MEM: float(hi)} if hi else None, CALC,
                            composite)
    jax = JaxInfo(name, ns, namespaces, {JAX_MEM: float(lo)},
                  {JAX_MEM: float(hi)} if hi else None, JAX_CALC,
                  composite)
    return port, jax


def _ledger_view(infos, jax: bool) -> dict:
    out = {}
    conv = port_resources if jax else dict
    for ns, info in sorted(infos.items()):
        out[ns] = (info.resource_name, sorted(info.namespaces),
                   conv(info.min), conv(info.max), info.max_enforced,
                   conv(info.used), sorted(info.pods), info.composite,
                   conv(infos.get_guaranteed_overquotas(ns)))
    out["aggregates"] = (conv(infos.aggregated_min()),
                         conv(infos.aggregated_used()),
                         conv(infos.aggregated_overquotas()))
    return out


class TestQuotaInfo:
    @pytest.mark.parametrize("seed", range(12))
    def test_operations_match_jax(self, seed):
        rng = np.random.default_rng(seed)
        infos, jinfos = ElasticQuotaInfos(), JaxInfos()
        grid = [8 * k for k in range(1, 30)]
        for ns in ("a", "b"):
            lo = int(rng.choice(grid))
            p, j = _info_pair(f"eq-{ns}", ns, [ns], lo,
                              0 if rng.random() < 0.3 else
                              lo + int(rng.choice(grid)))
            infos.add(p)
            jinfos.add(j)
        p, j = _info_pair("team", "default", ["c", "d"],
                          int(rng.choice(grid)), 0, composite=True)
        infos.add(p)
        jinfos.add(j)
        pods = []
        for i in range(30):
            ns = str(rng.choice(["a", "b", "c", "d"]))
            gb, qty = int(rng.choice(SIZES)), int(rng.integers(1, 3))
            pods.append((factory.make_timeshare_pod(
                gb, qty, name=f"p{i}", namespace=ns),
                jax_factory.make_timeshare_pod(
                gb, qty, name=f"p{i}", namespace=ns)))
        for _ in range(80):
            op = int(rng.integers(0, 7))
            pod, jpod = pods[int(rng.integers(len(pods)))]
            ns = pod.metadata.namespace
            info, jinfo = infos.get(ns), jinfos.get(ns)
            assert (info is None) == (jinfo is None)
            req = CALC.compute_pod_request(pod)
            jreq = JAX_CALC.compute_pod_request(jpod)
            if op in (0, 1) and info is not None:
                info.add_pod_if_not_present(pod)
                jinfo.add_pod_if_not_present(jpod)
            elif op == 2 and info is not None:
                info.delete_pod_if_present(pod)
                jinfo.delete_pod_if_present(jpod)
            elif op == 3 and info is not None:
                limit = {MEM: float(rng.choice(grid))}
                jlimit = {JAX_MEM: limit[MEM]}
                assert (info.used_over_min_with(req),
                        info.used_over_max_with(req), info.used_over_min(),
                        info.used_over(limit),
                        info.used_lte_with(limit, req)) == (
                    jinfo.used_over_min_with(jreq),
                    jinfo.used_over_max_with(jreq), jinfo.used_over_min(),
                    jinfo.used_over(jlimit),
                    jinfo.used_lte_with(jlimit, jreq))
                assert infos.aggregated_used_over_min_with(req) == \
                    jinfos.aggregated_used_over_min_with(jreq)
            elif op == 4:
                infos, jinfos = infos.clone(), jinfos.clone()
                assert infos["c"] is infos["d"]
            elif op == 5:
                # the composite grows over a namespace, or shrinks
                old, jold = infos["c"], jinfos["c"]
                spans = sorted(old.namespaces)
                spans = spans[:-1] if len(spans) > 2 else spans + ["e"]
                new, jnew = _info_pair("team", "default", spans,
                                       old.min[MEM], 0, composite=True)
                infos.update_info(old, new)
                jinfos.update_info(jold, jnew)
            elif op == 6 and info is not None and not info.composite:
                infos.delete(info)
                jinfos.delete(jinfo)
                p, j = _info_pair(info.resource_name, ns, [ns],
                                  int(rng.choice(grid)), 0)
                infos.add(p)
                jinfos.add(j)
            assert _ledger_view(infos, False) == _ledger_view(jinfos, True)


# ---------------------------------------------------------------------------
# The webhooks, through the API server's admission (JAX's TestWebhooks)
# ---------------------------------------------------------------------------


def _denial(jax: bool, writes) -> str | None:
    """Run ``writes(api, make_eq, make_ceq)`` on a fresh API server with
    the webhooks installed; the denial's message, or None."""
    api = JaxAPIServer() if jax else APIServer()
    (jax_install_webhooks if jax else install_quota_webhooks)(api)
    meta = JaxMeta if jax else ObjectMeta

    def make_eq(name, ns, gb=0):
        lo = {JAX_MEM if jax else MEM: float(gb)} if gb else {}
        if jax:
            return JaxEQ(metadata=meta(name=name, namespace=ns),
                         spec=JaxEQSpec(min=lo))
        return ElasticQuota(metadata=meta(name=name, namespace=ns),
                            spec=ElasticQuotaSpec(min=lo))

    def make_ceq(name, namespaces):
        if jax:
            return JaxCEQ(metadata=meta(name=name, namespace="default"),
                          spec=JaxCEQSpec(namespaces=list(namespaces)))
        return CompositeElasticQuota(
            metadata=meta(name=name, namespace="default"),
            spec=CompositeElasticQuotaSpec(namespaces=list(namespaces)))

    try:
        writes(api, make_eq, make_ceq)
    except (AdmissionError, JaxAdmissionError) as e:
        assert isinstance(e, JaxAdmissionError if jax else AdmissionError)
        return str(e)
    return None


def _one_eq_per_namespace(api, eq, ceq):
    api.create(KIND_ELASTIC_QUOTA, eq("eq-1", "ns-1"))
    api.create(KIND_ELASTIC_QUOTA, eq("eq-2", "ns-1"))


def _update_of_the_same_eq_passes(api, eq, ceq):
    api.create(KIND_ELASTIC_QUOTA, eq("eq-1", "ns-1"))
    api.update(KIND_ELASTIC_QUOTA, eq("eq-1", "ns-1", 8))
    api.patch(KIND_ELASTIC_QUOTA, "eq-1", "ns-1",
              mutate=lambda o: o.spec.min.update({"x": 1.0}))


def _eq_in_ceq_namespace(api, eq, ceq):
    api.create(KIND_COMPOSITE_ELASTIC_QUOTA, ceq("team", ["ns-1"]))
    api.create(KIND_ELASTIC_QUOTA, eq("eq-1", "ns-1"))


def _ceq_overlap(api, eq, ceq):
    api.create(KIND_COMPOSITE_ELASTIC_QUOTA, ceq("team-a", ["ns-1", "ns-2"]))
    api.create(KIND_COMPOSITE_ELASTIC_QUOTA, ceq("team-b", ["ns-2"]))


def _ceq_without_namespaces(api, eq, ceq):
    api.create(KIND_COMPOSITE_ELASTIC_QUOTA, ceq("x", []))


def _ceq_patched_onto_another(api, eq, ceq):
    api.create(KIND_COMPOSITE_ELASTIC_QUOTA, ceq("team-a", ["ns-1"]))
    api.create(KIND_COMPOSITE_ELASTIC_QUOTA, ceq("team-b", ["ns-2"]))
    api.patch(KIND_COMPOSITE_ELASTIC_QUOTA, "team-b", "default",
              mutate=lambda o: o.spec.namespaces.append("ns-1"))


def _ceq_over_a_plain_eq_is_admitted(api, eq, ceq):
    api.create(KIND_ELASTIC_QUOTA, eq("eq-1", "ns-1"))
    api.create(KIND_COMPOSITE_ELASTIC_QUOTA, ceq("team", ["ns-1"]))


class TestWebhooks:
    @pytest.mark.parametrize("writes,denied", [
        (_one_eq_per_namespace, True),
        (_update_of_the_same_eq_passes, False),
        (_eq_in_ceq_namespace, True),
        (_ceq_overlap, True),
        (_ceq_without_namespaces, True),
        (_ceq_patched_onto_another, True),
        (_ceq_over_a_plain_eq_is_admitted, False),
    ], ids=lambda v: getattr(v, "__name__", str(v)).strip("_"))
    def test_denials_match_jax(self, writes, denied):
        got, want = _denial(False, writes), _denial(True, writes)
        assert got == want
        assert (got is not None) == denied

    def test_a_denied_write_leaves_the_store_and_watchers_untouched(self):
        api = APIServer()
        install_quota_webhooks(api)
        seen = []
        api.watch(KIND_ELASTIC_QUOTA, lambda e, o: seen.append(e))
        api.create(KIND_ELASTIC_QUOTA, ElasticQuota(
            metadata=ObjectMeta(name="eq-1", namespace="ns-1")))
        rv = api.resource_version
        with pytest.raises(AdmissionError):
            api.create(KIND_ELASTIC_QUOTA, ElasticQuota(
                metadata=ObjectMeta(name="eq-2", namespace="ns-1")))
        assert api.resource_version == rv and seen == ["ADDED"]
        assert api.try_get(KIND_ELASTIC_QUOTA, "eq-2", "ns-1") is None


# ---------------------------------------------------------------------------
# The reconcilers: status.used and every pod's label after each step
# ---------------------------------------------------------------------------


class TestReconcilers:
    @pytest.mark.parametrize("seed", range(12))
    @pytest.mark.parametrize("bound", [False, True],
                             ids=["polled", "watching"])
    def test_used_and_labels_match_jax(self, monkeypatch, seed, bound):
        """The quotas of a random spec over its Running pods; then pods
        deleted, finished, added and re-prioritised, a quota's min
        changed and, on even seeds, a plain quota created inside the
        composite's namespaces and deleted by its reconcile."""
        spec = cluster_spec(seed)
        spec["waves"] = [[], []]
        # no webhooks: the composite's reconcile must meet a plain quota
        twin = QuotaTwin(monkeypatch, spec, webhooks=False)
        if bound:
            twin.both(lambda s: [r.bind() for r in s.reconcilers])
        rng = np.random.default_rng(100 + seed)
        names = [p["name"] for p in spec["bound"]]
        for step in range(8):
            op = step % 4
            if op == 0 and names:
                name = names.pop(int(rng.integers(len(names))))
                ns = next(p["namespace"] for p in spec["bound"]
                          if p["name"] == name)
                twin.both(lambda s: s.api.delete(KIND_POD, name, ns))
            elif op == 1 and names:
                name = str(rng.choice(names))
                ns = next(p["namespace"] for p in spec["bound"]
                          if p["name"] == name)
                twin.both(lambda s: s.api.patch(
                    KIND_POD, name, ns,
                    mutate=lambda p: setattr(p.status, "phase",
                                             "Succeeded")))
            elif op == 2:
                p = dict(spec["bound"][0] if spec["bound"] else {
                    "namespace": "ns-a", "gb": 8, "qty": 1, "priority": 0,
                    "tier": "", "app": "job", "node": "node-0"})
                p |= {"name": f"late-{step}", "created": 20_000.0 + step,
                      "gb": int(rng.choice(SIZES)),
                      "namespace": str(rng.choice(["ns-a", "ns-c", "ns-d"]))}
                twin.both(lambda s: s.create_pod(p, phase=RUNNING))
            else:
                gb = float(8 * int(rng.integers(1, 20)))
                twin.both(lambda s: s.api.patch(
                    KIND_ELASTIC_QUOTA, "eq-ns-a", "ns-a",
                    mutate=lambda o: o.spec.min.update(
                        {(JAX_MEM if s.jax else MEM): gb})))
            if step == 5 and seed % 2 == 0 and not bound:
                # (with watches, both packages' create would raise: the
                # quota is deleted inside its own ADDED delivery)
                q = {"kind": "eq", "name": "eq-ns-d", "namespace": "ns-d",
                     "namespaces": ["ns-d"], "min": 16, "max": 0}
                twin.both(lambda s: s.create_quota(q))
            if not bound:
                twin.both(lambda s: s.reconcile())
            twin.compare()
        if seed % 2 == 0 and not bound:
            assert twin.side.api.try_get(KIND_ELASTIC_QUOTA, "eq-ns-d",
                                         "ns-d") is None
        governed = {ns for q in spec["quotas"] for ns in q["namespaces"]}
        labels = [p.metadata.labels.get(C.LABEL_CAPACITY)
                  for p in twin.side.api.list(KIND_POD)
                  if p.status.phase == RUNNING
                  and p.metadata.namespace in governed]
        assert set(labels) <= {C.CAPACITY_IN_QUOTA, C.CAPACITY_OVER_QUOTA}

    def test_status_drops_what_min_does_not_name(self):
        api = APIServer()
        api.create(KIND_ELASTIC_QUOTA, ElasticQuota(
            metadata=ObjectMeta(name="eq-a", namespace="ns-a"),
            spec=ElasticQuotaSpec(min={MEM: 64.0})))
        for i in range(3):
            api.create(KIND_POD, factory.make_timeshare_pod(
                24, name=f"p-{i}", namespace="ns-a", node_name="n",
                phase=RUNNING, creation_timestamp=float(i)))
        ElasticQuotaReconciler(api).reconcile("eq-a", "ns-a")
        assert api.get(KIND_ELASTIC_QUOTA, "eq-a", "ns-a").status.used == \
            {MEM: 72.0}
        assert [api.get(KIND_POD, f"p-{i}", "ns-a").metadata.labels[
            C.LABEL_CAPACITY] for i in range(3)] == [
            "in-quota", "in-quota", "over-quota"]

    def test_many_label_flips_do_not_recurse(self):
        import sys

        api = APIServer()
        api.create(KIND_ELASTIC_QUOTA, ElasticQuota(
            metadata=ObjectMeta(name="eq-a", namespace="ns-a"),
            spec=ElasticQuotaSpec(min={MEM: 8.0})))
        ElasticQuotaReconciler(api).bind()
        n = sys.getrecursionlimit() // 3
        for i in range(n):
            api.create(KIND_POD, factory.make_timeshare_pod(
                8, name=f"p-{i}", namespace="ns-a", node_name="n",
                phase=RUNNING, creation_timestamp=float(i)))
        labels = [p.metadata.labels.get(C.LABEL_CAPACITY)
                  for p in api.list(KIND_POD)]
        assert labels.count(C.CAPACITY_IN_QUOTA) == 1
        assert labels.count(C.CAPACITY_OVER_QUOTA) == n - 1


# ---------------------------------------------------------------------------
# Host-shard accounting (tests/test_elasticquota.py::
# test_multihost_shard_accounting): a JAX multi-host slice S on v5e's
# 8-chip hosts is the port's NVLink block "(S.chips / 8)x8", a chip a
# GPU; quotas at 80 GB a chip and a GPU
# ---------------------------------------------------------------------------

SHARD_CASES = [("4x8", "4x8", 1), ("4x4", "2x8", 1), ("8x8", "8x8", 2),
               ("2x2", "4", 1), ("2x4", "8", 3)]


class TestHostShardAccounting:
    @pytest.mark.parametrize("per_host", [0, 8, 3, 32],
                             ids=["off", "8", "not-dividing", "whole"])
    @pytest.mark.parametrize("jax_shape,port,qty", SHARD_CASES,
                             ids=[c[0] for c in SHARD_CASES])
    def test_charges_as_jax(self, jax_shape, port, qty, per_host):
        """One unit of a block is charged one node's share with the knob
        set (the chips the member owns), the whole block without it; a
        sub-host request (MIG 7g.80gb instances, one GPU each) is never
        touched.  In GB, the port's gpu-memory equals JAX's tpu-memory."""
        from nos_tpu.testing.factory import make_pod as jax_make_pod
        from nos_tpu_torch.topology.profile import slice_resource_name

        jcalc = TPUResourceCalculator(hbm_gb_per_chip=80,
                                      chips_per_host=per_host)
        pcalc = GPUResourceCalculator(gb_per_gpu=80, gpus_per_host=per_host)
        jpod = jax_make_pod(resources={
            f"{JC.RESOURCE_SLICE_PREFIX}{jax_shape}": qty})
        if "x" in port:
            res = {slice_resource_name(port): qty}
        else:
            res = {slice_resource_name("7g.80gb"): int(port) * qty}
        ppod = factory.make_pod(resources=res)
        want = jcalc.compute_pod_request(jpod)[JC.RESOURCE_TPU_MEMORY]
        got = pcalc.compute_pod_request(ppod)[C.RESOURCE_GPU_MEMORY]
        assert got == want

    def test_the_scheduler_main_passes_the_knob(self):
        from nos_tpu_torch.api.config import SchedulerConfig
        from nos_tpu_torch.cmd.scheduler import build_scheduler_main

        main = build_scheduler_main(APIServer(), SchedulerConfig(
            shard_chips_per_host=8))
        calc = main.scheduler._capacity.calculator
        assert calc.gpus_per_host == 8
        pod = factory.make_pod(resources={
            "nos.nebuly.com/nvlink-block-4x8": 1})
        assert calc.compute_pod_request(pod)[C.RESOURCE_GPU_MEMORY] \
            == 8 * 80
