"""Declarative scenarios and the control-plane assembly harness,
``nos_tpu/sim/scenario.py`` for the port.

``Scenario`` is the one declarative config for the stack a composed
run stands on (the API server, the quota webhooks, the node and pod
controllers, the partitioner controllers, the node agents,
``build_scheduler``, the ledger, the journal and the SLO engine), and
``assemble_control_plane`` is the one wiring function: it stands up the
scheduler, the partitioners, the quotas and the serving autoscaler from
the config, every component on the engine's injected clock, and returns
a ``ControlPlane`` whose ``tick()`` runs the canonical control-loop
body.  It stands up no capacity provisioner: a lost node comes back
only through the MIG controller's recovery knobs
(``spare_hosts_per_pool``, ``node_suspect_after_s``) and the caller's
own ``add_host``.

The H100 translation of the JAX harness:

- a pool is a node's NVLink domain (``make_gpu_node``'s ``domain``),
  where JAX names a TPU pod (``pod_id``); ``host_index``, the zone
  label and the warm-spare label are as in JAX;
- ``PoolSpec.model`` (default ``H100_80GB``) replaces JAX's
  ``generation``, and ``partitioning`` takes ``"mig"`` or ``"mps"``
  where JAX takes ``"slice"`` or ``"timeshare"``;
- ``Scenario.hbm_gb_per_chip`` keeps JAX's name and means GB of one GPU
  (default 80); ``chips_per_host`` means GPUs a node (default 8).
  Quotas are in ``nos.nebuly.com/gpu-memory`` through
  ``GPUResourceCalculator``;
- ``build_scheduler`` takes the GB of one GPU, the clock and
  ``shard_chips_per_host=chips_per_host``, as in JAX: a unit of an
  NVLink block is charged one node's GPUs of quota;
- a MIG node's agent runs on ``FakeGpuRuntime`` of the pool's model,
  always: a simulated node is not the card, and the port's
  ``default_gpu_runtime`` would bind every simulated node to the one
  real card's NVML (JAX's ``default_tpu_runtime`` falls back to its
  fake off a TPU).  An MPS node's agent is the ``ChipAgent``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.api.elasticquota import (
    CompositeElasticQuota, CompositeElasticQuotaSpec, ElasticQuota,
    ElasticQuotaSpec, install_quota_webhooks)
from nos_tpu_torch.cmd.assembly import build_scheduler
from nos_tpu_torch.controllers.chipagent import ChipAgent
from nos_tpu_torch.controllers.elasticquota.controller import (
    CompositeElasticQuotaReconciler, ElasticQuotaReconciler)
from nos_tpu_torch.controllers.node_controller import NodeController
from nos_tpu_torch.controllers.pod_controller import PodController
from nos_tpu_torch.controllers.sliceagent.agent import SliceAgent
from nos_tpu_torch.device.fake import FakeGpuRuntime, FakePodResources
from nos_tpu_torch.kube.client import (
    APIServer, KIND_COMPOSITE_ELASTIC_QUOTA, KIND_ELASTIC_QUOTA, KIND_NODE,
    NotFound)
from nos_tpu_torch.kube.objects import ObjectMeta
from nos_tpu_torch.obs.journal import DecisionJournal
from nos_tpu_torch.obs.ledger import ChipSecondLedger
from nos_tpu_torch.obs.slo import SLOEngine, SLOObjective
from nos_tpu_torch.obs.timeseries import TimeSeriesSampler
from nos_tpu_torch.partitioning.slicepart import SliceNodeInitializer
from nos_tpu_torch.partitioning.slicepart.factory import (
    new_slice_partitioner_controller)
from nos_tpu_torch.partitioning.state import ClusterState
from nos_tpu_torch.partitioning.timeshare.factory import (
    new_timeshare_partitioner_controller)
from nos_tpu_torch.quota import GPUResourceCalculator
from nos_tpu_torch.serving.autoscaler import ReplicaAutoscaler, ServingService
from nos_tpu_torch.testing.chaos import ChaosAPIServer
from nos_tpu_torch.testing.factory import make_gpu_node
from nos_tpu_torch.topology import H100_80GB, GpuModel

from .engine import SimEngine
from .trace import SamplerSource, TickSource, TraceSource


@dataclass(frozen=True)
class PoolSpec:
    """One failure-domain pool of identical nodes."""

    pool: str                       # NVLink domain label
    hosts: int
    partitioning: str = C.MIG_KIND  # "mig" | "mps"
    model: GpuModel = H100_80GB
    zone: str = ""
    spares: int = 0                 # warm spares labelled SPARE_WARM


@dataclass(frozen=True)
class QuotaSpec:
    """One ElasticQuota (or, with ``namespaces`` set, a composite), in GB
    of GPU memory."""

    name: str
    min_gb: float
    max_gb: float
    namespace: str = ""             # defaults to name for plain EQs
    namespaces: tuple[str, ...] = ()  # non-empty => CompositeElasticQuota


@dataclass(frozen=True)
class Scenario:
    """The full declarative run config: cluster, quotas, services,
    plane knobs, horizon.  Trace sources (arrivals, faults, load) are
    attached separately: they are composition, not configuration."""

    name: str
    horizon_s: float
    tick_s: float = 0.25
    seed: int = 0
    pools: tuple[PoolSpec, ...] = ()
    quotas: tuple[QuotaSpec, ...] = ()
    services: tuple[ServingService, ...] = ()
    hbm_gb_per_chip: int = 80       # GB of one GPU
    chips_per_host: int = 8         # GPUs a node
    chaos_api: bool = False
    batch_timeout_s: float = 0.2
    batch_idle_s: float = 0.05
    spare_hosts_per_pool: int = 0
    node_suspect_after_s: float = 0.0
    slo_objectives: tuple[SLOObjective, ...] = ()
    slo_fast_window_s: float = 30.0
    slo_slow_window_s: float = 120.0
    sample_period_s: float = 1.0
    scheduler_kwargs: tuple[tuple[str, Any], ...] = ()


class ControlPlane:
    """The assembled stack.  Attributes are the live components; the
    methods are the run-loop verbs every scenario drives."""

    def __init__(self, scenario: Scenario, engine: SimEngine) -> None:
        self.scenario = scenario
        self.engine = engine
        clock = engine.now
        self.api: APIServer = (
            ChaosAPIServer(scenario.seed) if scenario.chaos_api
            else APIServer())
        self.state = ClusterState()
        install_quota_webhooks(self.api)
        NodeController(self.api, self.state,
                       SliceNodeInitializer(self.api)).bind()
        PodController(self.api, self.state).bind()

        parts = {p.partitioning for p in scenario.pools}
        self.slice_ctl = None
        self.ts_ctl = None
        if C.MIG_KIND in parts or not scenario.pools:
            self.slice_ctl = new_slice_partitioner_controller(
                self.api, self.state,
                batch_timeout_s=scenario.batch_timeout_s,
                batch_idle_s=scenario.batch_idle_s,
                spare_hosts_per_pool=scenario.spare_hosts_per_pool,
                node_suspect_after_s=scenario.node_suspect_after_s,
                clock=clock)
            self.slice_ctl.bind()
        if C.MPS_KIND in parts:
            self.ts_ctl = new_timeshare_partitioner_controller(
                self.api, self.state,
                batch_timeout_s=scenario.batch_timeout_s,
                batch_idle_s=scenario.batch_idle_s,
                clock=clock)
            self.ts_ctl.bind()

        # Quotas through the admission-validated create path BEFORE any
        # pod exists, so the scheduler's quota ledger is live from t=0.
        self.calculator = GPUResourceCalculator(scenario.hbm_gb_per_chip)
        for q in scenario.quotas:
            if q.namespaces:
                self.api.create(
                    KIND_COMPOSITE_ELASTIC_QUOTA, CompositeElasticQuota(
                        metadata=ObjectMeta(name=q.name,
                                            namespace="default"),
                        spec=CompositeElasticQuotaSpec(
                            namespaces=list(q.namespaces),
                            min={C.RESOURCE_GPU_MEMORY: q.min_gb},
                            max={C.RESOURCE_GPU_MEMORY: q.max_gb})))
            else:
                ns = q.namespace or q.name
                self.api.create(KIND_ELASTIC_QUOTA, ElasticQuota(
                    metadata=ObjectMeta(name=q.name, namespace=ns),
                    spec=ElasticQuotaSpec(
                        min={C.RESOURCE_GPU_MEMORY: q.min_gb},
                        max={C.RESOURCE_GPU_MEMORY: q.max_gb})))
        self.eq_reconciler = (
            ElasticQuotaReconciler(self.api, self.calculator)
            if scenario.quotas else None)
        self.ceq_reconciler = (
            CompositeElasticQuotaReconciler(self.api, self.calculator)
            if any(q.namespaces for q in scenario.quotas) else None)

        self.agents: dict[str, ChipAgent | SliceAgent] = {}
        for pool in scenario.pools:
            for h in range(pool.hosts):
                self.add_host(pool, h)
            for s in range(pool.spares):
                self.add_host(pool, pool.hosts + s, spare=True)

        self.scheduler = build_scheduler(
            self.api, scenario.hbm_gb_per_chip,
            shard_chips_per_host=scenario.chips_per_host, clock=clock,
            **dict(scenario.scheduler_kwargs))
        self.autoscaler = (
            ReplicaAutoscaler(self.api, scenario.services, clock=clock)
            if scenario.services else None)

        self.ledger = ChipSecondLedger(clock=clock)
        self.journal = DecisionJournal(maxlen=200_000, clock=clock)
        self.slo_engine = SLOEngine(
            TimeSeriesSampler(clock=clock, maxlen=4096),
            list(scenario.slo_objectives),
            fast_window_s=scenario.slo_fast_window_s,
            slow_window_s=scenario.slo_slow_window_s, clock=clock)

    # -- cluster mutation (recovery verbs) ----------------------------------
    def add_host(self, pool: PoolSpec, host_index: int, *,
                 spare: bool = False) -> str:
        extra: dict[str, str] = {}
        if pool.zone:
            extra[C.LABEL_ZONE] = pool.zone
        name = f"{pool.pool}-h{host_index}"
        if spare:
            extra[C.LABEL_SPARE] = C.SPARE_WARM
            name = f"{pool.pool}-spare{host_index}"
        gpus = self.scenario.chips_per_host
        self.api.create(KIND_NODE, make_gpu_node(
            name, model=pool.model, gpus=gpus,
            partitioning=pool.partitioning, domain=pool.pool,
            host_index=host_index, extra_labels=extra))
        agent: ChipAgent | SliceAgent
        if pool.partitioning == C.MPS_KIND:
            agent = ChipAgent(self.api, name)
        else:
            agent = SliceAgent(self.api, name,
                               FakeGpuRuntime(pool.model, gpus),
                               FakePodResources())
        agent.start()
        self.agents[name] = agent
        return name

    def kill_host(self, name: str) -> None:
        """The node-loss verb: agent gone, node object gone."""
        self.agents.pop(name, None)
        try:
            self.api.delete(KIND_NODE, name)
        except NotFound:
            pass                    # already gone: kill is idempotent

    # -- run-loop verbs ------------------------------------------------------
    def tick(self) -> None:
        """The canonical control-loop body: one scheduling cycle,
        partitioner batches, agent admission, quota relabelling,
        autoscaler reconcile."""
        self.scheduler.run_cycle()
        if self.slice_ctl is not None:
            self.slice_ctl.process_if_ready()
        if self.ts_ctl is not None:
            self.ts_ctl.process_if_ready()
        for name in sorted(self.agents):    # stable node order
            self.agents[name].tick()
        if self.eq_reconciler is not None:
            self.eq_reconciler.reconcile_all()
        if self.ceq_reconciler is not None:
            self.ceq_reconciler.reconcile_all()
        if self.autoscaler is not None:
            self.autoscaler.reconcile()

    def sample(self, _t: float) -> None:
        """The observation body: SLO judgement on the shared registry."""
        self.slo_engine.tick()

    def sources(self) -> list[TraceSource]:
        """The plane's own periodic work as trace sources: compose
        these with the scenario's workload and fault sources."""
        out: list[TraceSource] = [
            TickSource(self.scenario.tick_s, self.tick,
                       until=self.scenario.horizon_s, label="ctl-tick")]
        if self.scenario.slo_objectives:
            out.append(SamplerSource(
                self.scenario.sample_period_s, self.sample,
                until=self.scenario.horizon_s, label="slo-sample"))
        return out


def assemble_control_plane(scenario: Scenario,
                           engine: Optional[SimEngine] = None
                           ) -> ControlPlane:
    """Stand up the control plane from one declarative config on one
    engine clock.  Returns the live ``ControlPlane``; install its
    ``sources()`` (plus workload and fault sources) and ``engine.run()``."""
    return ControlPlane(scenario, engine if engine is not None
                        else SimEngine())
