"""The JAX package's side of the serving fleets (``testing/fleet.py``'s
``drive_serving_fleet``): the stand-ins on which its planners decide as
the port's, its loop as ``fleet.PortServingOps``'s, and the patches that
give it the port's weighting and the card's costs.

The MIG stand-in: the H100 restricted to {1g.20gb, 3g.40gb, 7g.80gb}
(``fleet.serving_standin``) against a JAX generation whose host is a
1x4 line of 20 GB chips with the shapes {1x1, 1x2, 1x4}: a chip is a
pair of the GPU's memory slots, so 1x1 at chip i is 1g.20gb at slot 2i,
1x2 at chip 0 or 2 is 3g.40gb at slot 0 or 4, and 1x4 is 7g.80gb, the
placements one to one, and a quota's GB the same on both (20, 40, 80).
The generation's name is none of the JAX package's, so its scheduler
computes no multi-host window for it (the port has none).  The JAX
planner counts free capacity in chips (1, 2, 4) where the port counts
sevenths of a GPU (1, 3, 7); ``jax_serving_weighs_as_the_port`` gives
it the port's sevenths.

The MPS stand-in: a JAX host of two 80 GB chips, one a GPU, for the
port's two-GPU MPS node.
"""

from __future__ import annotations

import nos_tpu.api.constants as JC
import nos_tpu.partitioning.slicepart as jax_sp
import nos_tpu.partitioning.slicepart.factory as jax_sp_factory
import nos_tpu.partitioning.slicepart.node as jax_sp_node
import nos_tpu.partitioning.timeshare as jax_ts
import nos_tpu.partitioning.timeshare.factory as jax_ts_factory
from nos_tpu.topology import Shape
from nos_tpu.topology.known import Generation, TopologyRegistry
from nos_tpu.topology.profile import shape_from_resource

from nos_tpu_torch.testing import fleet

MIG_GEN = Generation(name="h100-mig-standin", ndims=2,
                     host_block=Shape.parse("1x4"), hbm_gb_per_chip=20,
                     slice_shapes=tuple(Shape.parse(s)
                                        for s in ("1x1", "1x2", "1x4")),
                     max_pod=Shape.parse("1x4"))
MPS_GEN = Generation(name="h100-mps-standin", ndims=2,
                     host_block=Shape.parse("1x2"), hbm_gb_per_chip=80,
                     slice_shapes=(Shape.parse("1x1"),),
                     max_pod=Shape.parse("1x2"))
JAX_REG = TopologyRegistry(generations={MIG_GEN.name: MIG_GEN,
                                        MPS_GEN.name: MPS_GEN})
TO_JAX = {fleet.SERVING_DECODE: "1x1", fleet.SERVING_HALF: "1x2",
          fleet.SERVING_WHOLE: "1x4"}
TO_PORT = {v: k for k, v in TO_JAX.items()}
SEVENTHS = {"1x1": 1, "1x2": 3, "1x4": 7}


def _jax_serving_sevenths(self) -> tuple[float, float, bool]:
    """JAX SliceNode.pool_free with the port's weighting: a 1x4 counts 7
    (a GPU), a 1x2 3, a 1x1 1 (their profiles' sevenths), a whole chip a
    fourth of 7."""
    ni = self.node_info()
    total, has_free = 0.0, False
    for res, aq in ni.allocatable.items():
        qty = aq - ni.requested.get(res, 0.0)
        if qty <= 0:
            continue
        has_free = True
        shape = shape_from_resource(res)
        if shape is not None:
            total += SEVENTHS[shape.name] * qty
        elif res == JC.RESOURCE_TPU:
            total += 7 * qty / MIG_GEN.chips_per_host
    return total, 0.0, has_free


def jax_serving_standin(monkeypatch) -> None:
    """The JAX package's loop on the stand-ins: both factories' snapshot
    takers on ``JAX_REG``, and the port's weighting of free capacity."""
    monkeypatch.setattr(jax_sp_factory, "SliceSnapshotTaker",
                        lambda: jax_sp.SliceSnapshotTaker(JAX_REG))
    monkeypatch.setattr(jax_ts_factory, "TimeshareSnapshotTaker",
                        lambda: jax_ts.TimeshareSnapshotTaker(JAX_REG))
    jax_serving_weighs_as_the_port(monkeypatch)


def jax_serving_weighs_as_the_port(monkeypatch) -> None:
    monkeypatch.setattr(jax_sp_node.SliceNode, "pool_free",
                        _jax_serving_sevenths)
    jax_quota_orders_as_the_port(monkeypatch)


def port_resource(resource: str) -> str:
    """A JAX resource name on the stand-ins as the port's."""
    from nos_tpu_torch.api import constants as C
    from nos_tpu_torch.topology.profile import (
        slice_resource_name, timeshare_resource_name)

    if resource == JC.RESOURCE_TPU_MEMORY:
        return C.RESOURCE_GPU_MEMORY
    if resource.startswith(JC.RESOURCE_TIMESHARE_PREFIX):
        return timeshare_resource_name(
            int(resource[len(JC.RESOURCE_TIMESHARE_PREFIX):-2]))
    shape = shape_from_resource(resource)
    if shape is not None:
        return slice_resource_name(TO_PORT[shape.name])
    return resource


def jax_quota_orders_as_the_port(monkeypatch) -> None:
    """The JAX ElasticQuota reconciler's first-come order with the port's
    tie-break: pods created at one instant with one priority fall to
    their sorted requests, whose resource names differ (JAX sorts a
    ``nos.tpu/slice-1x1`` filler before a ``nos.tpu/tpu-8gb`` one, the
    port an ``nvidia.com/gpu-8gb`` one before an ``nvidia.com/mig-1g.20gb``
    one, the quota's GB coming first in its names), so JAX's key reads
    the request under the port's names.  The serving fleets spawn both
    kinds of best-effort filler at one tick; ``TestQuotaOrder`` pins the
    flip."""
    from nos_tpu.controllers.elasticquota import controller

    def sort_key(self, pod):
        req = self._calculator.compute_pod_request(pod)
        return (pod.metadata.creation_timestamp, pod.spec.priority,
                sorted((port_resource(r), q) for r, q in req.items()),
                pod.metadata.name)

    monkeypatch.setattr(controller._PodsReconciler, "_sort_key", sort_key)


def jax_service(raw: dict) -> dict:
    """A port ServingService mapping under the JAX package's names."""
    out = dict(raw)
    if out.get("slice_shape"):
        out["slice_shape"] = TO_JAX[out["slice_shape"]]
    return out


def jax_routed(raw: dict) -> dict:
    """A port RouterService mapping for the JAX package: each cost block
    priced through ``jax_prices_as_the_port``."""
    from test_torch_requests import jax_cost_kwargs

    out = dict(raw)
    for block in ("prefill", "decode"):
        if block in out:
            out[block] = jax_cost_kwargs(out[block])
    return out


class JaxServingOps:
    """``fleet.PortServingOps`` on the JAX package, on the stand-ins:
    node controller with the virgin-node initializer on ``JAX_REG``, pod
    controller, the slice and timeshare partitioner controllers from
    their factories, a SliceAgent over ``FakeTpuRuntime`` a MIG node and
    a ChipAgent an MPS node, the ElasticQuota reconciler at 20 GB a chip,
    ``build_scheduler`` at 20 GB a chip (no host-shard accounting: the
    port has none), the replica autoscaler and the router.  Call
    ``jax_serving_standin`` and ``jax_prices_as_the_port`` first."""

    def __init__(self, workers: int = 0) -> None:
        from nos_tpu import sim
        from nos_tpu.api.elasticquota import install_quota_webhooks
        from nos_tpu.controllers.node_controller import NodeController
        from nos_tpu.controllers.pod_controller import PodController
        from nos_tpu.kube.client import APIServer
        from nos_tpu.obs import journal as J
        from nos_tpu.partitioning.state import ClusterState

        self.sim = sim
        self.eng = sim.SimEngine()
        self.now = self.eng.now
        self.workers = workers
        self.journal = J.DecisionJournal(maxlen=1 << 20, clock=self.now)
        self.api = APIServer()
        install_quota_webhooks(self.api)
        self.state = ClusterState()
        NodeController(self.api, self.state,
                       jax_sp.SliceNodeInitializer(self.api, JAX_REG)).bind()
        PodController(self.api, self.state).bind()
        self._agents: dict = {}
        self.preemptions: list = []
        self.router = None

    def add_mig_node(self, n: dict) -> None:
        from nos_tpu.controllers.sliceagent.agent import SliceAgent
        from nos_tpu.device.fake import FakePodResources, FakeTpuRuntime
        from nos_tpu.testing.factory import make_tpu_node

        self.api.create("Node", make_tpu_node(
            n["name"], generation=MIG_GEN, pod_id=fleet.SERVING_DOMAIN,
            host_index=n["host_index"]))
        agent = SliceAgent(self.api, n["name"], FakeTpuRuntime(MIG_GEN),
                           FakePodResources())
        agent.start()
        self._agents[n["name"]] = agent

    def add_mps_node(self, n: dict) -> None:
        from nos_tpu.controllers.chipagent.agent import ChipAgent
        from nos_tpu.testing.factory import make_tpu_node

        node = make_tpu_node(n["name"], generation=MPS_GEN,
                             partitioning="timeshare", pod_id="",
                             host_index=n["host_index"])
        node.metadata.labels.pop(JC.LABEL_POD_ID)
        self.api.create("Node", node)
        agent = ChipAgent(self.api, n["name"])
        agent.start()
        self._agents[n["name"]] = agent

    def create_quota(self, q: dict) -> None:
        from nos_tpu.api.elasticquota import ElasticQuota, ElasticQuotaSpec
        from nos_tpu.kube.objects import ObjectMeta

        mem = JC.RESOURCE_TPU_MEMORY
        self.api.create("ElasticQuota", ElasticQuota(
            metadata=ObjectMeta(name=q["namespace"],
                                namespace=q["namespace"]),
            spec=ElasticQuotaSpec(min={mem: q["min_gb"]},
                                  max={mem: q["max_gb"]})))

    def build(self, spec: dict) -> None:
        from nos_tpu.cmd.assembly import build_scheduler
        from nos_tpu.controllers.elasticquota.controller import (
            ElasticQuotaReconciler)
        from nos_tpu.quota import TPUResourceCalculator
        from nos_tpu.requests import RouterService, ServingRouter
        from nos_tpu.scheduler.capacityscheduling import CapacityScheduling
        from nos_tpu.serving import ReplicaAutoscaler, ServingService
        from nos_tpu.utils.pod_util import workload_tier

        self.slice_ctl = jax_sp_factory.new_slice_partitioner_controller(
            self.api, self.state,
            batch_timeout_s=fleet.SERVING_BATCH_TIMEOUT_S,
            batch_idle_s=fleet.SERVING_BATCH_IDLE_S, clock=self.now)
        self.slice_ctl.bind()
        self.ts_ctl = jax_ts_factory.new_timeshare_partitioner_controller(
            self.api, self.state,
            batch_timeout_s=fleet.SERVING_BATCH_TIMEOUT_S,
            batch_idle_s=fleet.SERVING_BATCH_IDLE_S, clock=self.now)
        self.ts_ctl.bind()
        self.eq = ElasticQuotaReconciler(self.api, TPUResourceCalculator(
            fleet.SERVING_CHIP_GB))
        self.sched = build_scheduler(
            self.api, fleet.SERVING_CHIP_GB,
            preempt_budget_per_cycle=fleet.SERVING_PREEMPT_BUDGET,
            clock=self.now)
        capacity = next(p for p in self.sched._framework.plugins
                        if isinstance(p, CapacityScheduling))

        def on_preempt(preemptor, victims) -> None:
            self.preemptions.append([self.now(), preemptor.key, sorted(
                [v.key, workload_tier(v)] for v in victims)])

        capacity.on_preempt = on_preempt
        self.autoscaler = ReplicaAutoscaler(
            self.api, [ServingService.from_mapping(jax_service(s))
                       for s in spec["autoscaled"]], clock=self.now)
        if spec["routed"]:
            self.router = ServingRouter(
                self.api, [RouterService.from_mapping(jax_routed(s))
                           for s in spec["routed"]],
                clock=self.now, workers=self.workers,
                publish_every_ticks=fleet.SERVING_STAMP_EVERY_TICKS,
                keep_completed=True)

    def trace(self, **kw):
        from nos_tpu.serving import DiurnalTrace

        return DiurnalTrace(**kw)

    def request(self, *args):
        from nos_tpu.requests import Request

        return Request(*args)

    def create_pod(self, p: dict) -> None:
        from nos_tpu.testing.factory import make_slice_pod, make_timeshare_pod

        labels = {JC.LABEL_TIER: p["tier"]} if p["tier"] else None
        kw = dict(name=p["name"], namespace=p["namespace"], labels=labels,
                  creation_timestamp=p["created"])
        if p.get("profile"):
            pod = make_slice_pod(TO_JAX[p["profile"]], 1, **kw)
        else:
            pod = make_timeshare_pod(p["gb"], 1, **kw)
        self.api.create("Pod", pod)

    def delete_pod(self, name: str, namespace: str) -> None:
        from nos_tpu.kube.client import NotFound

        try:
            self.api.delete("Pod", name, namespace)
        except NotFound:
            pass

    def stamp(self, svc: dict, demand: float) -> None:
        from nos_tpu.kube.client import NotFound
        from nos_tpu.utils.retry import retry_on_conflict

        replicas = self.api.list(
            "Pod", namespace=svc["namespace"],
            label_selector={JC.LABEL_SERVICE: svc["name"]},
            filter_fn=lambda p: p.status.phase in ("Pending", "Running"))
        if not replicas:
            return
        share = demand / len(replicas)

        def mutate(p) -> None:
            p.metadata.annotations[JC.ANNOT_SERVING_LOAD] = f"{share:.3f}"

        for p in replicas:
            try:
                retry_on_conflict(self.api, "Pod", p.metadata.name, mutate,
                                  p.metadata.namespace,
                                  component="serving-load")
            except NotFound:
                pass

    def pod_names(self) -> set[str]:
        return set(fleet._read_pods(self.api, lambda p: p.metadata.name))

    def pods(self) -> list[dict]:
        from nos_tpu.kube.resources import pod_request
        from nos_tpu.serving import replica_load
        from nos_tpu.topology.profile import (
            extract_slice_requests, extract_timeshare_requests)

        def row(p) -> dict:
            req = pod_request(p)
            shapes = sorted(s.name for s in extract_slice_requests(req))
            return {
                "name": p.metadata.name, "namespace": p.metadata.namespace,
                "node": p.spec.node_name, "phase": p.status.phase,
                "created": p.metadata.creation_timestamp,
                "service": p.metadata.labels.get(JC.LABEL_SERVICE, ""),
                "load": replica_load(p),
                "profile": TO_PORT[shapes[0]] if shapes else "",
                "gb": next(iter(sorted(extract_timeshare_requests(req))),
                           0)}

        return sorted(fleet._read_pods(self.api, row),
                      key=lambda r: (r["namespace"], r["name"]))

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
                if r.category in fleet.SERVING_RECORDS]

    def close(self) -> None:
        self.sched.close()


def jax_serving_run(monkeypatch, spec: dict, workers: int = 0) -> dict:
    """``fleet.run_serving_fleet`` on the JAX package, on the stand-ins,
    weighed and priced as the port, under a journal and a waste ledger
    of its own (``waste``)."""
    from nos_tpu.obs import ledger as jax_ledger
    from nos_tpu.obs import scoped as jax_scoped

    from test_torch_requests import jax_prices_as_the_port

    jax_serving_standin(monkeypatch)
    jax_prices_as_the_port(monkeypatch)
    ops = JaxServingOps(workers)
    ledger = jax_ledger.ChipSecondLedger(clock=ops.now)
    try:
        with jax_scoped(journal=ops.journal, ledger=ledger):
            out = fleet.drive_serving_fleet(spec, ops)
    finally:
        ops.close()
    out["waste"] = ledger.report()
    out["journal"] = [
        [r.category, r.subject, sorted((k, str(v)) for k, v in r.attrs.items()
                                       if k != "plan_id")]
        for r in ops.journal.events()]
    return out
