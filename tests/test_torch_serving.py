"""The port's serving plane (``nos_tpu_torch/serving``, ``api/config.py``'s
AutoscalerConfig, the serving fleets of ``testing/fleet.py``) against the
JAX package's, each case run through both packages on the same inputs.

- the autoscaler: ``tests/test_autoscaler.py``'s TestScaling and
  TestServiceSpec on both (a MIG service on the stand-in of
  ``tests/serving_twin.py``: the port's 1g.20gb is JAX's 1x1), the
  replicas, the status ConfigMap, the ``autoscale`` records and the
  ``nos_tpu_autoscaler_*`` metrics compared after every reconcile; a TPU
  slice shape refused; the status write through a chaos API server and a
  seeded round under the port's lock discipline;
- ``DiurnalTrace``: the same seed gives JAX's curve, bit for bit;
- the tier end to end: ``tests/test_serving.py``'s tiered scheduling,
  serving-never-a-victim and burst cases on the MIG stand-in, every pod
  and victim compared;
- ``AutoscalerConfig`` through ``ServingService`` on both;
- the router-off serving fleet (bench_serving.py's run, mapped): the
  JAX package's run hashes to ``chip_smoke.SERVING_FLEET_DIGEST`` and
  the port's run to the same, its waterfall conserved;
  ``TestQuotaOrder`` pins the one tie-break the JAX side is given.
"""

from __future__ import annotations

import math

import numpy as np
import pytest

import nos_tpu.api.constants as JC
import nos_tpu.serving as jax_serving
from nos_tpu.api.config import AutoscalerConfig as JaxAutoscalerConfig
from nos_tpu.api.config import ConfigError as JaxConfigError
from nos_tpu.exporter.metrics import REGISTRY as JAX_REGISTRY
from nos_tpu.kube import client as jax_client
from nos_tpu.obs import journal as jax_journal
from nos_tpu.obs import scoped as jax_scoped
from nos_tpu.testing import factory as jax_factory
from nos_tpu.utils import retry as jax_retry

import nos_tpu_torch.serving as port_serving
from nos_tpu_torch.api import constants as C
from nos_tpu_torch.api.config import AutoscalerConfig, ConfigError
from nos_tpu_torch.exporter.metrics import REGISTRY as PORT_REGISTRY
from nos_tpu_torch.kube import client as port_client
from nos_tpu_torch.obs import journal as port_journal
from nos_tpu_torch.obs import scoped as port_scoped
from nos_tpu_torch.testing import factory as port_factory
from nos_tpu_torch.testing import fleet
from nos_tpu_torch.utils import retry as port_retry

import serving_twin
from serving_twin import MIG_GEN, TO_JAX


@pytest.fixture(autouse=True)
def fast_retry(monkeypatch):
    monkeypatch.setattr(jax_retry, "sleep", lambda s: None)
    monkeypatch.setattr(port_retry, "sleep", lambda s: None)


class Pkg:
    def __init__(self, jax: bool) -> None:
        self.jax = jax
        self.name = "jax" if jax else "port"
        self.S = jax_serving if jax else port_serving
        self.C = JC if jax else C
        self.client = jax_client if jax else port_client
        self.J = jax_journal if jax else port_journal
        self.scoped = jax_scoped if jax else port_scoped
        self.factory = jax_factory if jax else port_factory
        self.retry = jax_retry if jax else port_retry
        self.REGISTRY = JAX_REGISTRY if jax else PORT_REGISTRY

    def service(self, **kw):
        defaults = dict(name="chat", namespace="serve",
                        slice_shape=fleet.SERVING_DECODE, min_replicas=1,
                        max_replicas=8, target_load_per_replica=10.0,
                        scale_up_cooldown_s=0.0, scale_down_cooldown_s=0.0,
                        down_hysteresis=0.2)
        defaults.update(kw)
        if self.jax:
            defaults = serving_twin.jax_service(defaults)
        return self.S.ServingService(**defaults)

    def resource(self, shape: str) -> str:
        if self.jax:
            return f"{JC.RESOURCE_SLICE_PREFIX}{TO_JAX[shape]}"
        return f"nvidia.com/mig-{shape}"


PKGS = (Pkg(True), Pkg(False))


def same(story):
    out = {pk.name: story(pk) for pk in PKGS}
    assert out["port"] == out["jax"]
    return out["port"]


class Harness:
    """``tests/test_autoscaler.py``'s harness on one package; ``view``
    is what both must agree on after every step."""

    def __init__(self, pk: Pkg, svc=None, api=None) -> None:
        self.pk = pk
        self.now = [0.0]
        self.api = api if api is not None else pk.client.APIServer()
        self.svc = svc or pk.service()
        self.journal = pk.J.DecisionJournal(clock=lambda: self.now[0])
        self.autoscaler = pk.S.ReplicaAutoscaler(
            self.api, [self.svc], clock=lambda: self.now[0])
        self.views: list = []

    def replicas(self) -> list:
        return self.api.list("Pod", namespace=self.svc.namespace,
                             label_selector={self.pk.C.LABEL_SERVICE:
                                             self.svc.name})

    def stamp(self, total: float) -> None:
        pods = self.replicas()
        share = total / len(pods)
        for p in pods:
            self.pk.retry.retry_on_conflict(
                self.api, "Pod", p.metadata.name,
                lambda q: q.metadata.annotations.__setitem__(
                    self.pk.C.ANNOT_SERVING_LOAD, str(share)),
                p.metadata.namespace, component="test-stamp")

    def mark(self, name: str, load: float, sessions: int | None = None):
        C_ = self.pk.C

        def mutate(p) -> None:
            p.status.phase = "Running"
            p.spec.node_name = "host-0"
            p.metadata.annotations[C_.ANNOT_SERVING_LOAD] = str(load)
            if sessions is not None:
                p.metadata.annotations[C_.ANNOT_SERVING_SESSIONS] = \
                    str(sessions)

        self.api.patch("Pod", name, self.svc.namespace, mutate=mutate)

    def reconcile(self, at: float | None = None) -> dict:
        if at is not None:
            self.now[0] = at
        with self.pk.scoped(journal=self.journal):
            out = self.autoscaler.reconcile()
        self.views.append(self.view())
        return out

    def view(self) -> dict:
        C_ = self.pk.C
        pods = {}
        for p in self.replicas():
            res = p.spec.containers[0].resources
            pods[p.metadata.name] = (
                p.status.phase, p.metadata.labels.get(C_.LABEL_TIER),
                p.metadata.labels.get(C_.LABEL_SERVICE),
                p.metadata.creation_timestamp, p.spec.priority,
                p.spec.scheduler_name,
                sorted((("unit" if r != "cpu" else r), q)
                       for r, q in res.items()))
        cm = self.api.try_get("ConfigMap", "nos-tpu-autoscaler-status",
                              "nos-tpu-system")
        snap = self.pk.REGISTRY.snapshot()
        metrics = {m: snap.get(m, {}).get("service=serve/chat") for m in (
            "nos_tpu_autoscaler_load", "nos_tpu_autoscaler_replicas",
            "nos_tpu_autoscaler_desired_replicas")}
        return {"pods": pods, "status": dict(cm.data) if cm else None,
                "records": [(r.category, r.subject, dict(r.attrs))
                            for r in self.journal.events()],
                "metrics": metrics}


class TestScaling:
    def test_min_floor_is_enforced_immediately(self):
        def story(pk):
            h = Harness(pk, pk.service(min_replicas=3))
            out = h.reconcile()
            return out, h.views

        out, views = same(story)
        assert out["serve/chat"]["scaled"] == 3 and len(views[-1]["pods"]) == 3

    @pytest.mark.parametrize("load,max_replicas,want", [
        (35.0, 8, 4), (1000.0, 5, 5), (0.0, 8, 1), (80.0, 8, 8)])
    def test_scale_up_follows_load_inside_the_band(self, load, max_replicas,
                                                    want):
        def story(pk):
            h = Harness(pk, pk.service(max_replicas=max_replicas))
            h.reconcile()
            h.stamp(load)
            h.reconcile(1.0)
            return h.views

        assert len(same(story)[-1]["pods"]) == want

    def test_replica_pods_carry_the_tier_contract(self):
        def story(pk):
            h = Harness(pk)
            h.reconcile()
            (pod,) = h.replicas()
            return (pod.metadata.labels[pk.C.LABEL_TIER],
                    pod.metadata.labels[pk.C.LABEL_SERVICE],
                    pod.metadata.annotations[pk.C.ANNOT_SERVING_LOAD],
                    pod.metadata.creation_timestamp,
                    pk.resource(fleet.SERVING_DECODE)
                    in pod.spec.containers[0].resources, h.views)

        tier, service, load, created, unit, _ = same(story)
        assert (tier, service, load, created, unit) == (
            "serving", "chat", "0", 0.0, True)

    def test_scale_down_hysteresis_blocks_the_boundary(self):
        def story(pk):
            h = Harness(pk)
            h.reconcile()
            for t, load in ((1.0, 35.0), (2.0, 29.0), (3.0, 22.0)):
                h.stamp(load)
                h.reconcile(t)
            return [len(v["pods"]) for v in h.views], h.views

        counts, _ = same(story)
        assert counts == [1, 4, 4, 3]

    def test_cooldowns_per_direction(self):
        def story(pk):
            h = Harness(pk, pk.service(scale_up_cooldown_s=10.0,
                                       scale_down_cooldown_s=30.0))
            h.reconcile()
            steps = ((1.0, 25.0), (10.5, None), (11.0, 60.0), (21.0, None),
                     (22.0, 15.0), (23.0, 5.0), (60.0, None))
            for t, load in steps:
                if load is not None:
                    h.stamp(load)
                h.reconcile(t)
            return [len(v["pods"]) for v in h.views], h.views

        counts, _ = same(story)
        # up deferred at 1 s, landed at 10.5; the second burst deferred
        # to 21; the first shrink at once, the second after the down
        # cooldown
        assert counts == [1, 1, 3, 3, 6, 2, 2, 1]

    def test_scale_down_takes_pending_then_drained_then_least_loaded(self):
        def story(pk):
            h = Harness(pk)
            h.reconcile()
            h.stamp(55.0)
            h.reconcile(1.0)
            names = sorted(p.metadata.name for p in h.replicas())
            for name, load, sessions in zip(names, (10.0, 9.0, 7.0, 6.0),
                                            (3, 2, 0, 0)):
                h.mark(name, load, sessions)
            for name in names[4:]:       # pending, no load
                h.api.patch("Pod", name, "serve", mutate=lambda q: q.metadata
                            .annotations.__setitem__(
                                pk.C.ANNOT_SERVING_LOAD, "0"))
            h.reconcile(2.0)             # 32 in flight: 4 replicas
            after_pending = sorted(p.metadata.name for p in h.replicas())
            for name, load, sessions in zip(names, (5.0, 1.0, 6.0, 0.0),
                                            (3, 2, 0, 0)):
                h.mark(name, load, sessions)
            h.reconcile(3.0)             # 12 in flight: 2 replicas
            return names, after_pending, h.views

        names, after, views = same(story)
        # the pending pair first; then the drained pair, though the
        # least loaded replica (names[1]) still streams
        assert after == names[:4]
        assert sorted(views[-1]["pods"]) == [names[0], names[1]]

    def test_status_configmap_and_garbage_loads(self):
        def story(pk):
            h = Harness(pk)
            h.reconcile()
            pods = [pk.factory.make_pod(annotations={
                pk.C.ANNOT_SERVING_LOAD: v,
                pk.C.ANNOT_SERVING_SESSIONS: v}) for v in
                ("-3", "7.5", "banana", "2", "")]
            loads = [pk.S.replica_load(pk.factory.make_pod(annotations={
                pk.C.ANNOT_SERVING_LOAD: v})) for v in ("nan", "inf")]
            return ([pk.S.replica_load(p) for p in pods] + loads,
                    [pk.S.replica_sessions(p) for p in pods], h.views)

        loads, sessions, views = same(story)
        assert loads == [0.0, 7.5, 0.0, 2.0, 0.0, 0.0, 0.0]
        assert sessions == [0, 7, 0, 2, 0]
        assert "serve/chat" in views[-1]["status"]

    def test_a_non_finite_session_count_reads_zero(self):
        """Where the JAX package's reader raises OverflowError on "inf"
        (``int(float("inf"))``), failing the reconcile, the port's reads
        a garbage count as 0, as both docstrings promise."""
        for v in ("inf", "-inf", "nan"):
            pod = port_factory.make_pod(annotations={
                C.ANNOT_SERVING_SESSIONS: v})
            assert port_serving.replica_sessions(pod) == 0
        with pytest.raises((OverflowError, ValueError)):
            jax_serving.replica_sessions(jax_factory.make_pod(annotations={
                JC.ANNOT_SERVING_SESSIONS: "inf"}))

    @pytest.mark.parametrize("seed", range(4))
    def test_a_drawn_load_sequence_decides_alike(self, seed):
        """numpy-drawn loads, clock steps and band knobs: the replicas,
        the status and the records equal after every reconcile."""
        rng = np.random.default_rng(seed)
        lo = int(rng.integers(0, 3))
        knobs = dict(min_replicas=lo, max_replicas=lo + int(
            rng.integers(1, 8)), target_load_per_replica=float(
            rng.uniform(0.3, 12.0)), scale_up_cooldown_s=float(
            rng.uniform(0, 2)), scale_down_cooldown_s=float(
            rng.uniform(0, 5)), down_hysteresis=float(rng.uniform(0, 0.5)))
        loads = rng.uniform(0, 60, size=30)
        dts = rng.uniform(0.1, 2.0, size=30)

        def story(pk):
            h = Harness(pk, pk.service(**knobs))
            h.reconcile()
            t = 0.0
            for load, dt in zip(loads, dts):
                t += float(dt)
                if h.replicas():
                    h.stamp(float(load))
                h.reconcile(t)
            return h.views

        views = same(story)
        assert any(r[0] == "autoscale" for r in views[-1]["records"])


class TestServiceSpec:
    @pytest.mark.parametrize("kw", [
        dict(slice_shape=fleet.SERVING_DECODE, timeshare_gb=8),
        dict(slice_shape="", timeshare_gb=0),
        dict(min_replicas=5, max_replicas=2),
        dict(target_load_per_replica=0.0),
        dict(down_hysteresis=1.0),
        dict(scale_up_cooldown_s=-1.0)])
    def test_knobs_are_checked_as_jax_checks_them(self, kw):
        def story(pk):
            with pytest.raises(ValueError):
                pk.service(**kw)
            return True

        same(story)

    @pytest.mark.parametrize("shape", ["1x1", "2x4", "1x2", "mig-1g.10gb",
                                       "8g.90gb"])
    def test_a_shape_with_no_h100_meaning_is_refused(self, shape):
        with pytest.raises(ValueError, match="is not a MIG profile"):
            port_serving.ServingService(name="x", slice_shape=shape)
        with pytest.raises(ValueError, match="over a card's 80 GB"):
            port_serving.ServingService(name="x", timeshare_gb=96)

    @pytest.mark.parametrize("shape", ["1g.10gb", "1g.20gb", "2g.20gb",
                                       "3g.40gb", "4g.40gb", "7g.80gb"])
    def test_every_h100_profile_names_its_resource(self, shape):
        svc = port_serving.ServingService(name="x", slice_shape=shape)
        assert svc.replica_resources() == {f"nvidia.com/mig-{shape}": 1.0,
                                           "cpu": 1.0}
        ts = port_serving.ServingService(name="x", timeshare_gb=24)
        assert ts.replica_resources() == {"nvidia.com/gpu-24gb": 1.0,
                                          "cpu": 1.0}

    def test_from_mapping_rejects_unknown_keys(self):
        def story(pk):
            with pytest.raises(ValueError, match="unknown"):
                pk.S.ServingService.from_mapping(
                    {"name": "x", "timeshare_gb": 8, "cooldown": 1})
            return True

        same(story)


class TestAutoscalerConfig:
    @pytest.mark.parametrize("services,ok", [
        ([{"name": "chat", "slice_shape": fleet.SERVING_DECODE}], True),
        ([{"name": "chat", "timeshare_gb": 24, "min_replicas": 1,
           "max_replicas": 2}], True),
        ([{"name": "chat"}], False),
        ([{"name": "chat", "timeshare_gb": 8, "cooldown": 1}], False),
        ([["chat"]], False),
        ({"chat": {}}, False)])
    def test_services_are_validated_as_jax_validates_them(self, services,
                                                          ok):
        jservices = [serving_twin.jax_service(s) if isinstance(s, dict)
                     else s for s in services] if isinstance(
            services, list) else services
        for cfg, err in ((AutoscalerConfig(services=services), ConfigError),
                         (JaxAutoscalerConfig(services=jservices),
                          JaxConfigError)):
            if ok:
                cfg.validate()
            else:
                with pytest.raises(err):
                    cfg.validate()

    def test_a_tpu_slice_shape_fails_the_port_s_load(self):
        with pytest.raises(ConfigError, match="not a MIG profile"):
            AutoscalerConfig(services=[{"name": "chat",
                                        "slice_shape": "1x1"}]).validate()

    @pytest.mark.parametrize("knob,value", [
        ("reconcile_interval_s", 0.0), ("status_configmap", "")])
    def test_knobs(self, knob, value):
        with pytest.raises(ConfigError):
            AutoscalerConfig(**{knob: value}).validate()
        with pytest.raises(JaxConfigError):
            JaxAutoscalerConfig(**{knob: value}).validate()

    def test_the_defaults_are_jax_s(self):
        import dataclasses

        port = {f.name: getattr(AutoscalerConfig(), f.name)
                for f in dataclasses.fields(AutoscalerConfig)}
        jax = {f.name: getattr(JaxAutoscalerConfig(), f.name)
               for f in dataclasses.fields(JaxAutoscalerConfig)}
        for key in ("reconcile_interval_s", "status_configmap",
                    "status_namespace", "services", "leader_election"):
            assert port[key] == jax[key]


class TestChaos:
    def test_status_write_retries_on_conflict(self):
        from nos_tpu_torch.testing.chaos import ChaosAPIServer

        api = ChaosAPIServer(7, conflict_rate=0.5, transient_rate=0.2)
        h = Harness(Pkg(False), api=api)
        before = PORT_REGISTRY.value("nos_tpu_retry_total",
                                     {"component": "autoscaler-status"}) or 0
        for i in range(30):
            h.reconcile(float(i))
        cm = api.get("ConfigMap", "nos-tpu-autoscaler-status",
                     "nos-tpu-system")
        assert "serve/chat" in cm.data
        after = PORT_REGISTRY.value("nos_tpu_retry_total",
                                    {"component": "autoscaler-status"})
        assert after > before

    def test_seeded_chaos_round_under_the_lock_discipline(self):
        from nos_tpu_torch.testing.chaos import ChaosAPIServer
        from nos_tpu_torch.testing.lockcheck import (
            LockGraph, guard_state, unguard_all)

        graph = LockGraph(name="autoscaler")
        try:
            with graph.install():
                api = ChaosAPIServer(11, conflict_rate=0.3,
                                     transient_rate=0.1)
                h = Harness(Pkg(False), api=api)
                guard_state(h.autoscaler, graph, name="autoscaler")
                h.reconcile()
                for i, load in enumerate((0.0, 30.0, 75.0, 75.0, 20.0, 5.0,
                                          90.0, 0.0)):
                    h.stamp(load)
                    h.reconcile(float(i + 1))
                assert 1 <= len(h.replicas()) <= h.svc.max_replicas
            graph.assert_clean()
        finally:
            graph.close()
            unguard_all()


class TestTrace:
    @pytest.mark.parametrize("seed", [0, 3, 17])
    def test_the_same_seed_gives_jax_s_curve(self, seed):
        rng = np.random.default_rng(seed)
        kw = dict(seed=seed, period_s=float(rng.uniform(30, 300)),
                  base_users=float(rng.uniform(1e4, 1e6)),
                  requests_per_user_per_s=float(rng.uniform(1e-6, 1e-4)),
                  service_time_s=float(rng.uniform(0.1, 2.0)),
                  burst_rate_per_s=float(rng.uniform(0, 0.2)),
                  burst_multiplier=float(rng.uniform(1, 4)),
                  burst_duration_s=float(rng.uniform(1, 20)),
                  phase_s=float(rng.uniform(0, 100)))
        kw["peak_users"] = kw["base_users"] * float(rng.uniform(1, 10))
        a, b = jax_serving.DiurnalTrace(**kw), port_serving.DiurnalTrace(**kw)
        ts = [float(t) for t in rng.uniform(0, 3600, size=300)]
        assert [a.load_at(t) for t in ts] == [b.load_at(t) for t in ts]
        assert [a.users_at(t) for t in ts] == [b.users_at(t) for t in ts]
        assert [a.burst_multiplier_at(t) for t in ts] == \
            [b.burst_multiplier_at(t) for t in ts]

    def test_swing_bursts_and_validation(self):
        t = port_serving.DiurnalTrace(seed=1, base_users=1e5, peak_users=1e6,
                                      period_s=100.0, burst_rate_per_s=0.0)
        loads = [t.load_at(x) for x in range(100)]
        assert max(loads) > 5 * min(loads) and min(loads) > 0
        for kw in (dict(peak_users=1.0, base_users=2.0),
                   dict(burst_multiplier=0.5), dict(period_s=0.0)):
            with pytest.raises(ValueError):
                port_serving.DiurnalTrace(**kw)
            with pytest.raises(ValueError):
                jax_serving.DiurnalTrace(**kw)


# ---------------------------------------------------------------------------
# The tier end to end, on the MIG stand-in
# ---------------------------------------------------------------------------


class Tier:
    """``tests/test_serving.py``'s clusters on one package: nodes of
    ``units`` carved decode units (the port's 1g.20gb, JAX's stand-in
    1x1), quotas in GB, ``build_scheduler``."""

    def __init__(self, pk: Pkg, monkeypatch, nodes: int = 1,
                 units: int = 4, quotas=(), now=None, budget=None) -> None:
        self.pk = pk
        self.now = now or [0.0]
        self.api = pk.client.APIServer()
        clock = lambda: self.now[0]  # noqa: E731
        if pk.jax:
            from nos_tpu.api.elasticquota import install_quota_webhooks
            from nos_tpu.cmd.assembly import build_scheduler

            serving_twin.jax_serving_weighs_as_the_port(monkeypatch)
            install_quota_webhooks(self.api)
            for i in range(nodes):
                self.api.create("Node", jax_factory.make_tpu_node(
                    f"host-{i}", generation=MIG_GEN, pod_id="pod-0",
                    host_index=i, status_geometry={"free": {"1x1": units}}))
            kw = {} if budget is None else {"preempt_budget_per_cycle":
                                            budget}
            self.sched = build_scheduler(self.api, fleet.SERVING_CHIP_GB,
                                         clock=clock, **kw)
        else:
            from nos_tpu_torch.api.elasticquota import (
                install_quota_webhooks)
            from nos_tpu_torch.cmd.assembly import build_scheduler

            install_quota_webhooks(self.api)
            model = fleet.serving_standin()
            for i in range(nodes):
                self.api.create("Node", port_factory.make_gpu_node(
                    f"host-{i}", model=model, gpus=1,
                    partitioning=C.MIG_KIND, domain="pod-0", host_index=i,
                    status_geometry={0: {"free": {
                        fleet.SERVING_DECODE: units}}}))
            kw = {} if budget is None else {"preempt_budget_per_cycle":
                                            budget}
            self.sched = build_scheduler(self.api, clock=clock, **kw)
        for ns, lo, hi in quotas:
            self.api.create("ElasticQuota", quota(pk, ns, lo, hi))
        self.victims: list = []
        capacity = next(p for p in self.sched._framework.plugins
                        if type(p).__name__ == "CapacityScheduling")
        capacity.on_preempt = lambda pre, vs: self.victims.append(
            (pre.metadata.name, sorted(v.metadata.name for v in vs)))

    def pod(self, name: str, ns: str = "default", tier: str = "",
            capacity: str = "", node: str = "", created: float = 1.0,
            priority: int = 0) -> None:
        C_ = self.pk.C
        labels = {}
        if tier:
            labels[C_.LABEL_TIER] = tier
        if capacity:
            labels[C_.LABEL_CAPACITY] = capacity
        kw = dict(name=name, namespace=ns, labels=labels,
                  creation_timestamp=created, priority=priority,
                  node_name=node, phase="Running" if node else "Pending")
        if self.pk.jax:
            pod = jax_factory.make_slice_pod("1x1", 1, **kw)
        else:
            pod = port_factory.make_mig_pod(fleet.SERVING_DECODE, **kw)
        self.api.create("Pod", pod)

    def bound(self) -> dict:
        return {p.metadata.name: p.spec.node_name
                for p in self.api.list("Pod")}

    def admit(self) -> None:
        """The kubelet with no node agent (``admit_all``): every bound
        Pending pod Running, MIG pods too."""
        for p in self.api.list("Pod", filter_fn=lambda p: (
                p.spec.node_name and p.status.phase == "Pending")):
            self.api.patch("Pod", p.metadata.name, p.metadata.namespace,
                           mutate=lambda q: setattr(q.status, "phase",
                                                    "Running"))

    def close(self) -> None:
        self.sched.close()


def quota(pk: Pkg, ns: str, lo: float, hi: float):
    """An ElasticQuota of ``lo`` to ``hi`` GB in ``ns``, in the package's
    memory resource."""
    if pk.jax:
        from nos_tpu.api.elasticquota import ElasticQuota, ElasticQuotaSpec
        from nos_tpu.kube.objects import ObjectMeta
        mem = JC.RESOURCE_TPU_MEMORY
    else:
        from nos_tpu_torch.api.elasticquota import (
            ElasticQuota, ElasticQuotaSpec)
        from nos_tpu_torch.kube.objects import ObjectMeta
        mem = C.RESOURCE_GPU_MEMORY
    return ElasticQuota(metadata=ObjectMeta(name=ns, namespace=ns),
                        spec=ElasticQuotaSpec(min={mem: lo}, max={mem: hi}))


def tier_story(monkeypatch, story):
    out = {}
    for pk in PKGS:
        with monkeypatch.context() as mp:
            out[pk.name] = story(pk, mp)
    assert out["port"] == out["jax"]
    return out["port"]


class TestTierEndToEnd:
    def test_serving_is_scheduled_first_and_outranks_priority(
            self, monkeypatch):
        def story(pk, mp):
            t = Tier(pk, mp, units=2)
            t.pod("be", tier="best-effort", created=1.0)
            t.pod("batch", created=2.0, priority=100)
            t.pod("serve", tier="serving", created=3.0)
            n = t.sched.run_cycle()
            t.close()
            return n, t.bound()

        n, bound = tier_story(monkeypatch, story)
        assert n == 2 and bound["serve"] and bound["batch"] and not bound["be"]

    def test_a_replica_pod_is_exempt_from_the_quota_head_of_line(
            self, monkeypatch):
        """The pod the autoscaler creates carries the serving tier, so a
        higher-priority claim on its namespace's quota (a gang gathering
        its headroom) defers it in neither package, where the same pod
        without the tier label is deferred."""
        def story(pk, mp):
            t = Tier(pk, mp)
            scaler = pk.S.ReplicaAutoscaler(t.api, [pk.service()])
            scaler.reconcile()
            (replica,) = t.api.list("Pod", namespace="serve")
            t.sched._quota_hol["serve"] = 10
            shielded = t.sched._quota_hol_defers(replica)
            del replica.metadata.labels[pk.C.LABEL_TIER]
            deferred = t.sched._quota_hol_defers(replica)
            t.close()
            return shielded, deferred

        assert tier_story(monkeypatch, story) == (False, True)

    @pytest.mark.parametrize("case", ["reclaim", "shielded", "borrower",
                                      "best-effort-first"])
    def test_serving_is_never_an_in_quota_victim(self, monkeypatch, case):
        g = fleet.SERVING_CHIP_GB

        def story(pk, mp):
            if case == "reclaim":
                t = Tier(pk, mp, units=2, quotas=(("serve", g, 4 * g),
                                                  ("batch", g, 4 * g)))
                t.pod("b0", "batch", capacity="in-quota", node="host-0")
                t.pod("b1", "batch", capacity="over-quota", node="host-0")
                t.pod("replica", "serve", tier="serving", created=2.0)
            elif case == "shielded":
                t = Tier(pk, mp, units=1, quotas=(("team", g / 2, 4 * g),))
                t.pod("replica", "team", tier="serving",
                      capacity="in-quota", node="host-0")
                t.pod("train", "team", created=2.0, priority=100)
            elif case == "borrower":
                t = Tier(pk, mp, units=1, quotas=(("serve", g / 2, 4 * g),
                                                  ("lender", g, 4 * g)))
                t.pod("replica", "serve", tier="serving",
                      capacity="over-quota", node="host-0")
                t.pod("claim", "lender", created=2.0)
            else:
                t = Tier(pk, mp, units=2, quotas=(
                    ("serve", g, 4 * g), ("batch", g / 2, 4 * g),
                    ("scrap", g / 2, 4 * g)))
                t.pod("batchpod", "batch", capacity="over-quota",
                      node="host-0")
                t.pod("scrappod", "scrap", tier="best-effort",
                      capacity="over-quota", node="host-0")
                t.pod("replica", "serve", tier="serving", created=2.0)
            t.sched.run_cycle()
            t.close()
            return t.bound(), t.victims

        bound, victims = tier_story(monkeypatch, story)
        if case == "reclaim":
            assert "b1" not in bound and bound["replica"] == "host-0"
        elif case == "shielded":
            assert "replica" in bound and not bound["train"]
        elif case == "borrower":
            assert "replica" not in bound and bound["claim"] == "host-0"
        else:
            assert "scrappod" not in bound and "batchpod" in bound

    def test_a_burst_scales_up_with_no_serving_victim(self, monkeypatch):
        """``tests/test_serving.py``'s burst: batch soaks 16 carved units
        over quota, a burst scales the service 2 -> 6 replicas through the
        scheduler; every scale-up binds by preempting batch borrowers, no
        serving pod is a victim, and a scavenger claims its namespace's
        one-unit min."""
        g = fleet.SERVING_CHIP_GB

        def story(pk, mp):
            now = [0.0]
            t = Tier(pk, mp, nodes=4, units=4, now=now, budget=4,
                     quotas=(("serve", 6 * g, 8 * g), ("batch", 9 * g,
                                                       16 * g),
                             ("scrap", g, 16 * g)))
            if pk.jax:
                from nos_tpu.controllers.elasticquota.controller import (
                    ElasticQuotaReconciler)
                from nos_tpu.quota import TPUResourceCalculator

                serving_twin.jax_quota_orders_as_the_port(mp)
                rec = ElasticQuotaReconciler(t.api, TPUResourceCalculator(g))
            else:
                from nos_tpu_torch.controllers.elasticquota.controller import (
                    ElasticQuotaReconciler)
                from nos_tpu_torch.quota import GPUResourceCalculator

                rec = ElasticQuotaReconciler(t.api, GPUResourceCalculator())
            svc = pk.service(min_replicas=2, max_replicas=6,
                             target_load_per_replica=8.0,
                             scale_up_cooldown_s=0.0,
                             scale_down_cooldown_s=5.0)
            scaler = pk.S.ReplicaAutoscaler(t.api, [svc],
                                            clock=lambda: now[0])
            for i in range(16):
                t.pod(f"fill-{i}", "batch", created=0.0)
            for i in range(2):
                t.pod(f"scavenge-{i}", "scrap", tier="best-effort",
                      created=0.0)
            seen: dict[str, float] = {}
            for _ in range(60):
                now[0] += 0.05
                load = 40.0 if 1.0 <= now[0] < 2.0 else 10.0
                serve = t.api.list("Pod", namespace="serve")
                for p in serve:
                    t.api.patch("Pod", p.metadata.name, "serve",
                                mutate=lambda q, v=load / max(1, len(serve)):
                                q.metadata.annotations.__setitem__(
                                    pk.C.ANNOT_SERVING_LOAD, str(v)))
                scaler.reconcile()
                t.sched.run_cycle()
                t.admit()
                rec.reconcile_all()
                for p in t.api.list("Pod", namespace="serve"):
                    if p.spec.node_name and p.metadata.name not in seen:
                        seen[p.metadata.name] = \
                            now[0] - p.metadata.creation_timestamp
            t.close()
            return t.bound(), t.victims, seen

        bound, victims, seen = tier_story(monkeypatch, story)
        assert victims and not [v for _, vs in victims for v in vs
                                if v.startswith("chat-")]
        assert len(seen) >= 5 and max(seen.values()) <= 0.101
        # a scavenger claims its namespace's one-unit min from a batch
        # borrower, the other waits for capacity the burst's end frees
        assert any(pre.startswith("scavenge-") for pre, _ in victims)


# ---------------------------------------------------------------------------
# The router-off serving fleet
# ---------------------------------------------------------------------------


class TestQuotaOrder:
    def test_jax_s_tie_order_differs_from_the_port_s_without_the_patch(
            self, monkeypatch):
        """Two best-effort fillers created at one instant, a decode unit
        and an 8 GB share, in a namespace whose min holds one of them:
        unpatched, JAX marks the unit in quota, the port the share;
        ``jax_quota_orders_as_the_port`` makes JAX mark the share."""
        from nos_tpu.controllers.elasticquota.controller import (
            ElasticQuotaReconciler as JaxRec)
        from nos_tpu.quota import TPUResourceCalculator

        from nos_tpu_torch.controllers.elasticquota.controller import (
            ElasticQuotaReconciler)
        from nos_tpu_torch.quota import GPUResourceCalculator

        def run(pk) -> dict:
            api = pk.client.APIServer()
            if pk.jax:
                unit = jax_factory.make_slice_pod(
                    "1x1", 1, name="unit", namespace="be", node_name="h",
                    phase="Running", creation_timestamp=5.0)
                share = jax_factory.make_timeshare_pod(
                    8, 1, name="share", namespace="be", node_name="h",
                    phase="Running", creation_timestamp=5.0)
                rec = JaxRec(api, TPUResourceCalculator(fleet.SERVING_CHIP_GB))
            else:
                unit = port_factory.make_mig_pod(
                    fleet.SERVING_DECODE, name="unit", namespace="be",
                    node_name="h", phase="Running", creation_timestamp=5.0)
                share = port_factory.make_timeshare_pod(
                    8, name="share", namespace="be", node_name="h",
                    phase="Running", creation_timestamp=5.0)
                rec = ElasticQuotaReconciler(api, GPUResourceCalculator())
            api.create("ElasticQuota", quota(pk, "be", 20.0, 200.0))
            api.create("Pod", unit)
            api.create("Pod", share)
            rec.reconcile_all()
            return {p.metadata.name: p.metadata.labels.get(
                pk.C.LABEL_CAPACITY) for p in api.list("Pod")}

        jax_pk, port_pk = PKGS
        assert run(jax_pk) == {"unit": "in-quota", "share": "over-quota"}
        assert run(port_pk) == {"unit": "over-quota", "share": "in-quota"}
        serving_twin.jax_quota_orders_as_the_port(monkeypatch)
        assert run(jax_pk) == run(port_pk)


class TestServingFleet:
    def test_the_jax_run_hashes_to_the_pinned_digest(self, monkeypatch):
        """bench_serving.py's run, mapped (router off), on the JAX
        package: its summary is ``SERVING_FLEET_DIGEST``; the invariants
        it meets are the ones the smoke holds."""
        import chip_smoke

        out = serving_twin.jax_serving_run(
            monkeypatch, fleet.serving_fleet_spec(0))
        assert fleet.plan_digest(out["summary"]) == \
            chip_smoke.SERVING_FLEET_DIGEST
        assert chip_smoke.serving_invariants(out) == \
            chip_smoke.SERVING_FLEET_MET
        assert out["serving"]["preempted"] == 0

    def test_the_port_s_run_is_jax_s_and_conserves(self):
        """The smoke's router-off run on the port: the same digest, every
        held invariant met, the waste waterfall conserved."""
        import chip_smoke

        line = chip_smoke._serving_fleet_runs(router=False, runs=1)
        assert line["digest"] == chip_smoke.SERVING_FLEET_DIGEST
        assert line["invariants"] == chip_smoke.SERVING_FLEET_MET
        assert all(abs(d) <= 1e-6
                   for d in line["waste"]["conservation_delta"].values())

    def test_the_spec_keeps_the_bench_s_mix(self):
        import bench_serving as bs

        spec = fleet.serving_fleet_spec(0)
        assert fleet.SERVING_TOTAL_UNITS == bs.TOTAL_CHIPS
        assert sum(q["min_gb"] for q in spec["quotas"]) == \
            fleet.SERVING_MIG_NODES * 80 + fleet.SERVING_MPS_NODES \
            * fleet.SERVING_MPS_GPUS * 80
        for (ns, lo, hi), (bns, q) in zip(fleet.SERVING_QUOTAS,
                                          bs.QUOTAS.items()):
            assert ns == bns and (lo, hi) == (q["min"] / bs.HBM_GB,
                                              q["max"] / bs.HBM_GB)
        for port, jax in zip(spec["autoscaled"], bs.SERVICES):
            jax_view = serving_twin.jax_service(port)
            for key, value in jax_view.items():
                assert getattr(jax, key) == value, key
        assert (fleet.SERVING_TICK_S, fleet.SERVING_BATCH_IDLE_S,
                fleet.SERVING_BATCH_TIMEOUT_S,
                fleet.SERVING_STAMP_EVERY_TICKS) == (
            bs.TICK_S, bs.BATCH_IDLE_S, bs.BATCH_TIMEOUT_S,
            bs.STAMP_EVERY_TICKS)
        assert (fleet.SERVING_BATCH_TARGET, fleet.SERVING_BE_TARGET,
                fleet.SERVING_BE_TS_TARGET) == (
            bs.BATCH_TARGET_CHIPS, bs.BESTEFFORT_TARGET,
            bs.BESTEFFORT_TS_TARGET)
        assert fleet.SERVING_DURATION_S == bs.DURATION_S
        for key, kw in fleet.serving_traces(0, False).items():
            assert vars(bs.make_traces(0)[key]) == vars(
                jax_serving.DiurnalTrace(**kw))
        assert fleet.SERVING_TRACE_S < bs.TRACE_S and \
            math.isclose(fleet.SERVING_P99_TARGET_S, bs.SERVING_P99_TARGET_S)
