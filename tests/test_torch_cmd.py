"""The port's mains held to the JAX package's (``nos_tpu_torch/cmd/``,
``api/config.py``, ``kube/client.Informer``, ``exporter.collect``,
``testing/lockcheck.py``):

- every case of ``tests/test_cmd.py``'s TestConfig and
  TestConfigVersioning on both packages, the renamed fields mapped
  (``tpu_memory_gb_per_chip`` -> ``gpu_memory_gb_per_gpu``,
  ``generation`` -> ``model``, the kinds ``slice``/``timeshare`` ->
  ``mig``/``mps``): equal objects or the same error class; a knob of a
  plane the port lacks, away from JAX's default, is a ConfigError naming
  its ROADMAP item (one case per item);
- the Informer on the same event sequence, in memory and over the REST
  stub (``tests/k8s_stub.py``);
- each main's assembly beside JAX's on twin in-memory clusters: the
  controllers bound and the knobs passed per partitioning kind, binding
  only on gaining the lease, the operator's resync, the agents' node
  rules, the kubelet paths over a kubeconfig (the device-plugin
  managers where the plugin directory exists, a warning where it does
  not, the pod-resources client or JAX's refusal without its socket),
  ``collect``'s payload and the exporter's exits;
- ``tests/test_cmd.py``'s TestProcessModelEndToEnd: the threaded control
  plane converges for ``mps`` and ``mig`` under this module's
  ``lock_discipline`` (the port's ``LockGraph``), and the ``--sim`` demo
  converges;
- the port's ``LockGraph`` convicts and acquits what JAX's does;
- chip_smoke.py's phase 14 topology (two partitioners, a scheduler, an
  operator and a chip agent as processes against the stub) writes
  ``MAINS_LOOP_WRITES``, and so do the JAX package's mains on the same
  story over a stub of their own.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import tempfile
import threading
import time

import pytest

import nos_tpu.api.config as jconfig
import nos_tpu_torch.api.config as pconfig
from nos_tpu_torch.api import constants as C

# -- the lock discipline ------------------------------------------------------


@pytest.fixture
def lock_discipline():
    """Every threading.Lock/RLock built while the test runs is checked by
    the port's LockGraph; an inversion or an unguarded write fails the
    test at teardown."""
    from nos_tpu_torch.testing.lockcheck import LockGraph, unguard_all

    graph = LockGraph(name="lock-discipline")
    with graph.install():
        yield graph
    try:
        graph.assert_clean()
    finally:
        graph.close()
        unguard_all()


# -- configs ------------------------------------------------------------------

# JAX field -> (port field, {JAX value: port value})
RENAMED = {
    "tpu_memory_gb_per_chip": ("gpu_memory_gb_per_gpu", {16: 80}),
    "generation": ("model", {"tpu-v5e": "nvidia-h100-80gb-hbm3"}),
    "kind": ("kind", {"slice": "mig", "timeshare": "mps"}),
    "device_plugin_cm_name": ("device_plugin_cm_name", {
        "nos-tpu-device-plugin-config": "nos-device-plugin-configs"}),
    "device_plugin_cm_namespace": ("device_plugin_cm_namespace", {
        "nos-tpu-system": "nebuly-nos"}),
}
TEXT_RENAMES = (("tpu_memory_gb_per_chip", "gpu_memory_gb_per_gpu"),)


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
            if f.init}


def _mapped(jax_obj) -> dict:
    out = {}
    for name, value in _fields(jax_obj).items():
        port_name, values = RENAMED.get(name, (name, {}))
        out[port_name] = values.get(value, value)
    return out


def _load(pkg, text, cls_name, tmp_path, validate=True, node=None):
    p = tmp_path / "cfg.yaml"
    if text is None:
        p = None
    else:
        if pkg is pconfig:
            for a, b in TEXT_RENAMES:
                text = text.replace(a, b)
        p.write_text(text)
    if cls_name == "AgentConfig":
        return pkg.load_agent_config(p, node)
    return pkg.load_config(p, getattr(pkg, cls_name), validate=validate)


def _outcome(pkg, text, cls_name, tmp_path, **kw):
    try:
        return "ok", _load(pkg, text, cls_name, tmp_path, **kw)
    except Exception as e:  # noqa: BLE001 — the class is compared
        return type(e).__name__, e


# (case id, config class, file text or None, the port's refusal: a
# ROADMAP item the loaded knobs belong to, else None)
CONFIG_CASES = [
    ("defaults-partitioner", "PartitionerConfig", None, None),
    ("defaults-scheduler", "SchedulerConfig", None, None),
    ("defaults-operator", "OperatorConfig", None, None),
    ("yaml-round-trip", "PartitionerConfig",
     "kind: hybrid\nbatch_timeout_s: 5\nbatch_idle_s: 1\n", None),
    ("json-accepted", "SchedulerConfig",
     json.dumps({"tpu_memory_gb_per_chip": 32}), None),
    ("v1beta2-nested-drain-block", "SchedulerConfig",
     "apiVersion: nos.tpu/v1beta2\ndrain_preemption:\n  after_cycles: 40\n"
     "  max_busy_fraction: 0.3\n  spare_progress: 0.6\n", "7.2"),
    ("v1beta1-flat-keys-convert", "SchedulerConfig",
     "apiVersion: nos.tpu/v1beta1\ndrain_preempt_after_cycles: 25\n"
     "drain_preempt_max_busy_fraction: 0.4\n", "7.2"),
    ("unversioned-loads-as-v1beta1", "SchedulerConfig",
     "drain_preempt_after_cycles: 10\n", "7.2"),
    ("unknown-version", "SchedulerConfig", "apiVersion: nos.tpu/v9\n",
     None),
    ("mixed-forms", "SchedulerConfig",
     "apiVersion: nos.tpu/v1beta1\ndrain_preempt_after_cycles: 10\n"
     "drain_preemption:\n  after_cycles: 20\n", None),
    ("unknown-nested-key", "SchedulerConfig",
     "apiVersion: nos.tpu/v1beta2\ndrain_preemption:\n  banana: 1\n", None),
    ("version-partitioner", "PartitionerConfig",
     "apiVersion: nos.tpu/v1beta2\n", None),
    ("version-operator", "OperatorConfig", "apiVersion: nos.tpu/v1beta2\n",
     None),
    ("partitioner-kind-banana", "PartitionerConfig", "kind: banana", None),
    ("partitioner-idle-over-timeout", "PartitionerConfig",
     "batch_idle_s: 10\nbatch_timeout_s: 2", None),
    ("partitioner-negative-timeout", "PartitionerConfig",
     "batch_timeout_s: -1", None),
    ("partitioner-unknown-key", "PartitionerConfig", "frobnicate: 1", None),
    ("partitioner-addr-nocolon", "PartitionerConfig",
     "health_probe_addr: nocolon", None),
    ("partitioner-missing-geometries", "PartitionerConfig",
     "known_geometries_file: /nope/missing.json", None),
    ("string-for-float", "PartitionerConfig", "batch_timeout_s: 'two'\n",
     None),
    ("string-for-int", "SchedulerConfig", "tpu_memory_gb_per_chip: '32'\n",
     None),
    ("string-for-bool", "OperatorConfig", "leader_election: 'yes'\n", None),
    ("bool-for-int", "SchedulerConfig", "tpu_memory_gb_per_chip: true\n",
     None),
    ("yaml-bare-key", "PartitionerConfig",
     "metrics_addr:\nbatch_timeout_s: 3\n", None),
    ("agent-node-override", "AgentConfig", "report_interval_s: 5\n", None),
]


class TestConfigParity:
    @pytest.mark.parametrize("case", CONFIG_CASES, ids=[c[0] for c in
                                                        CONFIG_CASES])
    def test_loads_as_jax(self, case, tmp_path, caplog):
        """The same file on both packages: equal objects, or the same
        error class; where the port refuses a knob of a plane it lacks,
        the unchecked load agrees and the checked one names the item."""
        _, cls_name, text, refused = case
        node = "host-7" if cls_name == "AgentConfig" else None
        with caplog.at_level(logging.INFO):
            jax = _outcome(jconfig, text, cls_name, tmp_path, node=node)
            jlogs = [r.getMessage() for r in caplog.records
                     if r.name == "nos_tpu.api.config"]
            caplog.clear()
            port = _outcome(pconfig, text, cls_name, tmp_path, node=node)
            plogs = [r.getMessage() for r in caplog.records
                     if r.name == "nos_tpu_torch.api.config"]
        assert [m.replace("'", "") for m in plogs] == \
            [m.replace("'", "") for m in jlogs]
        if refused is None:
            assert port[0] == jax[0], (port, jax)
            if jax[0] == "ok":
                assert _fields(port[1]) == _mapped(jax[1])
            return
        assert jax[0] == "ok"
        assert port[0] == "ConfigError"
        assert f"ROADMAP item {refused}" in str(port[1])
        unchecked = _load(pconfig, text, cls_name, tmp_path, validate=False)
        assert _fields(unchecked) == _mapped(jax[1])

    def test_agent_requires_node_name(self):
        for pkg in (jconfig, pconfig):
            with pytest.raises(pkg.ConfigError, match="node_name"):
                pkg.AgentConfig().validate()

    def test_node_override_applies_before_validation(self, tmp_path):
        for pkg in (jconfig, pconfig):
            p = tmp_path / "agent.yaml"
            p.write_text("report_interval_s: 5\n")
            cfg = pkg.load_agent_config(p, "host-7")
            assert (cfg.node_name, cfg.report_interval_s) == ("host-7", 5.0)
            with pytest.raises(pkg.ConfigError, match="node_name"):
                pkg.load_agent_config(p, None)

    def test_geometry_override_file_accepted(self, tmp_path):
        f = tmp_path / "geo.json"
        f.write_text("{}")
        for pkg in (jconfig, pconfig):
            cfg = pkg.load_config(None, pkg.PartitionerConfig)
            cfg.known_geometries_file = str(f)
            cfg.validate()

    def test_port_kind_names(self, tmp_path):
        for kind in ("mig", "mps", "hybrid"):
            p = tmp_path / "p.yaml"
            p.write_text(f"kind: {kind}\n")
            assert pconfig.load_config(p, pconfig.PartitionerConfig).kind \
                == kind
        p.write_text("kind: slice\n")
        with pytest.raises(pconfig.ConfigError, match="mig|mps|hybrid"):
            pconfig.load_config(p, pconfig.PartitionerConfig)

    @pytest.mark.parametrize("cls_name,func", [
        ("SchedulerConfig", "_scheduler_from_v1beta1"),
        ("SchedulerConfig", "_scheduler_decode")])
    @pytest.mark.parametrize("raw", [
        {}, {"drain_preempt_after_cycles": 3},
        {"drain_preemption": {"after_cycles": 4, "spare_progress": 0.5}},
        {"drain_preempt_after_cycles": 3,
         "drain_preemption": {"after_cycles": 4}},
        {"drain_preemption": {"banana": 1}},
        {"drain_preemption": 7}])
    def test_the_converters_match_jax(self, cls_name, func, raw):
        out = []
        for pkg in (jconfig, pconfig):
            try:
                out.append(("ok", getattr(pkg, func)(dict(raw))))
            except pkg.ConfigError as e:
                out.append(("ConfigError", str(e)))
        assert out[0] == out[1]


# One case per ROADMAP item whose plane the port lacks: the knob away from
# JAX's default loads on JAX and is refused by the port naming the item.
# An item of None is a plane the port has now (the SLO engine, the
# defragmenter, elastic growth): the knob away from the default loads on
# both, to JAX's value.
REFUSED = [
    ("PartitionerConfig", "defrag_enabled: true\n", None),
    ("PartitionerConfig", "defrag_interval_s: 30\n", None),
    ("SchedulerConfig", "drain_preempt_spare_progress: 0.5\n", "7.2"),
    ("SchedulerConfig", "shard_chips_per_host: 8\n", "7.2"),
    ("OperatorConfig", "shard_chips_per_host: 8\n", "7.2"),
    ("SchedulerConfig", "elastic_grow_budget_per_cycle: 2\n", None),
    ("PartitionerConfig", "slo_interval_s: 2.5\n", None),
    ("SchedulerConfig", "slo_interval_s: 0.5\n", None),
]


class TestRefusedKnobs:
    @pytest.mark.parametrize("cls_name,text,item", REFUSED,
                             ids=[f"{c}-{t.split(':')[0]}"
                                  for c, t, _ in REFUSED])
    def test_away_from_the_default_names_the_item(self, cls_name, text,
                                                  item, tmp_path):
        p = tmp_path / "c.yaml"
        p.write_text("apiVersion: nos.tpu/v1beta2\n" + text)
        want = jconfig.load_config(p, getattr(jconfig, cls_name))
        if item is None:
            got = pconfig.load_config(p, getattr(pconfig, cls_name))
            knob = text.split(":")[0]
            value = getattr(want, knob)
            assert value != getattr(getattr(jconfig, cls_name)(), knob)
            assert getattr(got, knob) == value
            assert not any(knob in line
                           for line in pconfig.missing_planes(got))
            return
        with pytest.raises(pconfig.ConfigError,
                           match=f"ROADMAP item {item}"):
            pconfig.load_config(p, getattr(pconfig, cls_name))

    @pytest.mark.parametrize("text,err", [
        ("defrag_payback_min: 0\n", "defrag_payback_min must be positive"),
        ("defrag_drain_timeout_s: -1\n", "must be positive")])
    def test_jax_checks_come_first(self, text, err, tmp_path):
        p = tmp_path / "c.yaml"
        p.write_text(text)
        for pkg in (jconfig, pconfig):
            with pytest.raises(pkg.ConfigError, match=err):
                pkg.load_config(p, pkg.PartitionerConfig)

    def test_slo_off_is_accepted_quietly(self):
        cfg = pconfig.PartitionerConfig(slo_interval_s=0.0)
        cfg.validate()
        assert not any("SLO" in line
                       for line in pconfig.missing_planes(cfg))

    @pytest.mark.parametrize("main", ["partitioner", "scheduler",
                                      "operator"])
    def test_the_defaults_are_logged_once_naming_the_items(self, main,
                                                           caplog):
        from nos_tpu_torch.cmd import assembly, operator, scheduler
        from nos_tpu_torch.kube.client import APIServer
        from nos_tpu_torch.partitioning.state import ClusterState

        api = APIServer()
        with caplog.at_level(logging.INFO,
                             logger="nos_tpu_torch.cmd.assembly"):
            if main == "partitioner":
                assembly.build_partitioner_main(
                    api, ClusterState(), pconfig.PartitionerConfig())
                want = []
            elif main == "scheduler":
                scheduler.build_scheduler_main(api, pconfig.SchedulerConfig())
                want = ["ROADMAP item 7.2", "ROADMAP item 7.2"]
            else:
                operator.build_operator_main(api, pconfig.OperatorConfig())
                want = ["ROADMAP item 7.2"]
        got = [m for r in caplog.records for m in [r.getMessage()]
               if "ROADMAP item" in m]
        assert [w for w in want if any(w in g for g in got)] == want
        assert len(got) == len(want)


# -- the informer ---------------------------------------------------------------


def _drive_events(api, kind_pod, make_pod):
    """Create a, b, c; relabel a; delete b."""
    for name in ("a", "b", "c"):
        api.create(kind_pod, make_pod(name))

    def relabel(p):
        p.metadata.labels["x"] = "y"

    api.patch(kind_pod, "a", "default", mutate=relabel)
    api.delete(kind_pod, "b", "default")


def _informer_view(informer) -> dict:
    return {k: (o.metadata.name, dict(o.metadata.labels))
            for k, o in sorted(informer.items().items())}


class TestInformer:
    @pytest.mark.parametrize("store", [True, False],
                             ids=["store", "no-store"])
    def test_matches_jax_in_memory(self, store):
        from nos_tpu.kube import client as jc
        from nos_tpu.testing.factory import make_pod as jmake
        from nos_tpu_torch.kube import client as pc
        from nos_tpu_torch.testing.factory import make_pod as pmake

        views = []
        for client, make in ((jc, jmake), (pc, pmake)):
            api = client.APIServer()
            api.create(client.KIND_POD, make("pre"))
            events = []
            inf = client.Informer(api, client.KIND_POD, store=store,
                                  on_event=lambda e, o: events.append(
                                      (e, o.metadata.name)))
            _drive_events(api, client.KIND_POD, lambda n: make(n))
            views.append((_informer_view(inf), len(inf), events,
                          inf.get("default/a") is not None))
            inf.close()
            api.create(client.KIND_POD, make("after-close"))
            assert len(events) == len(views[-1][2])
        assert views[0] == views[1]

    def test_over_the_stub(self):
        """The informer over KubeClient's watch: the same final store and
        an ADDED replay; the stream lands in order, polled for."""
        from k8s_stub import StubApiServer
        from nos_tpu.kube import client as jc
        from nos_tpu.testing.factory import make_pod as jmake
        from nos_tpu_torch.kube import client as pc
        from nos_tpu_torch.kube.rest import KubeClient, KubeConfig
        from nos_tpu_torch.testing.factory import make_pod as pmake

        japi = jc.APIServer()
        japi.create(jc.KIND_POD, jmake("pre"))
        jinf = jc.Informer(japi, jc.KIND_POD)
        _drive_events(japi, jc.KIND_POD, jmake)
        want = _informer_view(jinf)
        with StubApiServer() as stub:
            client = KubeClient(KubeConfig(server=stub.url))
            try:
                client.create(pc.KIND_POD, pmake("pre"))
                events = []
                inf = pc.Informer(client, pc.KIND_POD, on_event=lambda e, o:
                                  events.append((e, o.metadata.name)))
                assert events == [("ADDED", "pre")]
                _drive_events(client, pc.KIND_POD, pmake)
                deadline = time.monotonic() + 10.0
                while _informer_view(inf) != want \
                        and time.monotonic() < deadline:
                    time.sleep(0.02)
                assert _informer_view(inf) == want
                inf.close()
            finally:
                client.close()

    def test_guarded_store(self):
        from nos_tpu_torch.kube.client import Informer

        assert Informer.__guarded_by__ == {"_store": "_lock"}


# -- the assembly --------------------------------------------------------------

KINDS = [("mig", "slice"), ("mps", "timeshare"), ("hybrid", "hybrid")]


def _controller_view(ctl) -> dict:
    return {"plan_deadline_s": ctl._plan_deadline_s,
            "rescan_interval_s": ctl._rescan_interval_s,
            "replan_epoch_s": ctl._replan_epoch_s,
            "batch": (ctl._batcher.timeout_s, ctl._batcher.idle_s),
            "recovery": ctl._recovery is not None}


@contextlib.contextmanager
def _pod_resources_stub():
    """A kubelet PodResourcesLister stub on a unix socket in a short
    temporary directory (a socket's path is capped at 107 bytes): one
    pod holding one MIG device."""
    import concurrent.futures

    import grpc

    from nos_tpu_torch.device.podresources import podresources_pb2 as pb

    resp = pb.ListPodResourcesResponse(pod_resources=[pb.PodResources(
        name="w", namespace="default", containers=[pb.ContainerResources(
            name="c", devices=[pb.ContainerDevices(
                resource_name="nvidia.com/mig-3g.40gb",
                device_ids=["MIG-aaaaaaaa-0000-4000-8000-000000000001"])])])])
    server = grpc.server(concurrent.futures.ThreadPoolExecutor(max_workers=2))
    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
        "v1.PodResourcesLister",
        {"List": grpc.unary_unary_rpc_method_handler(
            lambda req, ctx: resp,
            request_deserializer=pb.ListPodResourcesRequest.FromString,
            response_serializer=pb.ListPodResourcesResponse
            .SerializeToString)}),))
    with tempfile.TemporaryDirectory(prefix="pr") as d:
        sock = f"{d}/kubelet.sock"
        server.add_insecure_port(f"unix://{sock}")
        server.start()
        try:
            yield sock
        finally:
            server.stop(0)


def _loops(main) -> list:
    return sorted((loop.name, loop._interval) for loop in main._loops)


LOOP_NAMES = {"partitioner-slice": "partitioner-mig",
              "partitioner-timeshare": "partitioner-mps"}


class TestPartitionerMain:
    @pytest.mark.parametrize("kinds", KINDS, ids=[k[0] for k in KINDS])
    @pytest.mark.parametrize("knobs", [
        {}, {"plan_deadline_s": 6.0, "replan_epoch_s": 1.5},
        {"node_suspect_after_s": 3.0, "migrate_grace_s": 2.0,
         "poll_interval_s": 0.2}], ids=["defaults", "timing", "recovery"])
    def test_binds_the_kinds_controllers_with_every_knob(self, kinds, knobs):
        from nos_tpu.cmd.assembly import build_partitioner_main as jbuild
        from nos_tpu.partitioning.state import ClusterState as JState
        from nos_tpu_torch.cmd.assembly import build_partitioner_main
        from nos_tpu_torch.kube.client import APIServer
        from nos_tpu_torch.partitioning.state import ClusterState

        from nos_tpu.kube.client import APIServer as JaxAPIServer

        port_kind, jax_kind = kinds
        kw = dict(batch_timeout_s=2.0, batch_idle_s=0.5, **knobs)
        pmain, pctl = build_partitioner_main(
            APIServer(), ClusterState(),
            pconfig.PartitionerConfig(kind=port_kind, **kw))
        jmain, jctl = jbuild(JaxAPIServer(), JState(),
                             jconfig.PartitionerConfig(kind=jax_kind, **kw))
        assert [_controller_view(c) for c in pctl] == \
            [_controller_view(c) for c in jctl]
        assert _loops(pmain) == sorted((LOOP_NAMES.get(n, n), i)
                                       for n, i in _loops(jmain))
        assert [c._kind for c in pctl] == [
            {"slice": C.MIG_KIND, "timeshare": C.MPS_KIND}[c._kind]
            for c in jctl]

    def test_binds_only_on_gaining_the_lease(self):
        """With leader election nothing is bound until the lease is
        held; the lease goes at shutdown (deadline 0)."""
        from nos_tpu.cmd.assembly import build_partitioner_main as jbuild
        from nos_tpu.kube.client import APIServer as JaxAPIServer
        from nos_tpu.kube.client import KIND_CONFIGMAP as JCM
        from nos_tpu.partitioning.state import ClusterState as JState
        from nos_tpu_torch.cmd.assembly import build_partitioner_main
        from nos_tpu_torch.kube.client import APIServer, KIND_CONFIGMAP
        from nos_tpu_torch.kube.leaderelection import ANN_DEADLINE
        from nos_tpu_torch.partitioning.state import ClusterState

        from nos_tpu.kube.leaderelection import ANN_DEADLINE as JDEADLINE

        seen = []
        # the port's shutdown waits for the elector's release; JAX's
        # returns before its elector thread has released, so its lease is
        # read once that thread's patch has landed
        for build, api, state, cfg, cm, deadline, settle_s in (
                (build_partitioner_main, APIServer(), ClusterState(),
                 pconfig.PartitionerConfig(kind="mps", leader_election=True),
                 KIND_CONFIGMAP, ANN_DEADLINE, 0.0),
                (jbuild, JaxAPIServer(), JState(),
                 jconfig.PartitionerConfig(kind="timeshare",
                                           leader_election=True),
                 JCM, JDEADLINE, 5.0)):
            main, controllers = build(api, state, cfg)
            before = (len(controllers), len(main._loops),
                      api.try_get(cm, "nos-tpu-partitioner-leader",
                                  "nos-tpu-system") is None)
            main.start()
            try:
                assert main._elector.is_leader.wait(5.0)
                t0 = time.monotonic()
                while not main._loops and time.monotonic() - t0 < 5:
                    time.sleep(0.01)
                after = (len(controllers),
                         [LOOP_NAMES.get(n, n) for n, _ in _loops(main)])
            finally:
                main.shutdown()

            def released():
                return api.get(cm, "nos-tpu-partitioner-leader",
                               "nos-tpu-system").metadata.annotations[deadline]

            t0 = time.monotonic()
            while released() != "0" and time.monotonic() - t0 < settle_s:
                time.sleep(0.01)
            seen.append((before, after, released()))
        assert seen[0] == seen[1]
        assert seen[0] == ((0, 0, True), (1, ["partitioner-mps"]), "0")


    def test_known_geometries_file_restricts_the_registry(self, tmp_path,
                                                          monkeypatch):
        """known_geometries_file reaches GpuModelRegistry.load_overrides
        before the controllers are built, as JAX's reaches its
        registry."""
        from nos_tpu_torch.cmd.assembly import build_partitioner_main
        from nos_tpu_torch.kube.client import APIServer
        from nos_tpu_torch.partitioning.state import ClusterState
        from nos_tpu_torch.topology import DEFAULT_REGISTRY, H100_80GB

        monkeypatch.setattr(DEFAULT_REGISTRY, "models",
                            dict(DEFAULT_REGISTRY.models))
        f = tmp_path / "geometries.json"
        f.write_text(json.dumps({H100_80GB.name: {
            "mig_profiles": ["1g.10gb", "7g.80gb"]}}))
        build_partitioner_main(APIServer(), ClusterState(),
                               pconfig.PartitionerConfig(
                                   known_geometries_file=str(f)))
        assert DEFAULT_REGISTRY.get(H100_80GB.name).profile_names() == [
            "1g.10gb", "7g.80gb"]


class TestSchedulerMain:
    @pytest.mark.parametrize("knobs", [
        {}, {"preempt_budget_per_cycle": 5, "displaced_age_cap_s": 12.0,
             "cycle_interval_s": 0.2}], ids=["defaults", "knobs"])
    def test_passes_the_knobs(self, knobs):
        from nos_tpu.kube.client import APIServer as JaxAPIServer
        from nos_tpu_torch.cmd.scheduler import build_scheduler_main
        from nos_tpu_torch.kube.client import APIServer

        main = build_scheduler_main(APIServer(),
                                    pconfig.SchedulerConfig(**knobs))
        sched = main.scheduler
        jcfg = jconfig.SchedulerConfig(**knobs)
        from nos_tpu.cmd.assembly import build_scheduler as jbuild

        jsched = jbuild(JaxAPIServer(), jcfg.tpu_memory_gb_per_chip,
                        preempt_budget_per_cycle=jcfg.preempt_budget_per_cycle,
                        displaced_age_cap_s=jcfg.displaced_age_cap_s)
        assert (sched._preempt_budget_per_cycle,
                sched._displaced_age_cap_s) == (
            jsched._preempt_budget_per_cycle, jsched._displaced_age_cap_s)
        assert _loops(main) == [("scheduler", jcfg.cycle_interval_s)]
        assert sched._capacity.calculator.gb_per_gpu == 80
        sched.close()

    def test_the_loop_waits_for_the_lease(self):
        from nos_tpu_torch.cmd.scheduler import build_scheduler_main
        from nos_tpu_torch.kube.client import APIServer

        main = build_scheduler_main(APIServer(), pconfig.SchedulerConfig(
            leader_election=True))
        assert main._elector is not None
        assert all(loop._gate is main._elector.is_leader
                   for loop in main._loops)
        main.scheduler.close()


class TestOperatorMain:
    def test_binds_the_reconcilers_and_resyncs(self, monkeypatch):
        """Both mains bind both reconcilers (the watch replay reconciles
        the quota at once) and add the resync loop, which runs
        reconcile_all on each."""
        from nos_tpu.api.config import OperatorConfig as JaxOperatorConfig
        from nos_tpu.cmd import operator as joperator
        from nos_tpu.controllers import elasticquota as jeqc
        from nos_tpu.kube.client import APIServer as JaxAPIServer
        from nos_tpu_torch.cmd import operator as poperator
        from nos_tpu_torch.controllers import elasticquota as peqc
        from nos_tpu_torch.kube.client import APIServer

        seen = []
        for operator, eqc, api, cfg_cls in (
                (poperator, peqc, APIServer(), pconfig.OperatorConfig),
                (joperator, jeqc, JaxAPIServer(), JaxOperatorConfig)):
            calls = {"eq": 0, "ceq": 0}
            for cls, key in ((eqc.ElasticQuotaReconciler, "eq"),
                             (eqc.CompositeElasticQuotaReconciler, "ceq")):
                real = cls.reconcile_all

                def counted(self, real=real, key=key):
                    calls[key] += 1
                    return real(self)

                monkeypatch.setattr(cls, "reconcile_all", counted)
            main = operator.build_operator_main(
                api, cfg_cls(resync_interval_s=0.02))
            loops = _loops(main)
            main.start()
            try:
                t0 = time.monotonic()
                while min(calls.values()) < 3 and time.monotonic() - t0 < 5:
                    time.sleep(0.01)
            finally:
                main.shutdown()
            seen.append((loops, min(calls.values()) >= 3))
        assert seen[0] == seen[1] == ([("quota-resync", 0.02)], True)

    def test_a_lease_gates_the_reconcilers(self):
        from nos_tpu_torch.cmd.operator import build_operator_main
        from nos_tpu_torch.kube.client import APIServer

        main = build_operator_main(APIServer(), pconfig.OperatorConfig(
            leader_election=True))
        assert main._loops == [] and main._elector is not None


@pytest.fixture
def stub_client():
    from k8s_stub import StubApiServer
    from nos_tpu_torch.kube.rest import KubeClient, KubeConfig

    with StubApiServer() as stub:
        client = KubeClient(KubeConfig(server=stub.url))
        try:
            yield stub, client
        finally:
            client.close()


def _observed_port(gpus: int = 4):
    from nos_tpu_torch.device import discovery
    from nos_tpu_torch.topology import H100_80GB

    return discovery.DiscoveredTopology(
        model=H100_80GB, num_local_gpus=gpus, num_hosts=1,
        source=discovery.SOURCE_ENV, product_name="NVIDIA H100 80GB HBM3")


def _observed_jax():
    from nos_tpu.device import discovery
    from nos_tpu.topology import Shape, V5E

    return discovery.DiscoveredTopology(
        generation=V5E, host_block=Shape((2, 2)), num_local_chips=4,
        num_hosts=1, source=discovery.SOURCE_ENV,
        accelerator_type="v5litepod-4", origin=(0, 0))


class TestAgentMains:
    @pytest.mark.parametrize("model", ["auto", "named"])
    def test_chipagent_registers_its_node_in_memory(self, model,
                                                    monkeypatch):
        """In memory the agent registers its node: with model auto the
        GPUs discovery observed (JAX: the observed chips), else the
        model's default count; partitioning mps (JAX: timeshare)."""
        from nos_tpu.api import constants as JC
        from nos_tpu.cmd.chipagent import build_chipagent_main as jbuild
        from nos_tpu.device import discovery as jdisc
        from nos_tpu.kube.client import APIServer as JaxAPIServer
        from nos_tpu_torch.cmd.chipagent import build_chipagent_main
        from nos_tpu_torch.device import discovery as pdisc
        from nos_tpu_torch.kube.client import APIServer, KIND_NODE

        monkeypatch.setattr(jdisc, "discover",
                            lambda *a, **k: _observed_jax())
        asked = []

        def port_discover(*a, **k):
            asked.append(k.get("allow_cuda"))
            return _observed_port()

        monkeypatch.setattr(pdisc, "discover", port_discover)
        api, japi = APIServer(), JaxAPIServer()
        auto = model == "auto"
        main = build_chipagent_main(api, pconfig.AgentConfig(
            node_name="ts-0", model="auto" if auto else
            "nvidia-h100-80gb-hbm3", heartbeat=True))
        jbuild(japi, jconfig.AgentConfig(
            node_name="ts-0", generation="auto" if auto else "tpu-v5e"))
        labels = api.get(KIND_NODE, "ts-0").metadata.labels
        jlabels = japi.get("Node", "ts-0").metadata.labels
        assert labels[C.LABEL_PARTITIONING] == C.MPS_KIND
        assert jlabels[JC.LABEL_PARTITIONING] == "timeshare"
        assert labels[C.LABEL_GPU_COUNT] == ("4" if auto else "8")
        assert labels[C.LABEL_GPU_COUNT] == jlabels[JC.LABEL_CHIP_COUNT]
        assert asked == ([False] if auto else [])
        assert _loops(main) == [("chipagent", 10.0)]

    @pytest.mark.parametrize("model", ["auto", "named"])
    def test_sliceagent_registers_its_node_in_memory(self, model,
                                                     monkeypatch):
        from nos_tpu.api import constants as JC
        from nos_tpu.cmd.sliceagent import build_agent_main as jbuild
        from nos_tpu.device import discovery as jdisc
        from nos_tpu.kube.client import APIServer as JaxAPIServer
        from nos_tpu_torch.cmd.sliceagent import build_agent_main
        from nos_tpu_torch.device import discovery as pdisc
        from nos_tpu_torch.device.fake import FakeGpuRuntime
        from nos_tpu_torch.kube.client import APIServer, KIND_NODE

        monkeypatch.setattr(jdisc, "discover",
                            lambda *a, **k: _observed_jax())
        monkeypatch.setattr(pdisc, "discover",
                            lambda *a, **k: _observed_port())
        api, japi = APIServer(), JaxAPIServer()
        auto = model == "auto"
        main = build_agent_main(api, pconfig.AgentConfig(
            node_name="mig-0", model="auto" if auto else
            "nvidia-h100-80gb-hbm3"), device="cpu")
        jbuild(japi, jconfig.AgentConfig(
            node_name="mig-0", generation="auto" if auto else "tpu-v5e"))
        labels = api.get(KIND_NODE, "mig-0").metadata.labels
        assert labels[C.LABEL_PARTITIONING] == C.MIG_KIND
        assert japi.get("Node", "mig-0").metadata.labels[
            JC.LABEL_PARTITIONING] == "slice"
        # the fake runtime holds one GPU: auto advertises what it sees
        assert labels[C.LABEL_GPU_COUNT] == ("1" if auto else "8")
        assert isinstance(main.agent.runtime, FakeGpuRuntime)
        assert _loops(main) == [("sliceagent", 10.0)]

    def test_sliceagent_on_cuda_needs_nvml(self):
        """--device cuda is NVML on the card, never a fake: without NVML
        it raises."""
        from nos_tpu_torch.cmd.sliceagent import build_agent_main
        from nos_tpu_torch.device import nvml
        from nos_tpu_torch.kube.client import APIServer

        try:
            nvml.Nvml().__enter__()
        except nvml.NvmlUnavailable:
            pass
        else:
            pytest.skip("this host has NVML")
        with pytest.raises(nvml.NvmlUnavailable):
            build_agent_main(APIServer(), pconfig.AgentConfig(
                node_name="mig-0"))

    @pytest.mark.parametrize("agent", ["chipagent", "sliceagent"])
    def test_a_missing_node_over_rest_is_a_config_error(self, agent,
                                                        stub_client,
                                                        tmp_path):
        """Over a cluster's API the agents never make up a node, as
        JAX's."""
        from nos_tpu.kube.rest import KubeClient as JaxKubeClient
        from nos_tpu.kube.rest import KubeConfig as JaxKubeConfig
        from nos_tpu_torch.cmd import chipagent, sliceagent

        stub, client = stub_client
        jclient = JaxKubeClient(JaxKubeConfig(stub.url))
        try:
            if agent == "chipagent":
                from nos_tpu.cmd.chipagent import build_chipagent_main as jb

                with pytest.raises(pconfig.ConfigError, match="not found"):
                    chipagent.build_chipagent_main(client, pconfig.AgentConfig(
                        node_name="ghost"))
            else:
                from nos_tpu.cmd.sliceagent import build_agent_main as jb

                with pytest.raises(pconfig.ConfigError, match="not found"):
                    sliceagent.build_agent_main(client, pconfig.AgentConfig(
                        node_name="ghost"), device="cpu")
            with pytest.raises(jconfig.ConfigError, match="not found"):
                jb(jclient, jconfig.AgentConfig(node_name="ghost"))
        finally:
            jclient.close()

    def _rest_node(self, client, partitioning):
        from nos_tpu_torch.kube.client import KIND_NODE
        from nos_tpu_torch.testing.factory import make_gpu_node

        client.create(KIND_NODE, make_gpu_node("n-0", gpus=1,
                                               partitioning=partitioning))

    def _kubeconfig(self, stub, tmp_path) -> str:
        path = tmp_path / "kubeconfig.json"
        path.write_text(json.dumps({
            "current-context": "s",
            "contexts": [{"name": "s", "context": {"cluster": "s",
                                                   "user": "u"}}],
            "clusters": [{"name": "s", "cluster": {"server": stub.url}}],
            "users": [{"name": "u", "user": {}}]}))
        return str(path)

    @pytest.mark.parametrize("plugins_dir", [False, True],
                             ids=["missing", "present"])
    def test_chipagent_device_plugins_dir(self, plugins_dir, stub_client,
                                          tmp_path, monkeypatch, caplog):
        """With a kubeconfig: a missing device-plugins dir warns as JAX
        does and the agent runs; a present one adds the timeshare plugin
        manager's sync loop and its shutdown hook, as JAX's main does."""
        from nos_tpu_torch.cmd import chipagent
        from nos_tpu_torch.device import plugin
        from nos_tpu_torch.device.deviceplugin import TimesharePluginManager

        stub, client = stub_client
        self._rest_node(client, C.MPS_KIND)
        path = tmp_path / "device-plugins"
        if plugins_dir:
            path.mkdir()
        monkeypatch.setattr(plugin, "PLUGINS_DIR", str(path))
        cfg = pconfig.AgentConfig(node_name="n-0",
                                  kubeconfig=self._kubeconfig(stub, tmp_path))
        with caplog.at_level(logging.WARNING):
            main = chipagent.build_chipagent_main(client, cfg)
        warned = any("device-plugins dir" in r.getMessage()
                     and "will not be advertised" in r.getMessage()
                     for r in caplog.records)
        if not plugins_dir:
            assert warned
            assert _loops(main) == [("chipagent", 10.0)]
            assert main._shutdown_hooks == []
            return
        assert not warned
        assert _loops(main) == [("chipagent", 10.0),
                                ("timeshare-plugins", 10.0)]
        (hook,) = main._shutdown_hooks
        manager = hook.__self__
        assert isinstance(manager, TimesharePluginManager)
        assert manager._plugins_dir == str(path)
        assert manager._kubelet_socket == str(path / "kubelet.sock")

    @pytest.mark.parametrize("socket", [False, True],
                             ids=["missing", "present"])
    def test_sliceagent_pod_resources_socket(self, socket, stub_client,
                                             tmp_path, monkeypatch):
        """With a kubeconfig: no pod-resources socket is JAX's
        ConfigError; a socket is read through the kubelet client, whose
        used devices the startup cleanup keeps."""
        from nos_tpu_torch.cmd import sliceagent
        from nos_tpu_torch.device import plugin
        from nos_tpu_torch.device.podresources import (
            KubeletPodResourcesClient)

        stub, client = stub_client
        self._rest_node(client, C.MIG_KIND)
        monkeypatch.setattr(plugin, "PLUGINS_DIR", str(tmp_path / "none"))
        cfg = pconfig.AgentConfig(node_name="n-0",
                                  kubeconfig=self._kubeconfig(stub, tmp_path))
        if not socket:
            monkeypatch.setattr(plugin, "POD_RESOURCES_SOCKET",
                                str(tmp_path / "kubelet.sock"))
            with pytest.raises(pconfig.ConfigError,
                               match="pod-resources socket"):
                sliceagent.build_agent_main(client, cfg, device="cpu")
            return
        with _pod_resources_stub() as sock:
            monkeypatch.setattr(plugin, "POD_RESOURCES_SOCKET", sock)
            main = sliceagent.build_agent_main(client, cfg, device="cpu")
            assert isinstance(main.agent.client.pod_resources,
                              KubeletPodResourcesClient)
            assert main.agent.client.pod_resources.used_device_ids() == {
                "MIG-aaaaaaaa-0000-4000-8000-000000000001"}
            main.agent.client.pod_resources.close()
        assert _loops(main) == [("sliceagent", 10.0)]

    @pytest.mark.parametrize("plugins_dir", [False, True],
                             ids=["missing", "present"])
    def test_sliceagent_device_plugins_dir(self, plugins_dir, stub_client,
                                           tmp_path, monkeypatch, caplog):
        """With a kubeconfig and the pod-resources socket: a missing
        device-plugins dir warns and the agent runs without the kubelet
        plugins; a present one gives its refresh a DevicePluginManager
        and the main a shutdown hook that stops it."""
        from nos_tpu_torch.cmd import sliceagent
        from nos_tpu_torch.device import plugin
        from nos_tpu_torch.device.deviceplugin import DevicePluginManager

        stub, client = stub_client
        self._rest_node(client, C.MIG_KIND)
        path = tmp_path / "device-plugins"
        if plugins_dir:
            path.mkdir()
        monkeypatch.setattr(plugin, "PLUGINS_DIR", str(path))
        cfg = pconfig.AgentConfig(node_name="n-0",
                                  kubeconfig=self._kubeconfig(stub, tmp_path))
        with _pod_resources_stub() as sock, \
                caplog.at_level(logging.WARNING):
            monkeypatch.setattr(plugin, "POD_RESOURCES_SOCKET", sock)
            main = sliceagent.build_agent_main(client, cfg, device="cpu")
            main.agent.client.pod_resources.close()
        warned = any("device-plugins dir" in r.getMessage()
                     and "not be advertised" in r.getMessage()
                     for r in caplog.records)
        manager = main.agent.plugin._manager
        if not plugins_dir:
            assert warned and manager is None
            assert main._shutdown_hooks == []
            return
        assert not warned and isinstance(manager, DevicePluginManager)
        assert main._shutdown_hooks == [manager.stop]
        assert manager._plugins_dir == str(path)
        assert manager._kubelet_socket == str(path / "kubelet.sock")

    def test_jax_refuses_a_missing_socket_too(self, tmp_path, monkeypatch):
        from nos_tpu.cmd.sliceagent import build_agent_main as jbuild
        from nos_tpu.device import podresources
        from nos_tpu.kube.client import APIServer as JaxAPIServer

        kc = tmp_path / "kc"
        kc.write_text("{}")
        monkeypatch.setattr(podresources, "DEFAULT_SOCKET",
                            str(tmp_path / "none.sock"))
        with pytest.raises(jconfig.ConfigError,
                           match="pod-resources socket"):
            jbuild(JaxAPIServer(), jconfig.AgentConfig(
                node_name="h", kubeconfig=str(kc)))


# -- the exporter -------------------------------------------------------------


class TestExporter:
    def test_collect_matches_jax(self):
        from nos_tpu.exporter import collect as jcollect
        from nos_tpu.exporter.metrics import Registry as JRegistry
        from nos_tpu.kube.client import APIServer as JaxAPIServer
        from nos_tpu.testing.factory import make_tpu_node
        from nos_tpu_torch.exporter import collect
        from nos_tpu_torch.exporter.metrics import Registry
        from nos_tpu_torch.kube.client import APIServer, KIND_NODE, KIND_POD
        from nos_tpu_torch.testing.factory import make_gpu_node, make_pod

        japi = JaxAPIServer()
        japi.create("Node", make_tpu_node("h0", pod_id="p0"))
        japi.create("Node", make_tpu_node("t0", partitioning="timeshare",
                                          pod_id=""))
        jreg = JRegistry()
        jreg.inc("nos_tpu_plans_total", labels={"kind": "slice"})
        want = jcollect(japi, components={"partitioner": True},
                        registry=jreg)
        api = APIServer()
        api.create(KIND_NODE, make_gpu_node("h0", gpus=8,
                                            partitioning=C.MIG_KIND))
        api.create(KIND_NODE, make_gpu_node("t0", gpus=8,
                                            partitioning=C.MPS_KIND))
        api.create(KIND_POD, make_pod("p"))
        reg = Registry()
        reg.inc("nos_tpu_plans_total", labels={"kind": "slice"})
        got = collect(api, components={"partitioner": True}, registry=reg)
        kinds = {"slice": C.MIG_KIND, "timeshare": C.MPS_KIND}
        assert got["cluster"]["partitioning"] == {
            kinds[k]: {"nodes": v["nodes"], "gpus": v["chips"]}
            for k, v in want["cluster"]["partitioning"].items()}
        assert got["cluster"]["nodes_total"] == \
            want["cluster"]["nodes_total"] == 2
        assert got["cluster"]["pods_total"] == 1
        assert got["components"] == want["components"]
        assert got["metrics"] == want["metrics"]
        assert sorted(got) == sorted(want)

    def test_state_file_source(self, tmp_path):
        from nos_tpu_torch.cmd import metricsexporter
        from nos_tpu_torch.kube.client import APIServer, KIND_NODE
        from nos_tpu_torch.kube.serialize import dump_state
        from nos_tpu_torch.testing.factory import make_gpu_node

        api = APIServer()
        api.create(KIND_NODE, make_gpu_node("n-0", gpus=1))
        src = tmp_path / "state.json"
        src.write_text(json.dumps(dump_state(api)))
        out = tmp_path / "payload.json"
        assert metricsexporter.main(["--source", str(src), "--out",
                                     str(out)]) == 0
        payload = json.loads(out.read_text())
        assert payload["cluster"]["nodes_total"] == 1
        assert payload["cluster"]["partitioning"] == {
            C.MPS_KIND: {"nodes": 1, "gpus": 1.0}}
        assert "slo" not in payload

    def test_a_ports_snapshot_answers_501_and_the_exporter_exits_1(
            self, tmp_path, monkeypatch):
        """A port main's live /snapshot: the exporter exits 0 and its
        payload carries the cluster, the source's series and its waste
        report (before the ledger the main answered 501 and the exporter
        exited 1; the name keeps that history)."""
        from nos_tpu_torch.cmd import metricsexporter
        from nos_tpu_torch.cmd._runtime import Main
        from nos_tpu_torch.kube.client import APIServer, KIND_NODE
        from nos_tpu_torch.obs import ledger as pledger
        from nos_tpu_torch.testing.factory import make_gpu_node

        ledger = pledger.ChipSecondLedger(clock=lambda: 5.0)
        ledger.observe({"nvl-0": {"capacity": 1.0,
                                  "categories": {"productive": 0.6}}})
        monkeypatch.setattr(pledger, "_ledger", ledger)
        api = APIServer()
        api.create(KIND_NODE, make_gpu_node("n-0", gpus=1))
        main = Main("t", health_addr="127.0.0.1:0", api=api)
        main.start()
        out = tmp_path / "payload.json"
        try:
            rc = metricsexporter.main(
                ["--source", f"http://{main.health_address}",
                 "--out", str(out)])
        finally:
            main.shutdown()
        assert rc == 0
        payload = json.loads(out.read_text())
        assert payload["cluster"]["nodes_total"] == 1
        assert payload["waste"] == json.loads(json.dumps(ledger.report()))
        assert payload["waste"]["pools"]["nvl-0"]["capacity_chips"] == 1.0
        assert "nos_tpu_chip_seconds_total" not in payload["metrics"] \
            or isinstance(payload["metrics"], dict)

    @pytest.mark.parametrize("source,rc", [
        ('{"Lease": [{"metadata": {"name": "l0"}}], "Node": []}', 0),
        ("[1, 2, 3]", 1), (None, 1)], ids=["unknown-kind", "not-an-object",
                                           "missing"])
    def test_sources_exit_as_jax(self, source, rc, tmp_path):
        from nos_tpu.cmd import metricsexporter as jme
        from nos_tpu_torch.cmd import metricsexporter as pme

        src = tmp_path / "state.json"
        if source is not None:
            src.write_text(source)
        out = tmp_path / "o.json"
        got = [m.main(["--source", str(src), "--out", str(out)])
               for m in (pme, jme)]
        assert got == [rc, rc]

    def test_export_post_failure_is_rc_1(self):
        from nos_tpu_torch.cmd.metricsexporter import export

        assert export({"x": 1}, endpoint="http://127.0.0.1:1/ingest") == 1


# -- the threaded control plane ------------------------------------------------


def _wait_running(api, names, limit_s: float = 20.0) -> bool:
    from nos_tpu_torch.kube.client import KIND_POD

    deadline = time.monotonic() + limit_s
    while time.monotonic() < deadline:
        pods = {p.metadata.name: p for p in api.list(KIND_POD)}
        if all(n in pods and pods[n].spec.node_name
               and pods[n].status.phase == "Running" for n in names):
            return True
        time.sleep(0.02)
    return False


class TestProcessModelEndToEnd:
    @pytest.mark.usefixtures("lock_discipline")
    @pytest.mark.parametrize("kind", [C.MPS_KIND, C.MIG_KIND])
    def test_threaded_control_plane_converges(self, kind):
        """The partitioner main, a node agent and the scheduler as run
        loops bind a pod with no hand-cranking, under the port's lock
        discipline."""
        from nos_tpu_torch.cmd.assembly import (
            build_partitioner_main, build_scheduler)
        from nos_tpu_torch.kube.client import APIServer, KIND_NODE, KIND_POD
        from nos_tpu_torch.partitioning.state import ClusterState
        from nos_tpu_torch.testing.factory import (
            make_gpu_node, make_mig_pod, make_timeshare_pod)

        api = APIServer()
        cfg = pconfig.PartitionerConfig(kind=kind, batch_timeout_s=0.3,
                                        batch_idle_s=0.05,
                                        poll_interval_s=0.01)
        main, _ = build_partitioner_main(api, ClusterState(), cfg)
        api.create(KIND_NODE, make_gpu_node("host-0", gpus=1,
                                            partitioning=kind))
        if kind == C.MPS_KIND:
            from nos_tpu_torch.controllers.chipagent import ChipAgent

            agent = ChipAgent(api, "host-0")
            pod = make_timeshare_pod(24, name="w")
        else:
            from nos_tpu_torch.controllers.sliceagent import SliceAgent
            from nos_tpu_torch.device import default_gpu_runtime
            from nos_tpu_torch.device.fake import FakePodResources

            agent = SliceAgent(api, "host-0",
                               default_gpu_runtime(device="cpu"),
                               FakePodResources())
            pod = make_mig_pod("3g.40gb", name="w")
        agent.start()
        main.add_loop("agent", agent.tick, 0.01)
        sched = build_scheduler(api)
        main.add_loop("sched", sched.run_cycle, 0.01)
        main.start()
        try:
            api.create(KIND_POD, pod)
            assert _wait_running(api, ["w"]), \
                "pod did not bind via threaded control plane"
        finally:
            main.shutdown()
            sched.close()

    def test_partitioner_sim_demo(self, caplog):
        """``--sim`` converges: every demo pod bound and Running."""
        from nos_tpu_torch.cmd.assembly import build_partitioner_main
        from nos_tpu_torch.cmd.partitioner import add_sim
        from nos_tpu_torch.kube.client import APIServer
        from nos_tpu_torch.partitioning.state import ClusterState

        api = APIServer()
        cfg = pconfig.PartitionerConfig(batch_timeout_s=0.3,
                                        batch_idle_s=0.05,
                                        poll_interval_s=0.01)
        main, _ = build_partitioner_main(api, ClusterState(), cfg)
        add_sim(main, api, hosts=2)
        main.start()
        try:
            with caplog.at_level(logging.INFO):
                assert _wait_running(api, ["sim-0", "sim-1"]), \
                    "sim demo did not converge"
                t0 = time.monotonic()
                while time.monotonic() - t0 < 5 and not any(
                        "demo converged" in r.getMessage()
                        for r in caplog.records):
                    time.sleep(0.05)
            assert any("demo converged" in r.getMessage()
                       for r in caplog.records)
        finally:
            main.shutdown()


# -- the lock checker -----------------------------------------------------------


def _ab_ba(lc):
    g = lc.LockGraph(name="inv")
    a, b = g.lock("A"), g.lock("B")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    return g


def _transitive(lc):
    g = lc.LockGraph(name="trans")
    a, b, c = g.lock("A"), g.lock("B"), g.lock("C")
    for x, y in ((a, b), (b, c), (c, a)):
        with x:
            with y:
                pass
    return g


def _consistent(lc):
    g = lc.LockGraph(name="ok")
    a, b = g.lock("A"), g.lock("B")
    for _ in range(5):
        with a:
            with b:
                pass
    return g


def _reentrant(lc):
    g = lc.LockGraph(name="re")
    r = g.lock("R", reentrant=True)
    with r:
        with r:
            pass
    return g


def _cross_thread(lc):
    g = lc.LockGraph(name="xthread")
    a, b = g.lock("A"), g.lock("B")

    def t1():
        with a:
            with b:
                pass

    th = threading.Thread(target=t1)
    th.start()
    th.join()
    with b:
        with a:
            pass
    return g


def _gated(lc):
    g = lc.LockGraph(name="gated")
    gate, a, b = g.lock("G"), g.lock("A"), g.lock("B")
    with gate:
        with a:
            with b:
                pass
    with gate:
        with b:
            with a:
                pass
    return g


def _unguarded_write(lc):
    class Shared:
        def __init__(self):
            self._lock = threading.RLock()
            self.field = 0

    g = lc.LockGraph(name="guard")
    s = Shared()
    lc.guard_state(s, g)
    with s._lock:
        s.field = 1
    s.field = 2
    lc.unguard_all()
    return g


def _closed(lc):
    g = lc.LockGraph(name="closed")
    a, b = g.lock("A"), g.lock("B")
    with a:
        with b:
            pass
    g.close()
    with b:
        with a:
            pass
    return g


def _installed_condition(lc):
    g = lc.LockGraph(name="inst")
    with g.install():
        lk = threading.Lock()
        cond = threading.Condition()
        ev = threading.Event()

        def worker():
            with lk:
                pass
            with cond:
                cond.notify_all()
            ev.set()

        th = threading.Thread(target=worker)
        with cond:
            th.start()
            cond.wait(timeout=2.0)
        assert ev.wait(timeout=2.0)
        th.join()
    assert threading.Lock is not type(lk)
    return g


LOCK_STORIES = {
    "ab-ba": _ab_ba, "transitive": _transitive, "consistent": _consistent,
    "reentrant": _reentrant, "cross-thread": _cross_thread,
    "gated": _gated, "unguarded-write": _unguarded_write,
    "closed": _closed, "installed-condition": _installed_condition,
}


class TestLockcheck:
    @pytest.mark.parametrize("story", list(LOCK_STORIES))
    def test_verdicts_match_jax(self, story):
        """Each story on both checkers: the same inversions (by their
        rendered lock names) and unguarded writes, the same verdict."""
        from nos_tpu.testing import lockcheck as jlc
        from nos_tpu_torch.testing import lockcheck as plc

        verdicts = []
        for lc in (plc, jlc):
            g = LOCK_STORIES[story](lc)
            try:
                g.assert_clean()
                clean = True
            except AssertionError:
                clean = False
            verdicts.append((clean, len(g.inversions),
                             len(g.unguarded_writes)))
        assert verdicts[0] == verdicts[1]
        convicted = {"ab-ba", "transitive", "cross-thread",
                     "unguarded-write"}
        assert verdicts[0][0] == (story not in convicted)

    def test_the_gate_acquits_and_its_absence_convicts(self):
        from nos_tpu_torch.testing.lockcheck import LockGraph

        g = LockGraph(name="gated")
        gate, a, b = g.lock("G"), g.lock("A"), g.lock("B")
        with gate:
            with a:
                with b:
                    pass
        with gate:
            with b:
                with a:
                    pass
        g.assert_clean()
        with b:
            with a:
                pass
        assert g.inversions

    def test_guard_state_reads_the_ports_declarations(self):
        """A class declaring its fields with the port's ``guarded_by``:
        only the declared field is judged, against its lock."""
        from nos_tpu_torch.testing.lockcheck import (
            LockGraph, guard_state, unguard_all)
        from nos_tpu_torch.utils.guards import guarded_by

        @guarded_by("_lock", "store")
        class Shared:
            def __init__(self):
                self._lock = threading.Lock()
                self.store = {}
                self.free = 0

        g = LockGraph(name="declared")
        s = Shared()
        guard_state(s, g)
        try:
            s.free = 1
            with s._lock:
                s.store = {"a": 1}
            g.assert_clean()
            s.store = {}
            assert len(g.unguarded_writes) == 1
            assert "Shared.store" in g.unguarded_writes[0]
        finally:
            unguard_all()


# -- the mains as processes ------------------------------------------------------

_MAINS_SCRIPT = """
import json, sys, tempfile
sys.path[:0] = [{root!r}, {tests!r}]
import chip_smoke
from k8s_stub import StubApiServer

device = {{"model": "nvidia-h100-80gb-hbm3", "memory_bytes": 85_000_000_000,
           "uuids": ["GPU-0"]}}
with StubApiServer() as stub, tempfile.TemporaryDirectory() as tmp:
    fields, writes, _ = chip_smoke._mains_host(
        stub, tmp, device, "nvidia-h100-80gb-hbm3")
print(json.dumps({{"fields": fields, "writes": writes}}))
"""
MAINS_TIMEOUT_S = 50.0


class TestMainsAsProcesses:
    def test_the_mains_write_what_the_smoke_pins(self):
        """chip_smoke.py's phase 14 without its children: two
        partitioners under a lease, a scheduler, an operator and a chip
        agent (an explicit model) as processes against the REST stub;
        the two pods bound through one plan, the leader's SIGTERM handed
        over, the third pod planned by the new leader, the pods marked
        Succeeded, the exporter's exits (0 on the scheduler's /snapshot,
        where before the waste ledger it answered 501 and the exporter
        exited 1), the scheduler's waterfall (48/80 productive while the
        two pods held their shares, conserved), its /debug/slo verdict
        for the pods' class and ``obs waste`` over it, every main's exit
        0 on SIGTERM; the final objects are MAINS_LOOP_WRITES.  The whole run (the
        mains included, one process group) is killed at
        MAINS_TIMEOUT_S."""
        import os
        import pathlib
        import signal
        import subprocess
        import sys

        import chip_smoke

        root = pathlib.Path(chip_smoke.__file__).resolve().parent
        script = _MAINS_SCRIPT.format(root=str(root),
                                      tests=str(root / "tests"))
        proc = subprocess.Popen([sys.executable, "-c", script], cwd=root,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True,
                                start_new_session=True)
        try:
            out, err = proc.communicate(timeout=MAINS_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            out, err = proc.communicate()
            pytest.fail(f"the mains took over {MAINS_TIMEOUT_S} s:\n"
                        f"{err[-4000:]}")
        finally:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        assert proc.returncode == 0, err[-4000:]
        result = json.loads(out.strip().splitlines()[-1])
        assert result["writes"] == chip_smoke.MAINS_LOOP_WRITES
        f = result["fields"]
        assert f["plans"] == 1 and f["new_leader_plans"] == 1
        assert {f["leader"], f["standby"]} == {"partitioner-0",
                                              "partitioner-1"}
        assert f["exporter"]["exit_codes"] == {"file": 0, "snapshot": 0}
        assert f["exporter"]["payload_waste_pools"] == ["-"]
        both = f["waste_while_both_ran"]
        assert both["want_share"] == 48 / 80
        assert abs(both["productive_gpu_seconds"] - 0.6
                   * both["window_gpu_seconds"]) \
            <= both["tolerance_gpu_seconds"]
        assert f["slo_verdict"]["class"] == "ts-24"
        assert f["obs_waste_rc"] == 0
        assert "productive" in f["obs_waste_categories"]
        assert all(abs(d) <= 1e-6
                   for d in f["waste"]["conservation_delta"].values())
        assert sorted(f["main_exits"]) == sorted(chip_smoke.MAINS)
        assert all(e["rc"] == 0 and e["exit_s"] < 5.0
                   for e in f["main_exits"].values())
        assert f["sigterm_to_new_holder_ms"] < 3000.0
        assert [g["gb"] for g in f["grants"]] == [24, 24]

    def test_the_jax_mains_leave_the_pinned_objects(self, monkeypatch):
        """The same story on the JAX package's mains (``_jax_mains``):
        their final objects, under the port's names, are
        MAINS_LOOP_WRITES (the plugin config compared as its GPU
        table)."""
        import chip_smoke

        from test_torch_timeshare import port_config_table

        writes = _jax_mains(monkeypatch)
        want = dict(chip_smoke.MAINS_LOOP_WRITES)
        want["configmap"] = {k: port_config_table(json.loads(v))
                             for k, v in want["configmap"].items()}
        assert writes == want


def _jax_mains(monkeypatch) -> dict:
    """chip_smoke.py's phase 14 story on the JAX package, in one process
    over a stub of its own, without children: two partitioners
    (``build_partitioner_main``, the timeshare kind, a lease each
    contends for), the scheduler main's cycle loop, the operator
    (``build_operator_main``, webhook port 0) and the chip agent
    (``build_chipagent_main``, heartbeat on, the 80 GB stand-in
    generation cut to one chip a host), each on a REST client of its
    own, at the smoke's windows and report interval.  A main's exit is
    its shutdown, then its client's close once its lease is released
    (JAX's shutdown does not wait for the elector).  Returns the final
    objects masked as ``chip_smoke._mains_writes`` masks them, under the
    port's names, the plugin config as its GPU table."""
    import contextlib

    import chip_smoke
    import nos_tpu.kube.k8s_codec as jcodec
    from nos_tpu.api import constants as JC
    from nos_tpu.api.elasticquota import ElasticQuota, ElasticQuotaSpec
    from nos_tpu.cmd._runtime import Main as JaxMain
    from nos_tpu.cmd.assembly import build_partitioner_main, build_scheduler
    from nos_tpu.cmd.chipagent import build_chipagent_main
    from nos_tpu.cmd.operator import build_operator_main
    from nos_tpu.kube.leaderelection import ANN_DEADLINE, ANN_HOLDER
    from nos_tpu.kube.objects import ObjectMeta
    from nos_tpu.kube.rest import KubeClient, KubeConfig
    from nos_tpu.obs import journal as jax_journal, ledger as jax_ledger
    from nos_tpu.partitioning.state import ClusterState
    from nos_tpu.partitioning.timeshare import (
        DEVICE_PLUGIN_CM_NAME, DEVICE_PLUGIN_CM_NAMESPACE)
    from nos_tpu.testing import factory as jf
    from nos_tpu.topology import DEFAULT_REGISTRY, Shape

    from k8s_stub import StubApiServer
    from test_torch_controller import node_key
    from test_torch_quota import JAX_MEM, port_resources
    from test_torch_timeshare import JAX_GEN, jax_config_table

    gen = dataclasses.replace(JAX_GEN, name="h100-80gb-standin-1gpu",
                              host_block=Shape.parse("1x1"))
    monkeypatch.setattr(DEFAULT_REGISTRY, "generations",
                        dict(DEFAULT_REGISTRY.generations) | {gen.name: gen})
    monkeypatch.setattr(jax_journal, "_journal", jax_journal.DecisionJournal())
    monkeypatch.setattr(jax_ledger, "_ledger", jax_ledger.ChipSecondLedger())
    node_name, lease = chip_smoke.CARD_NODE, chip_smoke.MAINS_LEASE
    parts = chip_smoke.MAINS[:2]

    def until(done, what: str, limit_s: float = 30.0) -> None:
        t0 = time.monotonic()
        while not done():
            assert time.monotonic() - t0 < limit_s, f"the JAX mains: {what}"
            time.sleep(chip_smoke.CARD_POLL_S)

    with contextlib.ExitStack() as stack:
        stub = stack.enter_context(StubApiServer())
        log: list[tuple[str, object]] = []
        tap = chip_smoke._StubTap(stub, decode=jcodec.from_k8s)
        for kind in ("Node", "Pod", "ConfigMap", "ElasticQuota"):
            tap.watch(kind, lambda e, o, kind=kind: log.append((kind, o)))
        clients: dict[str, KubeClient] = {}

        def client(name: str) -> KubeClient:
            c = clients[name] = KubeClient(KubeConfig(server=stub.url))
            stack.callback(c.close)
            return c

        smoke = client("smoke")
        smoke.create("Node", jf.make_tpu_node(node_name, generation=gen,
                                              partitioning="timeshare"))
        for ns, lo, hi in chip_smoke.MAINS_QUOTAS:
            smoke.create("ElasticQuota", ElasticQuota(
                metadata=ObjectMeta(name=ns, namespace=ns),
                spec=ElasticQuotaSpec(min={JAX_MEM: lo},
                                      max={JAX_MEM: hi} if hi else {})))
        mains = {}
        for name in parts:
            mains[name], _ = build_partitioner_main(
                client(name), ClusterState(), jconfig.PartitionerConfig(
                    kind="timeshare", leader_election=True,
                    batch_idle_s=chip_smoke.CARD_BATCH_IDLE_S,
                    batch_timeout_s=chip_smoke.CARD_BATCH_TIMEOUT_S,
                    health_probe_addr=""))
        scfg = jconfig.SchedulerConfig(tpu_memory_gb_per_chip=80,
                                       health_probe_addr="")
        api = client("scheduler")
        sched = build_scheduler(api, scfg.tpu_memory_gb_per_chip)
        stack.callback(sched.close)
        mains["scheduler"] = JaxMain("nos-tpu-scheduler", "", api=api)
        mains["scheduler"].add_loop("scheduler", sched.run_cycle,
                                    scfg.cycle_interval_s)
        mains["operator"] = build_operator_main(
            client("operator"), jconfig.OperatorConfig(
                tpu_memory_gb_per_chip=80, webhook_port=0,
                health_probe_addr=""))
        mains["chipagent"] = build_chipagent_main(
            client("chipagent"), jconfig.AgentConfig(
                node_name=node_name, generation=gen.name, heartbeat=True,
                report_interval_s=chip_smoke.MAINS_REPORT_S,
                health_probe_addr=""))
        up = list(mains.values())
        for m in up:
            stack.callback(m.shutdown)
            m.start()

        def lease_of() -> tuple[str, str]:
            cm = smoke.try_get("ConfigMap", *lease)
            a = cm.metadata.annotations if cm is not None else {}
            return a.get(ANN_HOLDER, ""), a.get(ANN_DEADLINE, "")

        def leading() -> list[str]:
            return [n for n in parts if mains[n]._elector.is_leader.is_set()]

        def stop(name: str) -> None:
            mains[name].shutdown()
            if name in parts:
                until(lambda: lease_of() == (mains[name]._elector.identity,
                                             "0"),
                      f"{name} releases the lease")
            clients[name].close()

        def pods() -> dict:
            return {p.metadata.name: p for p in smoke.list("Pod")}

        def running(names) -> bool:
            now = pods()
            return all(n in now and now[n].spec.node_name == node_name
                       and now[n].status.phase == "Running" for n in names)

        def create(ns: str, name: str) -> None:
            smoke.create("Pod", jf.make_timeshare_pod(
                chip_smoke.CARD_SHARE_GB, name=name, namespace=ns,
                creation_timestamp=time.time()))

        def mark(names) -> None:
            now = pods()
            for name in names:
                smoke.patch("Pod", name, now[name].metadata.namespace,
                            mutate=lambda p: setattr(p.status, "phase",
                                                     "Succeeded"))

        def used() -> dict[str, list]:
            out: dict[str, list] = {}
            for kind, obj in list(log):
                if kind == "ElasticQuota":
                    seq = out.setdefault(obj.metadata.namespace, [])
                    value = dict(sorted(port_resources(
                        obj.status.used).items()))
                    if not seq or seq[-1] != value:
                        seq.append(value)
            return out

        def quotas_at(gb: float) -> bool:
            return all(used().get(ns, [{}])[-1] == {C.RESOURCE_GPU_MEMORY: gb}
                       for ns, _, _ in chip_smoke.MAINS_QUOTAS)

        until(lambda: len(leading()) == 1, "one partitioner leads")
        (leader,) = leading()
        (standby,) = [n for n in parts if n != leader]
        names = [n for _, n in chip_smoke.MAINS_PODS]
        for ns, name in chip_smoke.MAINS_PODS:
            create(ns, name)
        until(lambda: running(names), "bind both pods")
        until(lambda: [used()[ns][-1] for ns, _ in chip_smoke.MAINS_PODS]
              == [{C.RESOURCE_GPU_MEMORY: float(chip_smoke.CARD_SHARE_GB)}]
              * 2, "write each quota's use")
        stop(leader)
        until(lambda: leading() == [standby], "hand the lease over",
              limit_s=3 * chip_smoke.MAINS_RETRY_S + 10)
        create(*chip_smoke.MAINS_THIRD)
        until(lambda: running([chip_smoke.MAINS_THIRD[1]]),
              "bind the third pod")
        mark([chip_smoke.MAINS_THIRD[1]])
        mark(names)
        until(lambda: quotas_at(0.0), "write each quota's use back to 0")
        until(lambda: not any(k.endswith("-used") for k in smoke.get(
            "Node", node_name).metadata.annotations),
            "report the shares released")
        for name in mains:
            if name != leader:
                stop(name)
        assert not tap.errors, tap.errors

        spec = JC.spec_plan_annotation("timeshare")
        plans: list[str] = []
        for kind, obj in log:
            plan = (obj.metadata.annotations.get(spec, "")
                    if kind == "Node" else "")
            if plan and (not plans or plans[-1] != plan):
                plans.append(plan)

        def mask(s: str) -> str:
            for i, plan in enumerate(plans, 1):
                s = s.replace(plan, f"plan-{i}")
            return s

        node = smoke.get("Node", node_name)
        beat = C.heartbeat_annotation(C.MPS_KIND)
        annots = {node_key(mask(k)): mask(v)
                  for k, v in node.metadata.annotations.items()}
        annots = {k: "<beat>" if k == beat else v
                  for k, v in sorted(annots.items())}
        cm = smoke.get("ConfigMap", DEVICE_PLUGIN_CM_NAME,
                       DEVICE_PLUGIN_CM_NAMESPACE)
        holder, deadline = lease_of()
        return {
            "node": {"annotations": annots, "plan_label": mask(
                node.metadata.labels.get(JC.LABEL_DEVICE_PLUGIN_CONFIG,
                                         ""))},
            "configmap": {mask(k): jax_config_table(json.loads(v))
                          for k, v in sorted(cm.data.items())},
            "pods": {n: [p.spec.node_name, p.status.phase]
                     for n, p in sorted(pods().items())},
            "quotas": used(),
            "lease": {"holder": "standby"
                      if holder == mains[standby]._elector.identity
                      else holder, "deadline": deadline}}


# ---------------------------------------------------------------------------
# The serving replica autoscaler's main
# ---------------------------------------------------------------------------

AUTOSCALED = {"name": "chat", "namespace": "serve", "timeshare_gb": 24,
              "min_replicas": 2, "max_replicas": 4,
              "target_load_per_replica": 10.0, "scale_up_cooldown_s": 0.0,
              "scale_down_cooldown_s": 0.0}


def _wait(done, what: str, limit_s: float = 10.0) -> None:
    t0 = time.monotonic()
    while not done():
        assert time.monotonic() - t0 < limit_s, what
        time.sleep(0.01)


class TestAutoscalerMain:
    @pytest.mark.parametrize("jax", [True, False], ids=["jax", "port"])
    def test_the_main_reconciles_without_leader_election(self, jax):
        """``build_autoscaler_main`` on each package's in-memory API: the
        loop binds at once, creates the min floor of replicas and writes
        the status ConfigMap; the same objects on both."""
        if jax:
            from nos_tpu.cmd.autoscaler import build_autoscaler_main
            from nos_tpu.kube.client import APIServer
            cfg = jconfig.AutoscalerConfig(
                services=[AUTOSCALED], reconcile_interval_s=0.02,
                slo_interval_s=0)
        else:
            from nos_tpu_torch.cmd.autoscaler import build_autoscaler_main
            from nos_tpu_torch.kube.client import APIServer
            cfg = pconfig.AutoscalerConfig(
                services=[AUTOSCALED], reconcile_interval_s=0.02,
                slo_interval_s=0)
        api = APIServer()
        main = build_autoscaler_main(api, cfg)
        main.start()
        try:
            _wait(lambda: len(api.list("Pod", namespace="serve")) == 2,
                  "create the min floor")
            _wait(lambda: api.try_get("ConfigMap", cfg.status_configmap,
                                      cfg.status_namespace) is not None,
                  "write the status")
        finally:
            main.shutdown()
        pods = sorted(p.metadata.name for p in api.list("Pod"))
        assert pods == ["chat-r0", "chat-r1"]
        assert [s.key for s in main.autoscaler.services()] == ["serve/chat"]

    @pytest.mark.parametrize("raw,ok", [
        ({"services": [AUTOSCALED]}, True),
        ({"services": [AUTOSCALED], "reconcile_interval_s": 0}, False),
        ({"services": [{"name": "chat"}]}, False),
        ({"services": [AUTOSCALED | {"colldown": 1}]}, False),
    ])
    def test_the_config_file_loads_as_jax_s(self, raw, ok, tmp_path):
        path = tmp_path / "a.json"
        path.write_text(json.dumps({"apiVersion": "nos.tpu/v1beta2", **raw}))
        for mod in (jconfig, pconfig):
            if ok:
                cfg = mod.load_config(path, mod.AutoscalerConfig)
                assert cfg.services == raw["services"]
            else:
                with pytest.raises(mod.ConfigError):
                    mod.load_config(path, mod.AutoscalerConfig)

    def test_an_invalid_config_exits_2(self, tmp_path, capsys):
        from nos_tpu_torch.cmd.autoscaler import main

        path = tmp_path / "a.json"
        path.write_text(json.dumps({"apiVersion": "nos.tpu/v1beta2",
                                    "services": [{"name": "chat",
                                                  "slice_shape": "1x1"}]}))
        assert main(["--config", str(path)]) == 2
        assert "not a MIG profile" in capsys.readouterr().err

    def test_the_main_as_a_process_serves_health_and_exits_0(self, tmp_path):
        """``python -m nos_tpu_torch.cmd.autoscaler --config`` on the
        in-memory API: /healthz and /readyz answer, the loop runs
        (/metrics counts its ticks), SIGTERM exits 0."""
        import os
        import signal
        import subprocess
        import sys
        import urllib.request

        import chip_smoke

        addr = f"127.0.0.1:{chip_smoke._free_port()}"
        path = tmp_path / "a.json"
        path.write_text(json.dumps({
            "apiVersion": "nos.tpu/v1beta2", "health_probe_addr": addr,
            "services": [AUTOSCALED], "reconcile_interval_s": 0.05,
            "slo_interval_s": 0}))
        env = dict(os.environ, PYTHONPATH=str(chip_smoke.ROOT))
        proc = subprocess.Popen(
            [sys.executable, "-m", "nos_tpu_torch.cmd.autoscaler",
             "--config", str(path)], cwd=chip_smoke.ROOT, env=env,
            stderr=subprocess.PIPE, text=True)
        try:
            def get(p: str) -> tuple[int, str]:
                try:
                    with urllib.request.urlopen(f"http://{addr}{p}",
                                                timeout=2) as r:
                        return r.status, r.read().decode()
                except OSError:
                    return 0, ""

            _wait(lambda: get("/healthz")[0] == 200, "answer /healthz", 60)
            assert get("/readyz") == (200, "ok")
            _wait(lambda: 'loop="autoscaler"' in get("/metrics")[1],
                  "run the loop")
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=10) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


class TestProvisionerMain:
    """``cmd/provisioner.py`` and ``build_provisioner_main``: off means
    off, the main serves its health and its ``capacity`` flight block,
    and a TPU machine class is refused."""

    def test_disabled_exits_0_and_constructs_nothing(self, tmp_path,
                                                     monkeypatch):
        import nos_tpu_torch.capacity as cap
        from nos_tpu_torch.cmd.provisioner import main
        from nos_tpu_torch.obs import _flight_blocks

        built = []
        for name in ("CapacityProvisioner", "CloudGPUAPI"):
            monkeypatch.setattr(cap, name, lambda *a, name=name, **k:
                                built.append(name))
        before = dict(_flight_blocks)
        path = tmp_path / "p.json"
        path.write_text(json.dumps({"apiVersion": "nos.tpu/v1beta2",
                                    "enabled": False}))
        assert main(["--config", str(path)]) == 0
        assert main([]) == 0            # the defaults: off
        assert built == [] and dict(_flight_blocks) == before

    @pytest.mark.parametrize("raw,ok", [
        ({"enabled": True, "poll_interval_s": 0.5}, True),
        ({"enabled": True, "scale_up_deficit_chips": 0.25,
          "provision_deadline_s": 45.0}, True),
        ({"enabled": True, "poll_interval_s": 0}, False),
        ({"enabled": True, "breaker_threshold": 0}, False),
        ({"enabled": True, "scale_up_deficit_chip": 1.0}, False),
    ])
    def test_the_config_file_loads_as_jax_s(self, raw, ok, tmp_path):
        path = tmp_path / "p.json"
        path.write_text(json.dumps({"apiVersion": "nos.tpu/v1beta2", **raw}))
        for mod in (jconfig, pconfig):
            if ok:
                cfg = mod.load_config(path, mod.ProvisionerConfig)
                assert all(getattr(cfg, k) == v for k, v in raw.items())
            else:
                with pytest.raises(mod.ConfigError):
                    mod.load_config(path, mod.ProvisionerConfig)

    def test_an_invalid_config_exits_2(self, tmp_path, capsys):
        from nos_tpu_torch.cmd.provisioner import main

        path = tmp_path / "p.json"
        path.write_text(json.dumps({"apiVersion": "nos.tpu/v1beta2",
                                    "enabled": True, "cloud_attempts": 0}))
        assert main(["--config", str(path)]) == 2
        assert "cloud_attempts" in capsys.readouterr().err

    def test_a_tpu_machine_class_is_refused(self, caplog):
        """A node labelled with a TPU class is in no pool: pending demand
        on it creates nothing, and the refusal is logged once."""
        from nos_tpu_torch.cmd.assembly import build_provisioner_main
        from nos_tpu_torch.kube.client import APIServer
        from nos_tpu_torch.obs import set_flight_block
        from nos_tpu_torch.testing import factory

        api = APIServer()
        node = factory.make_gpu_node("tpu-host-0", domain="pod-0",
                                     host_index=0)
        node.metadata.labels[C.LABEL_ACCELERATOR] = "tpu-v5e"
        api.create("Node", node)
        api.create("Pod", factory.make_timeshare_pod(80, 8, name="p0"))
        cfg = pconfig.ProvisionerConfig(enabled=True, scale_up_after_s=0.0,
                                        scale_up_deficit_chips=0.25,
                                        slo_interval_s=0)
        prev = set_flight_block("capacity")
        try:
            main = build_provisioner_main(api, cfg)
            with caplog.at_level(logging.WARNING):
                for _ in range(3):
                    main.provisioner.reconcile()
        finally:
            set_flight_block("capacity", prev)
        report = main.provisioner.report()
        assert report["pools"] == {} and report["pending_demand_chips"] == 8.0
        assert report["counters"]["requested"] == 0
        refusals = [r for r in caplog.records if "TPU machine class"
                    in r.getMessage()]
        assert len(refusals) == 1 and "tpu-host-0" in refusals[0].getMessage()

    def test_the_main_as_a_process_serves_health_and_its_block(
            self, tmp_path):
        """``python -m nos_tpu_torch.cmd.provisioner --config`` enabled on
        the in-memory API: /healthz and /readyz answer, the loop runs,
        /debug/flightrecorder carries the ``capacity`` block, ``obs
        capacity`` renders it (exit 0), SIGTERM exits 0."""
        import os
        import signal
        import subprocess
        import sys
        import urllib.request

        import chip_smoke

        addr = f"127.0.0.1:{chip_smoke._free_port()}"
        path = tmp_path / "p.json"
        path.write_text(json.dumps({
            "apiVersion": "nos.tpu/v1beta2", "enabled": True,
            "health_probe_addr": addr, "poll_interval_s": 0.05,
            "slo_interval_s": 0}))
        env = dict(os.environ, PYTHONPATH=str(chip_smoke.ROOT))
        proc = subprocess.Popen(
            [sys.executable, "-m", "nos_tpu_torch.cmd.provisioner",
             "--config", str(path)], cwd=chip_smoke.ROOT, env=env,
            stderr=subprocess.PIPE, text=True)
        try:
            def get(p: str) -> tuple[int, str]:
                try:
                    with urllib.request.urlopen(f"http://{addr}{p}",
                                                timeout=2) as r:
                        return r.status, r.read().decode()
                except OSError:
                    return 0, ""

            _wait(lambda: get("/healthz")[0] == 200, "answer /healthz", 60)
            assert get("/readyz") == (200, "ok")
            _wait(lambda: 'loop="provisioner"' in get("/metrics")[1],
                  "run the loop")
            code, body = get("/debug/flightrecorder")
            block = json.loads(body)["capacity"]
            assert code == 200 and block["pools"] == {}
            assert block["counters"]["requested"] == 0
            out = subprocess.run(
                [sys.executable, "-m", "nos_tpu_torch.obs", "capacity",
                 "--url", f"http://{addr}"], cwd=tmp_path, env=env,
                capture_output=True, text=True, timeout=60)
            assert out.returncode == 0, out.stderr
            assert out.stdout.startswith("capacity plane:")
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=10) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


class TestAutoscalerLeaderHandoff:
    @pytest.mark.parametrize("jax", [True, False], ids=["jax", "port"])
    def test_the_standby_takes_over_the_reconcile_loop(self, jax):
        """``tests/test_autoscaler.py``'s handoff on each package: two
        autoscaler mains on one API with fast lease timings; the standby
        does not scale while the leader holds the lease, and scales once
        the leader's shutdown released it."""
        if jax:
            from nos_tpu.cmd._runtime import Main
            from nos_tpu.kube.client import APIServer
            from nos_tpu.kube.leaderelection import LeaderElector
            from nos_tpu.serving import ReplicaAutoscaler, ServingService
            from nos_tpu.api import constants as PC
        else:
            from nos_tpu_torch.cmd._runtime import Main
            from nos_tpu_torch.kube.client import APIServer
            from nos_tpu_torch.kube.leaderelection import LeaderElector
            from nos_tpu_torch.serving import ReplicaAutoscaler, ServingService
            PC = C
        api = APIServer()
        svc = ServingService.from_mapping(AUTOSCALED)
        mains = []
        for ident in ("a", "b"):
            m = Main(f"autoscaler-{ident}")
            m.attach_leader_election(LeaderElector(
                api, "nos-tpu-autoscaler-leader", identity=ident,
                lease_duration_s=0.6, renew_s=0.05, retry_s=0.05))
            m.add_loop("autoscaler", ReplicaAutoscaler(api, [svc]).reconcile,
                       0.02)
            mains.append(m)

        def replicas() -> int:
            return len(api.list("Pod", namespace="serve"))

        try:
            mains[0].start()
            _wait(lambda: replicas() == 2, "the leader's min floor")
            mains[1].start()
            time.sleep(0.2)
            assert not mains[1]._elector.is_leader.is_set()
            mains[0].shutdown()
            _wait(lambda: mains[1]._elector.is_leader.is_set(),
                  "the standby takes the released lease")
            for p in api.list("Pod", namespace="serve"):
                api.patch("Pod", p.metadata.name, "serve",
                          mutate=lambda q: q.metadata.annotations.
                          __setitem__(PC.ANNOT_SERVING_LOAD, "20"))
            _wait(lambda: replicas() == 4, "the new leader scales up")
        finally:
            for m in mains:
                m.shutdown()


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 16 (b) on the host: the port's processes, JAX's mains
# ---------------------------------------------------------------------------

_SERVING_SCRIPT = """
import json, sys, tempfile
sys.path[:0] = [{root!r}, {tests!r}]
import chip_smoke
from k8s_stub import StubApiServer

device = {{"model": "nvidia-h100-80gb-hbm3", "memory_bytes": 85_000_000_000,
           "uuids": ["GPU-0"]}}
with StubApiServer() as stub, tempfile.TemporaryDirectory() as tmp:
    fields, writes = chip_smoke._serving_host(
        stub, tmp, device, "NVIDIA H100 80GB HBM3",
        agent_model="nvidia-h100-80gb-hbm3")
print(json.dumps({{"fields": fields, "writes": writes}}))
"""
SERVING_TIMEOUT_S = 120.0


class TestServingAsProcesses:
    def test_the_story_writes_what_the_smoke_pins(self):
        """chip_smoke.py's phase 16 (b) without its children: a
        partitioner, a scheduler, an operator, a chip agent and the
        replica autoscaler's main as processes against the REST stub, the
        router a process on its virtual clock.  One plan carves three 24
        GB shares for the first replica and the two fillers; the burst's
        published load passes twice the target; the scale-up evicts
        SERVING_FILLER_VICTIM and binds chat-r1 with no new plan; the
        drained replica (its sessions published as 0) is the one the
        scale-down deletes, SERVING_VICTIM; every main and the router
        exit 0; the writes are SERVING_LOOP_WRITES.  The run (one process
        group) is killed at SERVING_TIMEOUT_S."""
        import os
        import pathlib
        import signal
        import subprocess
        import sys

        import chip_smoke

        root = pathlib.Path(chip_smoke.__file__).resolve().parent
        script = _SERVING_SCRIPT.format(root=str(root),
                                        tests=str(root / "tests"))
        proc = subprocess.Popen([sys.executable, "-c", script], cwd=root,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True,
                                start_new_session=True)
        try:
            out, err = proc.communicate(timeout=SERVING_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            out, err = proc.communicate()
            pytest.fail(f"the serving story took over {SERVING_TIMEOUT_S} "
                        f"s:\n{err[-4000:]}")
        finally:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        assert proc.returncode == 0, err[-4000:]
        result = json.loads(out.strip().splitlines()[-1])
        assert result["writes"] == chip_smoke.SERVING_LOOP_WRITES
        f = result["fields"]
        assert f["plans"] == 1
        assert [e[:2] for e in f["events"]] == [
            ["evicted", chip_smoke.SERVING_FILLER_VICTIM], ["up", "chat-r1"],
            ["down", chip_smoke.SERVING_VICTIM]]
        assert f["max_published_load"] >= 2 * chip_smoke.SERVING_SERVICE[
            "target_load_per_replica"]
        assert all(e["rc"] == 0 for e in f["main_exits"].values())
        assert f["router_stats"]["completed"] == \
            f["router_stats"]["submitted"] - f["router_stats"]["shed"]

    def test_the_jax_package_s_loop_writes_the_same(self, monkeypatch):
        """The same story on the JAX package (``_jax_serving``): its mains,
        its autoscaler main and its router (``chip_smoke._RouterDriver``
        on the JAX modules, priced as the port by
        ``jax_prices_as_the_port``) in one process over a stub of their
        own; its writes under the port's names are SERVING_LOOP_WRITES
        (the plugin config compared as its GPU table), and it takes the
        same scale events."""
        import chip_smoke

        from test_torch_timeshare import port_config_table

        writes, fields = _jax_serving(monkeypatch)
        want = dict(chip_smoke.SERVING_LOOP_WRITES)
        want["configmap"] = {k: port_config_table(json.loads(v))
                             for k, v in want["configmap"].items()}
        assert writes == want
        assert [e[:2] for e in fields["events"]] == [
            ["evicted", chip_smoke.SERVING_FILLER_VICTIM], ["up", "chat-r1"],
            ["down", chip_smoke.SERVING_VICTIM]]


class _JaxServingCluster:
    """``chip_smoke._ServingCluster``'s surface on the JAX package, in one
    process over ``stub``: the partitioner (timeshare, a lease), the
    scheduler's cycle loop, the operator and the chip agent (the 80 GB
    stand-in generation cut to one chip a host) as in ``_jax_mains``, the
    autoscaler's main (``build_autoscaler_main``) and the router, each on
    a REST client of its own.  Its recorder maps every commit to the
    port's names."""

    def __init__(self, monkeypatch, stub, stack) -> None:
        import nos_tpu.kube.k8s_codec as jcodec
        from nos_tpu.api import constants as JC
        from nos_tpu.api.elasticquota import ElasticQuota, ElasticQuotaSpec
        from nos_tpu.kube.objects import ObjectMeta
        from nos_tpu.kube.rest import KubeClient, KubeConfig
        from nos_tpu.obs import journal as jax_journal, ledger as jax_ledger
        from nos_tpu.testing import factory as jf
        from nos_tpu.topology import DEFAULT_REGISTRY, Shape

        import chip_smoke
        from test_torch_quota import JAX_MEM
        from test_torch_timeshare import JAX_GEN

        self.JC, self.cs = JC, chip_smoke
        self.stub, self.stack = stub, stack
        self.gen = dataclasses.replace(
            JAX_GEN, name="h100-80gb-standin-1gpu",
            host_block=Shape.parse("1x1"))
        monkeypatch.setattr(DEFAULT_REGISTRY, "generations",
                            dict(DEFAULT_REGISTRY.generations)
                            | {self.gen.name: self.gen})
        monkeypatch.setattr(jax_journal, "_journal",
                            jax_journal.DecisionJournal())
        monkeypatch.setattr(jax_ledger, "_ledger",
                            jax_ledger.ChipSecondLedger())
        self.records: list[tuple] = []
        self.tap = chip_smoke._StubTap(stub, decode=jcodec.from_k8s)
        for kind in ("Node", "Pod", "ConfigMap", "ElasticQuota"):
            self.tap.watch(kind, lambda e, o, kind=kind: self.records.append(
                self.port_record(kind, e, o)))
        self.clients: dict = {}
        self.mains: dict = {}
        self.smoke = self.client("smoke")
        self.smoke.create("Node", jf.make_tpu_node(
            chip_smoke.CARD_NODE, generation=self.gen,
            partitioning="timeshare"))
        for ns, lo, hi in chip_smoke.SERVING_CARD_QUOTAS:
            self.smoke.create("ElasticQuota", ElasticQuota(
                metadata=ObjectMeta(name=ns, namespace=ns),
                spec=ElasticQuotaSpec(min={JAX_MEM: lo},
                                      max={JAX_MEM: hi} if hi else {})))
        self.KubeClient, self.KubeConfig = KubeClient, KubeConfig
        self.driver = None

    def client(self, name: str):
        from nos_tpu.kube.rest import KubeClient, KubeConfig

        c = self.clients[name] = KubeClient(KubeConfig(server=self.stub.url))
        self.stack.callback(c.close)
        return c

    def port_record(self, kind: str, event: str, obj) -> tuple:
        from test_torch_controller import node_key
        from test_torch_quota import port_resources
        from test_torch_timeshare import jax_config_table

        rec = self.cs.serving_record(kind, event, obj, self.JC)
        if kind == "Node":
            fields = rec[3]
            return ("Node", event, rec[2], {
                "annotations": {node_key(k): v for k, v in
                                fields["annotations"].items()},
                "labels": {node_key(k): v for k, v in
                           fields["labels"].items()}})
        if kind == "ElasticQuota":
            return ("ElasticQuota", event, rec[2], dict(sorted(
                port_resources(rec[3]).items())))
        if kind == "ConfigMap" and obj.metadata.name == \
                "nos-tpu-device-plugin-config":
            from nos_tpu_torch.partitioning.timeshare import (
                DEVICE_PLUGIN_CM_NAME, DEVICE_PLUGIN_CM_NAMESPACE)

            return ("ConfigMap", event,
                    f"{DEVICE_PLUGIN_CM_NAMESPACE}/{DEVICE_PLUGIN_CM_NAME}",
                    {k: jax_config_table(json.loads(v))
                     for k, v in rec[3].items()})
        return rec

    # -- the story's surface ----------------------------------------------
    def start_mains(self) -> None:
        from nos_tpu.cmd._runtime import Main as JaxMain
        from nos_tpu.cmd.assembly import build_partitioner_main, build_scheduler
        from nos_tpu.cmd.chipagent import build_chipagent_main
        from nos_tpu.cmd.operator import build_operator_main
        from nos_tpu.partitioning.state import ClusterState

        cs = self.cs
        self.mains["partitioner-0"], _ = build_partitioner_main(
            self.client("partitioner-0"), ClusterState(),
            jconfig.PartitionerConfig(
                kind="timeshare", leader_election=True,
                batch_idle_s=cs.SERVING_BATCH_IDLE_S,
                batch_timeout_s=cs.CARD_BATCH_TIMEOUT_S,
                health_probe_addr=""))
        api = self.client("scheduler")
        sched = build_scheduler(api, 80)
        self.stack.callback(sched.close)
        self.mains["scheduler"] = JaxMain("nos-tpu-scheduler", "", api=api)
        self.mains["scheduler"].add_loop(
            "scheduler", sched.run_cycle,
            jconfig.SchedulerConfig().cycle_interval_s)
        self.mains["operator"] = build_operator_main(
            self.client("operator"), jconfig.OperatorConfig(
                tpu_memory_gb_per_chip=80, webhook_port=0,
                health_probe_addr=""))
        self.mains["chipagent"] = build_chipagent_main(
            self.client("chipagent"), jconfig.AgentConfig(
                node_name=cs.CARD_NODE, generation=self.gen.name,
                heartbeat=True, report_interval_s=cs.MAINS_REPORT_S,
                health_probe_addr=""))
        for m in self.mains.values():
            self.stack.callback(m.shutdown)
            m.start()

    def start_autoscaler(self) -> None:
        from nos_tpu.cmd.autoscaler import build_autoscaler_main

        m = self.mains["autoscaler"] = build_autoscaler_main(
            self.client("autoscaler"), jconfig.AutoscalerConfig(
                reconcile_interval_s=self.cs.SERVING_RECONCILE_S,
                services=[self.cs.SERVING_SERVICE], slo_interval_s=0,
                health_probe_addr=""))
        self.stack.callback(m.shutdown)
        m.start()

    def create_filler(self, name: str) -> None:
        from nos_tpu.testing import factory as jf

        self.smoke.create("Pod", jf.make_timeshare_pod(
            self.cs.CARD_SHARE_GB, name=name, namespace="filler",
            labels={self.JC.LABEL_TIER: self.JC.TIER_BEST_EFFORT},
            creation_timestamp=time.time()))

    def pods(self) -> dict:
        return {p.metadata.name: self.cs.serving_record(
                    "Pod", "", p, self.JC)[3]
                for p in self.smoke.list("Pod")}

    def running(self, names) -> bool:
        pods = self.pods()
        return all(n in pods and pods[n]["node"] == self.cs.CARD_NODE
                   and pods[n]["phase"] == "Running" for n in names)

    def stamps(self) -> dict:
        return {n: [p["load"], p["sessions"]] for n, p in self.pods().items()
                if n.startswith("chat-") and p["phase"] == "Running"}

    def until(self, done, what: str, limit_s: float = 60.0) -> None:
        _wait(done, f"the JAX serving loop: {what}", limit_s)

    def wait_reconcile(self, n: int) -> None:
        from nos_tpu.exporter.metrics import REGISTRY as JAX_REGISTRY

        def count() -> float:
            return JAX_REGISTRY.snapshot().get(
                "nos_tpu_runloop_tick_seconds_count", {}).get(
                "loop=autoscaler", 0.0)

        want = count() + n
        self.until(lambda: count() >= want, f"reconcile {n} more times")

    def start_router(self) -> None:
        from nos_tpu import requests as JR, sim as jsim
        from test_torch_requests import jax_cost_kwargs

        service = self.cs.serving_router_service(
            "NVIDIA H100 80GB HBM3", self.cs._bench350m_weights_gb())
        service["prefill"] = jax_cost_kwargs(service["prefill"])
        self.driver = self.cs._RouterDriver(JR, jsim, self.client("router"),
                                            service)

    def router(self, cmd: str) -> dict:
        return self.driver.burst() if cmd == "burst" \
            else self.driver.advance()

    def stop_router(self) -> None:
        pass

    def on_running(self, names) -> None:
        pass

    def on_deleted(self, name: str) -> None:
        pass

    def writes(self) -> dict:
        from test_torch_controller import node_key

        spec = self.JC.spec_plan_annotation("timeshare")
        plans: list[str] = []
        for kind, _, _, fields in self.records:
            plan = (fields["annotations"].get(node_key(spec), "")
                    if kind == "Node" else "")
            if plan and (not plans or plans[-1] != plan):
                plans.append(plan)
        from nos_tpu_torch.partitioning.timeshare import (
            DEVICE_PLUGIN_CM_NAME, DEVICE_PLUGIN_CM_NAMESPACE)

        return self.cs.serving_writes(
            self.records, plans, C.heartbeat_annotation(C.MPS_KIND),
            f"{DEVICE_PLUGIN_CM_NAMESPACE}/{DEVICE_PLUGIN_CM_NAME}",
            "nos-tpu-system/nos-tpu-autoscaler-status")


def _jax_serving(monkeypatch) -> tuple[dict, dict]:
    """chip_smoke.py's phase 16 (b) story on the JAX package
    (``_JaxServingCluster``): its writes under the port's names (the plugin
    config as its GPU table) and the story's fields."""
    import contextlib

    import chip_smoke
    from k8s_stub import StubApiServer
    from test_torch_requests import jax_prices_as_the_port

    jax_prices_as_the_port(monkeypatch)
    with contextlib.ExitStack() as stack:
        stub = stack.enter_context(StubApiServer())
        cl = _JaxServingCluster(monkeypatch, stub, stack)
        fields = chip_smoke.serving_story(cl)
        for name in list(cl.mains):
            cl.mains[name].shutdown()
        assert not cl.tap.errors, cl.tap.errors
        writes = cl.writes()
    return writes, fields
