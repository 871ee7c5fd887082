"""The port's helm chart, ``deploy/helm/nos-tpu-torch/``, rendered on the
CPU by the port's renderer (``nos_tpu_torch.testing.helm.render_chart``,
the template subset ``_helpers.tpl`` states; it renders both charts as
the JAX package's does): every manifest parses,
every rendered config loads through the port's ``api/config.py``, every
container runs a main under ``nos_tpu_torch/cmd/``, and the CRDs are the
port's kinds in its API group.  The JAX chart beside it is not touched.
"""

from __future__ import annotations

import pathlib

import pytest

from nos_tpu_torch.api import config as pconfig
from nos_tpu_torch.api.constants import GROUP
from nos_tpu_torch.kube.k8s_codec import GROUP_VERSION, KIND_REST
from nos_tpu_torch.testing import helm
from nos_tpu_torch.testing.helm import default_context, render_chart

ROOT = pathlib.Path(__file__).resolve().parent.parent
CHART = ROOT / "deploy/helm/nos-tpu-torch"
MAINS = ("partitioner", "scheduler", "operator", "chipagent", "sliceagent",
         "metricsexporter", "autoscaler")
# rendered ConfigMap -> the port's config class that loads it
CONFIGS = {
    "nos-tpu-torch-partitioner-config": pconfig.PartitionerConfig,
    "nos-tpu-torch-scheduler-config": pconfig.SchedulerConfig,
    "nos-tpu-torch-operator-config": pconfig.OperatorConfig,
    "nos-tpu-torch-chipagent-config": pconfig.AgentConfig,
    "nos-tpu-torch-sliceagent-config": pconfig.AgentConfig,
    "nos-tpu-torch-autoscaler-config": pconfig.AutoscalerConfig,
    "nos-tpu-torch-provisioner-config": pconfig.ProvisionerConfig,
}


def context(**values) -> dict:
    """``helm template``'s context from values.yaml, the chart's own
    helpers, and ``values`` ("a.b" paths) set over the defaults."""
    ctx = default_context(CHART)
    for path, value in values.items():
        cur = ctx["Values"]
        *head, last = path.split(".")
        for part in head:
            cur = cur[part]
        assert last in cur, path
        cur[last] = value
    return ctx


def configs(docs: list[dict], tmp_path, validate: bool = True) -> dict:
    """Each rendered config, loaded through the port's loader (an agent's
    with the --node the DaemonSet passes)."""
    out = {}
    for doc in docs:
        if doc["kind"] != "ConfigMap":
            continue
        name = doc["metadata"]["name"]
        path = tmp_path / f"{name}.yaml"
        path.write_text(doc["data"]["config.yaml"])
        cls = CONFIGS[name]
        if cls is pconfig.AgentConfig:
            cfg = pconfig.load_config(path, cls, validate=False)
            cfg.node_name = "gpu-node-0"
            if validate:
                cfg.validate()
        else:
            cfg = pconfig.load_config(path, cls, validate=validate)
        out[name] = cfg
    return out


def containers(docs: list[dict]) -> dict[str, dict]:
    out = {}
    for doc in docs:
        if doc["kind"] in ("Deployment", "DaemonSet", "Job"):
            for c in doc["spec"]["template"]["spec"]["containers"]:
                out[doc["metadata"]["name"]] = c
    return out


@pytest.fixture(scope="module")
def docs():
    return render_chart(CHART, context(**{"metricsexporter.enabled": True}))


class TestRender:
    def test_every_manifest_parses_with_its_kind(self, docs):
        kinds = {}
        for doc in docs:
            assert doc["apiVersion"] and doc["metadata"]["name"]
            kinds[doc["kind"]] = kinds.get(doc["kind"], 0) + 1
        assert kinds["Deployment"] == 4 and kinds["DaemonSet"] == 2
        assert kinds["ConfigMap"] == 6
        assert kinds["ValidatingWebhookConfiguration"] == 1
        assert kinds["Job"] == 3      # the exporter, certgen create/patch
        assert "MutatingWebhookConfiguration" not in kinds

    def test_every_config_loads_through_the_port(self, docs, tmp_path):
        got = configs(docs, tmp_path)
        assert set(got) == set(CONFIGS) - {
            "nos-tpu-torch-provisioner-config"}
        part = got["nos-tpu-torch-partitioner-config"]
        assert part.kind == pconfig.HYBRID_KIND and part.slo_interval_s == 1.0
        assert part.device_plugin_cm_namespace == "nebuly-nos"
        sched = got["nos-tpu-torch-scheduler-config"]
        assert sched.gpu_memory_gb_per_gpu == 80
        op = got["nos-tpu-torch-operator-config"]
        assert op.webhook_port == 9443 and op.gpu_memory_gb_per_gpu == 80
        assert got["nos-tpu-torch-chipagent-config"].model == "auto"

    def test_every_container_runs_a_port_main(self, docs):
        seen = set()
        for name, c in containers(docs).items():
            if "certgen" in name:
                continue
            cmd = c["command"]
            assert cmd[:2] == ["python", "-m"], name
            module = cmd[2]
            assert module.startswith("nos_tpu_torch.cmd."), name
            main = module.rsplit(".", 1)[1]
            assert (ROOT / "nos_tpu_torch/cmd" / f"{main}.py").is_file()
            seen.add(main)
            if main != "metricsexporter":
                assert cmd[cmd.index("--config") + 1] == \
                    "/etc/nos-tpu-torch/config.yaml"
        assert seen == set(MAINS)

    def test_the_agents_follow_their_partitioning_kind(self, docs):
        for doc in docs:
            if doc["kind"] != "DaemonSet":
                continue
            spec = doc["spec"]["template"]["spec"]
            kind = spec["nodeSelector"]["nos.nebuly.com/gpu-partitioning"]
            cmd = spec["containers"][0]["command"]
            assert ("chipagent" in doc["metadata"]["name"]) == \
                (kind == pconfig.MPS_KIND)
            assert cmd[cmd.index("--node") + 1] == "$(NODE_NAME)"
            if kind == pconfig.MIG_KIND:
                assert cmd[cmd.index("--device") + 1] == "cuda"

    def test_the_exporter_reads_the_scheduler_s_snapshot(self, docs):
        cmd = containers(docs)["nos-tpu-torch-metricsexporter"]["command"]
        src = cmd[cmd.index("--source") + 1]
        assert src == "http://nos-tpu-torch-scheduler:8081"
        services = {d["metadata"]["name"] for d in docs
                    if d["kind"] == "Service"}
        assert {"nos-tpu-torch-scheduler", "nos-tpu-torch-partitioner",
                "nos-tpu-torch-operator-webhook"} <= services


    def test_every_config_validates_through_the_renderer(self, docs):
        # the renderer's own table names every rendered config's class
        assert set(helm.CONFIG_KINDS) == set(CONFIGS)
        assert helm.validate_configmaps(docs) == 6
        stray = {"kind": "ConfigMap", "metadata": {"name": "stray-config"},
                 "data": {"config.yaml": "{}"}}
        with pytest.raises(AssertionError, match="CONFIG_KINDS"):
            helm.validate_configmaps(docs + [stray])

    def test_both_renderers_render_both_charts_alike(self):
        # the port's renderer is the JAX package's subset, unchanged: on
        # every template of both charts the two give the same text
        from nos_tpu.testing import helm as jax_helm

        charts = {ROOT / "deploy/helm/nos-tpu": jax_helm.default_context,
                  CHART: default_context}
        templates = 0
        for chart, make_context in charts.items():
            ctx = make_context(chart)
            for path in sorted(chart.glob("templates/**/*.yaml")):
                text = path.read_text()
                assert helm.render(text, ctx) == jax_helm.render(text, ctx), \
                    path
                templates += 1
            assert render_chart(chart, ctx) == jax_helm.render_chart(chart,
                                                                     ctx)
        assert templates > 40


class TestValues:
    @pytest.mark.parametrize("path,value,cfg,field", [
        ("partitioner.kind", "mps", "partitioner", "kind"),
        ("partitioner.spareHostsPerPool", 1, "partitioner",
         "spare_hosts_per_pool"),
        ("partitioner.nodeSuspectAfterSeconds", 5.0, "partitioner",
         "node_suspect_after_s"),
        ("scheduler.preemptBudgetPerCycle", 4, "scheduler",
         "preempt_budget_per_cycle"),
        ("scheduler.displacedAgeCapSeconds", 0, "scheduler",
         "displaced_age_cap_s"),
        ("gpuMemoryGBPerGPU", 40, "operator", "gpu_memory_gb_per_gpu"),
        ("sloIntervalSeconds", 2.5, "scheduler", "slo_interval_s"),
        ("partitioner.defrag.enabled", True, "partitioner",
         "defrag_enabled"),
        ("partitioner.defrag.paybackMin", 1.2, "partitioner",
         "defrag_payback_min"),
        ("partitioner.defrag.intervalSeconds", 6.0, "partitioner",
         "defrag_interval_s"),
        ("partitioner.defrag.drainTimeoutSeconds", 30.0, "partitioner",
         "defrag_drain_timeout_s"),
        ("scheduler.elasticGrowBudgetPerCycle", 2, "scheduler",
         "elastic_grow_budget_per_cycle"),
        ("chipagent.heartbeat", True, "chipagent", "heartbeat"),
        ("sliceagent.model", "nvidia-h100-80gb-hbm3", "sliceagent",
         "model"),
        ("autoscaler.reconcileIntervalSeconds", 0.25, "autoscaler",
         "reconcile_interval_s"),
        ("autoscaler.statusConfigMap", "serving-status", "autoscaler",
         "status_configmap"),
        ("autoscaler.leaderElection.enabled", False, "autoscaler",
         "leader_election"),
        ("sloIntervalSeconds", 2.5, "autoscaler", "slo_interval_s"),
    ])
    def test_a_value_reaches_its_config_field(self, path, value, cfg,
                                              field, tmp_path):
        got = configs(render_chart(CHART, context(**{path: value})),
                      tmp_path)
        assert getattr(got[f"nos-tpu-torch-{cfg}-config"], field) == value

    def test_the_defragmenter_and_the_grow_budget_load(self, tmp_path):
        """defrag_enabled true and a grow budget of 2 load in the port
        and build the planes: the MIG partitioner's defragmenter (the MPS
        family has none) and the scheduler's budget."""
        from nos_tpu_torch.cmd import assembly, scheduler
        from nos_tpu_torch.kube.client import APIServer
        from nos_tpu_torch.partitioning.state import ClusterState

        got = configs(render_chart(CHART, context(**{
            "partitioner.defrag.enabled": True,
            "scheduler.elasticGrowBudgetPerCycle": 2})), tmp_path)
        part = got["nos-tpu-torch-partitioner-config"]
        sched = got["nos-tpu-torch-scheduler-config"]
        assert part.defrag_enabled and sched.elastic_grow_budget_per_cycle \
            == 2
        part.leader_election = False
        _, controllers = assembly.build_partitioner_main(
            APIServer(), ClusterState(), part)
        assert [c._defrag is not None for c in controllers] == [True, False]
        main = scheduler.build_scheduler_main(APIServer(), sched)
        assert main.scheduler._elastic_grow_budget == 2
        main.scheduler.close()

    def test_the_webhook_off_renders_none(self, tmp_path):
        docs = render_chart(CHART, context(**{
            "operator.webhook.enabled": False}))
        kinds = {d["kind"] for d in docs}
        assert "ValidatingWebhookConfiguration" not in kinds
        op = configs(docs, tmp_path)["nos-tpu-torch-operator-config"]
        assert op.webhook_port == 0 and op.webhook_cert_dir == ""

    def test_a_main_turned_off_renders_nothing_of_it(self):
        docs = render_chart(CHART, context(**{"sliceagent.enabled": False}))
        assert not [d for d in docs if "sliceagent" in d["metadata"]["name"]]

    def test_a_kubeconfig_secret_reaches_every_main(self, tmp_path):
        docs = render_chart(CHART, context(**{
            "kubeconfig.secret": "nos-kubeconfig"}))
        got = configs(docs, tmp_path, validate=False)
        assert {c.kubeconfig for c in got.values()} == {
            "/etc/nos-tpu-torch-kube/config"}
        # the loader checks that the file exists: it is mounted at run
        with pytest.raises(pconfig.ConfigError, match="does not exist"):
            got["nos-tpu-torch-scheduler-config"].validate()
        for doc in docs:
            if doc["kind"] in ("Deployment", "DaemonSet"):
                vols = doc["spec"]["template"]["spec"]["volumes"]
                assert {"name": "kubeconfig", "secret": {
                    "secretName": "nos-kubeconfig"}} in vols


class TestKubeletMounts:
    """On a cluster the agents reach the kubelet's sockets: the chip
    agent its device-plugin directory, the MIG agent that and its
    pod-resources socket, each mounted from the node at the path the
    mains look for (``device/plugin.py``)."""

    WANT = {"nos-tpu-torch-chipagent": ("device-plugins",),
            "nos-tpu-torch-sliceagent": ("device-plugins", "pod-resources")}

    @staticmethod
    def _mounts(docs) -> dict:
        out = {}
        for doc in docs:
            if doc["kind"] != "DaemonSet":
                continue
            spec = doc["spec"]["template"]["spec"]
            (c,) = spec["containers"]
            host = {v["name"]: v["hostPath"] for v in spec["volumes"]
                    if "hostPath" in v}
            out[doc["metadata"]["name"]] = {
                m["name"]: (m["mountPath"], host[m["name"]])
                for m in c["volumeMounts"] if m["name"] in host}
        return out

    def test_mounted_with_a_kubeconfig(self):
        from nos_tpu_torch.device import plugin

        docs = render_chart(CHART, context(**{
            "kubeconfig.secret": "nos-kubeconfig"}))
        paths = {"device-plugins": plugin.PLUGINS_DIR,
                 "pod-resources": str(pathlib.PurePosixPath(
                     plugin.POD_RESOURCES_SOCKET).parent)}
        assert self._mounts(docs) == {
            name: {v: (paths[v], {"path": paths[v], "type": "Directory"})
                   for v in volumes}
            for name, volumes in self.WANT.items()}

    def test_not_mounted_in_memory(self, docs):
        assert self._mounts(docs) == {name: {} for name in self.WANT}


class TestAutoscalerChart:
    """The autoscaler's templates (the JAX chart's
    ``templates/autoscaler/``, ported): rendered, loaded through the
    port's AutoscalerConfig, and built into a main."""

    def test_the_rendered_config_builds_the_main(self, docs, tmp_path):
        from nos_tpu_torch.cmd.autoscaler import build_autoscaler_main
        from nos_tpu_torch.kube.client import APIServer

        cfg = configs(docs, tmp_path)["nos-tpu-torch-autoscaler-config"]
        assert cfg.status_namespace == "nos-tpu-torch-system"
        assert cfg.leader_election and cfg.services == []
        cfg.leader_election = False
        main = build_autoscaler_main(APIServer(), cfg)
        assert main.autoscaler.services() == []
        assert main.autoscaler.reconcile() == {}

    def test_its_role_creates_and_deletes_replica_pods(self, docs):
        role = next(d for d in docs if d["kind"] == "ClusterRole"
                    and d["metadata"]["name"] == "nos-tpu-torch-autoscaler")
        verbs = {r["resources"][0]: set(r["verbs"]) for r in role["rules"]}
        assert {"create", "delete", "list"} <= verbs["pods"]
        assert {"create", "patch"} <= verbs["configmaps"]
        dep = containers(docs)["nos-tpu-torch-autoscaler"]
        assert dep["command"][:3] == ["python", "-m",
                                      "nos_tpu_torch.cmd.autoscaler"]

    @pytest.mark.parametrize("service,ok", [
        ({"name": "chat", "namespace": "serve", "slice_shape": "1g.20gb",
          "min_replicas": 2, "max_replicas": 12}, True),
        ({"name": "embed", "timeshare_gb": 8}, True),
        ({"name": "chat", "slice_shape": "1x1"}, False),
        ({"name": "chat", "timeshare_gb": 8, "max_replica": 3}, False),
    ])
    def test_a_service_in_the_rendered_config_is_checked(
            self, docs, tmp_path, service, ok):
        """A service added to the rendered ``services:`` loads when its
        fields mean something on an H100 and fails the load otherwise (a
        TPU slice shape, a typoed key)."""
        import json

        doc = next(d for d in docs if d["kind"] == "ConfigMap" and
                   d["metadata"]["name"] == "nos-tpu-torch-autoscaler-config")
        text = doc["data"]["config.yaml"].replace(
            "services: []", f"services: [{json.dumps(service)}]")
        path = tmp_path / "autoscaler.yaml"
        path.write_text(text)
        if ok:
            cfg = pconfig.load_config(path, pconfig.AutoscalerConfig)
            assert cfg.services == [service]
        else:
            with pytest.raises(pconfig.ConfigError, match="services\\[0\\]"):
                pconfig.load_config(path, pconfig.AutoscalerConfig)

    def test_off_renders_nothing_of_it(self):
        docs = render_chart(CHART, context(**{"autoscaler.enabled": False}))
        assert not [d for d in docs if "autoscaler" in d["metadata"]["name"]]

class TestProvisionerChart:
    """The provisioner's templates (the JAX chart's
    ``templates/provisioner/``, ported): off by default, and when on
    rendered, loaded through the port's ProvisionerConfig and built into
    a main."""

    @pytest.fixture(scope="class")
    def on(self):
        return render_chart(CHART, context(**{"provisioner.enabled": True}))

    def test_off_by_default_renders_nothing_of_it(self, docs):
        assert not [d for d in docs
                    if "provisioner" in d["metadata"]["name"]]

    def test_the_rendered_config_builds_the_main(self, on, tmp_path):
        from nos_tpu_torch.cmd.assembly import build_provisioner_main
        from nos_tpu_torch.kube.client import APIServer
        from nos_tpu_torch.obs import set_flight_block

        cfg = configs(on, tmp_path)["nos-tpu-torch-provisioner-config"]
        assert cfg.enabled and cfg.leader_election
        assert cfg.inventory_namespace == "nos-tpu-torch-system"
        assert (cfg.scale_up_deficit_chips, cfg.hbm_gb_per_chip,
                cfg.chips_per_host_cap) == (8.0, 80.0, 8.0)
        cfg.leader_election = False
        prev = set_flight_block("capacity")
        try:
            main = build_provisioner_main(APIServer(), cfg)
            main.provisioner.reconcile()
            assert main.provisioner.report()["pools"] == {}
        finally:
            set_flight_block("capacity", prev)

    def test_its_role_and_its_container(self, on):
        role = next(d for d in on if d["kind"] == "ClusterRole"
                    and d["metadata"]["name"] == "nos-tpu-torch-provisioner")
        verbs = {r["resources"][0]: set(r["verbs"]) for r in role["rules"]}
        assert "delete" in verbs["nodes"] and "patch" in verbs["nodes"]
        assert {"create", "patch"} <= verbs["configmaps"]
        dep = containers(on)["nos-tpu-torch-provisioner"]
        assert dep["command"] == ["python", "-m",
                                  "nos_tpu_torch.cmd.provisioner",
                                  "--config",
                                  "/etc/nos-tpu-torch/config.yaml"]

    @pytest.mark.parametrize("path,value,field", [
        ("provisioner.pollIntervalSeconds", 0.5, "poll_interval_s"),
        ("provisioner.scaleUpDeficitChips", 0.25, "scale_up_deficit_chips"),
        ("provisioner.scaleDownIdleSeconds", 5.0, "scale_down_idle_s"),
        ("provisioner.breakerThreshold", 2, "breaker_threshold"),
        ("provisioner.leaderElection.enabled", False, "leader_election"),
    ])
    def test_a_value_reaches_its_config_field(self, path, value, field,
                                              tmp_path):
        got = configs(render_chart(CHART, context(**{
            "provisioner.enabled": True, path: value})), tmp_path)
        assert getattr(got["nos-tpu-torch-provisioner-config"], field) \
            == value


class TestCRDs:
    def test_the_quota_and_gang_kinds_in_the_port_s_group(self):
        import yaml

        crds = {}
        for path in sorted((CHART / "crds").glob("*.yaml")):
            doc = yaml.safe_load(path.read_text())
            assert doc["spec"]["group"] == GROUP
            crds[doc["spec"]["names"]["kind"]] = doc
        assert set(crds) == {"ElasticQuota", "CompositeElasticQuota",
                             "PodGroup"}
        for kind, doc in crds.items():
            api_version, plural, namespaced = KIND_REST[kind]
            assert api_version == GROUP_VERSION
            assert doc["spec"]["names"]["plural"] == plural
            assert doc["metadata"]["name"] == f"{plural}.{GROUP}"
            assert (doc["spec"]["scope"] == "Namespaced") == namespaced
            version = doc["spec"]["versions"][0]
            assert f"{GROUP}/{version['name']}" == GROUP_VERSION
