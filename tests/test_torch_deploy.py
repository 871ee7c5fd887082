"""The port's helm chart, ``deploy/helm/nos-tpu-torch/``, rendered on the
CPU by the port's renderer (``nos_tpu_torch.testing.helm.render_chart``,
the template subset ``_helpers.tpl`` states; it renders both charts as
the JAX package's does): every manifest parses,
every rendered config loads through the port's ``api/config.py``, every
container runs a main under ``nos_tpu_torch/cmd/``, and the CRDs are the
port's kinds in its API group.  The JAX chart beside it is not touched.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import pytest

from nos_tpu_torch.api import config as pconfig
from nos_tpu_torch.api import constants as pconst
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


# -- the image ----------------------------------------------------------------

DOCKERFILE = ROOT / "deploy/image/Dockerfile"


def dockerfile_stages(path: pathlib.Path = DOCKERFILE) -> dict[str, dict]:
    """The Dockerfile's stages by name, in order: each its base image (the
    global ARGs' defaults substituted) and its instructions as (keyword,
    text) with continuation lines joined."""
    lines, cur = [], ""
    for raw in path.read_text().splitlines():
        line = raw.strip()
        if not cur and (not line or line.startswith("#")):
            continue
        if line.endswith("\\"):
            cur += line[:-1] + " "
            continue
        lines.append(cur + line)
        cur = ""
    args: dict[str, str] = {}
    stages: dict[str, dict] = {}
    stage = None
    for line in lines:
        keyword, _, text = line.partition(" ")
        keyword, text = keyword.upper(), text.strip()
        if keyword == "ARG" and stage is None:
            name, _, default = text.partition("=")
            args[name] = default
        elif keyword == "FROM":
            words = text.split()
            base = words[0]
            for name, value in args.items():
                base = base.replace("${" + name + "}", value)
            name = words[2] if len(words) == 3 and words[1].upper() == "AS" \
                else str(len(stages))
            stage = stages[name] = {"base": base, "steps": []}
        else:
            stage["steps"].append((keyword, text))
    return stages


def copied(stages: dict, name: str) -> set[str]:
    """The build context's paths stage ``name`` holds through its COPYs,
    through ``--from`` stages too."""
    out = set()
    for keyword, text in stages[name]["steps"]:
        if keyword != "COPY":
            continue
        words = text.split()
        source = words[-2]
        if words[0].startswith("--from="):
            stage = words[0].split("=", 1)[1]
            out |= {p for p in copied(stages, stage)
                    if p == pathlib.PurePosixPath(source).name}
        else:
            out.add(source.rstrip("/"))
    return out


def _has_main(module: str) -> bool:
    import ast

    tree = ast.parse((ROOT / (module.replace(".", "/") + ".py")).read_text())
    return any(isinstance(n, ast.FunctionDef) and n.name == "main"
               for n in tree.body)


class TestImage:
    """``deploy/image/Dockerfile``, checked statically (no docker here):
    the chart's mains run from its control-plane stage, the default
    target; nothing of the JAX package is copied; the native shim and the
    kernels are built at image build time."""

    @pytest.fixture(scope="class")
    def stages(self):
        return dockerfile_stages()

    def test_the_stages(self, stages):
        assert list(stages) == ["shim", "workload", "control-plane"]
        assert stages["control-plane"]["base"] == "python:3.12-slim"

    def test_every_chart_main_is_a_module_the_control_plane_copies(
            self, stages):
        docs = render_chart(CHART, context(**{
            "metricsexporter.enabled": True, "provisioner.enabled": True,
            "autoscaler.enabled": True}))
        modules = set()
        for name, c in containers(docs).items():
            if "certgen" not in name:
                assert c["command"][:2] == ["python", "-m"], name
                modules.add(c["command"][2])
        assert {m.rsplit(".", 1)[1] for m in modules} == \
            set(MAINS) | {"provisioner"}
        assert copied(stages, "control-plane") == {"nos_tpu_torch"}
        for module in modules:
            assert module.split(".")[0] == "nos_tpu_torch", module
            assert _has_main(module), module

    def test_no_stage_copies_the_jax_package(self, stages):
        for name, stage in stages.items():
            for keyword, text in stage["steps"]:
                if keyword in ("COPY", "ADD"):
                    sources = [w for w in text.split()[:-1]
                               if not w.startswith("--")]
                    assert not any(
                        pathlib.PurePosixPath(s).parts[0] == "nos_tpu"
                        for s in sources), (name, text)

    def test_the_control_plane_installs_no_torch(self, stages):
        steps = stages["control-plane"]["steps"]
        installs = " ".join(t for k, t in steps if k == "RUN")
        assert "pip install" in installs
        for package in ("pyyaml", "grpcio", "protobuf"):
            assert package in installs.split()
        assert "torch" not in installs
        assert "torch" not in stages["control-plane"]["base"]

    def test_the_shim_is_built_by_native_load(self, stages):
        runs = [t for k, t in stages["shim"]["steps"] if k == "RUN"]
        assert any("from nos_tpu_torch.device import native; native.load()"
                   in t for t in runs)
        assert any("g++" in t for t in runs)
        assert copied(stages, "shim") == {"nos_tpu_torch"}

    def test_the_workload_builds_the_kernels_and_runs_the_train_main(
            self, stages):
        steps = stages["workload"]["steps"]
        runs = [t for k, t in steps if k == "RUN"]
        assert any("from nos_tpu_torch.ops import _build; _build.build()"
                   in t for t in runs)
        assert any("torch==" in t for t in runs)
        assert "cuda" in stages["workload"]["base"] \
            and "devel" in stages["workload"]["base"]
        entry = [t for k, t in steps if k == "ENTRYPOINT"]
        assert entry == ['["python", "-m", "nos_tpu_torch.cmd.train"]']
        assert _has_main("nos_tpu_torch.cmd.train")

    def test_the_chart_names_the_image_s_dockerfile(self):
        values = (CHART / "values.yaml").read_text()
        assert "deploy/image/Dockerfile" in values
        assert context()["Values"]["image"]["repository"] == \
            "ghcr.io/nos-tpu/nos-tpu-torch"


# -- the deploy on-ramp -------------------------------------------------------
# hack/render-chart-torch.py, deploy/config-torch/, hack/kind/
# cluster-torch.yaml and hack/dev-cluster-torch.sh: the port's
# counterparts of the JAX package's hack/render-chart.py,
# deploy/config/, hack/kind/cluster.yaml and hack/dev-cluster.sh.

RENDER_CLI = ROOT / "hack/render-chart-torch.py"
DEV_CLUSTER = ROOT / "hack/dev-cluster-torch.sh"
CONFIG_TORCH = ROOT / "deploy/config-torch"
# the overrides dev-cluster-torch.sh's `up` renders with (a kind worker
# has no GPU)
KIND_SETS = ("kubeconfig.secret=nos-tpu-torch-kube", "sliceagent.device=cpu",
             "sliceagent.model=nvidia-h100-80gb-hbm3",
             "chipagent.model=nvidia-h100-80gb-hbm3")


def _cli(*args: str, cwd) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, str(RENDER_CLI), *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=120)


def _kinds_line(docs: list[dict]) -> str:
    kinds: dict[str, int] = {}
    for doc in docs:
        kinds[doc["kind"]] = kinds.get(doc["kind"], 0) + 1
    return ", ".join(f"{k} x{v}" for k, v in sorted(kinds.items()))


class TestRenderCLI:
    def test_it_writes_what_the_renderer_renders(self, tmp_path):
        import yaml

        out = _cli("--out", str(tmp_path / "out"), cwd=tmp_path)
        assert out.returncode == 0, out.stderr
        want = render_chart(CHART)
        written = list(yaml.safe_load_all(
            (tmp_path / "out/nos-tpu-torch.yaml").read_text()))
        assert written == want
        crds = list(yaml.safe_load_all(
            (tmp_path / "out/crds.yaml").read_text()))
        assert [c["spec"]["names"]["kind"] for c in crds] == \
            ["CompositeElasticQuota", "ElasticQuota", "PodGroup"]
        lines = out.stdout.splitlines()
        assert lines[-2] == (f"rendered {len(want)} manifests from "
                             f"nos-tpu-torch: {_kinds_line(want)}")
        assert lines[-1] == (
            f"validated {helm.validate_configmaps(want)} ConfigMaps "
            f"through the typed loaders; 3 CRDs parsed")

    def test_the_kind_overrides_reach_the_agents(self, tmp_path):
        import yaml

        args = [a for s in KIND_SETS for a in ("--set", s)]
        out = _cli(*args, "--out", str(tmp_path), cwd=tmp_path)
        assert out.returncode == 0, out.stderr
        docs = list(yaml.safe_load_all(
            (tmp_path / "nos-tpu-torch.yaml").read_text()))
        # validated by the CLI but for the kubeconfig, mounted at run
        got = configs(docs, tmp_path, validate=False)
        assert got["nos-tpu-torch-sliceagent-config"].model == \
            "nvidia-h100-80gb-hbm3"
        command = containers(docs)["nos-tpu-torch-sliceagent"]["command"]
        assert command[command.index("--device") + 1] == "cpu"
        assert got["nos-tpu-torch-chipagent-config"].model == \
            "nvidia-h100-80gb-hbm3"
        assert all(cfg.kubeconfig for cfg in got.values())
        assert "--set" in DEV_CLUSTER.read_text()
        for s in KIND_SETS:
            assert s.split("=")[0] in DEV_CLUSTER.read_text()

    @pytest.mark.parametrize("value, why", [
        ("partitioner.kind=banana",
         "ConfigError: kind must be mig|mps|hybrid, got 'banana'"),
        ("scheduler.cycleIntervalSeconds=0",
         "ConfigError: cycle_interval_s must be positive"),
        ("partitioner.nosuchknob=1",
         "ValueError: --set partitioner.nosuchknob: the chart has no such "
         "value")], ids=["bad-kind", "bad-interval", "unknown-value"])
    def test_a_refused_config_fails_the_render(self, value, why, tmp_path):
        out = _cli("--set", value, "--out", str(tmp_path / "out"),
                   cwd=tmp_path)
        assert out.returncode == 1
        assert why in out.stderr
        assert "rendered" not in out.stdout
        assert not (tmp_path / "out").exists()

    def test_it_imports_neither_torch_nor_the_jax_package(self, tmp_path):
        probe = (
            "import runpy, sys\n"
            f"sys.argv = [{str(RENDER_CLI)!r}]\n"
            "try:\n"
            f"    runpy.run_path({str(RENDER_CLI)!r}, run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('torch', 'jax', 'flax', 'nos_tpu'))\n"
            "print('IMPORTED', bad)\n")
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        out = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path,
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.splitlines()[-1] == "IMPORTED []"


class TestKustomizeBase:
    def test_it_lists_exactly_the_port_s_crds(self):
        import yaml

        top = yaml.safe_load((CONFIG_TORCH / "kustomization.yaml").read_text())
        assert top["kind"] == "Kustomization" and top["resources"] == ["crd"]
        crd_dir = CONFIG_TORCH / "crd"
        base = yaml.safe_load((crd_dir / "kustomization.yaml").read_text())
        listed = sorted((crd_dir / r).resolve() for r in base["resources"])
        assert listed == sorted(p.resolve()
                                for p in (CHART / "crds").glob("*.yaml"))
        for path in listed:
            assert yaml.safe_load(path.read_text())["kind"] == \
                "CustomResourceDefinition"


def _example(name: str) -> dict:
    import yaml

    return yaml.safe_load((CONFIG_TORCH / name).read_text())


class TestExamplePods:
    @pytest.mark.parametrize("name", ["train-pod-example.yaml",
                                      "serving-pod-example.yaml"])
    def test_it_names_the_port_and_one_h100_resource(self, name):
        from nos_tpu_torch.scheduler.scheduler import Scheduler
        from nos_tpu_torch.topology.profile import (
            gb_from_resource, profile_from_resource)

        text = (CONFIG_TORCH / name).read_text()
        assert "nos_tpu_torch" in text
        assert "nos.tpu/" not in text and "nos_tpu.cmd" not in text
        doc = _example(name)
        assert (doc["apiVersion"], doc["kind"]) == ("v1", "Pod")
        assert doc["spec"]["schedulerName"] == Scheduler.name
        (container,) = doc["spec"]["containers"]
        gpu = {r: q for r, q in container["resources"]["limits"].items()
               if r.startswith("nvidia.com/")}
        assert len(gpu) == 1 and list(gpu.values()) == [1]
        (res,) = gpu
        assert (profile_from_resource(res) is not None) != \
            (gb_from_resource(res) is not None)

    def test_the_train_pod_runs_the_port_s_main_with_its_hooks(self):
        doc = _example("train-pod-example.yaml")
        (container,) = doc["spec"]["containers"]
        assert container["command"][:4] == \
            ["python", "-m", "nos_tpu_torch.cmd.train", "--config"]
        assert _has_main("nos_tpu_torch.cmd.train")
        env = {e["name"]: e["valueFrom"]["fieldRef"]["fieldPath"]
               for e in container["env"]}
        assert env == {"POD_NAME": "metadata.name",
                       "POD_NAMESPACE": "metadata.namespace"}
        assert doc["metadata"]["labels"] == {
            pconst.LABEL_POD_GROUP: "train-example-gang"}
        assert list(container["resources"]["limits"]) == \
            ["nvidia.com/mig-3g.40gb"]

    def test_the_serving_pod_carries_the_tier_contract(self):
        doc = _example("serving-pod-example.yaml")
        meta = doc["metadata"]
        assert meta["labels"] == {pconst.LABEL_TIER: pconst.TIER_SERVING,
                                  pconst.LABEL_SERVICE: "chat"}
        assert meta["annotations"] == {pconst.ANNOT_SERVING_LOAD: "0"}
        (container,) = doc["spec"]["containers"]
        assert "nvidia.com/gpu-10gb" in container["resources"]["limits"]

    def test_both_are_planned_and_bound_over_the_kind_nodes(self):
        from nos_tpu_torch.testing import devcluster

        nodes = devcluster.kind_nodes()
        pods = devcluster.example_pods()
        assert [p.metadata.name for p in pods] == \
            ["train-example", "chat-replica-example"]
        got = devcluster.plan_and_bind(nodes, pods)
        mig, mps = (n.metadata.name for n in nodes)
        assert got["bound"] == {"train-example": mig,
                                "chat-replica-example": mps}
        assert got["geometry"][mig].get("nvidia.com/mig-3g.40gb", 0) >= 1
        assert got["geometry"][mps] == {"nvidia.com/gpu-10gb": 1.0}


class TestKindConfig:
    def test_the_workers_carry_make_gpu_node_s_labels(self):
        import yaml

        from nos_tpu_torch.testing import devcluster
        from nos_tpu_torch.testing.factory import make_gpu_node
        from nos_tpu_torch.topology import DEFAULT_REGISTRY

        config = yaml.safe_load(devcluster.KIND_CONFIG.read_text())
        assert [n["role"] for n in config["nodes"]] == \
            ["control-plane", "worker", "worker"]
        workers = devcluster.kind_worker_labels()
        assert [w[pconst.LABEL_PARTITIONING] for w in workers] == \
            [pconst.MIG_KIND, pconst.MPS_KIND]
        for labels in workers:
            assert pconst.LABEL_GPU_COUNT in labels
            built = make_gpu_node(
                "w", model=DEFAULT_REGISTRY.get(
                    labels[pconst.LABEL_ACCELERATOR]),
                gpus=int(labels[pconst.LABEL_GPU_COUNT]),
                partitioning=labels[pconst.LABEL_PARTITIONING],
                domain=labels[pconst.LABEL_NVLINK_DOMAIN],
                host_index=int(labels[pconst.LABEL_HOST_INDEX]))
            assert built.metadata.labels == labels

    def test_a_discovered_model_replaces_the_label_s(self):
        from dataclasses import replace

        from nos_tpu_torch.testing import devcluster
        from nos_tpu_torch.topology import DEFAULT_REGISTRY, H100_80GB

        twin = replace(H100_80GB, name="nvidia-h100-80gb-hbm3-twin")
        reg = dict(DEFAULT_REGISTRY.models)
        try:
            DEFAULT_REGISTRY.models[twin.name] = twin
            nodes = devcluster.kind_nodes(model=twin.name)
        finally:
            DEFAULT_REGISTRY.models.clear()
            DEFAULT_REGISTRY.models.update(reg)
        assert {n.metadata.labels[pconst.LABEL_ACCELERATOR]
                for n in nodes} == {twin.name}


class TestDevClusterScript:
    def _run(self, mode: str, tmp_path, path: str | None = None):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["OUT"] = str(tmp_path / "rendered")
        if path is not None:
            env["PATH"] = path
        import shutil

        return subprocess.run([shutil.which("bash"), str(DEV_CLUSTER), mode],
                              cwd=tmp_path,
                              env=env, capture_output=True, text=True,
                              timeout=120)

    def test_render_runs_with_python_alone(self, tmp_path):
        out = self._run("render", tmp_path)
        assert out.returncode == 0, out.stderr
        assert (tmp_path / "rendered/nos-tpu-torch.yaml").exists()
        assert (tmp_path / "rendered/crds.yaml").exists()
        assert "validated" in out.stdout

    def test_up_stops_before_anything_without_kind(self, tmp_path):
        import shutil

        # a PATH that holds the script's own needs and no cluster tools
        bin_dir = tmp_path / "bin"
        bin_dir.mkdir()
        for tool, target in (("dirname", shutil.which("dirname")),
                             ("python3", sys.executable)):
            (bin_dir / tool).symlink_to(target)
        out = self._run("up", tmp_path, path=str(bin_dir))
        assert out.returncode == 1
        assert "kind not found" in out.stderr
        assert not (tmp_path / "rendered").exists()

    def test_an_unknown_mode_is_a_usage_error(self, tmp_path):
        out = self._run("sideways", tmp_path)
        assert out.returncode == 2 and "usage:" in out.stderr


class TestSmokeOnramp:
    """chip_smoke.py's on-ramp line, run here as the card's host runs it
    beside the card phases (it touches no GPU)."""

    def test_the_line_renders_plans_and_binds(self):
        import chip_smoke

        assert ("onramp", "_onramp_line") in chip_smoke.HOST_JOBS
        assert "onramp" in chip_smoke.HOST_LINES
        line = chip_smoke._onramp_line("cpu")
        docs = render_chart(CHART)
        assert (line["phase"], line["manifests"], line["configmaps"],
                line["crds"]) == ("onramp", len(docs), 6, 3)
        assert sorted(line["nodes"].values()) == ["mig", "mps"]
        assert line["bound"] == {
            "train-example": "nos-tpu-torch-dev-worker",
            "chat-replica-example": "nos-tpu-torch-dev-worker2"}
        # no NVML here: discovery falls to the configured H100
        assert (line["model"], line["discovery"]) == \
            ("nvidia-h100-80gb-hbm3", "configured")

    def test_a_refused_render_fails_the_smoke(self, monkeypatch):
        import chip_smoke

        monkeypatch.setattr(chip_smoke, "ROOT", ROOT / "no-such-checkout")
        with pytest.raises(SystemExit,
                           match="render-chart-torch.py exited 2"):
            chip_smoke._onramp_line("cpu")
