"""The port's training main (nos_tpu_torch.cmd.train) against the JAX
main's contract, tests/test_train_cmd.py's TestTrainMain mirrored on 8
gloo ranks over the same mesh (fsdp=2,tp=2,sp=2, TINY with ring
attention): the loop and its checkpoints, resume at the latest step, the
"already complete" None, a fresh run into a used directory refused, the
config checks; torchrun's environment failing fast; the exits at a
checkpoint on a dp-resize or a migration; the pod hooks against the JAX
main's on the same pod, in memory and over ``tests/k8s_stub.py``, and
``train`` on one CPU rank against the stub as a deployed pod runs it;
the device grant's order in ``main`` (apply, then validate, then the
process group); and dryrun_multigpu on 2, 4 and 6 ranks."""

import collections
import contextlib
import json
import logging
import math
import types

import pytest
import torch
import torch.distributed as dist

from nos_tpu_torch.api.config import ConfigError, load_config
from nos_tpu_torch.cmd import train as cmd
from nos_tpu_torch.cmd.train import TrainConfig, maybe_init_distributed
from nos_tpu_torch.entry import dryrun_multigpu
from nos_tpu_torch.exporter.metrics import REGISTRY, Registry
from nos_tpu_torch.parallel.mesh import run_ranks
from nos_tpu_torch.testing import ranks

BASE = dict(model="tiny", attn_impl="ring", batch_size=4, seq_len=64,
            steps=6, mesh="fsdp=2,tp=2,sp=2", log_every=3,
            checkpoint_every=3)


def tiny_cfg(**kw) -> TrainConfig:
    cfg = TrainConfig(**{**BASE, **kw})
    cfg.validate()
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every scenario of ranks.train_main_scenarios, as rank 0 saw it
    (every rank must have seen the same)."""
    out = run_ranks(ranks.train_main_scenarios, 8,
                    str(tmp_path_factory.mktemp("train")), BASE, timeout=300)
    assert all(o == out[0] for o in out[1:])
    return out[0]


class TestTrainMain:
    def test_loop_runs_and_checkpoints(self, runs):
        assert math.isfinite(runs["loop"]["loss"])
        assert runs["loop"]["latest"] == 6
        # progress only after each landed save
        assert runs["loop"]["progress"] == [0.5, 1.0]

    def test_resume_picks_up_from_latest(self, runs):
        assert runs["resume_build"] == {"start_step": 6, "state_step": 6}
        assert math.isfinite(runs["resume"])

    def test_already_complete_returns_none(self, runs):
        assert runs["complete"] == [None, None]

    def test_restart_continues_bitwise(self, runs):
        # 4 steps, a checkpoint, a restart to 6 (and its final save)
        assert runs["restart"]["resumed"] == runs["restart"]["straight"]
        assert runs["restart"]["latest"] == 6

    def test_fresh_run_into_used_dir_rejected(self, runs):
        assert "resume" in runs["fresh_into_used"]

    def test_invalid_model_rejected(self):
        with pytest.raises(ConfigError, match="model"):
            tiny_cfg(model="gpt17")

    def test_missing_data_path_rejected(self):
        with pytest.raises(ConfigError, match="data_path"):
            tiny_cfg(data_path="/nonexistent/corpus.bin")

    def test_health_addr_validated_like_other_mains(self):
        with pytest.raises(ConfigError, match="host:port"):
            tiny_cfg(health_probe_addr="8080")

    def test_bad_rank_env_fails_fast(self):
        env = {"WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1"}
        with pytest.raises(RuntimeError, match="unset"):
            maybe_init_distributed("cpu", environ=env)
        with pytest.raises(RuntimeError, match="not an integer"):
            maybe_init_distributed("cpu", environ={**env, "RANK": "worker-1"})
        with pytest.raises(RuntimeError, match="out of range"):
            maybe_init_distributed("cpu", environ={**env, "RANK": "5"})
        with pytest.raises(RuntimeError, match="not an integer"):
            maybe_init_distributed("cpu", environ={"WORLD_SIZE": "two"})
        assert not dist.is_initialized()

    def test_one_process_makes_a_group_of_one(self):
        assert maybe_init_distributed("cpu", environ={})
        try:
            assert dist.get_world_size() == 1
            assert dist.get_backend() == "gloo"
            # a group already there is kept
            assert not maybe_init_distributed("cpu", environ={})
        finally:
            dist.destroy_process_group()

    def test_boot_world_size(self):
        assert cmd.boot_world_size({}) == 1
        assert cmd.boot_world_size({"WORLD_SIZE": "4"}) == 4

    def test_models_accepted(self):
        assert set(cmd._MODELS) == {"tiny", "bench350m", "llama3-8b"}
        for model in cmd._MODELS:
            tiny_cfg(model=model)


class TestExitsAtCheckpoint:
    def test_resize_exits_at_the_first_checkpoint(self, runs):
        # 8 workers asked to become 4: out after the save at step 2
        assert runs["resize"]["latest"] == 2
        assert runs["resize"]["progress"] == [pytest.approx(2 / 6)]
        assert math.isfinite(runs["resize"]["loss"])

    def test_resize_to_the_same_size_keeps_training(self, runs):
        assert runs["same_size"]["latest"] == 6
        assert runs["same_size"]["progress"] == [
            pytest.approx(f) for f in (2 / 6, 4 / 6, 1.0)]

    def test_migrate_exits_at_the_first_checkpoint(self, runs):
        assert runs["migrate"]["latest"] == 2
        assert runs["migrate"]["progress"] == [pytest.approx(2 / 6)]


def _pod_twins(api_kind: str, stack: contextlib.ExitStack):
    """The same pod ("trainer" in "jobs") on each package's substrate:
    in memory, or a KubeClient over a stub of its own."""
    import nos_tpu.kube.client as jclient
    import nos_tpu.kube.rest as jrest
    from nos_tpu.testing.factory import make_pod as jax_make_pod
    from nos_tpu_torch.kube.client import APIServer, KIND_POD
    from nos_tpu_torch.kube.rest import KubeClient, KubeConfig
    from nos_tpu_torch.testing.factory import make_pod

    from k8s_stub import StubApiServer

    if api_kind == "memory":
        api, japi = APIServer(), jclient.APIServer()
    else:
        stubs = [stack.enter_context(StubApiServer()) for _ in range(2)]
        api = KubeClient(KubeConfig(server=stubs[0].url))
        japi = jrest.KubeClient(jrest.KubeConfig(server=stubs[1].url))
        stack.callback(api.close)
        stack.callback(japi.close)
    api.create(KIND_POD, make_pod(name="trainer", namespace="jobs"))
    japi.create("Pod", jax_make_pod(name="trainer", namespace="jobs"))
    return api, japi


def _stamp(api, key: str, value: str) -> None:
    api.patch("Pod", "trainer", "jobs",
              mutate=lambda p: p.metadata.annotations.update({key: value}))


class TestPodHooks:
    """The pod hooks against the JAX main's on the same pod, in memory
    and over the stub (``tests/k8s_stub.py``)."""

    @pytest.mark.parametrize("api_kind", ["memory", "rest"])
    def test_progress_clamps_and_formats_as_jax(self, api_kind):
        import nos_tpu.api.constants as JC
        import nos_tpu.cmd.train as jcmd
        from nos_tpu_torch.api import constants as C

        fracs = (0.25, -0.5, 0.0, 1 / 3, 0.99999, 1.0, 7.3, 2 / 6)
        with contextlib.ExitStack() as stack:
            api, japi = _pod_twins(api_kind, stack)
            for frac in fracs:
                assert cmd.report_job_progress(api, "trainer", "jobs", frac)
                assert jcmd.report_job_progress(japi, "trainer", "jobs",
                                                frac)
                got = api.get("Pod", "trainer", "jobs").metadata.annotations
                want = japi.get("Pod", "trainer",
                                "jobs").metadata.annotations
                assert got[C.ANNOT_JOB_PROGRESS] == \
                    want[JC.ANNOT_JOB_PROGRESS] == \
                    f"{max(0.0, min(1.0, frac)):.4f}"
            # a vanished pod: a warning and False, never a raise
            assert not cmd.report_job_progress(api, "ghost", "jobs", 0.5)
            assert not jcmd.report_job_progress(japi, "ghost", "jobs", 0.5)

    @pytest.mark.parametrize("api_kind", ["memory", "rest"])
    def test_signals_read_as_jax(self, api_kind):
        """The resize stamp parsed (garbage, zero and negative are no
        resize), the migrate stamp's cause, both on one read; a vanished
        pod reads as no signal."""
        import nos_tpu.api.constants as JC
        import nos_tpu.cmd.train as jcmd
        from nos_tpu_torch.api import constants as C

        with contextlib.ExitStack() as stack:
            api, japi = _pod_twins(api_kind, stack)

            def both():
                return ((cmd.read_resize_signal(api, "trainer", "jobs"),
                         cmd.read_migrate_signal(api, "trainer", "jobs")),
                        (jcmd.read_resize_signal(japi, "trainer", "jobs"),
                         jcmd.read_migrate_signal(japi, "trainer", "jobs")))

            got, want = both()
            assert got == want == (None, None)
            for raw in ("banana", "", "0", "-3", "2.5", "4", "1"):
                _stamp(api, C.ANNOT_DP_RESIZE, raw)
                _stamp(japi, JC.ANNOT_DP_RESIZE, raw)
                got, want = both()
                assert got == want
            assert got == (1, None)
            for cause in ("", "node-suspect", "maintenance"):
                _stamp(api, C.ANNOT_MIGRATE, cause)
                _stamp(japi, JC.ANNOT_MIGRATE, cause)
                got, want = both()
                assert got == want == (1, cause or None)
            for fn in (cmd.read_resize_signal, cmd.read_migrate_signal):
                assert fn(api, "ghost", "jobs") is None

    def test_hooks_inert_without_downward_api_identity(self, tmp_path):
        import nos_tpu.cmd.train as jcmd

        kubeconfig = tmp_path / "kubeconfig"
        kubeconfig.write_text(json.dumps(
            {"clusters": [{"name": "c", "cluster": {
                "server": "http://127.0.0.1:1"}}]}))
        for kc in ("", str(kubeconfig)):
            cfg, jcfg = TrainConfig(kubeconfig=kc), \
                jcmd.TrainConfig(kubeconfig=kc)
            for env in ({}, {"POD_NAME": "t"}, {"POD_NAMESPACE": "jobs"}):
                for fn in ("progress_reporter", "signal_checker"):
                    assert getattr(cmd, fn)(cfg, environ=env) is None
                    assert getattr(jcmd, fn)(jcfg, environ=env) is None
        # identity present but no kubeconfig: nothing to annotate against
        env = {"POD_NAME": "t", "POD_NAMESPACE": "jobs"}
        assert cmd.progress_reporter(TrainConfig(), environ=env) is None
        # both, and a kubeconfig: live hooks
        cfg = TrainConfig(kubeconfig=str(kubeconfig))
        assert callable(cmd.progress_reporter(cfg, environ=env))
        assert callable(cmd.signal_checker(cfg, environ=env))

    @pytest.mark.parametrize("text", ["banana: [unclosed", "{not json",
                                      "[]"])
    def test_a_malformed_kubeconfig_disables_the_hooks(self, tmp_path,
                                                       caplog, text):
        import nos_tpu.cmd.train as jcmd

        bad = tmp_path / "kubeconfig"
        bad.write_text(text)
        env = {"POD_NAME": "t", "POD_NAMESPACE": "jobs"}
        with caplog.at_level(logging.WARNING):
            for fn in ("progress_reporter", "signal_checker"):
                assert getattr(cmd, fn)(
                    TrainConfig(kubeconfig=str(bad)), environ=env) is None
                assert getattr(jcmd, fn)(
                    jcmd.TrainConfig(kubeconfig=str(bad)),
                    environ=env) is None
        disabled = [r.getMessage() for r in caplog.records
                    if r.name == "nos_tpu_torch.cmd.train"]
        assert disabled == [
            f"progress reporter disabled: kubeconfig {bad} unusable",
            f"signal checker disabled: kubeconfig {bad} unusable"]


class TestEndToEndOverTheStub:
    """``train(cfg, device="cpu")`` as a deployed pod runs it: POD_NAME and
    POD_NAMESPACE set, a JSON kubeconfig naming the stub, a health
    address; each stamp set before checkpoint 1 makes the loop exit
    there with the progress written."""

    @pytest.mark.parametrize("stamp", ["migrate", "resize", "none"])
    def test_a_stamp_exits_at_the_first_checkpoint(self, tmp_path,
                                                   monkeypatch, caplog,
                                                   stamp):
        from nos_tpu_torch.api import constants as C
        from nos_tpu_torch.kube.rest import KubeClient, KubeConfig
        from nos_tpu_torch.models.checkpoint import TrainCheckpointer
        from nos_tpu_torch.testing.factory import make_pod

        from k8s_stub import StubApiServer

        with StubApiServer() as stub:
            api = KubeClient(KubeConfig(server=stub.url))
            api.create("Pod", make_pod(name="trainer", namespace="jobs"))
            key, value = {"migrate": (C.ANNOT_MIGRATE, "node-suspect"),
                          "resize": (C.ANNOT_DP_RESIZE, "2"),
                          "none": (C.ANNOT_DP_RESIZE, "1")}[stamp]
            _stamp(api, key, value)
            kubeconfig = tmp_path / "kubeconfig.json"
            kubeconfig.write_text(json.dumps({
                "current-context": "stub",
                "contexts": [{"name": "stub", "context": {
                    "cluster": "stub", "user": "u"}}],
                "clusters": [{"name": "stub", "cluster": {
                    "server": stub.url}}],
                "users": [{"name": "u", "user": {}}]}))
            monkeypatch.setenv("POD_NAME", "trainer")
            monkeypatch.setenv("POD_NAMESPACE", "jobs")
            monkeypatch.delenv("WORLD_SIZE", raising=False)
            ck = str(tmp_path / "ck")
            cfg = TrainConfig(model="tiny", batch_size=2, seq_len=32,
                              steps=4, log_every=1, checkpoint_every=1,
                              checkpoint_dir=ck, mesh="fsdp=1",
                              kubeconfig=str(kubeconfig),
                              health_probe_addr="127.0.0.1:0")
            cfg.validate()
            try:
                with caplog.at_level(logging.INFO):
                    loss = cmd.train(cfg, device="cpu")
                latest = TrainCheckpointer(ck).latest_step()
            finally:
                if dist.is_initialized():
                    dist.destroy_process_group()
            progress = api.get("Pod", "trainer", "jobs").metadata \
                .annotations[C.ANNOT_JOB_PROGRESS]
            api.close()
        assert math.isfinite(loss)
        said = [r.getMessage() for r in caplog.records
                if "requested" in r.getMessage()]
        if stamp == "none":
            assert (latest, progress, said) == (4, "1.0000", [])
            return
        assert (latest, progress) == (1, "0.2500")
        assert said == [{
            "migrate": "migration requested (node-suspect): exiting at "
                       "checkpoint step 1 for reschedule",
            "resize": "dp resize requested (1 -> 2 workers): exiting at "
                      "checkpoint step 1 for re-mesh"}[stamp]]


class TestConfigAndGauges:
    def test_load_config_json(self, tmp_path):
        path = tmp_path / "train.json"
        path.write_text(json.dumps({"apiVersion": "nos.tpu/v1beta2",
                                    "model": "tiny", "steps": 3,
                                    "mesh": "fsdp=2"}))
        cfg = load_config(path, TrainConfig)
        assert (cfg.model, cfg.steps, cfg.mesh) == ("tiny", 3, "fsdp=2")
        assert cfg.batch_size == 8 and cfg.attn_impl == "flash"

    def test_load_config_rejects_unknown_keys_and_types(self, tmp_path):
        path = tmp_path / "train.json"
        path.write_text(json.dumps({"model": "tiny", "stepz": 3}))
        with pytest.raises(ConfigError, match="unknown"):
            load_config(path, TrainConfig)
        path.write_text(json.dumps({"steps": "3"}))
        with pytest.raises(ConfigError, match="int"):
            load_config(path, TrainConfig)
        path.write_text(json.dumps({"apiVersion": "nos.tpu/v9"}))
        with pytest.raises(ConfigError, match="apiVersion"):
            load_config(path, TrainConfig)

    def test_main_reports_a_bad_config(self, tmp_path, capsys):
        path = tmp_path / "train.json"
        path.write_text(json.dumps({"model": "gpt17"}))
        assert cmd.main(["--config", str(path)]) == 2
        assert "invalid config" in capsys.readouterr().err

    def test_train_gauges_are_described_under_the_jax_names(self):
        assert sorted(n for n in REGISTRY._help
                      if n.startswith("nos_tpu_train_")) == [
            "nos_tpu_train_loss", "nos_tpu_train_mfu", "nos_tpu_train_step",
            "nos_tpu_train_tokens_per_s"]

    def test_registry(self):
        reg = Registry()
        reg.describe("g", "a gauge")
        reg.describe("g", "a gauge")            # idempotent
        with pytest.raises(ValueError, match="already registered"):
            reg.describe("g", "another meaning")
        assert reg.value("g") is None
        reg.set("g", 2.5)
        reg.set("g", 1.0, labels={"pool": "a"})
        assert reg.value("g") == 2.5 and reg.value("g", {"pool": "a"}) == 1.0


@pytest.mark.parametrize("n,mesh", [
    (2, "'tp': 2, 'sp': 1"), (4, "'tp': 2, 'sp': 2"),
    (6, "'dp': 3, 'fsdp': 1, 'tp': 1, 'sp': 2"),    # 6: the dp >= 2 leg
    (8, "'dp': 1, 'fsdp': 2, 'tp': 2, 'sp': 2")])   # 8: the MoE, pp legs
def test_dryrun_multigpu(n, mesh, capsys):
    loss = dryrun_multigpu(n, device="cpu")
    assert math.isfinite(loss)
    out = capsys.readouterr().out
    assert f"dryrun_multigpu({n})" in out and mesh in out
    # the MoE and pipeline legs run when n is a multiple of 8
    legs = (f"dryrun_multigpu({n}): moe mesh={{'dp': 1, 'fsdp': 2, "
            f"'tp': 1, 'sp': 2, 'ep': 2}} experts=4",
            "dryrun_multigpu: pipeline pp=4 microbatches=4")
    assert all((leg in out) == (n == 8) for leg in legs), out


def test_dryrun_multigpu_needs_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun_multigpu(2)


class TestGrantInTheMain:
    """``main`` applies the grant before any CUDA call, validates it once
    CUDA is up and before the process group, and a ConfinementError stops
    it before ``train`` (CUDA's calls recorded under a CPU-only
    torch)."""

    CUDA_CALLS = ("init", "_lazy_init", "is_available", "device_count",
                  "get_device_properties", "get_device_name", "set_device",
                  "current_device", "set_per_process_memory_fraction",
                  "device")

    @pytest.fixture
    def order(self, monkeypatch, tmp_path):
        from nos_tpu_torch.device import workload_env

        calls = []
        props = types.SimpleNamespace(
            name="NVIDIA H100 80GB HBM3", total_memory=85_017_493_504,
            uuid="5d7b5fb2-1c5c-4b3f-9a41-0c2e7d9f8e11")
        fakes = {"device_count": lambda: 1,
                 "get_device_properties": lambda i: props,
                 "device": lambda i: contextlib.nullcontext()}
        for name in self.CUDA_CALLS:
            impl = fakes.get(name, lambda *a, **k: None)
            monkeypatch.setattr(torch.cuda, name,
                                lambda *a, _n=name, _f=impl, **k:
                                calls.append(f"cuda.{_n}") or _f(*a, **k))
        monkeypatch.setattr(torch.backends.cuda, "is_built", lambda: True)
        for fn in ("apply", "validate_confinement"):
            real = getattr(workload_env, fn)
            monkeypatch.setattr(workload_env, fn,
                                lambda *a, _n=fn, _r=real, **k:
                                calls.append(_n) or _r(*a, **k))
        monkeypatch.setattr(cmd, "maybe_init_distributed",
                            lambda *a, **k: calls.append("init_distributed")
                            or False)
        monkeypatch.setattr(cmd, "train",
                            lambda *a, **k: calls.append("train") or 1.0)
        for key in ("CUDA_VISIBLE_DEVICES", "CUDA_DEVICE_ORDER",
                    workload_env.ENV_MEM_FRACTION):
            monkeypatch.setenv(key, "unset")
            monkeypatch.delenv(key)
        path = tmp_path / "train.json"
        path.write_text(json.dumps({"model": "tiny"}))
        return calls, str(path)

    def test_apply_before_cuda_then_validate_before_the_group(
            self, order, monkeypatch):
        calls, path = order
        monkeypatch.setenv("NOS_TPU_VISIBLE_CHIPS",
                           "GPU-5d7b5fb2-1c5c-4b3f-9a41-0c2e7d9f8e11")
        monkeypatch.setenv("NOS_TPU_TIMESHARE_GB", "24")
        assert cmd.main(["--config", path]) == 0
        assert calls[0] == "apply"
        assert calls[1] == "validate_confinement"
        assert "cuda.set_per_process_memory_fraction" in calls
        assert calls.index("cuda.set_per_process_memory_fraction") < \
            calls.index("init_distributed") < calls.index("train")
        import os

        assert os.environ["CUDA_VISIBLE_DEVICES"] == \
            "GPU-5d7b5fb2-1c5c-4b3f-9a41-0c2e7d9f8e11"
        assert os.environ["CUDA_DEVICE_ORDER"] == "PCI_BUS_ID"

    def test_confinement_error_stops_before_train(self, order, monkeypatch):
        from nos_tpu_torch.device.workload_env import ConfinementError

        calls, path = order
        monkeypatch.setenv("NOS_TPU_VISIBLE_CHIPS",
                           "GPU-00000000-1111-2222-3333-444444444444")
        with pytest.raises(ConfinementError):
            cmd.main(["--config", path])
        assert "train" not in calls and "init_distributed" not in calls
        assert "cuda.set_per_process_memory_fraction" not in calls

    def test_zero_devices_is_a_confinement_error_not_no_cuda(
            self, order, monkeypatch):
        from nos_tpu_torch.device.workload_env import ConfinementError

        calls, path = order
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
        monkeypatch.setenv("NOS_TPU_VISIBLE_CHIPS", "0")
        with pytest.raises(ConfinementError, match="CUDA sees 0"):
            cmd.main(["--config", path])
        assert "init_distributed" not in calls

    def test_cpu_path_installs_no_cap(self, order, monkeypatch):
        calls, path = order
        monkeypatch.setattr(torch.backends.cuda, "is_built", lambda: False)
        monkeypatch.setenv("NOS_TPU_TIMESHARE_GB", "24")
        assert cmd.main(["--config", path]) == 0
        assert not [c for c in calls if c.startswith("cuda.")]

    def test_the_last_line_reports_the_grant(self, order, monkeypatch,
                                             caplog):
        calls, path = order
        monkeypatch.setenv("NOS_TPU_TIMESHARE_GB", "24")
        with caplog.at_level(logging.INFO, logger="nos_tpu_torch.cmd.train"):
            assert cmd.main(["--config", path]) == 0
        done = [r.getMessage() for r in caplog.records
                if r.getMessage().startswith("done: final loss 1.0000 grant ")]
        assert len(done) == 1
        report = json.loads(done[0].split(" grant ", 1)[1])
        assert report["verified"] is True and report["fraction"] == 0.27
        assert report["devices"] == [] and report["timeshare_gb"] == 24.0
        assert set(report["launches"]) == {"flash_fwd", "flash_bwd_fused"}
        # CUDA never started: no memory to read
        assert report["max_memory_allocated"] is None

    def test_the_grant_is_reported_before_the_group_and_train(
            self, order, monkeypatch, caplog):
        """A run stopped by a signal never logs its last line: the grant
        as verified is logged once confinement holds, before the process
        group and any step, and says what the last line says of it."""
        calls, path = order
        monkeypatch.setenv("NOS_TPU_TIMESHARE_GB", "24")
        logged = []
        monkeypatch.setattr(cmd.logger, "info", lambda msg, *a:
                            logged.append(msg % a) or calls.append("log"))
        assert cmd.main(["--config", path]) == 0
        confined = [m for m in logged if m.startswith("confined: grant ")]
        done = [m for m in logged if m.startswith("done: ")]
        assert len(confined) == 1 and len(done) == 1
        assert calls.index("validate_confinement") < calls.index("log") \
            < calls.index("init_distributed") < calls.index("train")
        first = json.loads(confined[0].split(" grant ", 1)[1])
        last = json.loads(done[0].split(" grant ", 1)[1])
        keys = ("verified", "devices", "timeshare_gb", "fraction",
                "cap_bytes")
        assert first["verified"] is True and first["fraction"] == 0.27
        assert {k: first[k] for k in keys} == {k: last[k] for k in keys}

    def test_grant_report_on_the_card(self, monkeypatch):
        from nos_tpu_torch.ops import attention as A

        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda i: types.SimpleNamespace(
                                total_memory=85_017_493_504))
        monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda: 7)
        monkeypatch.setattr(torch.cuda, "max_memory_reserved", lambda: 8)
        monkeypatch.setattr(A, "FLASH_FWD_LAUNCHES", 48)
        monkeypatch.setattr(A, "FLASH_BWD_FUSED_LAUNCHES", 48)
        monkeypatch.setattr(A, "TILE_LAUNCHES", collections.Counter({
            ("flash_fwd", (128, 128)): 48,
            ("flash_bwd_fused", (64, 128)): 48}))
        env = {"NOS_TPU_TIMESHARE_GB": "24", "NOS_TPU_VISIBLE_CHIPS": "0",
               "NOS_TPU_TORCH_MEM_FRACTION": "0.270"}
        assert cmd.grant_report(True, env) == {
            "verified": True, "devices": [0], "timeshare_gb": 24.0,
            "fraction": 0.27, "cap_bytes": int(0.27 * 85_017_493_504),
            "max_memory_allocated": 7, "max_memory_reserved": 8,
            "launches": {"flash_fwd": 48, "flash_bwd_fused": 48},
            "tile_launches": {"flash_bwd_fused:64x128": 48,
                              "flash_fwd:128x128": 48}}
        assert cmd.grant_report(False, env)["cap_bytes"] is None
