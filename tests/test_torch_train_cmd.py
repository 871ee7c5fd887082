"""The port's training main (nos_tpu_torch.cmd.train) against the JAX
main's contract, tests/test_train_cmd.py's TestTrainMain mirrored on 8
gloo ranks over the same mesh (fsdp=2,tp=2,sp=2, TINY with ring
attention): the loop and its checkpoints, resume at the latest step, the
"already complete" None, a fresh run into a used directory refused, the
config checks; torchrun's environment failing fast; the exits at a
checkpoint on a dp-resize or a migration; NotImplementedError for the
control-plane settings; and dryrun_multigpu on 2, 4 and 6 ranks."""

import json
import math

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


class TestControlPlaneRefused:
    @pytest.mark.parametrize("field,value", [
        ("health_probe_addr", "127.0.0.1:0"), ("metrics_addr", "0.0.0.0:9")])
    def test_server_addresses_raise(self, field, value):
        with pytest.raises(NotImplementedError, match="item 32"):
            cmd.train(tiny_cfg(**{field: value}), device="cpu")

    def test_kubeconfig_raises(self, tmp_path):
        kubeconfig = tmp_path / "kubeconfig"
        kubeconfig.write_text("apiVersion: v1\n")
        cfg = tiny_cfg(kubeconfig=str(kubeconfig))
        with pytest.raises(NotImplementedError, match="kubeconfig"):
            cmd.train(cfg, device="cpu")
        env = {"POD_NAME": "t", "POD_NAMESPACE": "jobs"}
        with pytest.raises(NotImplementedError, match="jobs/t"):
            cmd.progress_reporter(cfg, environ=env)
        with pytest.raises(NotImplementedError, match="jobs/t"):
            cmd.signal_checker(cfg, environ=env)
        assert not dist.is_initialized()

    def test_hooks_inert_without_downward_api_identity(self, tmp_path):
        kubeconfig = tmp_path / "kubeconfig"
        kubeconfig.write_text("apiVersion: v1\n")
        for cfg in (TrainConfig(), TrainConfig(kubeconfig=str(kubeconfig))):
            for env in ({}, {"POD_NAME": "t"}, {"POD_NAMESPACE": "jobs"}):
                assert cmd.progress_reporter(cfg, environ=env) is None
                assert cmd.signal_checker(cfg, environ=env) is None
        # identity present but no kubeconfig: nothing to annotate against
        env = {"POD_NAME": "t", "POD_NAMESPACE": "jobs"}
        assert cmd.progress_reporter(TrainConfig(), environ=env) is None


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
