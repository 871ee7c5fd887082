"""The port's training step (nos_tpu_torch.models.train, .data,
nos_tpu_torch.ops.roofline, entry.bench_trainer) against the JAX
package's, on the CPU: the schedule, the clip and AdamW against optax,
and Trainer steps against ShardedTrainer steps on a one-device mesh from
the same converted parameters and batches."""

import dataclasses
import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nos_tpu.models import data as jdata
from nos_tpu.models import llama as jl
from nos_tpu.models import train as jtrain
from nos_tpu.ops import roofline as jroof
from nos_tpu.parallel.mesh import MeshSpec, make_mesh
from nos_tpu_torch.models import data as tdata
from nos_tpu_torch.models import llama as tl
from nos_tpu_torch.models import train as ttrain
from nos_tpu_torch.models.convert import params_from_jax
from nos_tpu_torch.ops import roofline as troof

from test_torch_llama import TOY, port_cfg


class TestSchedule:
    @pytest.mark.parametrize("warmup", [1, 5, 100])
    def test_matches_optax(self, warmup):
        lr = 3e-4
        sched = optax.warmup_cosine_decay_schedule(
            0.0, lr, warmup, 10_000, end_value=lr * 0.1)
        for step in (0, 1, warmup - 1, warmup, warmup + 1, 2500, 9999,
                     10_000, 20_000):
            step = max(step, 0)
            want = float(sched(step))
            got = ttrain.warmup_cosine_decay(step, lr, warmup,
                                             end_value=lr * 0.1)
            assert abs(got - want) <= 1e-6 * lr, step

    def test_first_step_rate_is_zero(self):
        opt = ttrain.DefaultOptimizer([torch.zeros(3, requires_grad=True)])
        assert opt.learning_rate() == 0.0


def _tree(arrays):
    return {f"p{i}": jnp.asarray(a) for i, a in enumerate(arrays)}


class TestOptimizer:
    """DefaultOptimizer against optax's chain(clip_by_global_norm, adamw)
    (nos_tpu.models.train.default_optimizer) on the same gradients."""

    @pytest.mark.parametrize("grad_scale", [1e-3, 10.0],
                             ids=["below-clip", "above-clip"])
    def test_steps_match_optax(self, grad_scale):
        rng = np.random.default_rng(0)
        shapes = [(8, 4), (4,), (16,)]          # a matrix, a scale, a bias
        params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        grads = [[rng.standard_normal(s).astype(np.float32) * grad_scale
                  for s in shapes] for _ in range(4)]

        tx = jtrain.default_optimizer(lr=1e-2, warmup=2)
        jp = _tree(params)
        state = tx.init(jp)
        tp = [torch.tensor(p, requires_grad=True) for p in params]
        opt = ttrain.DefaultOptimizer(tp, lr=1e-2, warmup=2)
        for g in grads:
            updates, state = tx.update(_tree(g), state, jp)
            jp = optax.apply_updates(jp, updates)
            for p, gi in zip(tp, g):
                p.grad = torch.tensor(gi)
            opt.step()
        for i, p in enumerate(tp):
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jp[f"p{i}"]),
                                       atol=1e-6, rtol=1e-6)

    def test_clip_is_optax_global_norm(self):
        g = [np.full((4,), 3.0, np.float32), np.full((2,), 4.0, np.float32)]
        want, _ = optax.clip_by_global_norm(1.0).update(_tree(g), None)
        tp = [torch.zeros(4, requires_grad=True),
              torch.zeros(2, requires_grad=True)]
        for p, gi in zip(tp, g):
            p.grad = torch.tensor(gi)
        opt = ttrain.DefaultOptimizer(tp)
        opt.adamw = type("NoStep", (), {"step": lambda self: None,
                                        "param_groups": [{}]})()
        opt.step()
        for i, p in enumerate(tp):
            np.testing.assert_allclose(p.grad.numpy(),
                                       np.asarray(want[f"p{i}"]), rtol=1e-6)

    def test_one_group_decays_every_parameter(self):
        model = tl.Llama(tl.TINY, device="meta")
        opt = ttrain.DefaultOptimizer(model.parameters())
        (group,) = opt.adamw.param_groups
        assert group["weight_decay"] == 0.1
        assert len(group["params"]) == len(list(model.parameters()))
        assert group["betas"] == (0.9, 0.95) and group["eps"] == 1e-8


class TestCrossEntropy:
    def test_matches_jax(self):
        rng = np.random.default_rng(1)
        logits = rng.standard_normal((2, 7, 11)).astype(np.float32)
        tokens = rng.integers(0, 11, (2, 7), dtype=np.int32)
        want = float(jtrain.cross_entropy_loss(jnp.asarray(logits),
                                               jnp.asarray(tokens)))
        got = ttrain.cross_entropy_loss(torch.from_numpy(logits),
                                        torch.from_numpy(tokens)).item()
        assert abs(got - want) <= 1e-6


def _jax_run(cfg, batches, warmup):
    """Losses and final parameters of ShardedTrainer on a one-device CPU
    mesh, and its initial parameters."""
    mesh = make_mesh(MeshSpec(1, 1, 1, 1), devices=jax.devices()[:1])
    tr = jtrain.ShardedTrainer(
        cfg, mesh, optimizer=jtrain.default_optimizer(lr=1e-3, warmup=warmup),
        batch_size=batches[0].shape[0], seq_len=batches[0].shape[1])
    state = tr.init_state(0)
    unbox = lambda t: jax.tree_util.tree_map(  # noqa: E731
        np.asarray, flax.core.meta.unbox(t))
    init = unbox(state.params)
    step = tr.train_step()
    losses = []
    for b in batches:
        state, loss = step(state, jnp.asarray(b))
        losses.append(float(loss))
    return init, losses, unbox(state.params)


class TestTrainer:
    """Three Trainer steps against three ShardedTrainer steps from the
    same converted parameters and batches (fp32; warmup 2, so the second
    and third steps move the parameters)."""

    @pytest.mark.parametrize("cfg", [
        jl.TINY, dataclasses.replace(TOY, remat_policy="rots")],
        ids=["tiny-dense", "toy-flash-rots"])
    def test_three_steps_match_sharded_trainer(self, cfg):
        rng = np.random.default_rng(2)
        batches = [rng.integers(0, cfg.vocab_size, (2, 32), dtype=np.int32)
                   for _ in range(3)]
        init, want_losses, want = _jax_run(cfg, batches, warmup=2)
        pcfg = port_cfg(cfg)
        trainer = ttrain.Trainer(pcfg, device="cpu",
                                 optimizer_factory=functools.partial(
                                     ttrain.DefaultOptimizer, lr=1e-3,
                                     warmup=2))
        trainer.load_params(params_from_jax(init, pcfg))
        losses = [trainer.train_step(b).item() for b in batches]
        # losses: fp32, rounding only
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
        want_sd = params_from_jax(want, pcfg)
        start_sd = params_from_jax(init, pcfg)
        for name, p in trainer.model.named_parameters():
            moved = (want_sd[name] - start_sd[name]).abs().max().item()
            assert moved > 0, name
            # Adam divides by sqrt(v), so where a gradient is near zero
            # its rounding differences are magnified: the parameters agree
            # within 5e-5, 5% of one step at lr 1e-3.
            err = (p.detach() - want_sd[name]).abs().max().item()
            assert err <= 5e-5, (name, err)

    def test_step_before_params_raises(self):
        trainer = ttrain.Trainer(tl.TINY, device="cpu")
        with pytest.raises(RuntimeError, match="init_state"):
            trainer.train_step(np.zeros((1, 4), np.int32))

    def test_init_state_is_seeded(self):
        a, b = (ttrain.Trainer(tl.TINY, device="cpu") for _ in range(2))
        a.init_state(3)
        b.init_state(3)
        for (n, p), q in zip(a.model.named_parameters(),
                             b.model.parameters()):
            assert torch.equal(p, q), n


class TestData:
    @pytest.mark.parametrize("step", [0, 3, 17])
    def test_same_batches_as_jax(self, step):
        args = (500, 4096, 4, 64)
        want = jdata.TokenLoader.synthetic(*args, seed=5).batch_at(step)
        got = tdata.TokenLoader.synthetic(*args, seed=5).batch_at(step)
        np.testing.assert_array_equal(got, want)

    def test_train_loader_is_the_train_main_stream(self):
        from nos_tpu_torch.entry import train_loader

        loader = train_loader()
        want = jdata.TokenLoader.synthetic(
            32000, max(8 * 2048 * 8, 1 << 16), 8, 2048, seed=0)
        np.testing.assert_array_equal(loader.batch_at(1), want.batch_at(1))

    def test_short_stream_raises(self):
        with pytest.raises(ValueError):
            tdata.TokenLoader(np.zeros(10, np.int32), 2, 8)


class TestRoofline:
    @pytest.mark.parametrize("name", ["TINY", "BENCH_350M_TRAIN",
                                      "LLAMA3_8B"])
    def test_model_flops_match_jax(self, name):
        assert troof.model_flops_per_step(getattr(tl, name), 8, 2048) == \
            jroof.model_flops_per_step(getattr(jl, name), 8, 2048)

    @pytest.mark.parametrize("device,flops", [
        ("NVIDIA H100 80GB HBM3", 989e12), ("NVIDIA H100 PCIe", 756e12),
        ("NVIDIA H100 NVL", 835e12), ("NVIDIA H200", 989e12)])
    def test_peaks_by_card_name(self, device, flops):
        assert troof.peaks_for(device)[0] == flops

    def test_unknown_card_raises(self):
        with pytest.raises(ValueError):
            troof.peaks_for("TPU v5 lite")


class TestBenchTrainer:
    def test_config_and_device(self):
        from nos_tpu_torch.entry import bench_trainer

        trainer = bench_trainer("cpu", num_layers=1)
        cfg = trainer.cfg
        assert (cfg.attn_impl, cfg.remat_policy) == ("flash", "rots")
        assert (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
                cfg.head_dim, cfg.vocab_size) == (1024, 8, 4, 128, 32000)
        assert trainer.model.embed.dtype == torch.float32
        assert cfg.dtype == torch.bfloat16
        assert trainer.optimizer is not None
