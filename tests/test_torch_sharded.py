"""The port's ShardedTrainer (nos_tpu_torch.models.train) over gloo ranks
against the JAX package's ShardedTrainer on the same mesh shape of the
virtual CPU devices, from the same converted parameters and batches: the
loss of three steps and the parameters after them, on meshes where each
of dp, fsdp, tp and sp exceeds 1 (sp through ring attention), on
fsdp=2,tp=2,sp=2, and on one rank.  The losses are also held against
the port's single-device Trainer.  And TokenLoader.device_iter against
the JAX loader's."""

import dataclasses
import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nos_tpu.models import data as jdata
from nos_tpu.models import llama as jl
from nos_tpu.models import train as jtrain
from nos_tpu.parallel.mesh import MeshSpec, batch_sharding, make_mesh
from nos_tpu_torch.models import data as tdata
from nos_tpu_torch.models import train as ttrain
from nos_tpu_torch.models.convert import params_from_jax
from nos_tpu_torch.parallel.mesh import MeshSpec as TMeshSpec
from nos_tpu_torch.parallel.mesh import run_ranks
from nos_tpu_torch.testing import ranks

from test_torch_llama import TOY, port_cfg

LR, WARMUP = 1e-3, 2
# fp32 throughout: the losses agree to rounding (rtol 1e-5); the
# parameters within 5e-5 (Adam divides by sqrt(v), magnifying the
# rounding of near-zero gradients: 5% of one step at lr 1e-3), the
# limits of tests/test_torch_train.py's one-device comparison.
LOSS_RTOL, PARAM_ATOL = 1e-5, 5e-5

RING = dataclasses.replace(jl.TINY, attn_impl="ring")
MESHES = {
    "dp=2": jl.TINY,
    "fsdp=2": jl.TINY,
    "tp=2": jl.TINY,
    "sp=2": RING,
    "dp=2,fsdp=2": jl.TINY,
    "fsdp=2,tp=2,sp=2": RING,
    # one rank, the card's path: flash through its plain version, rots
    "fsdp=1": dataclasses.replace(TOY, remat_policy="rots"),
}


def _batches(cfg, seed=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (4, 32), dtype=np.int32)
            for _ in range(3)]


@functools.lru_cache(maxsize=None)
def _run(spec_text):
    """(JAX: initial params, losses, final params; port: rank results)."""
    cfg = MESHES[spec_text]
    batches = _batches(cfg)
    spec = MeshSpec.parse(spec_text)
    mesh = make_mesh(spec, devices=jax.devices()[:spec.size])
    tr = jtrain.ShardedTrainer(
        cfg, mesh, optimizer=jtrain.default_optimizer(lr=LR, warmup=WARMUP),
        batch_size=4, seq_len=32)
    state = tr.init_state(0)
    unbox = lambda t: jax.tree_util.tree_map(  # noqa: E731
        np.asarray, flax.core.meta.unbox(t))
    init = unbox(state.params)
    step = tr.train_step()
    losses = []
    for b in batches:
        state, loss = step(state, jnp.asarray(b))
        losses.append(float(loss))
    pcfg = port_cfg(cfg)
    port = run_ranks(ranks.sharded_steps, spec.size, spec_text, pcfg,
                     params_from_jax(init, pcfg), batches, LR, WARMUP,
                     timeout=240)
    return init, losses, unbox(state.params), port


@pytest.mark.parametrize("spec_text", list(MESHES))
class TestShardedTrainer:
    def test_losses_match_jax(self, spec_text):
        _, want, _, port = _run(spec_text)
        for rank in port:
            # every rank reports the global batch's loss
            assert rank["losses"] == port[0]["losses"]
            assert rank["step"] == 3
        np.testing.assert_allclose(port[0]["losses"], want, rtol=LOSS_RTOL)

    def test_params_match_jax(self, spec_text):
        init, _, want, port = _run(spec_text)
        pcfg = port_cfg(MESHES[spec_text])
        start, want = params_from_jax(init, pcfg), params_from_jax(want, pcfg)
        got = port[0]["params"]
        assert set(got) == set(want)
        for name in want:
            assert (want[name] - start[name]).abs().max().item() > 0, name
            err = np.abs(got[name] - want[name].numpy()).max()
            assert err <= PARAM_ATOL, (name, err)

    def test_losses_match_single_device_trainer(self, spec_text):
        init, _, _, port = _run(spec_text)
        cfg = MESHES[spec_text]
        # the single-device Trainer has no mesh, so no ring: dense
        pcfg = port_cfg(dataclasses.replace(
            cfg, attn_impl="dense" if cfg.attn_impl == "ring"
            else cfg.attn_impl))
        trainer = ttrain.Trainer(pcfg, device="cpu",
                                 optimizer_factory=functools.partial(
                                     ttrain.DefaultOptimizer, lr=LR,
                                     warmup=WARMUP))
        trainer.load_params(params_from_jax(init, pcfg))
        want = [trainer.train_step(b).item() for b in _batches(cfg)]
        np.testing.assert_allclose(port[0]["losses"], want, rtol=LOSS_RTOL)


class TestDeviceIter:
    ARGS = (500, 4096, 4, 16, 5)        # vocab, tokens, batch, seq, seed
    SPEC = "dp=2,sp=2"

    @pytest.fixture(scope="class")
    def blocks(self):
        spec = TMeshSpec.parse(self.SPEC)
        return run_ranks(ranks.device_iter_blocks, spec.size, self.SPEC,
                         self.ARGS, 3, 4, timeout=120)

    def test_each_rank_gets_the_jax_shard(self, blocks):
        spec = MeshSpec.parse(self.SPEC)
        mesh = make_mesh(spec, devices=jax.devices()[:spec.size])
        want = list(jdata.TokenLoader.synthetic(*self.ARGS).device_iter(
            mesh, start_step=3, num_steps=4))
        assert all(len(b) == len(want) for b in blocks)
        for step, arr in enumerate(want):
            assert arr.sharding == batch_sharding(mesh)
            by_device = {s.device: np.asarray(s.data)
                         for s in arr.addressable_shards}
            for rank, got in enumerate(blocks):
                assert got[step].dtype == np.int32
                np.testing.assert_array_equal(
                    got[step], by_device[jax.devices()[rank]])

    def test_blocks_make_the_jax_batches(self, blocks):
        # rank order (dp, sp): rows over dp, the sequence over sp
        loader = jdata.TokenLoader.synthetic(*self.ARGS)
        for step in range(4):
            rows = [np.concatenate([blocks[2 * d + s][step]
                                    for s in range(2)], axis=1)
                    for d in range(2)]
            np.testing.assert_array_equal(np.concatenate(rows),
                                          loader.batch_at(3 + step))

    def test_without_a_mesh_the_card_is_required(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        loader = tdata.TokenLoader.synthetic(*self.ARGS)
        with pytest.raises(RuntimeError, match="CUDA"):
            next(loader.device_iter())



@pytest.mark.parametrize("spec_text", ["fsdp=1", "fsdp=2"])
def test_a_forward_between_steps_changes_nothing(spec_text):
    # FSDP2 leaves the root's parameters unsharded after a forward
    # without grad; the step reshards first, or the next backward would
    # reduce the root's gradients (embed, final_norm) wrong
    assert all(run_ranks(ranks.forward_between_steps, TMeshSpec.parse(
        spec_text).size, "sharded", spec_text, port_cfg(jl.TINY),
        timeout=120))
