"""The port's GPipe pipeline (nos_tpu_torch.parallel.pipeline) over 2 and
4 gloo ranks against the JAX package's pipeline_apply on a pp mesh of the
virtual CPU devices and against the stages run in sequence, on the same
stages made with numpy from a seed (tests/test_pipeline.py's cases):
outputs for (pp, microbatches) in (2, 2), (2, 4), (4, 4), (4, 8) and
(2, 1); gradients of sum(y^2) through every stage and into x; the
indivisible batch; and 4 TINY Llama blocks as 2 stages of 2.  All fp32:
outputs within 1e-5 and gradients within 1e-4, the limits of the JAX
tests (the same products in another order)."""

import dataclasses
import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from nos_tpu.models import llama as jl
from nos_tpu.parallel.pipeline import pipeline_apply as jax_pipeline
from nos_tpu.parallel.pipeline import stack_stage_params as jax_stack
from nos_tpu_torch.models.convert import params_from_jax
from nos_tpu_torch.parallel.mesh import run_ranks
from nos_tpu_torch.parallel.pipeline import stack_stage_params
from nos_tpu_torch.testing import ranks

from test_torch_llama import port_cfg

OUT_TOL, GRAD_TOL, BLOCK_TOL = 1e-5, 1e-4, 2e-5
CASES = [(2, 2), (2, 4), (4, 4), (4, 8), (2, 1)]
WIDTH = 16


def _stages(num_stages, seed=0):
    """Per-stage numpy params of tests/test_pipeline.py's MLP stage."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num_stages):
        out.append({
            "w1": (rng.standard_normal((WIDTH, WIDTH)) / WIDTH ** 0.5
                   ).astype(np.float32),
            "b1": rng.standard_normal(WIDTH).astype(np.float32) * 0.1,
            "w2": (rng.standard_normal((WIDTH, WIDTH)) / WIDTH ** 0.5
                   ).astype(np.float32),
            "b2": rng.standard_normal(WIDTH).astype(np.float32) * 0.1})
    return out


def _x(seed=1):
    return np.random.default_rng(seed).standard_normal(
        (8, WIDTH)).astype(np.float32)


def _torch_stacked(stages):
    return stack_stage_params([{k: torch.from_numpy(v) for k, v in s.items()}
                               for s in stages])


@functools.lru_cache(maxsize=None)
def _port(pp):
    """Every rank's results for the cases of ``pp`` ranks, in one
    launch: outputs for each count, gradients at 4 microbatches (pp 4)
    and the indivisible batch's error (pp 2)."""
    counts = [m for p, m in CASES if p == pp]
    return run_ranks(ranks.pipeline_cases, pp, _torch_stacked(_stages(pp)),
                     _x(), counts, 4 if pp == 4 else None,
                     3 if pp == 2 else None, timeout=120)


def _jax_mesh(pp):
    return Mesh(np.array(jax.devices()[:pp]), ("pp",))


def _sequential(stages, x):
    x = torch.from_numpy(x)
    for s in stages:
        x = ranks.mlp_stage({k: torch.from_numpy(v) for k, v in s.items()}, x)
    return x


@pytest.mark.parametrize("pp,microbatches", CASES)
class TestPipelineEquivalence:
    def test_matches_sequential(self, pp, microbatches):
        want = _sequential(_stages(pp), _x()).numpy()
        for rank in _port(pp):
            # replicated on every pp rank
            np.testing.assert_allclose(rank["y"][microbatches], want,
                                       atol=OUT_TOL, rtol=0)

    def test_matches_jax(self, pp, microbatches):
        stacked = jax_stack([{k: jnp.asarray(v) for k, v in s.items()}
                             for s in _stages(pp)])
        want = jax_pipeline(_jax_mesh(pp), _jax_mlp_stage, stacked,
                            jnp.asarray(_x()), num_microbatches=microbatches)
        np.testing.assert_allclose(_port(pp)[0]["y"][microbatches],
                                   np.asarray(want), atol=OUT_TOL, rtol=0)


class TestGradients:
    def test_match_sequential_through_every_stage(self):
        stages = _stages(4)
        params = [{k: torch.from_numpy(v).requires_grad_()
                   for k, v in s.items()} for s in stages]
        x = torch.from_numpy(_x()).requires_grad_()
        y = x
        for p in params:
            y = ranks.mlp_stage(p, y)
        (y ** 2).sum().backward()
        for i, rank in enumerate(_port(4)):
            for name, g in rank["grads"].items():
                np.testing.assert_allclose(g, params[i][name].grad.numpy(),
                                           atol=GRAD_TOL, rtol=0,
                                           err_msg=f"stage {i} {name}")
                assert np.any(g != 0), (i, name)
            # the input's gradient, replicated on every rank
            np.testing.assert_allclose(rank["dx"], x.grad.numpy(),
                                       atol=GRAD_TOL, rtol=0)

    def test_match_jax(self):
        mesh = _jax_mesh(4)
        stacked = jax_stack([{k: jnp.asarray(v) for k, v in s.items()}
                             for s in _stages(4)])
        x = jnp.asarray(_x())

        @jax.jit
        def loss(stacked, x):
            return jnp.sum(jax_pipeline(mesh, _jax_mlp_stage, stacked, x,
                                        num_microbatches=4) ** 2)

        want = jax.grad(loss)(stacked, x)
        for i, rank in enumerate(_port(4)):
            for name, g in rank["grads"].items():
                np.testing.assert_allclose(g, np.asarray(want[name][i]),
                                           atol=GRAD_TOL, rtol=0)


def _jax_mlp_stage(params, x):
    h = jnp.tanh(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def test_indivisible_batch_rejected():
    for rank in _port(2):
        assert "divisible" in rank["indivisible"]


def test_stack_stage_params_matches_jax():
    stages = _stages(2)
    got = _torch_stacked(stages)
    want = jax_stack([{k: jnp.asarray(v) for k, v in s.items()}
                      for s in stages])
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))


def test_llama_blocks_pipeline_matches_jax_sequential():
    """4 TINY Llama blocks split into 2 stages of 2 layers reproduce the
    flax blocks run in sequence (tests/test_pipeline.py:97-135)."""
    cfg = dataclasses.replace(jl.TINY, remat=False, num_layers=4,
                              scan_layers=False)
    block = jl.Block(cfg)
    x = np.random.default_rng(0).standard_normal(
        (2, 32, cfg.hidden_size)).astype(np.float32)
    rope = jl.rope_tables(jnp.arange(32, dtype=jnp.int32)[None],
                          cfg.head_dim, cfg.rope_theta)
    keys = jax.random.split(jax.random.PRNGKey(1), 4)
    layers = [jax.tree_util.tree_map(np.asarray, flax.core.meta.unbox(
        block.init(k, jnp.asarray(x), rope)["params"])) for k in keys]
    want = jnp.asarray(x)
    for p in layers:
        want = block.apply({"params": p}, want, rope)

    # the port's state dict of each layer, through the model converter
    pcfg = port_cfg(cfg)
    tree = {f"layer_{i}": p for i, p in enumerate(layers)}
    tree["embed"] = np.zeros((cfg.vocab_size, cfg.hidden_size), np.float32)
    tree["final_norm"] = {"scale": np.ones(cfg.hidden_size, np.float32)}
    sd = params_from_jax(tree, pcfg)
    per_layer = [{k[len(f"layers.{i}."):]: v for k, v in sd.items()
                  if k.startswith(f"layers.{i}.")} for i in range(4)]
    # each stage a list of its two layers; stacked: the stage axis leads
    stacked = stack_stage_params([per_layer[0:2], per_layer[2:4]])
    got = run_ranks(ranks.pipeline_blocks, 2, pcfg, stacked, x, 2,
                    timeout=120)
    for rank in got:
        np.testing.assert_allclose(rank, np.asarray(want), atol=BLOCK_TOL,
                                   rtol=0)
