"""The port's generation loop (nos_tpu_torch.models.generate) against
nos_tpu.models.generate, on the CPU and on converted parameters."""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nos_tpu.models import generate as jg
from nos_tpu.models import llama as jl
from nos_tpu_torch.models import generate as tg
from nos_tpu_torch.models import llama as tl
from nos_tpu_torch.models.convert import params_from_jax

# head_dim 128: the port runs its flash op, the JAX model its dense path.
TOY = dataclasses.replace(jl.TINY, hidden_size=128, num_heads=2,
                          num_kv_heads=1, head_dim=128, attn_impl="flash",
                          max_seq_len=32)
PROMPT, STEPS = 12, 10


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, TOY.vocab_size, (2, PROMPT), dtype=np.int32)
    jmodel = jl.Llama(TOY)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(prompt))
    params = jax.tree_util.tree_map(np.asarray, flax.core.meta.unbox(params))
    fields = dataclasses.asdict(TOY)
    fields.update(dtype=torch.float32, param_dtype=torch.float32)
    tmodel = tl.Llama(tl.LlamaConfig(**fields), device="cpu")
    tmodel.load_state_dict(params_from_jax(params, tmodel.cfg), assign=True)
    return jmodel, params, tmodel, prompt


def test_greedy_matches_jax_token_for_token(models):
    jmodel, params, tmodel, prompt = models
    want = np.asarray(jg.make_generate(jmodel, STEPS)(params,
                                                      jnp.asarray(prompt)))
    got = tg.generate(tmodel, torch.from_numpy(prompt), STEPS)
    assert got.dtype == torch.int32 and got.shape == (2, PROMPT + STEPS)
    np.testing.assert_array_equal(got.numpy(), want)


def test_make_generate_is_generate(models):
    _, _, tmodel, prompt = models
    fn = tg.make_generate(tmodel, 4)
    p = torch.from_numpy(prompt)
    assert torch.equal(fn(p), tg.generate(tmodel, p, 4))


def test_zero_padded_buffer_and_prompt_kept(models):
    _, _, tmodel, prompt = models
    out = tg.generate(tmodel, torch.from_numpy(prompt), 0)
    np.testing.assert_array_equal(out.numpy(), prompt)


@pytest.mark.parametrize("steps", [PROMPT + 9, 32])
def test_over_length_raises(models, steps):
    _, _, tmodel, prompt = models
    with pytest.raises(ValueError, match="max_seq_len"):
        tg.generate(tmodel, torch.from_numpy(prompt), steps + 1)


def test_sampling_is_seeded(models):
    _, _, tmodel, prompt = models
    p = torch.from_numpy(prompt)

    def sample(seed):
        return tg.generate(tmodel, p, STEPS, temperature=1.0,
                           generator=torch.Generator().manual_seed(seed))

    a, b, c = sample(1), sample(1), sample(2)
    assert torch.equal(a, b)
    assert not torch.equal(a[:, PROMPT:], c[:, PROMPT:])
    assert torch.equal(a[:, :PROMPT], p)
    assert bool(((a >= 0) & (a < TOY.vocab_size)).all())


def test_sampling_default_generator_is_seed_zero(models):
    _, _, tmodel, prompt = models
    p = torch.from_numpy(prompt)
    a = tg.generate(tmodel, p, 4, temperature=0.7)
    b = tg.generate(tmodel, p, 4, temperature=0.7,
                    generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
