"""The port's Llama (nos_tpu_torch.models.llama, .convert) against the
flax model, on the CPU and on the same converted parameters."""

import dataclasses
import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nos_tpu.models import llama as jl
from nos_tpu_torch.models import llama as tl
from nos_tpu_torch.models.convert import params_from_jax

_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}

# head_dim 128, so attn_impl="flash" reaches the port's flash op (its
# plain version on the CPU) while the JAX model takes its dense path.
TOY = dataclasses.replace(jl.TINY, hidden_size=128, num_heads=2,
                          num_kv_heads=1, head_dim=128, attn_impl="flash")


def port_cfg(cfg: jl.LlamaConfig) -> tl.LlamaConfig:
    fields = dataclasses.asdict(cfg)
    fields["dtype"] = _DTYPES[cfg.dtype]
    fields["param_dtype"] = _DTYPES[cfg.param_dtype]
    return tl.LlamaConfig(**fields)


def tokens_for(cfg, seed, batch=2, seq=32):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (batch, seq), dtype=np.int32)


@functools.lru_cache(maxsize=None)
def flax_params(cfg, seed=0):
    """Unboxed numpy parameters of the flax model (shared by the tests
    of one config and seed: the init dominates their time)."""
    variables = jax.jit(jl.Llama(cfg).init)(
        jax.random.PRNGKey(seed), jnp.asarray(tokens_for(cfg, seed, seq=8)))
    return jax.tree_util.tree_map(np.asarray, flax.core.meta.unbox(variables))


def port_model(cfg, params):
    model = tl.Llama(port_cfg(cfg), device="cpu")
    model.load_state_dict(params_from_jax(params, model.cfg), assign=True)
    return model


@functools.lru_cache(maxsize=None)
def logits_pair(cfg, seed=0):
    """(port logits, flax logits) for one config and seed, as numpy."""
    tokens = tokens_for(cfg, seed)
    params = flax_params(cfg, seed)
    want = np.asarray(jl.Llama(cfg).apply(params, jnp.asarray(tokens)),
                      np.float32)
    with torch.no_grad():
        got = port_model(cfg, params)(torch.from_numpy(tokens))
    assert got.dtype == torch.float32
    return got.numpy(), want


class TestConvert:
    @pytest.mark.parametrize("scan", [True, False])
    def test_layouts_give_flax_logits(self, scan):
        got, want = logits_pair(dataclasses.replace(TOY, scan_layers=scan))
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)

    def test_scanned_and_unrolled_convert_alike(self):
        cfg = dataclasses.replace(TOY, scan_layers=False)
        params = flax_params(cfg)["params"]
        stacked = jax.tree_util.tree_map(
            np.asarray, jl.stack_layer_params(params, cfg.num_layers))
        a = params_from_jax(params, port_cfg(cfg))
        b = params_from_jax(stacked, port_cfg(cfg))
        assert a.keys() == b.keys()
        for key in a:
            assert torch.equal(a[key], b[key]), key

    def test_state_dict_matches_module(self):
        cfg = TOY
        sd = params_from_jax(flax_params(cfg), port_cfg(cfg))
        want = tl.Llama(port_cfg(cfg), device="meta").state_dict()
        assert sd.keys() == want.keys()
        for key, t in want.items():
            assert sd[key].shape == t.shape and sd[key].dtype == t.dtype, key

    def test_kernel_layouts(self):
        # q/k/v [E, H, D] -> [H*D, E]; o_proj [H, D, E] -> [E, H*D]
        cfg = TOY
        params = flax_params(cfg)["params"]
        sd = params_from_jax(params, port_cfg(cfg))
        attn = params["layers"]["attn"]
        q = attn["q_proj"]["kernel"][1]
        o = attn["o_proj"]["kernel"][1]
        np.testing.assert_array_equal(
            sd["layers.1.attn.q_proj.weight"].numpy()[128 + 5, 7], q[7, 1, 5])
        np.testing.assert_array_equal(
            sd["layers.1.attn.o_proj.weight"].numpy()[7, 128 + 5], o[1, 5, 7])

    def test_fused_params_raise(self):
        cfg = dataclasses.replace(TOY, fused_qkv=True)
        params = flax_params(cfg)
        with pytest.raises(NotImplementedError):
            params_from_jax(params, port_cfg(dataclasses.replace(
                cfg, fused_qkv=False)))


class TestLogits:
    @pytest.mark.parametrize("cfg", [
        TOY,                                          # flash, head_dim 128
        jl.TINY,                                      # dense, head_dim 16
        dataclasses.replace(jl.TINY, attn_impl="flash"),
    ], ids=["toy-flash", "tiny-dense", "tiny-flash"])
    def test_fp32_matches_flax(self, cfg):
        got, want = logits_pair(cfg)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)

    def test_bf16_activations(self):
        # bf16 activations and params: the frameworks round in other
        # places (XLA fuses elementwise chains in fp32), so the logits
        # agree to a few bf16 ulps of their magnitude (|logits| < ~1).
        cfg = dataclasses.replace(jl.TINY, dtype=jnp.bfloat16,
                                  param_dtype=jnp.bfloat16)
        got, want = logits_pair(cfg, seed=6)
        np.testing.assert_allclose(got, want, atol=3e-2, rtol=0)

    @pytest.mark.parametrize("name", [
        "LLAMA3_8B", "TINY", "BENCH_350M", "BENCH_350M_TRAIN"])
    def test_configs_and_param_count(self, name):
        jcfg, tcfg = getattr(jl, name), getattr(tl, name)
        assert port_cfg(jcfg) == tcfg
        model = tl.Llama(tcfg, device="meta")
        want = jl.Llama(jcfg).param_count()
        assert model.param_count() == want
        assert sum(p.numel() for p in model.parameters()) == want


class TestParts:
    def test_rope(self):
        rng = np.random.default_rng(7)
        x = rng.standard_normal((2, 12, 3, 16)).astype(np.float32)
        pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
        jcos, jsin = jl.rope_tables(jnp.asarray(pos), 16, 10000.0)
        tcos, tsin = tl.rope_tables(torch.from_numpy(pos.copy()), 16, 10000.0)
        np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), atol=1e-5)
        np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin), atol=1e-5)
        want = np.asarray(jl._rope(jnp.asarray(x), (jcos, jsin)))
        got = tl._rope(torch.from_numpy(x), (tcos, tsin)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)

    def test_rmsnorm(self):
        rng = np.random.default_rng(8)
        x = rng.standard_normal((2, 5, 32)).astype(np.float32) * 3
        scale = rng.standard_normal(32).astype(np.float32)
        want = jl.RMSNorm(1e-5).apply({"params": {"scale": scale}},
                                      jnp.asarray(x))
        norm = tl.RMSNorm(32, 1e-5, device="cpu")
        norm.load_state_dict({"scale": torch.from_numpy(scale)})
        with torch.no_grad():
            got = norm(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)


class TestTrainingOnlyOptions:
    @pytest.mark.parametrize("change", [
        {"fused_qkv": True}, {"fused_gate_up": True}, {"attn_impl": "ring"}])
    def test_refused(self, change):
        with pytest.raises(NotImplementedError):
            tl.Llama(dataclasses.replace(tl.TINY, **change), device="cpu")

    def test_targets_refused(self):
        model = tl.Llama(tl.TINY, device="cpu")
        tokens = torch.zeros(1, 4, dtype=torch.int32)
        with pytest.raises(NotImplementedError):
            model(tokens, targets=tokens)

    def test_remat_is_accepted(self):
        cfg = dataclasses.replace(tl.TINY, remat=True, remat_policy="rots")
        assert tl.Llama(cfg, device="meta").cfg.remat_policy == "rots"


class TestInitParams:
    def test_distributions_and_dtypes(self):
        cfg = dataclasses.replace(tl.TINY, hidden_size=256,
                                  intermediate_size=512, vocab_size=512,
                                  param_dtype=torch.bfloat16)
        sd = tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        assert sd.keys() == tl.Llama(cfg, device="meta").state_dict().keys()
        embed = sd["embed"].float()
        assert sd["embed"].dtype == torch.bfloat16
        assert abs(embed.std().item() - 0.02) < 1e-3
        q = sd["layers.0.attn.q_proj.weight"].float()
        # lecun-normal over fan_in 256: std 1/16, truncated at 2 std of
        # the underlying normal
        assert abs(q.std().item() - 1 / 16) < 3e-3
        assert q.abs().max().item() <= 2 * (1 / 16) / .87962566103423978 + 1e-3
        down = sd["layers.1.mlp.down_proj.weight"].float()
        assert abs(down.std().item() - 512 ** -0.5) < 3e-3
        scale = sd["final_norm.scale"]
        assert scale.dtype == torch.float32 and bool((scale == 1).all())

    def test_seeded(self):
        a = tl.init_params(tl.TINY, torch.Generator().manual_seed(3), "cpu")
        b = tl.init_params(tl.TINY, torch.Generator().manual_seed(3), "cpu")
        c = tl.init_params(tl.TINY, torch.Generator().manual_seed(4), "cpu")
        assert all(torch.equal(a[k], b[k]) for k in a)
        assert not torch.equal(a["embed"], c["embed"])
