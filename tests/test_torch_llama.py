"""The port's Llama (nos_tpu_torch.models.llama, .convert) against the
flax model, on the CPU and on the same converted parameters: logits, and
the chunked loss and its gradients under every remat policy."""

import dataclasses
import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

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
        # The fused qkv_proj [E, H+2Hkv, D] and gate_up_proj [E, 2I] trees,
        # once refused, now convert and give the flax logits; a tree whose
        # fusion disagrees with the config still raises.
        cfg = dataclasses.replace(TOY, fused_qkv=True, fused_gate_up=True)
        got, want = logits_pair(cfg)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        with pytest.raises(ValueError, match="fused"):
            params_from_jax(flax_params(cfg), port_cfg(dataclasses.replace(
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
    """The options the port refused before its training slice."""

    @pytest.mark.parametrize("change", [
        {"fused_qkv": True}, {"fused_gate_up": True}, {"attn_impl": "ring"}])
    def test_refused(self, change):
        # ring attention builds over a mesh only (as the JAX model's
        # needs one; tests/test_torch_ring.py runs it); the fused
        # projections now build and give the flax model's logits.
        if change.get("attn_impl") == "ring":
            with pytest.raises(ValueError, match="needs a mesh"):
                tl.Llama(dataclasses.replace(tl.TINY, **change), device="cpu")
            return
        got, want = logits_pair(dataclasses.replace(jl.TINY, **change))
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)

    def test_targets_refused(self):
        # Llama(tokens, targets) now returns the chunked loss: the flax
        # model's, from the same parameters.
        got, want = loss_pair(jl.TINY)
        assert abs(got[0] - want[0]) <= 1e-4 * abs(want[0])

    def test_remat_is_accepted(self):
        # remat changes what the backward keeps, not what it computes
        cfg = dataclasses.replace(TOY, remat_policy="rots")
        params = flax_params(cfg)
        tokens = torch.from_numpy(tokens_for(cfg, 3))
        grads = []
        for remat in (True, False):
            model = port_model(dataclasses.replace(cfg, remat=remat), params)
            loss = model(tokens, targets=tokens)
            loss.backward()
            grads.append((loss.detach(), [p.grad for p in model.parameters()]))
        torch.testing.assert_close(grads[0][0], grads[1][0], atol=0, rtol=0)
        for a, b in zip(grads[0][1], grads[1][1]):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)

    def test_unknown_remat_policy_raises(self):
        with pytest.raises(ValueError, match="remat_policy"):
            tl.Llama(dataclasses.replace(tl.TINY, remat_policy="some"),
                     device="meta")


def loss_pair(cfg, seed=0):
    """((loss, {name: grad}) of the port, (loss, {name: grad}) of flax's
    value_and_grad of Llama(tokens, targets=tokens)), as numpy, with the
    flax gradients carried into the port's layout by params_from_jax."""
    tokens = tokens_for(cfg, seed + 1)
    params = flax_params(cfg, seed)

    def loss_fn(p):
        return jl.Llama(cfg).apply({"params": p}, jnp.asarray(tokens),
                                   targets=jnp.asarray(tokens))

    loss, grads = jax.value_and_grad(loss_fn)(params["params"])
    grads = params_from_jax(jax.tree_util.tree_map(np.asarray, grads),
                            port_cfg(cfg))
    model = port_model(cfg, params)
    t = torch.from_numpy(tokens)
    got = model(t, targets=t)
    got.backward()
    return ((got.item(), {n: p.grad.numpy()
                          for n, p in model.named_parameters()}),
            (float(loss), {n: g.numpy() for n, g in grads.items()}))


def _fused(cfg):
    return dataclasses.replace(cfg, fused_qkv=True, fused_gate_up=True)


class TestLoss:
    """Loss and gradients of Llama(tokens, targets) against
    jax.value_and_grad of the flax model (fp32, 1e-4 relative; the flax
    TOY runs dense attention on the CPU, the port its plain flash
    backward)."""

    @pytest.mark.parametrize("cfg", [
        jl.TINY,
        dataclasses.replace(jl.TINY, remat_policy="rots"),
        TOY,
        dataclasses.replace(TOY, remat_policy="rots"),
        _fused(dataclasses.replace(TOY, remat_policy="rots")),
        _fused(dataclasses.replace(TOY, remat_policy="all_mats")),
    ], ids=["tiny-dense-nothing", "tiny-dense-rots", "toy-flash-nothing",
            "toy-flash-rots", "toy-flash-fused-rots",
            "toy-flash-fused-all_mats"])
    def test_matches_flax_value_and_grad(self, cfg):
        (loss, grads), (want_loss, want) = loss_pair(cfg)
        assert abs(loss - want_loss) <= 1e-4 * abs(want_loss)
        assert grads.keys() == want.keys()
        for name, g in grads.items():
            scale = np.abs(want[name]).max()
            assert np.abs(g - want[name]).max() <= 1e-4 * scale, name

    @pytest.mark.parametrize("seq,chunk", [(24, 16), (24, 8), (24, 24),
                                           (24, 0)])
    def test_chunked_xent(self, seq, chunk):
        # 24 % 16: one chunk; 24 / 8: three; one chunk; chunk 0 disables
        rng = np.random.default_rng(9)
        x = rng.standard_normal((2, seq, 16)).astype(np.float32)
        embed = rng.standard_normal((40, 16)).astype(np.float32) * 0.3
        tokens = rng.integers(0, 40, (2, seq), dtype=np.int32)

        def jax_loss(x, e):
            return jl._chunked_xent(x, e, jnp.asarray(tokens), chunk,
                                    jnp.float32)

        want, (gx, ge) = jax.value_and_grad(jax_loss, (0, 1))(
            jnp.asarray(x), jnp.asarray(embed))
        xt = torch.from_numpy(x).requires_grad_()
        et = torch.from_numpy(embed).requires_grad_()
        got = tl._chunked_xent(xt, et, torch.from_numpy(tokens), chunk,
                               torch.float32)
        got.backward()
        assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(et.grad.numpy(), np.asarray(ge),
                                   atol=1e-6, rtol=0)

    def test_chunked_xent_is_the_full_loss(self):
        # the chunked loss equals cross_entropy_loss of the full logits
        from nos_tpu_torch.models.train import cross_entropy_loss

        model = port_model(TOY, flax_params(TOY))
        tokens = torch.from_numpy(tokens_for(TOY, 4))
        with torch.no_grad():
            chunked = model(tokens, targets=tokens)
            full = cross_entropy_loss(model(tokens), tokens)
        torch.testing.assert_close(chunked, full, atol=1e-5, rtol=0)


class _CountOps(TorchDispatchMode):
    """Counts the matrix products (aten.mm and the port's named
    projections) and the rope ops that run under it."""

    def __init__(self):
        super().__init__()
        self.matmuls = self.ropes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.matmuls += func in (torch.ops.aten.mm.default, tl.LINEAR_OP)
        self.ropes += func is tl.ROPE_OP
        return func(*args, **(kwargs or {}))


class TestRemat:
    """The seven remat policies: the same loss and gradients; the flash
    forward rerun in backward only where attn_out is not kept; and the
    projections and rotations whose outputs a policy keeps not
    recomputed."""

    @pytest.mark.parametrize("policy,reruns", [
        ("nothing", True), ("dots", True), ("mlp", True), ("attn", False),
        ("mats", False), ("all_mats", False), ("rots", False)])
    def test_policy(self, policy, reruns, monkeypatch):
        from nos_tpu_torch.ops import attention as tattn

        calls = []
        fwd = tattn.flash_attention_fwd
        monkeypatch.setattr(tattn, "flash_attention_fwd",
                            lambda *a: calls.append(1) or fwd(*a))
        cfg = dataclasses.replace(TOY, remat_policy=policy)
        params = flax_params(TOY)
        tokens = torch.from_numpy(tokens_for(TOY, 5))
        results = []
        for remat in (True, False):
            calls.clear()
            model = port_model(dataclasses.replace(cfg, remat=remat), params)
            loss = model(tokens, targets=tokens)
            loss.backward()
            results.append((loss.item(), len(calls),
                            [p.grad for p in model.parameters()]))
        (loss, n_calls, grads), (ref_loss, ref_calls, ref_grads) = results
        assert ref_calls == TOY.num_layers
        assert n_calls == TOY.num_layers * (2 if reruns else 1)
        assert loss == ref_loss
        for a, b in zip(grads, ref_grads):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)

    @staticmethod
    def _backward_ops(cfg, **change):
        """(matrix products, rope ops) run in backward: recomputed ones
        and, for the products, the gradient products."""
        model = port_model(dataclasses.replace(cfg, **change),
                           flax_params(cfg))
        tokens = torch.from_numpy(tokens_for(cfg, 5))
        loss = model(tokens, targets=tokens)
        with _CountOps() as ops:
            loss.backward()
        return ops.matmuls, ops.ropes

    def test_kept_projections_are_not_recomputed(self):
        # Matrix products run in backward, less those of remat=False:
        # none under "dots", which keeps every projection; fewer where a
        # policy keeps more of them.  "rots" keeps the q/k projections
        # with their rotations (_KEPT_WITH), so it reruns what
        # "all_mats" reruns.
        base = self._backward_ops(TOY, remat=False)[0]
        n = {policy: self._backward_ops(TOY, remat_policy=policy)[0] - base
             for policy in tl._REMAT_POLICIES}
        assert n["dots"] == 0
        assert n["rots"] == n["all_mats"] < n["mats"] == n["mlp"] \
            < n["attn"] == n["nothing"]

    @pytest.mark.parametrize("fused", [False, True],
                             ids=["separate", "fused"])
    def test_kept_rotations_are_not_recomputed(self, fused):
        # "rots" keeps the rotated q and k, "all_mats" the q and k before
        # rope: only the latter reruns rope (q and k, per layer) in
        # backward, as the JAX policies differ.
        cfg = _fused(TOY) if fused else TOY
        ropes = {policy: self._backward_ops(cfg, remat_policy=policy)[1]
                 for policy in ("rots", "all_mats", "nothing")}
        assert self._backward_ops(cfg, remat=False)[1] == 0
        assert ropes == {"rots": 0, "all_mats": 2 * TOY.num_layers,
                         "nothing": 2 * TOY.num_layers}

    def test_rope_op_gradient(self):
        # the rope op's own backward (the transposed rotation) against
        # autograd through the plain _rope
        rng = np.random.default_rng(10)
        x = torch.from_numpy(rng.standard_normal((2, 6, 3, 16))
                             .astype(np.float32))
        g = torch.from_numpy(rng.standard_normal((2, 6, 3, 16))
                             .astype(np.float32))
        pos = torch.arange(6, dtype=torch.int32)[None].expand(2, 6)
        cos, sin = tl.rope_tables(pos, 16, 10000.0)
        a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
        (tl._rope(a, (cos, sin)) * g).sum().backward()
        (tl.ROPE_OP(b, cos, sin, "attn_q_rot") * g).sum().backward()
        torch.testing.assert_close(b.grad, a.grad, atol=1e-6, rtol=0)


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

    def test_fused_layout(self):
        # fused_qkv / fused_gate_up: the module's keys, and the fused
        # weights lecun-normal over fan_in 256 (std 1/16)
        cfg = _fused(dataclasses.replace(tl.TINY, hidden_size=256,
                                         intermediate_size=512))
        sd = tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        assert sd.keys() == tl.Llama(cfg, device="meta").state_dict().keys()
        for name in ("attn.qkv_proj", "mlp.gate_up_proj"):
            w = sd[f"layers.0.{name}.weight"]
            assert abs(w.std().item() - 1 / 16) < 3e-3, name
