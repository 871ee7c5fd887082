"""The port's MoE family (nos_tpu_torch.models.moe, .convert) against the
JAX package's nos_tpu.models.moe on the CPU, from the same converted
parameters and inputs made with numpy from a seed.

One process, fp32: MoEMLP's output and aux term against the flax layer
and against the einsum reference (moe_mlp_reference), at the default
capacity and at capacity_factor 0.05, where most choices drop (1e-5);
the routing (expert indices, positions and the drop mask) exactly equal
to JAX's routing of JAX's own router logits; E = 1 / k = 1 as a dense
SwiGLU; MoELlama's logits (1e-4) and moe_loss with its gradients against
flax value_and_grad (loss 1e-5 relative, gradients 1e-6 absolute); and
the flash launches full remat implies.

Over gloo ranks: make_ep_trainer against the JAX make_ep_trainer on the
same mesh shape of the virtual CPU devices, for ep=2, fsdp=2 x ep=2,
tp=2 x ep=2, dp=2 x ep=2 at a capacity that drops tokens, and JAX's own
fsdp=2 x sp=2 x ep=2 (ring attention in the port, dense global attention
in JAX): the losses of three steps, the first step's gradients and the
parameters after the last."""

import dataclasses
import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nos_tpu.models import moe as jm
from nos_tpu.parallel.mesh import MeshSpec, batch_sharding, make_mesh
from nos_tpu_torch.models import moe as tm
from nos_tpu_torch.models.convert import moe_params_from_jax
from nos_tpu_torch.models.llama import (EXPERT_WEIGHTS, ep_slice, is_expert,
                                        tp_slice)
from nos_tpu_torch.parallel.mesh import run_ranks
from nos_tpu_torch.testing import ranks

from test_torch_llama import _DTYPES

# fp32 throughout: outputs and losses agree to rounding.
OUT_TOL = 1e-5
LOGITS_TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-6
# Adam's first update is about lr * sign(g): where a gradient is zero up
# to rounding (|g| below 1e-6 of its tensor's largest), the sign is
# rounding's, and three updates may move such an entry up to 2 lr each
# apart.  Those entries are held to 6 lr; every other to 5e-5 (Adam
# divides by sqrt(v), magnifying the rounding of small gradients: the
# limit of tests/test_torch_sharded.py).
LR = 1e-3
PARAM_ATOL, NEAR_ZERO, NEAR_ZERO_ATOL = 5e-5, 1e-6, 6 * LR


def moe_port_cfg(cfg: jm.MoEConfig, **changes) -> tm.MoEConfig:
    fields = dataclasses.asdict(cfg)
    fields["dtype"] = _DTYPES[cfg.dtype]
    fields["param_dtype"] = _DTYPES[cfg.param_dtype]
    return tm.MoEConfig(**{**fields, **changes})


def _unbox(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.meta.unbox(tree))


def _x(cfg, seed=2, b=2, s=16):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.hidden_size)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _layer(capacity_factor, num_experts=4, top_k=2):
    """The flax MoEMLP's params, output, aux term and router logits, and
    the port's MoEMLP with the same parameters."""
    cfg = dataclasses.replace(jm.TINY_MOE, capacity_factor=capacity_factor,
                              num_experts=num_experts, top_k=top_k)
    x = _x(cfg)
    layer = jm.MoEMLP(cfg)
    variables = layer.init(jax.random.PRNGKey(3), jnp.asarray(x))
    (y, state) = layer.apply(variables, jnp.asarray(x),
                             mutable=["losses", "intermediates"],
                             capture_intermediates=True)
    params = _unbox(variables)["params"]
    port = tm.MoEMLP(moe_port_cfg(cfg), device="cpu")
    port.load_state_dict({
        "router.weight": torch.from_numpy(params["router"]["kernel"].T.copy()),
        **{f"experts.{n}": torch.from_numpy(params[n].copy())
           for n in EXPERT_WEIGHTS}}, assign=True)
    aux = float(jax.tree_util.tree_leaves(state["losses"])[0])
    logits = np.asarray(state["intermediates"]["router"]["__call__"][0])
    return cfg, x, params, np.asarray(y), aux, logits, port


def _jax_routing(cfg, logits):
    """JAX's routing (nos_tpu/models/moe.py:79-97) of its own logits."""
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    _, idx = jax.lax.top_k(probs, cfg.top_k)
    cap = max(1, int(np.ceil(logits.shape[0] * cfg.top_k / cfg.num_experts
                             * cfg.capacity_factor)))
    flat = jax.nn.one_hot(idx, cfg.num_experts, dtype=jnp.float32).reshape(
        -1, cfg.num_experts)
    pos = jnp.sum((jnp.cumsum(flat, axis=0) - flat) * flat, -1).astype(
        jnp.int32)
    return (np.asarray(idx), np.asarray(pos).reshape(idx.shape),
            np.asarray(pos < cap).reshape(idx.shape), cap)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.05])
class TestMoEMLP:
    def test_matches_flax_layer(self, capacity_factor):
        _, x, _, want, want_aux, _, port = _layer(capacity_factor)
        with torch.no_grad():
            y, aux = port(torch.from_numpy(x))
        np.testing.assert_allclose(y.numpy(), want, atol=OUT_TOL, rtol=0)
        np.testing.assert_allclose(aux.item(), want_aux, rtol=OUT_TOL)

    def test_matches_einsum_reference(self, capacity_factor):
        _, x, _, _, _, _, port = _layer(capacity_factor)
        xt = torch.from_numpy(x).requires_grad_()
        y, aux = port(xt)
        (y.square().sum() + aux).backward()
        got = [xt.grad.clone()] + [p.grad.clone() for p in port.parameters()]
        xt.grad = None
        port.zero_grad(set_to_none=True)
        y_ref, aux_ref = tm.moe_mlp_reference(port, xt)
        (y_ref.square().sum() + aux_ref).backward()
        want = [xt.grad] + [p.grad for p in port.parameters()]
        torch.testing.assert_close(y, y_ref, atol=OUT_TOL, rtol=0)
        torch.testing.assert_close(aux, aux_ref, atol=0, rtol=OUT_TOL)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=OUT_TOL, rtol=0)

    def test_routing_equals_jax_exactly(self, capacity_factor):
        cfg, x, _, _, _, logits, port = _layer(capacity_factor)
        with torch.no_grad():
            got = port.route(torch.from_numpy(x))
        np.testing.assert_allclose(
            port.router(torch.from_numpy(x).reshape(-1, cfg.hidden_size))
            .detach().numpy(), logits, atol=OUT_TOL, rtol=0)
        idx, pos, kept, cap = _jax_routing(cfg, logits)
        assert got.capacity == cap
        np.testing.assert_array_equal(got.expert.numpy(), idx)
        np.testing.assert_array_equal(got.position.numpy(), pos)
        np.testing.assert_array_equal(got.kept.numpy(), kept)
        if capacity_factor < 1:
            assert (~kept).mean() > 0.5     # most choices drop

    def test_dropped_tokens_give_no_output(self, capacity_factor):
        cfg, x, _, _, _, _, port = _layer(capacity_factor)
        with torch.no_grad():
            y, _ = port(torch.from_numpy(x))
            kept = port.route(torch.from_numpy(x)).kept
        produced = (y.reshape(-1, cfg.hidden_size).abs() > 1e-9).any(-1)
        np.testing.assert_array_equal(produced.numpy(),
                                      kept.any(-1).numpy())


def test_single_expert_equals_dense_swiglu():
    """E=1/k=1 with ample capacity: every token goes through the one
    expert at gate 1.0, a dense SwiGLU (tests/test_moe.py:26-41)."""
    _, x, params, want, _, _, port = _layer(2.0, num_experts=1, top_k=1)
    with torch.no_grad():
        y, _ = port(torch.from_numpy(x))
    xt = torch.from_numpy(x)
    w = {n: torch.from_numpy(params[n][0].copy()) for n in EXPERT_WEIGHTS}
    ref = torch.nn.functional.silu(xt @ w["w_gate"]) * (xt @ w["w_up"])
    ref = ref @ w["w_down"]
    torch.testing.assert_close(y, ref, atol=1e-4, rtol=0)
    np.testing.assert_allclose(y.numpy(), want, atol=OUT_TOL, rtol=0)


# -- the model -----------------------------------------------------------------

TOY_MOE = dataclasses.replace(jm.TINY_MOE, hidden_size=128, num_heads=2,
                              num_kv_heads=1, head_dim=128)


def _tokens(cfg, seed=0, b=2, s=64):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s), dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _model(cfg):
    """(flax model, unboxed params, the port's MoELlama on them)."""
    model = jm.MoELlama(cfg)
    params = _unbox(model.init(jax.random.PRNGKey(1),
                               jnp.asarray(_tokens(cfg))))["params"]
    return model, params


def _port(cfg, params, **changes):
    pcfg = moe_port_cfg(cfg, **changes)
    port = tm.MoELlama(pcfg, device="cpu")
    port.load_state_dict(moe_params_from_jax(params, pcfg), assign=True)
    return port


# flash reaches the port's flash op (its plain version on the CPU) at
# head_dim 128; the JAX model runs dense attention.
@pytest.mark.parametrize("cfg,attn", [(jm.TINY_MOE, "dense"),
                                      (TOY_MOE, "flash")],
                         ids=["tiny-dense", "toy-flash"])
class TestMoELlama:
    def test_logits_match_flax(self, cfg, attn):
        model, params = _model(cfg)
        tokens = _tokens(cfg, 4)
        want = np.asarray(model.apply({"params": params},
                                      jnp.asarray(tokens)))
        with torch.no_grad():
            got = _port(cfg, params, attn_impl=attn)(torch.from_numpy(tokens))
        np.testing.assert_allclose(got.numpy(), want, atol=LOGITS_TOL, rtol=0)

    def test_loss_and_grads_match_flax(self, cfg, attn):
        model, params = _model(cfg)
        tokens = _tokens(cfg, 5)
        loss, grads = jax.value_and_grad(
            lambda p: jm.moe_loss(model, p, jnp.asarray(tokens)))(params)
        port = _port(cfg, params, attn_impl=attn)
        got = tm.moe_loss(port, torch.from_numpy(tokens))
        got.backward()
        np.testing.assert_allclose(got.item(), float(loss), rtol=LOSS_RTOL)
        want = moe_params_from_jax(_unbox(grads), port.cfg)
        for name, p in port.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                       atol=GRAD_TOL, rtol=0, err_msg=name)

    def test_every_expert_gets_a_gradient(self, cfg, attn):
        _, params = _model(cfg)
        port = _port(cfg, params, attn_impl=attn)
        tm.moe_loss(port, torch.from_numpy(_tokens(cfg, 6))).backward()
        for name, p in port.named_parameters():
            if is_expert(name):
                assert (p.grad.reshape(p.shape[0], -1) != 0).any(1).all(), \
                    name

    def test_forward_returns_the_xent_without_aux(self, cfg, attn):
        _, params = _model(cfg)
        port = _port(cfg, params, attn_impl=attn)
        tokens = torch.from_numpy(_tokens(cfg, 7))
        with torch.no_grad():
            xent, aux = port.loss_terms(tokens, tokens)
            assert port(tokens, tokens).item() == xent.item()
            assert aux.shape == (cfg.num_layers,)
            assert tm.moe_loss(port, tokens).item() == pytest.approx(
                (xent + aux.sum()).item(), rel=1e-7)


def test_full_remat_replays_the_flash_forward(monkeypatch):
    """MoELlama remats each whole block with no policy: the flash forward
    runs twice per layer in a step and the backward once, the launches
    entry.moe_launches_per_step derives for the card."""
    from nos_tpu_torch.entry import moe_launches_per_step
    from nos_tpu_torch.ops import attention as tattn

    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = tattn.flash_attention_fwd, tattn.flash_attention_bwd

    def count(key, fn):
        return lambda *a: calls.__setitem__(key, calls[key] + 1) or fn(*a)

    monkeypatch.setattr(tattn, "flash_attention_fwd", count("fwd", fwd))
    monkeypatch.setattr(tattn, "flash_attention_bwd", count("bwd", bwd))
    _, params = _model(TOY_MOE)
    port = _port(TOY_MOE, params, attn_impl="flash")
    tm.moe_loss(port, torch.from_numpy(_tokens(TOY_MOE, 8))).backward()
    want = moe_launches_per_step(port.cfg)
    assert calls == {"fwd": want["flash_fwd"], "bwd": want["flash_bwd_fused"]}
    assert calls == {"fwd": 2 * TOY_MOE.num_layers,
                     "bwd": TOY_MOE.num_layers}


class TestConvert:
    def test_state_dict_matches_module(self):
        _, params = _model(jm.TINY_MOE)
        pcfg = moe_port_cfg(jm.TINY_MOE)
        sd = moe_params_from_jax(params, pcfg)
        want = tm.MoELlama(pcfg, device="meta").state_dict()
        assert sd.keys() == want.keys()
        for key, t in want.items():
            assert sd[key].shape == t.shape and sd[key].dtype == t.dtype, key
        init = tm.init_moe_params(pcfg, torch.Generator().manual_seed(0),
                                  "cpu")
        assert {k: (v.shape, v.dtype) for k, v in init.items()} == {
            k: (v.shape, v.dtype) for k, v in want.items()}

    def test_expert_layout_is_jax_layout(self):
        _, params = _model(jm.TINY_MOE)
        sd = moe_params_from_jax(params, moe_port_cfg(jm.TINY_MOE))
        moe = params["layer_1"]["moe"]
        np.testing.assert_array_equal(
            sd["layers.1.moe.experts.w_down"].numpy(), moe["w_down"])
        np.testing.assert_array_equal(
            sd["layers.1.moe.router.weight"].numpy()[3, 5],
            moe["router"]["kernel"][5, 3])

    def test_ep_and_tp_slices(self):
        _, params = _model(jm.TINY_MOE)
        sd = moe_params_from_jax(params, moe_port_cfg(jm.TINY_MOE))
        name = "layers.0.moe.experts."
        part = ep_slice(tp_slice(sd, 2, 1), 2, 1)
        assert part[name + "w_gate"].shape == (2, 64, 64)
        assert part[name + "w_down"].shape == (2, 64, 64)
        torch.testing.assert_close(part[name + "w_gate"],
                                   sd[name + "w_gate"][2:, :, 64:])
        torch.testing.assert_close(part[name + "w_down"],
                                   sd[name + "w_down"][2:, 64:, :])
        assert part["layers.0.moe.router.weight"] is \
            sd["layers.0.moe.router.weight"]

    def test_init_draws_flax_fan_in(self):
        # a 3-D kernel's fan-in counts the leading expert dim (flax
        # variance_scaling's receptive field): std 1/sqrt(E D)
        cfg = dataclasses.replace(tm.TINY_MOE, num_experts=8,
                                  intermediate_size=512)
        sd = tm.init_moe_params(cfg, torch.Generator().manual_seed(0), "cpu")
        w = sd["layers.0.moe.experts.w_gate"]
        assert w.std().item() == pytest.approx((8 * 64) ** -0.5, rel=0.05)
        w = sd["layers.0.moe.experts.w_down"]
        assert w.std().item() == pytest.approx((8 * 512) ** -0.5, rel=0.05)

    def test_llama_with_ep_points_to_the_moe_model(self):
        from nos_tpu_torch.models.llama import TINY, Llama, Parallel

        with pytest.raises(ValueError, match="MoELlama"):
            Llama(TINY, device="cpu", mesh=_FakeMesh(ep=2))
        assert Parallel.of(None).ep == 1


class _FakeMesh:
    """A mesh's ``get_group`` / ``[axis]`` surface without process groups."""

    def __init__(self, **sizes):
        self.sizes = sizes

    def get_group(self, axis):
        return None

    def __getitem__(self, axis):
        size = self.sizes.get(axis, 1)
        return type("Dim", (), {"size": lambda self: size,
                                "get_local_rank": lambda self: 0})()


# -- expert parallelism over gloo ranks -----------------------------------------

DROPPING = 0.5      # capacity 32 of 128 tokens x 2 / 4 experts: drops
MESHES = {
    "ep=2": (2, 1.25),
    "fsdp=2,ep=2": (4, 1.25),
    "tp=2,ep=2": (4, 1.25),
    "dp=2,ep=2": (4, DROPPING),
    "fsdp=2,sp=2,ep=2": (8, 1.25),
}


def _batches(cfg, seed=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (4, 32), dtype=np.int32)
            for _ in range(3)]


@functools.lru_cache(maxsize=None)
def _jax_run(spec_text):
    """JAX make_ep_trainer: (initial params, step-0 gradients, losses,
    final params)."""
    cfg = dataclasses.replace(jm.TINY_MOE,
                              capacity_factor=MESHES[spec_text][1])
    batches = _batches(cfg)
    spec = MeshSpec.parse(spec_text)
    mesh = make_mesh(spec, devices=jax.devices()[:spec.size])
    model = jm.MoELlama(cfg)
    params, opt_state, step = jm.make_ep_trainer(
        model, mesh, jnp.asarray(batches[0]))
    init = _unbox(params)
    grads0 = _unbox(jax.jit(jax.grad(lambda p: jm.moe_loss(
        model, p, jnp.asarray(batches[0]))))(params))
    losses = []
    for b in batches:
        params, opt_state, loss = step(
            params, opt_state, jax.device_put(jnp.asarray(b),
                                              batch_sharding(mesh)))
        losses.append(float(loss))
    return cfg, batches, init, grads0, losses, _unbox(params)


@functools.lru_cache(maxsize=None)
def _port_world(world):
    """The port's make_ep_trainer on every mesh of ``world`` ranks, in
    one launch: spec -> rank results."""
    specs = [s for s, (n, _) in MESHES.items() if n == world]
    cases = []
    for spec_text in specs:
        cfg, batches, init, *_ = _jax_run(spec_text)
        pcfg = moe_port_cfg(cfg, attn_impl="ring" if "sp=" in spec_text
                            else "dense")
        cases.append((spec_text, pcfg, moe_params_from_jax(init, pcfg),
                      batches))
    out = run_ranks(ranks.ep_trainer_steps, world, cases, timeout=300)
    return {s: [rank[i] for rank in out] for i, s in enumerate(specs)}


def _port_run(spec_text):
    return _port_world(MESHES[spec_text][0])[spec_text]


@pytest.mark.parametrize("spec_text", list(MESHES))
class TestEPTrainer:
    def test_losses_match_jax(self, spec_text):
        *_, want, _ = _jax_run(spec_text)
        port = _port_run(spec_text)
        for rank in port:
            # every rank reports the global batch's loss
            assert rank["losses"] == port[0]["losses"]
            assert rank["step"] == 3
        np.testing.assert_allclose(port[0]["losses"], want, rtol=LOSS_RTOL)

    def test_first_step_grads_match_jax(self, spec_text):
        cfg, _, _, grads0, _, _ = _jax_run(spec_text)
        want = moe_params_from_jax(grads0, moe_port_cfg(cfg))
        got = _port_run(spec_text)[0]["grads0"]
        assert set(got) == set(want)
        for name in want:
            np.testing.assert_allclose(got[name], want[name].numpy(),
                                       atol=GRAD_TOL, rtol=0, err_msg=name)

    def test_params_match_jax(self, spec_text):
        cfg, _, init, grads0, _, final = _jax_run(spec_text)
        pcfg = moe_port_cfg(cfg)
        start = moe_params_from_jax(init, pcfg)
        want = moe_params_from_jax(final, pcfg)
        g0 = moe_params_from_jax(grads0, pcfg)
        got = _port_run(spec_text)[0]["params"]
        for name in want:
            assert (want[name] - start[name]).abs().max().item() > 0, name
            err = np.abs(got[name] - want[name].numpy())
            g = g0[name].abs().numpy()
            near_zero = g <= NEAR_ZERO * g.max()
            assert err[~near_zero].max(initial=0) <= PARAM_ATOL, name
            assert err[near_zero].max(initial=0) <= NEAR_ZERO_ATOL, name


def test_dropping_mesh_needs_global_routing():
    """On dp=2 x ep=2 at capacity factor 0.5, JAX's routing of the global
    batch drops other (token, choice) pairs than a capacity taken over
    each row block alone would: the parity above holds only with global
    routing."""
    cfg, batches, init, *_ = _jax_run("dp=2,ep=2")
    pcfg = moe_port_cfg(cfg)
    port = tm.MoELlama(pcfg, device="cpu")
    port.load_state_dict(moe_params_from_jax(init, pcfg), assign=True)
    tokens = torch.from_numpy(batches[0])
    moe = port.layers[0].moe
    with torch.no_grad():
        x = port.embed[tokens]
        x = x + port.layers[0].attn(port.layers[0].attn_norm(x),
                                    _rope(pcfg, tokens))
        x = port.layers[0].moe_norm(x)
        whole = moe.route(x).kept.reshape(4, 32, -1)
        halves = torch.cat([moe.route(x[i:i + 2]).kept.reshape(2, 32, -1)
                            for i in (0, 2)])
    assert (~whole).any()
    assert not torch.equal(whole, halves)


def _rope(cfg, tokens):
    from nos_tpu_torch.models.llama import rope_tables

    positions = torch.arange(tokens.shape[1], dtype=torch.int32)[None]
    return rope_tables(positions, cfg.head_dim, cfg.rope_theta)


@pytest.mark.parametrize("spec_text", ["fsdp=1", "ep=2"])
def test_a_forward_between_steps_changes_nothing(spec_text):
    # the step reshards FSDP2's root first, as ShardedTrainer's does
    assert all(run_ranks(ranks.forward_between_steps, MeshSpec.parse(
        spec_text).size, "ep", spec_text, moe_port_cfg(jm.TINY_MOE),
        timeout=120))
