"""The port's attention (nos_tpu_torch.ops.attention,
nos_tpu_torch.parallel.ring) against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both frameworks.
The flash forward's and backward's plain versions are held against the
Pallas kernel bodies run in interpret mode (the JAX package's own CPU
route to them), and the differentiable op against autograd of the dense
attention.  The CUDA kernels themselves are tested on the card by
tests/test_torch_kernels.py.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nos_tpu.ops import attention as jattn
from nos_tpu.parallel.ring import dense_attention as jax_dense
from nos_tpu_torch.ops import attention as tattn
from nos_tpu_torch.parallel.ring import dense_attention as torch_dense

BF16_TOL = 2e-2    # bf16 outputs: rounding at other places in each framework
FP32_TOL = 1e-5


def _inputs(seed, shapes, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype) for s in shapes]


def _jax(x, dtype=jnp.float32):
    return jnp.asarray(x, dtype=dtype)


def _torch(x, dtype=torch.float32):
    return torch.from_numpy(x).to(dtype)


class TestDenseAttention:
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("sq,sk", [(32, 32), (16, 48), (1, 40)])
    def test_fp32_matches_jax(self, causal, sq, sk):
        q, k, v = _inputs(0, [(2, sq, 3, 16), (2, sk, 3, 16), (2, sk, 3, 16)])
        want = np.asarray(jax_dense(_jax(q), _jax(k), _jax(v), causal))
        got = torch_dense(_torch(q), _torch(k), _torch(v), causal).numpy()
        np.testing.assert_allclose(got, want, atol=FP32_TOL, rtol=0)

    @pytest.mark.parametrize("causal", [True, False])
    def test_bf16_matches_jax(self, causal):
        q, k, v = _inputs(1, [(2, 24, 2, 32), (2, 40, 2, 32), (2, 40, 2, 32)])
        want = jax_dense(_jax(q, jnp.bfloat16), _jax(k, jnp.bfloat16),
                         _jax(v, jnp.bfloat16), causal)
        got = torch_dense(_torch(q, torch.bfloat16), _torch(k, torch.bfloat16),
                          _torch(v, torch.bfloat16), causal)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=BF16_TOL, rtol=0)

    def test_fully_masked_row_is_uniform_not_nan(self):
        # seq_q > seq_k under bottom-right alignment masks whole rows; the
        # -1e30 mask value makes them uniform, as in the JAX function.
        q, k, v = _inputs(2, [(1, 6, 1, 8), (1, 3, 1, 8), (1, 3, 1, 8)])
        got = torch_dense(_torch(q), _torch(k), _torch(v), True)
        want = np.asarray(jax_dense(_jax(q), _jax(k), _jax(v), True))
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), want, atol=FP32_TOL, rtol=0)


class TestFlashForwardPlain:
    """flash_attention_fwd_reference against the Pallas kernel body."""

    @pytest.mark.parametrize("causal", [True, False])
    def test_matches_pallas_interpret(self, causal):
        q, k, v = _inputs(3, [(1, 256, 2, 128)] * 3)
        o_j, lse_j = jattn._flash_forward(_jax(q), _jax(k), _jax(v), causal,
                                          128, 128, True)
        o_j = np.asarray(jattn._unfold(o_j, 1, 2))
        lse_j = np.asarray(lse_j).reshape(1, 2, 256)   # [B*H, S, 1] -> [B, H, S]
        o_t, lse_t = tattn.flash_attention_fwd_reference(
            _torch(q), _torch(k), _torch(v), causal)
        np.testing.assert_allclose(o_t.numpy(), o_j, atol=1e-4, rtol=0)
        np.testing.assert_allclose(lse_t.numpy(), lse_j, atol=1e-4, rtol=0)

    @pytest.mark.parametrize("causal", [True, False])
    def test_ragged_length_matches_dense(self, causal):
        # S=200 is no multiple of a tile: the JAX op sends it to dense.
        q, k, v = _inputs(4, [(2, 200, 2, 128)] * 3)
        want = np.asarray(jax_dense(_jax(q), _jax(k), _jax(v), causal))
        o, lse = tattn.flash_attention_fwd(_torch(q), _torch(k), _torch(v),
                                           causal)
        np.testing.assert_allclose(o.numpy(), want, atol=1e-5, rtol=0)
        assert lse.shape == (2, 2, 200) and lse.dtype == torch.float32

    def test_lse_is_logsumexp_of_scaled_scores(self):
        q, k, v = _inputs(5, [(1, 20, 2, 16)] * 3)
        qt, kt, vt = _torch(q), _torch(k), _torch(v)
        _, lse = tattn.flash_attention_fwd(qt, kt, vt, False)
        s = torch.einsum("bqhd,bkhd->bhqk", qt, kt) * 16 ** -0.5
        torch.testing.assert_close(lse, torch.logsumexp(s, -1), atol=1e-5,
                                   rtol=0)

    def test_public_op_returns_o(self):
        q, k, v = _inputs(6, [(1, 32, 2, 128)] * 3)
        qt, kt, vt = _torch(q), _torch(k), _torch(v)
        o = tattn.flash_attention(qt, kt, vt, True)
        want = np.asarray(jattn.flash_attention(_jax(q), _jax(k), _jax(v),
                                                True))
        np.testing.assert_allclose(o.numpy(), want, atol=1e-5, rtol=0)


class TestRepeatKV:
    @pytest.mark.parametrize("n_rep", [1, 2, 4])
    def test_exact(self, n_rep):
        (k,) = _inputs(7, [(2, 5, 3, 8)])
        want = np.asarray(jattn.repeat_kv(_jax(k), n_rep))
        got = tattn.repeat_kv(_torch(k), n_rep).numpy()
        np.testing.assert_array_equal(got, want)


class TestDispatch:
    def test_cpu_call_launches_nothing(self):
        q, k, v = _inputs(8, [(1, 64, 2, 128)] * 3)
        before = tattn.FLASH_FWD_LAUNCHES
        tattn.flash_attention_fwd(_torch(q, torch.bfloat16),
                                  _torch(k, torch.bfloat16),
                                  _torch(v, torch.bfloat16), True)
        assert tattn.FLASH_FWD_LAUNCHES == before

    def test_cpu_bf16_keeps_dtype(self):
        q, k, v = _inputs(9, [(1, 16, 1, 128)] * 3)
        o, lse = tattn.flash_attention_fwd(_torch(q, torch.bfloat16),
                                           _torch(k, torch.bfloat16),
                                           _torch(v, torch.bfloat16), True)
        assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32

    @pytest.mark.parametrize("shapes", [
        [(1, 8, 2, 16), (1, 8, 1, 16), (1, 8, 1, 16)],   # KV heads not repeated
        [(1, 8, 2, 16), (1, 8, 2, 16), (1, 9, 2, 16)],   # k and v differ
        [(8, 2, 16), (8, 2, 16), (8, 2, 16)],            # not [B, S, H, D]
    ])
    def test_bad_shapes_raise(self, shapes):
        q, k, v = (_torch(x) for x in _inputs(10, shapes))
        with pytest.raises(ValueError):
            tattn.flash_attention_fwd(q, k, v, True)


def _jax_backward(impl, q, k, v, g, causal, block_q, block_k, dtype):
    """(dq, dk, dv) of the JAX package's fused or split backward kernels
    in interpret mode, with the forward's o and lse, as numpy; and the
    same o and lse for the port ([B, S, H, D] and [B, H, S])."""
    qj, kj, vj, gj = (_jax(x, dtype) for x in (q, k, v, g))
    b, s, h, _ = q.shape
    o, lse = jattn._flash_forward(qj, kj, vj, causal, block_q, block_k, True)
    o = jattn._unfold(o, b, h)
    fn = (jattn._flash_backward_fused if impl == "fused"
          else jattn._flash_backward)
    grads = fn(qj, kj, vj, o, lse, gj, causal, block_q, block_k, True)
    return ([np.asarray(x, np.float32) for x in grads],
            np.asarray(o, np.float32), np.asarray(lse).reshape(b, h, s))


class TestFlashBackwardPlain:
    """The plain backward versions against the Pallas backward kernels
    (interpret mode) on the same q, k, v, dO and the same o and lse."""

    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("impl", ["fused", "split"])
    @pytest.mark.parametrize("bf16,tol", [
        (False, 1e-4),      # the algorithm: fp32 throughout
        (True, 3e-2),       # bf16 inputs: ds and p rounded to bf16
    ], ids=["fp32", "bf16"])
    def test_matches_pallas_interpret(self, causal, impl, bf16, tol):
        q, k, v, g = _inputs(11, [(1, 256, 2, 128)] * 4)
        # rectangular blocks: block_q 64 != block_k 128
        want, o, lse = _jax_backward(
            impl, q, k, v, g, causal, 64, 128,
            jnp.bfloat16 if bf16 else jnp.float32)
        tdt = torch.bfloat16 if bf16 else torch.float32
        qt, kt, vt, gt = (_torch(x, tdt) for x in (q, k, v, g))
        ot = torch.from_numpy(np.array(o)).to(tdt)
        lse_t = torch.from_numpy(np.array(lse))
        delta = (gt.float() * ot.float()).sum(-1).transpose(1, 2).contiguous()
        args = (qt, kt, vt, gt, lse_t, delta, causal)
        if impl == "fused":
            got = tattn.flash_attention_bwd_fused(*args)
        else:
            got = (tattn.flash_attention_dq(*args),
                   *tattn.flash_attention_dkv(*args))
        for name, x, w in zip("qkv", got, want):
            assert x.dtype == tdt
            scale = np.abs(w).max()
            err = np.abs(x.float().numpy() - w).max() / scale
            assert err <= tol, (name, err)

    @pytest.mark.parametrize("causal", [True, False])
    def test_fused_and_split_plain_agree(self, causal):
        q, k, v, g = (_torch(x) for x in _inputs(12, [(2, 96, 2, 16)] * 4))
        o, lse = tattn.flash_attention_fwd_reference(q, k, v, causal)
        delta = (g * o).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, g, lse, delta, causal)
        fused = tattn.flash_attention_bwd_fused(*args)
        split = (tattn.flash_attention_dq(*args),
                 *tattn.flash_attention_dkv(*args))
        for a, b in zip(fused, split):
            torch.testing.assert_close(a, b, atol=0, rtol=0)


class TestFlashGradient:
    """The differentiable op against autograd of the dense attention."""

    @pytest.mark.parametrize("impl", ["fused", "split"])
    @pytest.mark.parametrize("sq,sk,causal", [
        (48, 48, True), (48, 48, False),
        (16, 40, False),    # causal takes seq_q == seq_k only, as in JAX
    ])
    def test_matches_dense_autograd(self, impl, sq, sk, causal):
        q, k, v = (_torch(x).requires_grad_() for x in _inputs(
            13, [(2, sq, 3, 16), (2, sk, 3, 16), (2, sk, 3, 16)]))
        (g,) = (_torch(x) for x in _inputs(14, [(2, sq, 3, 16)]))
        prev = tattn.set_backward_impl(impl)
        try:
            got = torch.autograd.grad(tattn.flash_attention(q, k, v, causal),
                                      (q, k, v), g)
        finally:
            tattn.set_backward_impl(prev)
        want = torch.autograd.grad(torch_dense(q, k, v, causal), (q, k, v), g)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)

    def test_grouped_kv_grads_sum_over_the_group(self):
        # repeat_kv's expand + reshape: autograd sums dk/dv over the group
        # as jnp.broadcast_to's transpose does.
        q, k, v, g = _inputs(15, [(1, 32, 4, 16), (1, 32, 2, 16),
                                  (1, 32, 2, 16), (1, 32, 4, 16)])

        def jax_loss(q, k, v):
            out = jattn.flash_attention(q, jattn.repeat_kv(k, 2),
                                        jattn.repeat_kv(v, 2), True)
            return (out * _jax(g)).sum()

        want = jax.grad(jax_loss, (0, 1, 2))(_jax(q), _jax(k), _jax(v))
        qt, kt, vt = (_torch(x).requires_grad_() for x in (q, k, v))
        out = tattn.flash_attention(qt, tattn.repeat_kv(kt, 2),
                                    tattn.repeat_kv(vt, 2), True)
        got = torch.autograd.grad((out * _torch(g)).sum(), (qt, kt, vt))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                       rtol=0)


class TestBackwardChoice:
    """Fused or split: the same shapes take the same backward as in the
    JAX package (its _bwd formula over its default backward blocks)."""

    @staticmethod
    def _jax_choice(shape_q, shape_k, itemsize=2):
        qs = jax.ShapeDtypeStruct(shape_q, jnp.bfloat16)
        ks = jax.ShapeDtypeStruct(shape_k, jnp.bfloat16)
        plan = (jattn._plan(qs, ks, True, jattn.DEFAULT_BWD_BLOCK_Q,
                            jattn.DEFAULT_BWD_BLOCK_K)
                or jattn._plan(qs, ks, True, jattn.DEFAULT_BLOCK_Q,
                               jattn.DEFAULT_BLOCK_K))
        b, sq, h, d = shape_q
        partial = b * h * (shape_k[1] // plan[1]) * sq * d * itemsize
        return ("fused" if partial <= jattn.FUSED_PARTIAL_BUDGET
                else "split")

    @pytest.mark.parametrize("b,s,h", [
        (8, 2048, 8),       # BENCH_350M_TRAIN: 67 MB of partials -> fused
        (8, 8192, 8),       # 1.07 GB: just above the budget -> split
        (1, 32768, 8),      # long context -> split
        (2, 1536, 4),       # 1024 does not divide: the forward's blocks
        (4, 512, 8),        # blocks shrunk to the sequence
    ])
    def test_same_choice_as_jax(self, b, s, h):
        q = torch.empty(b, s, h, 128, dtype=torch.bfloat16, device="meta")
        assert tattn.FUSED_PARTIAL_BUDGET == jattn.FUSED_PARTIAL_BUDGET
        assert tattn.backward_impl(q, q) == self._jax_choice(q.shape, q.shape)

    def test_set_backward_impl(self):
        q = torch.empty(8, 2048, 8, 128, dtype=torch.bfloat16, device="meta")
        prev = tattn.set_backward_impl("split")
        try:
            assert prev == "fused"
            assert tattn.backward_impl(q, q) == "split"
        finally:
            tattn.set_backward_impl(prev)
        assert tattn.backward_impl(q, q) == "fused"
        with pytest.raises(ValueError):
            tattn.set_backward_impl("dense")

    def test_env_selects_split(self):
        code = ("from nos_tpu_torch.ops import attention as a; "
                "print(a._BWD_IMPL)")
        env = {"NOS_TPU_FLASH_BWD": "split", "PATH": os.environ["PATH"],
               "PYTHONPATH": str(Path(__file__).resolve().parent.parent)}
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=120,
                             check=True).stdout.strip()
        assert out == "split"

    def test_backward_counts_no_launch_on_cpu(self):
        q, k, v = (_torch(x).requires_grad_() for x in _inputs(
            16, [(1, 32, 2, 128)] * 3))
        before = (tattn.FLASH_BWD_FUSED_LAUNCHES, tattn.FLASH_DQ_LAUNCHES,
                  tattn.FLASH_DKV_LAUNCHES)
        tattn.flash_attention(q, k, v, True).sum().backward()
        assert (tattn.FLASH_BWD_FUSED_LAUNCHES, tattn.FLASH_DQ_LAUNCHES,
                tattn.FLASH_DKV_LAUNCHES) == before
        assert q.grad is not None and torch.isfinite(q.grad).all()
