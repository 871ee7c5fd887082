"""The port's attention (nos_tpu_torch.ops.attention,
nos_tpu_torch.parallel.ring) against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both frameworks.
The flash forward's plain version is held against the Pallas kernel body
run in interpret mode (the JAX package's own CPU route to it).  The
CUDA kernel itself is tested on the card by tests/test_torch_kernels.py.
"""

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
