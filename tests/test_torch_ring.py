"""The port's ring attention (nos_tpu_torch.parallel.ring) over 2 and 4
gloo ranks against dense attention on the gathered sequence and against
the JAX package's ring_attention on an sp mesh of the virtual CPU
devices: the output and the gradients of sum(out * dO), causal and not,
with the next hop issued before or after each block's products.  All in
fp32; each output and gradient agrees within 2e-5 (the n block sums run
in another order than the dense softmax and JAX's transposed scan)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nos_tpu.parallel.mesh import MeshSpec, make_mesh
from nos_tpu.parallel.ring import ring_attention as jax_ring
from nos_tpu_torch.parallel.mesh import run_ranks
from nos_tpu_torch.parallel.ring import dense_attention
from nos_tpu_torch.testing import ranks

TOL = 2e-5
CASES = [(True, True), (True, False), (False, True), (False, False)]
NAMES = ["o", "dq", "dk", "dv"]


def _inputs(seed=0, b=2, s=16, h=2, d=8):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(4)]


@functools.lru_cache(maxsize=None)
def _ring(n):
    """The gathered output and gradients of each case on n ranks."""
    q, k, v, do = _inputs()
    out = run_ranks(ranks.ring_attention_cases, n, q, k, v, do, CASES,
                    timeout=120)
    return [{name: np.concatenate([r[i][name] for r in out], axis=1)
             for name in NAMES} for i in range(len(CASES))]


def _dense(causal):
    q, k, v, do = (torch.from_numpy(x) for x in _inputs())
    q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
    o = dense_attention(q, k, v, causal)
    o.backward(do)
    return {"o": o.detach().numpy(), "dq": q.grad.numpy(),
            "dk": k.grad.numpy(), "dv": v.grad.numpy()}


def _jax(n, causal, overlap):
    q, k, v, do = (jnp.asarray(x) for x in _inputs())
    mesh = make_mesh(MeshSpec(sp=n), devices=jax.devices()[:n])

    @jax.jit
    def run(q, k, v, do):
        o, vjp = jax.vjp(lambda q, k, v: jax_ring(
            mesh, q, k, v, causal=causal, overlap=overlap), q, k, v)
        return (o, *vjp(do))

    return dict(zip(NAMES, (np.asarray(x) for x in run(q, k, v, do))))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"causal={c}-overlap={o}" for c, o in CASES])
class TestRingAttention:
    def test_matches_dense_attention(self, n, case):
        got, want = _ring(n)[case], _dense(CASES[case][0])
        for name in NAMES:
            np.testing.assert_allclose(got[name], want[name], atol=TOL,
                                       rtol=0, err_msg=name)

    def test_matches_jax_ring_attention(self, n, case):
        got, want = _ring(n)[case], _jax(n, *CASES[case])
        for name in NAMES:
            np.testing.assert_allclose(got[name], want[name], atol=TOL,
                                       rtol=0, err_msg=name)


@pytest.mark.parametrize("n", [2, 4])
def test_overlap_changes_no_number(n):
    # the products read the block held before the hop either way
    for causal in (True, False):
        a, b = (_ring(n)[CASES.index((causal, ov))] for ov in (True, False))
        for name in NAMES:
            np.testing.assert_array_equal(a[name], b[name])
