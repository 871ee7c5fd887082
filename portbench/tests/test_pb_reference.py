"""The plain reference against the port at test sizes on the CPU (both in
fp32, so they agree to rounding), and the reference's blocks against
the same computation whole."""

import importlib

import pytest
import torch

from portbench import check, readings
from portbench.reference import model as R
from portbench.tests.conftest import tiny_cell


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_reference_follows_the_port(family):
    cell = tiny_cell(family)
    entry = importlib.import_module(f"portbench.entries.{cell.entry}")
    session = entry.Session(cell, 20260, torch.device("cpu"))
    mine = readings.program(session, session.batches(), 3, cell.spec, 20260,
                            "cpu")
    session.close()
    theirs = readings.reference(cell.spec, 20260, cell.batch_size,
                                cell.seq_len, 3, "cpu")
    found = check.gaps(mine, theirs)
    assert found["loss_gap"]["value"] < 1e-5
    assert found["grad_gap"]["value"] < 1e-4
    assert found["update_gap"]["value"] < 1e-3
    # three steps that move the state
    assert len(set(theirs.losses)) == 3
    assert min(theirs.update_norms.values()) > 0


def _attention_whole(q, k, v):
    b, s, hq, d = q.shape
    g = hq // k.shape[2]
    k, v = k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k) / d ** 0.5
    sc = sc.masked_fill(torch.ones(s, s, dtype=torch.bool).triu(1),
                        float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", sc.softmax(-1), v)


def test_attention_blocks_match_whole(monkeypatch):
    monkeypatch.setattr(R, "_SCORE_BUDGET", 4 * 2 * 512)  # 128-row blocks
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 384, 4, 16, generator=gen, requires_grad=True)
    k = torch.randn(2, 384, 2, 16, generator=gen, requires_grad=True)
    v = torch.randn(2, 384, 2, 16, generator=gen, requires_grad=True)
    got = R.attention(q, k, v, R.Numerics())
    want = _attention_whole(q, k, v)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    g1 = torch.autograd.grad(got.square().sum(), (q, k, v))
    g2 = torch.autograd.grad(want.square().sum(), (q, k, v))
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_capacity_drops_in_token_order():
    cell = tiny_cell("moe")
    spec = cell.spec
    # 64 tokens, top-2 of 4 at capacity factor 1.25: 40 slots an expert
    assert R.capacity(spec, 64) == 40
    h = torch.zeros(64, spec.hidden_size)
    p = {"layers.0.moe.router.weight": torch.zeros(4, spec.hidden_size)}
    p["layers.0.moe.router.weight"][0, 0] = 5.0
    p["layers.0.moe.router.weight"][1, 0] = 4.0
    h[:, 0] = 1.0          # every token picks experts 0 and 1
    for w, shape in (("w_gate", (4, 64, 128)), ("w_up", (4, 64, 128)),
                     ("w_down", (4, 128, 64))):
        p[f"layers.0.moe.experts.{w}"] = torch.ones(shape) * 0.01
    y, _ = R.moe_mlp(h, p, "layers.0.", spec, R.Numerics())
    # tokens past the 40th get nothing: both their choices are dropped
    assert (y[:40].abs().sum(-1) > 0).all()
    assert (y[40:] == 0).all()


def test_fp8_control_rounds_products():
    x = torch.linspace(-3, 3, 1001)
    num = R.Numerics(fp8=True)
    r = num.r(x)
    assert 0 < (r - x).abs().max() < 3 * 2 ** -4
    assert torch.equal(R.Numerics().r(x), x)


def test_fp8_control_rounds_gradients():
    # the gradient passed back is the incoming one through e5m2, at a
    # per-tensor scale
    x = torch.ones(4, requires_grad=True)
    grad = torch.tensor([8.0, 9.0, 9.5, 1.0])    # scaled by amax
    R.Numerics(fp8=True).r(x).backward(grad)
    scale = torch.finfo(torch.float8_e5m2).max / 9.5
    want = (grad * scale).to(torch.float8_e5m2).float() / scale
    assert torch.equal(x.grad, want)
    assert not torch.equal(x.grad, grad)
