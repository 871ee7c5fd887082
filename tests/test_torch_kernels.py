"""The port's Hopper kernels against their plain PyTorch versions, on
the card.  Imports torch only, so it runs where JAX is not installed:

    python -m pytest tests/test_torch_kernels.py -m cuda -q

Without a card every test skips with its reason (the kernels have no CPU
mode); the CPU parity of the plain versions is in test_torch_attention.py.
"""

import dataclasses

import pytest
import torch

from nos_tpu_torch.ops import attention as tattn

O_TOL = 2e-2      # bf16 o: online vs one-pass rounding of p, bf16 output
LSE_TOL = 1e-3    # fp32 row statistics
# Backward: each gradient within 2e-2 of its reference's max |value| (the
# JAX package's own rule for its backward kernels), fused against split
# within 3e-2 (tests/test_compute.py).
GRAD_TOL = 2e-2
FUSED_SPLIT_TOL = 3e-2
# Lengths around the kernels' tile edges: K1 takes 128 q rows and 128 keys
# per step, K2 and K4 128 keys and 64 q rows, K3 128 q rows (64 per
# consumer warpgroup) and 64 keys; 191/192/193 straddle the consumers of
# K3's second q tile, 256/257 the edge of its third.
SEQS = [1, 63, 64, 65, 127, 128, 129, 191, 192, 193, 200, 256, 257, 512,
        2048]
# (batch, heads, seq): a grid well under one wave of 132 SMs, and one of
# several waves.
GRIDS = [(1, 1, 128), (8, 16, 2048)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels have no CPU mode")
    return torch.device("cuda")


def _bf16(gen, *shape, device):
    return torch.randn(*shape, generator=gen, device=device,
                       dtype=torch.bfloat16)


def _bwd_inputs(device, seq, causal, seed=0, batch=2, heads=4, seq_k=None):
    """q, k, v, dO and the forward's lse and delta (from the plain
    forward, so kernel and plain version see the same inputs)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    seq_k = seq if seq_k is None else seq_k
    q = _bf16(gen, batch, seq, heads, 128, device=device)
    k, v = (_bf16(gen, batch, seq_k, heads, 128, device=device)
            for _ in range(2))
    do = _bf16(gen, batch, seq, heads, 128, device=device)
    o, lse = tattn.flash_attention_fwd_reference(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta


def _rel_err(got, want):
    """max |got - want| over max |want|, with the scale floored at 1e-3:
    at S=1 dq and dk are 0 in exact arithmetic (p = 1 and dp = delta, so
    ds = 0) and both sides hold only rounding."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-3)).item()


_KERNELS = {
    "fused": (tattn.flash_attention_bwd_fused,
              tattn.flash_attention_bwd_fused_reference,
              "FLASH_BWD_FUSED_LAUNCHES"),
    "dq": (lambda *a: (tattn.flash_attention_dq(*a),),
           lambda *a: (tattn.flash_attention_dq_reference(*a),),
           "FLASH_DQ_LAUNCHES"),
    "dkv": (tattn.flash_attention_dkv, tattn.flash_attention_dkv_reference,
            "FLASH_DKV_LAUNCHES"),
}


@pytest.mark.cuda
class TestKernelOnCard:
    """The Hopper kernels against their plain versions (run on the card)."""

    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("seq", SEQS)
    def test_matches_plain(self, cuda, causal, seq):
        gen = torch.Generator(device=cuda).manual_seed(seq)
        q, k, v = (torch.randn(2, seq, 4, 128, generator=gen, device=cuda,
                               dtype=torch.bfloat16) for _ in range(3))
        before = tattn.FLASH_FWD_LAUNCHES
        o, lse = tattn.flash_attention_fwd(q, k, v, causal)
        o_ref, lse_ref = tattn.flash_attention_fwd_reference(q, k, v, causal)
        torch.cuda.synchronize()
        assert tattn.FLASH_FWD_LAUNCHES == before + 1
        assert (o.float() - o_ref.float()).abs().max().item() <= O_TOL
        assert (lse - lse_ref).abs().max().item() <= LSE_TOL

    @pytest.mark.parametrize("dtype,dim,sk", [
        (torch.float32, 128, 64),    # not bf16
        (torch.bfloat16, 64, 64),    # head_dim not 128
        (torch.bfloat16, 128, 96),   # causal rectangle
    ])
    def test_refuses_what_it_does_not_take(self, cuda, dtype, dim, sk):
        q = torch.zeros(1, 64, 2, dim, device=cuda, dtype=dtype)
        k = torch.zeros(1, sk, 2, dim, device=cuda, dtype=dtype)
        with pytest.raises(ValueError):
            tattn.flash_attention_fwd(q, k, k, True)

    def test_grad_raises(self, cuda):
        # Once refused, the gradient now runs through the backward kernel:
        # one K1 and one K2 launch, and dq/dk/dv match the dense autograd.
        from nos_tpu_torch.parallel.ring import dense_attention

        gen = torch.Generator(device=cuda).manual_seed(3)
        q, k, v = (_bf16(gen, 1, 64, 2, 128, device=cuda).requires_grad_()
                   for _ in range(3))
        do = _bf16(gen, 1, 64, 2, 128, device=cuda)
        fwd, bwd = tattn.FLASH_FWD_LAUNCHES, tattn.FLASH_BWD_FUSED_LAUNCHES
        prev = tattn.set_backward_impl("fused")
        try:
            grads = torch.autograd.grad(
                tattn.flash_attention(q, k, v, True), (q, k, v), do)
        finally:
            tattn.set_backward_impl(prev)
        assert tattn.FLASH_FWD_LAUNCHES == fwd + 1
        assert tattn.FLASH_BWD_FUSED_LAUNCHES == bwd + 1
        want = torch.autograd.grad(
            dense_attention(*(x.float() for x in (q, k, v)), causal=True),
            (q, k, v), do.float())
        for got, ref in zip(grads, want):
            assert got.dtype == torch.bfloat16
            assert _rel_err(got, ref) <= GRAD_TOL

    @pytest.mark.parametrize("v_start", [256, 64])
    def test_strided_views(self, cuda, v_start):
        # q/k/v as views into wider rows: the kernel reads through strides;
        # v_start 64 puts v's rows 128 bytes into the wider row
        gen = torch.Generator(device=cuda).manual_seed(1)
        wide = torch.randn(2, 70, 3, 384, generator=gen, device=cuda,
                           dtype=torch.bfloat16)
        q, k = wide[..., :128], wide[..., 128:256]
        v = wide[..., v_start:v_start + 128]
        o, lse = tattn.flash_attention_fwd(q, k, v, True)
        o_ref, lse_ref = tattn.flash_attention_fwd_reference(q, k, v, True)
        assert (o.float() - o_ref.float()).abs().max().item() <= O_TOL
        assert (lse - lse_ref).abs().max().item() <= LSE_TOL

    def test_noncausal_rectangle(self, cuda):
        gen = torch.Generator(device=cuda).manual_seed(4)
        q = _bf16(gen, 2, 100, 4, 128, device=cuda)
        k, v = (_bf16(gen, 2, 230, 4, 128, device=cuda) for _ in range(2))
        o, lse = tattn.flash_attention_fwd(q, k, v, False)
        o_ref, lse_ref = tattn.flash_attention_fwd_reference(q, k, v, False)
        assert (o.float() - o_ref.float()).abs().max().item() <= O_TOL
        assert (lse - lse_ref).abs().max().item() <= LSE_TOL

    @pytest.mark.parametrize("batch,heads,seq", GRIDS)
    def test_grid_sizes(self, cuda, batch, heads, seq):
        gen = torch.Generator(device=cuda).manual_seed(5)
        q, k, v = (_bf16(gen, batch, seq, heads, 128, device=cuda)
                   for _ in range(3))
        o, lse = tattn.flash_attention_fwd(q, k, v, True)
        o_ref, lse_ref = tattn.flash_attention_fwd_reference(q, k, v, True)
        assert (o.float() - o_ref.float()).abs().max().item() <= O_TOL
        assert (lse - lse_ref).abs().max().item() <= LSE_TOL

    def test_model_flash_matches_dense(self, cuda):
        from nos_tpu_torch.models.llama import TINY, Llama, init_params

        cfg = dataclasses.replace(
            TINY, hidden_size=256, num_heads=2, num_kv_heads=1, head_dim=128,
            dtype=torch.bfloat16, param_dtype=torch.bfloat16,
            attn_impl="flash")
        flash = Llama(cfg, device=cuda)
        flash.load_state_dict(init_params(
            cfg, torch.Generator(device=cuda).manual_seed(0), cuda),
            assign=True)
        dense = Llama(dataclasses.replace(cfg, attn_impl="dense"), device=cuda)
        dense.load_state_dict(flash.state_dict(), assign=True)
        tokens = torch.randint(0, cfg.vocab_size, (2, 100), device=cuda,
                               generator=torch.Generator(device=cuda).manual_seed(1))
        before = tattn.FLASH_FWD_LAUNCHES
        with torch.no_grad():
            a, b = flash(tokens), dense(tokens)
        assert tattn.FLASH_FWD_LAUNCHES == before + cfg.num_layers
        # bf16 activations through two layers: a few bf16 ulps of |logits|
        assert (a - b).abs().max().item() <= 3e-2


@pytest.mark.cuda
class TestBackwardKernelsOnCard:
    """K2 (fused), K3 (dq) and K4 (dk/dv) against their plain versions."""

    @pytest.mark.parametrize("kind", sorted(_KERNELS))
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("seq", SEQS)
    def test_matches_plain(self, cuda, kind, causal, seq):
        kernel, plain, counter = _KERNELS[kind]
        args = (*_bwd_inputs(cuda, seq, causal, seed=seq), causal)
        before = getattr(tattn, counter)
        got = kernel(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        assert getattr(tattn, counter) == before + 1
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == torch.bfloat16
            assert torch.isfinite(g).all()
            assert _rel_err(g, w) <= GRAD_TOL

    @pytest.mark.parametrize("kind", sorted(_KERNELS))
    def test_noncausal_rectangle(self, cuda, kind):
        kernel, plain, _ = _KERNELS[kind]
        args = (*_bwd_inputs(cuda, 100, False, seq_k=230), False)
        for g, w in zip(kernel(*args), plain(*args)):
            assert _rel_err(g, w) <= GRAD_TOL

    @pytest.mark.parametrize("kind", sorted(_KERNELS))
    @pytest.mark.parametrize("start", [0, 64])
    def test_strided_views(self, cuda, kind, start):
        # views into wider rows; start 64 puts every row 128 bytes in
        kernel, plain, _ = _KERNELS[kind]
        gen = torch.Generator(device=cuda).manual_seed(2)
        wide = _bf16(gen, 2, 130, 3, 576, device=cuda)
        q, k, v, do = (wide[..., start + i * 128:start + (i + 1) * 128]
                       for i in range(4))
        _, lse = tattn.flash_attention_fwd_reference(q, k, v, True)
        o = tattn.flash_attention_fwd_reference(q, k, v, True)[0]
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, do, lse, delta, True)
        for g, w in zip(kernel(*args), plain(*args)):
            assert _rel_err(g, w) <= GRAD_TOL

    @pytest.mark.parametrize("kind", sorted(_KERNELS))
    @pytest.mark.parametrize("batch,heads,seq", GRIDS)
    def test_grid_sizes(self, cuda, kind, batch, heads, seq):
        kernel, plain, _ = _KERNELS[kind]
        args = (*_bwd_inputs(cuda, seq, True, seed=9, batch=batch,
                             heads=heads), True)
        for g, w in zip(kernel(*args), plain(*args)):
            assert _rel_err(g, w) <= GRAD_TOL

    @pytest.mark.parametrize("kind", ["dq", "dkv"])
    def test_split_repeats_bitwise(self, cuda, kind):
        # No cross-CTA sum: two launches at a several-wave grid agree bit
        # for bit.
        batch, heads, seq = GRIDS[-1]
        kernel, _, _ = _KERNELS[kind]
        args = (*_bwd_inputs(cuda, seq, True, seed=11, batch=batch,
                             heads=heads), True)
        first, second = kernel(*args), kernel(*args)
        torch.cuda.synchronize()
        for a, b in zip(first, second):
            assert torch.equal(a, b)

    @pytest.mark.parametrize("seq,causal", [(512, True), (129, True),
                                            (129, False)])
    def test_fused_matches_split(self, cuda, seq, causal):
        args = (*_bwd_inputs(cuda, seq, causal, seed=7), causal)
        fused = tattn.flash_attention_bwd_fused(*args)
        split = (tattn.flash_attention_dq(*args),
                 *tattn.flash_attention_dkv(*args))
        want = tattn.flash_attention_bwd_fused_reference(*args)
        for f, s, w in zip(fused, split, want):
            assert ((f.float() - s.float()).abs().max()
                    / w.float().abs().max()).item() <= FUSED_SPLIT_TOL

    @pytest.mark.parametrize("kind", sorted(_KERNELS))
    @pytest.mark.parametrize("dtype,dim,sk", [
        (torch.float32, 128, 64),    # not bf16
        (torch.bfloat16, 64, 64),    # head_dim not 128
        (torch.bfloat16, 128, 96),   # causal rectangle
    ])
    def test_refuses_what_it_does_not_take(self, cuda, kind, dtype, dim, sk):
        q = torch.zeros(1, 64, 2, dim, device=cuda, dtype=dtype)
        k = torch.zeros(1, sk, 2, dim, device=cuda, dtype=dtype)
        stat = torch.zeros(1, 2, 64, device=cuda)
        with pytest.raises(ValueError):
            _KERNELS[kind][0](q, k, k, q, stat, stat, True)

    @pytest.mark.parametrize("impl,counters", [
        ("fused", ("FLASH_BWD_FUSED_LAUNCHES",)),
        ("split", ("FLASH_DQ_LAUNCHES", "FLASH_DKV_LAUNCHES")),
    ])
    def test_model_grads_through_kernels(self, cuda, impl, counters):
        # A two-layer bf16 model: the flash loss and gradients against the
        # dense path's, with every layer's backward on the kernels.
        from nos_tpu_torch.models.llama import TINY, Llama, init_params

        cfg = dataclasses.replace(
            TINY, hidden_size=256, num_heads=2, num_kv_heads=1, head_dim=128,
            dtype=torch.bfloat16, attn_impl="flash", remat_policy="rots")
        flash = Llama(cfg, device=cuda)
        flash.load_state_dict(init_params(
            cfg, torch.Generator(device=cuda).manual_seed(0), cuda),
            assign=True)
        dense = Llama(dataclasses.replace(cfg, attn_impl="dense"), device=cuda)
        dense.load_state_dict(
            {n: p.detach().clone() for n, p in flash.state_dict().items()},
            assign=True)
        tokens = torch.randint(0, cfg.vocab_size, (2, 128), device=cuda,
                               generator=torch.Generator(device=cuda).manual_seed(1))
        before = {c: getattr(tattn, c) for c in counters}
        fwd = tattn.FLASH_FWD_LAUNCHES
        prev = tattn.set_backward_impl(impl)
        try:
            loss = flash(tokens, targets=tokens)
            loss.backward()
        finally:
            tattn.set_backward_impl(prev)
        # "rots" keeps the flash op's outputs: no relaunch in backward
        assert tattn.FLASH_FWD_LAUNCHES == fwd + cfg.num_layers
        for c in counters:
            assert getattr(tattn, c) == before[c] + cfg.num_layers
        ref = dense(tokens, targets=tokens)
        ref.backward()
        assert abs(loss.item() - ref.item()) <= 1e-2
        for (name, p), q in zip(flash.named_parameters(), dense.parameters()):
            assert _rel_err(p.grad, q.grad) <= 5e-2, name
