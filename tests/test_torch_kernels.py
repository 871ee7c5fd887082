"""The port's Hopper kernels against their plain PyTorch versions, on
the card.  Imports torch only, so it runs where JAX is not installed:

    python -m pytest tests/test_torch_kernels.py -m cuda -q

Without a card every test skips with its reason (the kernels have no CPU
mode); the CPU parity of the plain versions is in test_torch_attention.py.
"""

import pytest
import torch

from nos_tpu_torch.ops import attention as tattn

O_TOL = 2e-2      # bf16 o: online vs one-pass rounding of p, bf16 output
LSE_TOL = 1e-3    # fp32 row statistics


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
class TestKernelOnCard:
    """The Hopper kernel against its plain version (run on the card)."""

    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("seq", [1, 64, 200, 512])
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
        q = torch.zeros(1, 64, 2, 128, device=cuda, dtype=torch.bfloat16,
                        requires_grad=True)
        with pytest.raises(NotImplementedError):
            tattn.flash_attention(q, q.detach(), q.detach(), True)

    def test_strided_views(self, cuda):
        # q/k/v as views into wider rows: the kernel reads through strides
        gen = torch.Generator(device=cuda).manual_seed(1)
        wide = torch.randn(2, 70, 3, 384, generator=gen, device=cuda,
                           dtype=torch.bfloat16)
        q, k, v = wide[..., :128], wide[..., 128:256], wide[..., 256:]
        o, lse = tattn.flash_attention_fwd(q, k, v, True)
        o_ref, lse_ref = tattn.flash_attention_fwd_reference(q, k, v, True)
        assert (o.float() - o_ref.float()).abs().max().item() <= O_TOL
        assert (lse - lse_ref).abs().max().item() <= LSE_TOL

    def test_model_flash_matches_dense(self, cuda):
        import dataclasses

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
