"""The yardstick's counts against hand counts."""

import pytest

from portbench import flops
from portbench.cells import ModelSpec, load_file
from portbench.metrics import attn_bwd_roofline, attn_fwd_roofline
from portbench.tests.conftest import ROOT


def spec(name):
    return ModelSpec.from_file(load_file(ROOT / f"portbench/configs/{name}.json"))


class Cell:
    def __init__(self, spec, b, s):
        self.spec, self.batch_size, self.seq_len = spec, b, s


MISTRAL, MIXTRAL = "mistral-7b-v0.3-8l", "mixtral-8x7b-v0.1-2l"


def test_dense_model_flops_by_hand():
    # 8 layers of q, o (4096 x 4096), k, v (4096 x 1024), three MLP
    # products (4096 x 14336), and the tied head (32768 x 4096)
    n_mm = 8 * (2 * 4096 * 4096 + 2 * 4096 * 1024 + 3 * 4096 * 14336) \
        + 32768 * 4096
    assert n_mm == 1_879_048_192
    attn = 6 * 8 * 4 * 32 * 8192 ** 2 * 128
    assert flops.dense_model_flops(spec(MISTRAL), 4, 8192) == \
        6 * n_mm * 4 * 8192 + attn == 422_212_465_065_984


def test_moe_model_flops_by_hand():
    # per token and layer: attention projections, top-2 of the experts'
    # three products, the router; and the tied head over 32000 rows
    per_layer = (2 * 4096 * 4096 + 2 * 4096 * 1024) \
        + 2 * 3 * 4096 * 14336 + 8 * 4096
    n_mm = 2 * per_layer + 32000 * 4096
    attn = 6 * 2 * 1 * 32 * 8192 ** 2 * 128
    assert flops.moe_model_flops(spec(MIXTRAL), 1, 8192) == \
        6 * n_mm * 8192 + attn
    assert round(flops.moe_model_flops(spec(MIXTRAL), 1, 8192) / 1e13, 2) \
        == 4.85


def test_dense_count_is_the_programs():
    from nos_tpu_torch.models.llama import LlamaConfig
    from nos_tpu_torch.ops import roofline

    s = spec(MISTRAL)
    cfg = LlamaConfig(vocab_size=s.vocab_size, hidden_size=s.hidden_size,
                      intermediate_size=s.intermediate_size,
                      num_layers=s.num_layers, num_heads=s.num_heads,
                      num_kv_heads=s.num_kv_heads, head_dim=s.head_dim)
    assert flops.dense_model_flops(s, 4, 8192) == \
        roofline.model_flops_per_step(cfg, 4, 8192)
    assert flops.PEAKS == roofline._PEAKS


def test_peaks():
    assert flops.peaks_for("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    assert flops.peaks_for("NVIDIA H100 PCIe") == (756e12, 2.0e12)
    assert flops.peaks_for("cpu") is None


@pytest.mark.parametrize("b, s", [(4, 8192), (1, 8192), (1, 32768)])
def test_attention_counts_by_hand(b, s):
    c = Cell(spec(MISTRAL), b, s)
    assert attn_fwd_roofline.call_flops(c) == 2 * b * 32 * s * s * 128
    assert attn_bwd_roofline.call_flops(c) == 5 * b * 32 * s * s * 128
    # q, o at 32 heads and k, v at 8, bf16; lse fp32
    assert attn_fwd_roofline.call_bytes(c) == \
        (2 * 32 + 2 * 8) * b * s * 128 * 2 + 32 * b * s * 4
    # q, o, dO, dq at 32 heads; k, v, dk, dv at 8; lse
    assert attn_bwd_roofline.call_bytes(c) == \
        (4 * 32 + 4 * 8) * b * s * 128 * 2 + 32 * b * s * 4


def test_attention_is_bound_by_operations_at_8k():
    c = Cell(spec(MISTRAL), 4, 8192)
    peak, bw = flops.peaks_for("NVIDIA H100 80GB HBM3")
    assert attn_fwd_roofline.call_flops(c) / peak > \
        attn_fwd_roofline.call_bytes(c) / bw
    # 2.22 ms a forward call at 989 TFLOP/s
    assert abs(attn_fwd_roofline.call_flops(c) / peak - 2.2237e-3) < 1e-6
