"""The yardstick's arithmetic: the card's published peaks and a train
step's model FLOPs.

``PEAKS`` and ``dense_model_flops`` are frozen copies of
``nos_tpu_torch/ops/roofline.py``'s ``_PEAKS`` and
``model_flops_per_step``; ``moe_model_flops`` extends the count to
routed experts.  Model FLOPs give no credit for recompute, for expert
slots no token fills, or for the masked half of causal attention."""

from __future__ import annotations

# (needle, bf16 FLOP/s, HBM bytes/s); more specific needles first.
PEAKS = (
    ("h100 pcie", 756e12, 2.0e12),
    ("h100 nvl", 835e12, 3.9e12),
    ("h200", 989e12, 4.8e12),
    ("h100", 989e12, 3.35e12),      # SXM: "NVIDIA H100 80GB HBM3"
)


def peaks_for(device_name: str) -> tuple[float, float] | None:
    """(bf16 FLOP/s, HBM bytes/s) for a ``torch.cuda.get_device_name``
    string, None for a device not in the table."""
    name = device_name.lower()
    for needle, flops, bandwidth in PEAKS:
        if needle in name:
            return flops, bandwidth
    return None


def _attention_params(spec) -> int:
    e, hd = spec.hidden_size, spec.head_dim
    return (e * spec.num_heads * hd + 2 * e * spec.num_kv_heads * hd
            + spec.num_heads * hd * e)


def _causal_attention(spec, batch: int, seq: int) -> float:
    # QK^T and PV: 2 matmuls x 2 FLOPs x B*H*S^2*D, causal halves it,
    # backward doubles it (fwd 1x + bwd 2x = 3x).
    return 3 * spec.num_layers * 2 * batch * spec.num_heads * seq * seq \
        * spec.head_dim


def dense_model_flops(spec, batch: int, seq: int) -> float:
    """Analytic dense train-step FLOPs (fwd+bwd, no remat credit): 6*T per
    matmul param + causal attention matmuls."""
    per_layer_mm = (_attention_params(spec)
                    + 3 * spec.hidden_size * spec.intermediate_size)
    n_mm = spec.num_layers * per_layer_mm + spec.vocab_size * spec.hidden_size
    return float(6 * n_mm * batch * seq + _causal_attention(spec, batch, seq))


def moe_model_flops(spec, batch: int, seq: int) -> float:
    """The same for routed experts: each token's top_k experts' SwiGLU
    products and the router beside attention and the tied head."""
    per_layer_mm = (_attention_params(spec)
                    + spec.top_k * 3 * spec.hidden_size
                    * spec.intermediate_size
                    + spec.num_experts * spec.hidden_size)
    n_mm = spec.num_layers * per_layer_mm + spec.vocab_size * spec.hidden_size
    return float(6 * n_mm * batch * seq + _causal_attention(spec, batch, seq))


def model_flops(spec, batch: int, seq: int) -> float:
    if spec.family == "moe":
        return moe_model_flops(spec, batch, seq)
    return dense_model_flops(spec, batch, seq)
