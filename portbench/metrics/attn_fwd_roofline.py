"""Layer: kernels (``ops/attention.py`` -> K1).  The least time of the
flash forward calls in the window (the larger of FLOPs over the bf16
peak and bytes over HBM bandwidth, per call) over the device time of the
kernels launched under the ``nos_tpu_torch::flash_fwd`` op (recomputed
calls included).  A call: FLOPs 2 B Hq S^2 D (causal); bytes q and o at
Hq heads, k and v at Hkv, lse in fp32, each once."""

from portbench import flops
from portbench.metrics import owned

OP = "nos_tpu_torch::flash_fwd"


def MATCH(name: str) -> bool:
    return name == OP


def call_flops(cell) -> float:
    s = cell.spec
    return 2.0 * cell.batch_size * s.num_heads * cell.seq_len ** 2 \
        * s.head_dim


def call_bytes(cell) -> float:
    s, b, n = cell.spec, cell.batch_size, cell.seq_len
    act = 2   # bf16
    return (2 * b * n * s.num_heads * s.head_dim * act
            + 2 * b * n * s.num_kv_heads * s.head_dim * act
            + b * s.num_heads * n * 4)


def roofline(trace, cell, kind, group, flop_count, byte_count):
    peaks = flops.peaks_for(kind)
    acts = owned(trace, group)
    if peaks is None or not acts:
        return None
    calls = len({op for _, op in acts})
    least = calls * max(flop_count / peaks[0], byte_count / peaks[1])
    return 100.0 * least / (sum(a.dur for a, _ in acts) * 1e-6)


def read(trace, cell, kind):
    return roofline(trace, cell, kind, __name__.rsplit(".", 1)[-1],
                    call_flops(cell), call_bytes(cell))
