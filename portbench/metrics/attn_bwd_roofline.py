"""Layer: kernels (the flash backward: K2, or K3 + K4).  The least time
of the backward calls in the window over the device time of every kernel
launched under the flash op's backward node (delta and the casts with
the kernels).  A call: FLOPs 2.5 times the forward's (its five products
against two); bytes q, k, v, o, dO, lse, dq, dk, dv once, k, v, dk and
dv at Hkv heads."""

from portbench.metrics import attn_fwd_roofline as fwd

NODE = "flash_fwd_defaultBackward"


def MATCH(name: str) -> bool:
    return NODE in name


def call_flops(cell) -> float:
    return 2.5 * fwd.call_flops(cell)


def call_bytes(cell) -> float:
    s, b, n = cell.spec, cell.batch_size, cell.seq_len
    act = 2   # bf16
    return (4 * b * n * s.num_heads * s.head_dim * act
            + 4 * b * n * s.num_kv_heads * s.head_dim * act
            + b * s.num_heads * n * 4)


def read(trace, cell, kind):
    return fwd.roofline(trace, cell, kind, __name__.rsplit(".", 1)[-1],
                        call_flops(cell), call_bytes(cell))
