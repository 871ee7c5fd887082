"""Flash attention, forward and backward, the port of
``nos_tpu/ops/attention.py``.

``flash_attention(q, k, v, causal)`` takes [B, S, H, D] tensors with K/V
already at the full head count (see ``repeat_kv``) and returns o in the
same layout.  It is differentiable: the op ``nos_tpu_torch::flash_fwd``
(a ``torch.library`` custom op, so that selective checkpointing can save
its outputs instead of relaunching it) saves (q, k, v, o, lse), and its
backward computes delta = rowsum(dO * O) in PyTorch and calls the fused
backward or the split pair, as the JAX custom VJP does.

Every kernel wrapper takes CUDA tensors to its hand-written Hopper kernel
under ``csrc/`` and CPU tensors to its plain PyTorch version, and raises
for what the kernel does not take (a dtype other than bf16, a head_dim
other than 128, causal with seq_q != seq_k); there is no fallback:

- ``flash_attention_fwd`` -> ``csrc/flash_fwd.cu`` (TPU ``_fwd_kernel``),
  plain ``flash_attention_fwd_reference``;
- ``flash_attention_bwd_fused`` -> ``csrc/flash_bwd.cu``
  (``_fused_bwd_kernel``), plain ``flash_attention_bwd_fused_reference``;
- ``flash_attention_dq`` -> ``nos_flash_dq`` in ``csrc/flash_bwd_split.cu``
  (``_dq_kernel``), plain ``flash_attention_dq_reference``;
- ``flash_attention_dkv`` -> ``nos_flash_dkv`` there (``_dkv_kernel``),
  plain ``flash_attention_dkv_reference``.

The kernels take any sequence length (they mask ragged tiles), so unlike
the TPU op there is no shape-based fallback to dense attention.

Fused or split backward: ``set_backward_impl`` / ``NOS_TPU_FLASH_BWD``
pick the default as in the JAX package, and a shape takes the split pair
when the fused kernel's dq partials would exceed
``FUSED_PARTIAL_BUDGET``.  The fused CUDA kernel keeps no partials (it
adds dq into one fp32 buffer by reductions), so the budget is read with
JAX's formula and JAX's default backward blocks (512/1024, shrunk for
short sequences as ``_plan`` shrinks them), whatever tiles the CUDA
kernels use: the same shapes take the same backward in both packages.

``FLASH_FWD_LAUNCHES``, ``FLASH_BWD_FUSED_LAUNCHES``,
``FLASH_DQ_LAUNCHES`` and ``FLASH_DKV_LAUNCHES`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import logging
import math
import os

import torch

from nos_tpu_torch.ops import _build

_NEG_INF = -1e30
HEAD_DIM = 128

# Kernel launches made by the wrappers on CUDA tensors.
FLASH_FWD_LAUNCHES = 0
FLASH_BWD_FUSED_LAUNCHES = 0
FLASH_DQ_LAUNCHES = 0
FLASH_DKV_LAUNCHES = 0

# The JAX package's default blocks: the forward's, and the backward's,
# which are what FUSED_PARTIAL_BUDGET is read with.
DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 512
DEFAULT_BWD_BLOCK_Q = 512
DEFAULT_BWD_BLOCK_K = 1024
_LANES = 128

# Backward implementation: "fused" (one kernel, dq added by reductions) or
# "split" (the deterministic dq and dk/dv pair).
_BWD_IMPL = os.environ.get("NOS_TPU_FLASH_BWD", "fused")
if _BWD_IMPL not in ("fused", "split"):
    logging.getLogger(__name__).warning(
        "NOS_TPU_FLASH_BWD=%r is not 'fused'/'split'; using 'fused'",
        _BWD_IMPL)
    _BWD_IMPL = "fused"

# Bytes of the JAX fused backward's dq partials ([B*H, Sk/block_k, Sq, D]
# in the array dtype) above which a shape takes the split backward.
FUSED_PARTIAL_BUDGET = 1 << 30

_C_FNS: dict[str, object] = {}
_PTR, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGTYPES = {
    "nos_flash_fwd": [_PTR] * 5 + [_INT] * 4 + [_I64] * 12
                     + [ctypes.c_float, _INT, _PTR],
    "nos_flash_bwd": [_PTR] * 9 + [_INT] * 4 + [_I64] * 12
                     + [ctypes.c_float, _INT, _PTR],
    "nos_flash_dq": [_PTR] * 7 + [_INT] * 4 + [_I64] * 12
                    + [ctypes.c_float, _INT, _PTR],
    "nos_flash_dkv": [_PTR] * 8 + [_INT] * 4 + [_I64] * 12
                     + [ctypes.c_float, _INT, _PTR],
}
_SOURCES = {"nos_flash_fwd": "flash_fwd", "nos_flash_bwd": "flash_bwd",
            "nos_flash_dq": "flash_bwd_split",
            "nos_flash_dkv": "flash_bwd_split"}


def set_backward_impl(impl: str) -> str:
    """Select the flash backward ("fused"/"split"); returns the previous
    value.  Read at each backward."""
    global _BWD_IMPL
    if impl not in ("fused", "split"):
        raise ValueError(f"unknown flash backward impl {impl!r}")
    prev, _BWD_IMPL = _BWD_IMPL, impl
    return prev


def _causal_bias(sq: int, sk: int, device: torch.device) -> torch.Tensor:
    mask = torch.ones(sq, sk, dtype=torch.bool, device=device).tril(sk - sq)
    return torch.where(mask, 0.0, _NEG_INF)


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """fp32 scores [B, H, Sq, Sk] times D^-1/2 with the additive -1e30
    causal mask (bottom-right aligned, which for seq_q == seq_k is the
    kernels' diagonal)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * q.shape[-1] ** -0.5
    if causal:
        s = s + _causal_bias(s.shape[-2], s.shape[-1], s.device)
    return s


def flash_attention_fwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, causal: bool = True
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel, [B, S, H, D] in;
    o [B, Sq, H, D] in q's dtype and lse [B, H, Sq] fp32 out.

    The kernel's numerics in one pass instead of online: fp32 scores
    times D^-1/2, an additive -1e30 causal mask, p rounded to v's dtype
    before P.V with fp32 accumulation, o = acc / max(l, 1e-20) and
    lse = m + log(max(l, 1e-20))."""
    s = _scores(q, k, causal)
    m = s.amax(dim=-1, keepdim=True)                      # [B, H, Sq, 1]
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = (acc / l.transpose(1, 2)).to(q.dtype)
    lse = (m + torch.log(l)).squeeze(-1)
    return o, lse


def _bwd_terms(q, k, v, do, lse, delta, causal):
    """(p, ds) of the backward kernels: p = exp(s - lse) in fp32 and
    ds = p * (dO.V^T - delta), rounded to q's dtype and held in fp32."""
    p = torch.exp(_scores(q, k, causal) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    return p, ds


def _dq_from(ds, k, dtype):
    return (k.shape[-1] ** -0.5 * torch.einsum(
        "bhqk,bkhd->bqhd", ds, k.float())).to(dtype)


def _dkv_from(p, ds, q, do, k_dtype, v_dtype):
    dk = (q.shape[-1] ** -0.5 * torch.einsum(
        "bhqk,bqhd->bkhd", ds, q.float())).to(k_dtype)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(),
                      do.float()).to(v_dtype)
    return dk, dv


def flash_attention_dq_reference(q, k, v, do, lse, delta, causal=True):
    """Plain PyTorch version of the dq kernel: [B, S, H, D] q/k/v/dO,
    lse and delta [B, H, Sq] fp32 -> dq [B, Sq, H, D] in q's dtype.
    dq = D^-1/2 * (ds . k) with fp32 accumulation, ds rounded first."""
    _, ds = _bwd_terms(q, k, v, do, lse, delta, causal)
    return _dq_from(ds, k, q.dtype)


def flash_attention_dkv_reference(q, k, v, do, lse, delta, causal=True):
    """Plain PyTorch version of the dk/dv kernel: (dk, dv) [B, Sk, H, D].
    dk = D^-1/2 * (ds^T . q), dv = p^T . dO with p rounded to dO's dtype;
    fp32 accumulation."""
    p, ds = _bwd_terms(q, k, v, do, lse, delta, causal)
    return _dkv_from(p, ds, q, do, k.dtype, v.dtype)


def flash_attention_bwd_fused_reference(q, k, v, do, lse, delta,
                                        causal=True):
    """Plain PyTorch version of the fused backward kernel: (dq, dk, dv).
    What the kernel computes: dq summed over every key in fp32 and
    rounded once (the TPU kernel rounds a partial per k block instead)."""
    p, ds = _bwd_terms(q, k, v, do, lse, delta, causal)
    return (_dq_from(ds, k, q.dtype),
            *_dkv_from(p, ds, q, do, k.dtype, v.dtype))


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes [B, S, H, D] tensors")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    b, _, h, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(
            f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on batch, "
            f"heads or head_dim (repeat grouped KV heads first: repeat_kv)")


def _device_type(*tensors: torch.Tensor) -> str:
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"} or devices == {"cuda"}:
        return devices.pop()
    raise ValueError(f"flash attention inputs must all be on the CPU or all "
                     f"on CUDA, got {sorted(devices)}")


def _c_fn(name: str):
    fn = _C_FNS.get(name)
    if fn is None:
        fn = getattr(_build.load(_SOURCES[name]), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _C_FNS[name] = fn
    return fn


def _check_kernel_inputs(q, k, v, causal, **extra) -> None:
    """Raise for what the CUDA kernels do not take."""
    named = {"q": q, "k": k, "v": v, **extra}
    if any(t.device != q.device for t in named.values()):
        raise ValueError("flash attention inputs must be on one CUDA device")
    if any(t.dtype != torch.bfloat16 for t in named.values()):
        raise ValueError(
            "the flash kernels take bf16 tensors, got "
            + ", ".join(f"{n} {t.dtype}" for n, t in named.items()))
    batch, seq_q, heads, head_dim = q.shape
    seq_k = k.shape[1]
    if head_dim != HEAD_DIM:
        raise ValueError(f"the flash kernels take head_dim {HEAD_DIM}, got "
                         f"{head_dim}")
    if causal and seq_q != seq_k:
        raise ValueError(
            f"causal flash attention needs seq_q == seq_k, got {seq_q} and "
            f"{seq_k}")
    if min(batch, heads, seq_q, seq_k) == 0:
        raise ValueError(f"empty attention input {tuple(q.shape)}")
    if batch > 65535 or heads > 65535:
        raise ValueError("batch and heads must each be below 65536")
    for name, t in named.items():
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(
                f"{name} must have unit stride over head_dim, strides that "
                f"are multiples of 8 and a 16-byte aligned start, got "
                f"strides {t.stride()}")


def _check_stats(q: torch.Tensor, **stats: torch.Tensor) -> None:
    want = (q.shape[0], q.shape[2], q.shape[1])
    for name, t in stats.items():
        if t.dtype != torch.float32 or tuple(t.shape) != want \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(
                f"{name} must be a contiguous fp32 [B, H, Sq] = {want} "
                f"tensor on {q.device}, got {t.dtype} {tuple(t.shape)}")


def _strides(*tensors: torch.Tensor) -> list[int]:
    return [s for t in tensors for s in t.stride()[:3]]


def _run(name: str, ptrs: list[int], q: torch.Tensor, k: torch.Tensor,
         tail: list[int], causal: bool) -> None:
    fn = _c_fn(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*ptrs, q.shape[0], q.shape[2], q.shape[1], k.shape[1],
                 *tail, q.shape[-1] ** -0.5, int(causal), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _launch_fwd(q, k, v, causal):
    global FLASH_FWD_LAUNCHES
    _check_kernel_inputs(q, k, v, causal)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((q.shape[0], q.shape[2], q.shape[1]),
                      dtype=torch.float32, device=q.device)
    _run("nos_flash_fwd",
         [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
          lse.data_ptr()], q, k, _strides(q, k, v, o), causal)
    FLASH_FWD_LAUNCHES += 1
    return o, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(o [B, Sq, H, D], lse [B, H, Sq] fp32) for [B, S, H, D] q/k/v:
    the Hopper kernel for CUDA tensors, the plain version for CPU ones."""
    _check_shapes(q, k, v)
    if _device_type(q, k, v) == "cpu":
        return flash_attention_fwd_reference(q, k, v, causal)
    return _launch_fwd(q, k, v, causal)


def _bwd_args(q, k, v, do, lse, delta, causal):
    _check_shapes(q, k, v)
    if do.shape != q.shape:
        raise ValueError(f"dO {tuple(do.shape)} must have q's shape "
                         f"{tuple(q.shape)}")
    device = _device_type(q, k, v, do, lse, delta)
    if device == "cuda":
        _check_kernel_inputs(q, k, v, causal, do=do)
        _check_stats(q, lse=lse, delta=delta)
    return device


def flash_attention_bwd_fused(q, k, v, do, lse, delta, causal=True):
    """(dq, dk, dv) [B, S, H, D] from q/k/v/dO and the row statistics
    lse and delta = rowsum(dO * O) [B, H, Sq] fp32: the fused kernel for
    CUDA tensors, the plain version for CPU ones."""
    global FLASH_BWD_FUSED_LAUNCHES
    if _bwd_args(q, k, v, do, lse, delta, causal) == "cpu":
        return flash_attention_bwd_fused_reference(q, k, v, do, lse, delta,
                                                   causal)
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _run("nos_flash_bwd",
         [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
          lse.data_ptr(), delta.data_ptr(), dq_acc.data_ptr(),
          dk.data_ptr(), dv.data_ptr()], q, k, _strides(q, k, v, do), causal)
    FLASH_BWD_FUSED_LAUNCHES += 1
    return dq_acc.to(q.dtype), dk, dv


def flash_attention_dq(q, k, v, do, lse, delta, causal=True):
    """dq [B, Sq, H, D]: the split backward's dq kernel for CUDA tensors,
    the plain version for CPU ones."""
    global FLASH_DQ_LAUNCHES
    if _bwd_args(q, k, v, do, lse, delta, causal) == "cpu":
        return flash_attention_dq_reference(q, k, v, do, lse, delta, causal)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _run("nos_flash_dq",
         [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
          lse.data_ptr(), delta.data_ptr(), dq.data_ptr()], q, k,
         _strides(q, k, v, do), causal)
    FLASH_DQ_LAUNCHES += 1
    return dq


def flash_attention_dkv(q, k, v, do, lse, delta, causal=True):
    """(dk, dv) [B, Sk, H, D]: the split backward's dk/dv kernel for CUDA
    tensors, the plain version for CPU ones."""
    global FLASH_DKV_LAUNCHES
    if _bwd_args(q, k, v, do, lse, delta, causal) == "cpu":
        return flash_attention_dkv_reference(q, k, v, do, lse, delta, causal)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _run("nos_flash_dkv",
         [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
          lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr()],
         q, k, _strides(q, k, v, do), causal)
    FLASH_DKV_LAUNCHES += 1
    return dk, dv


def _plan(seq_q: int, seq_k: int, block_q: int, block_k: int
          ) -> tuple[int, int] | None:
    """The JAX package's ``_plan`` on sequence lengths: the blocks shrunk
    to short sequences, or None where they do not divide them."""
    block_q, block_k = min(block_q, seq_q), min(block_k, seq_k)
    if seq_q % block_q or seq_k % block_k or block_k % _LANES:
        return None
    return block_q, block_k


def backward_impl(q: torch.Tensor, k: torch.Tensor) -> str:
    """"fused" or "split" for these shapes: the selected implementation,
    but split when the JAX fused backward's dq partials
    (B*H * Sk/block_k * Sq * D * itemsize bytes, at JAX's default
    backward blocks, else its forward blocks) would exceed
    FUSED_PARTIAL_BUDGET.  Where neither plan divides the shapes (the JAX
    op would run dense attention), block_k = min(1024, Sk) and the number
    of k blocks is rounded up."""
    batch, seq_q, heads, head_dim = q.shape
    seq_k = k.shape[1]
    plan = (_plan(seq_q, seq_k, DEFAULT_BWD_BLOCK_Q, DEFAULT_BWD_BLOCK_K)
            or _plan(seq_q, seq_k, DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K))
    k_blocks = (seq_k // plan[1] if plan is not None
                else math.ceil(seq_k / min(DEFAULT_BWD_BLOCK_K, seq_k)))
    partial_bytes = (batch * heads * k_blocks * seq_q * head_dim
                     * q.element_size())
    if _BWD_IMPL == "fused" and partial_bytes <= FUSED_PARTIAL_BUDGET:
        return "fused"
    return "split"


def flash_attention_bwd(q, k, v, o, lse, do, causal=True):
    """(dq, dk, dv) of flash attention from the forward's (q, k, v, o,
    lse) and dO: delta = rowsum(dO * O) in fp32, then the fused backward
    or the split pair (``backward_impl``)."""
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    if backward_impl(q, k) == "fused":
        return flash_attention_bwd_fused(q, k, v, do, lse, delta, causal)
    dq = flash_attention_dq(q, k, v, do, lse, delta, causal)
    return (dq, *flash_attention_dkv(q, k, v, do, lse, delta, causal))


@torch.library.custom_op("nos_tpu_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    return flash_attention_fwd(q, k, v, causal)


@_flash_fwd_op.register_fake
def _(q, k, v, causal):
    return (torch.empty_like(q),
            q.new_empty((q.shape[0], q.shape[2], q.shape[1]),
                        dtype=torch.float32))


def _flash_setup(ctx, inputs, output):
    q, k, v, causal = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.causal = causal


def _flash_backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                     ctx.causal)
    return dq, dk, dv, None


_flash_fwd_op.register_autograd(_flash_backward, setup_context=_flash_setup)

# The op as selective-checkpoint policies see it.
FLASH_FWD_OP = torch.ops.nos_tpu_torch.flash_fwd.default


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Fused attention, [B, S, H, D] -> o [B, S, H, D]; differentiable
    (the counterpart of the JAX op's custom VJP)."""
    return torch.ops.nos_tpu_torch.flash_fwd(q, k, v, causal)[0]


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """Expand grouped KV heads to the full head count ([B, S, Hkv, D] ->
    [B, S, Hkv*n_rep, D])."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)
