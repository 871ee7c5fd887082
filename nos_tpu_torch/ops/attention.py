"""Flash attention forward, the port of ``nos_tpu/ops/attention.py``.

``flash_attention(q, k, v, causal)`` takes [B, S, H, D] tensors with K/V
already at the full head count (see ``repeat_kv``) and returns o in the
same layout.  Under it, ``flash_attention_fwd`` returns (o, lse):

- a CUDA tensor goes to the hand-written Hopper kernel
  ``csrc/flash_fwd.cu`` (the port of the TPU kernel ``_fwd_kernel``),
  or the call raises for what the kernel does not take: a dtype other
  than bf16, a head_dim other than 128, causal with seq_q != seq_k;
- a CPU tensor goes to ``flash_attention_fwd_reference``, the plain
  PyTorch version of the same function.

The kernel takes any sequence length (it masks ragged tiles itself), so
unlike the TPU op there is no shape-based fallback to dense attention.
The op is forward-only in this slice: the backward kernels come with
the training path, and a CUDA call that would need a gradient raises.

``FLASH_FWD_LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from nos_tpu_torch.ops import _build

_NEG_INF = -1e30
HEAD_DIM = 128

# Kernel launches made by flash_attention_fwd on CUDA tensors.
FLASH_FWD_LAUNCHES = 0

_C_FN = None


def flash_attention_fwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, causal: bool = True
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel's function, [B, S, H, D] in;
    o [B, Sq, H, D] in q's dtype and lse [B, H, Sq] fp32 out.

    The kernel's numerics in one pass instead of online: fp32 scores
    times D^-1/2, an additive -1e30 causal mask (bottom-right aligned,
    which for seq_q == seq_k is the kernel's diagonal), p rounded to v's
    dtype before P.V with fp32 accumulation, o = acc / max(l, 1e-20) and
    lse = m + log(max(l, 1e-20))."""
    d = q.shape[-1]
    scale = d ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        mask = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril(
            sk - sq)
        s = s + torch.where(mask, 0.0, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)                      # [B, H, Sq, 1]
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = (acc / l.transpose(1, 2)).to(q.dtype)
    lse = (m + torch.log(l)).squeeze(-1)
    return o, lse


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


def _c_fn():
    global _C_FN
    if _C_FN is None:
        fn = _build.load("flash_fwd").nos_flash_fwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_int64] * 12
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _C_FN = fn
    return _C_FN


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    global FLASH_FWD_LAUNCHES
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "the flash attention backward (the TPU kernels _fused_bwd_kernel, "
            "_dq_kernel and _dkv_kernel) is the training slice's work; run "
            "inference under torch.no_grad()")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must be on one CUDA device")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError(
            f"the flash kernel takes bf16 q/k/v, got {q.dtype}/{k.dtype}/"
            f"{v.dtype}")
    batch, seq_q, heads, head_dim = q.shape
    seq_k = k.shape[1]
    if head_dim != HEAD_DIM:
        raise ValueError(f"the flash kernel takes head_dim {HEAD_DIM}, got "
                         f"{head_dim}")
    if causal and seq_q != seq_k:
        raise ValueError(
            f"causal flash attention needs seq_q == seq_k, got {seq_q} and "
            f"{seq_k}")
    if min(batch, heads, seq_q, seq_k) == 0:
        raise ValueError(f"empty attention input {tuple(q.shape)}")
    if batch > 65535 or heads > 65535:
        raise ValueError("batch and heads must each be below 65536")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(
                f"{name} must have unit stride over head_dim, strides that "
                f"are multiples of 8 and a 16-byte aligned start, got "
                f"strides {t.stride()}")
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((batch, heads, seq_q), dtype=torch.float32,
                      device=q.device)
    fn = _c_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), batch, heads, seq_q, seq_k,
                 q.stride(0), q.stride(1), q.stride(2),
                 k.stride(0), k.stride(1), k.stride(2),
                 v.stride(0), v.stride(1), v.stride(2),
                 o.stride(0), o.stride(1), o.stride(2),
                 head_dim ** -0.5, int(causal), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    FLASH_FWD_LAUNCHES += 1
    return o, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(o [B, Sq, H, D], lse [B, H, Sq] fp32) for [B, S, H, D] q/k/v:
    the Hopper kernel for CUDA tensors, the plain version for CPU ones."""
    _check_shapes(q, k, v)
    devices = {q.device.type, k.device.type, v.device.type}
    if devices == {"cpu"}:
        return flash_attention_fwd_reference(q, k, v, causal)
    if devices == {"cuda"}:
        return _launch(q, k, v, causal)
    raise ValueError(f"q, k and v must all be on the CPU or all on CUDA, "
                     f"got {sorted(devices)}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Fused attention, [B, S, H, D] -> o [B, S, H, D]."""
    return flash_attention_fwd(q, k, v, causal)[0]


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """Expand grouped KV heads to the full head count ([B, S, Hkv, D] ->
    [B, S, Hkv*n_rep, D])."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)
