"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero with no result:

1. env: the card (nvidia-smi name and power limit), torch and CUDA
   versions; TF32 is switched off for fp32 matmuls and convolutions.
2. build: nvcc builds every kernel in nos_tpu_torch/ops/csrc/ (all
   sources at once) into nos_tpu_torch/_kernels/, and reports each
   kernel's ptxas registers and spill bytes.
3. kernels: each kernel's wrapper against its plain PyTorch version on
   the card, with the stated tolerances: the forward (K1) at the serving
   shape, and the fused backward (K2), the dq kernel (K3) and the dk/dv
   kernel (K4) at the training shape, at S 127, 128, 129 and 200 causal
   and not (the edges of the 64- and 128-row tiles), and on strided
   views.  Kernel, plain and library times (CUDA events, median
   of several samples of back-to-back launches) at the serving shape for
   K1 and at the training shape for all four, and each bound from the
   card's published peaks (nos_tpu_torch.ops.roofline).
4. serve: BENCH_350M at full width and depth (24 layers), bf16
   parameters from a seed, flash attention, through ``generate`` for 8
   requests: 448 prompt tokens and 64 greedy steps each.  The launch
   counts are zeroed just before the run and read just after it.  Then
   one forward on the same buffer with the plain (dense) attention,
   compared with the kernel path's logits, and one with a deliberately
   wrong (non-causal) dense attention, which the same limit must fail.
5. train: BENCH_350M_TRAIN at full width and depth (24 layers, fp32
   parameters from seed 0, flash attention, "rots" remat) through
   ``Trainer.train_step`` on the synthetic 8 x 2048 batches: 2 untimed
   and 10 timed steps under the fused backward, then one under the
   split backward, with the launch counts zeroed just before and read
   just after, and per step.  It checks the launches per step, the first
   loss against its expected value and every loss for finiteness; that
   two loss-and-gradient passes from one state repeat (bitwise under the
   split backward, within a limit under the fused one); and, at a cut
   depth of 4 layers, that the flash path's loss and gradients agree
   with the dense path's and the fused backward's with the split one's.

Then the kernel summary line, the card's ``name, power.limit`` and, last,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from typing import NoReturn

import torch

O_TOL = 2e-2       # bf16 o: a few bf16 ulps of |o| <= ~1
LSE_TOL = 1e-3     # fp32 row statistics
# dq, dk and dv: within 2e-2 of the reference's max |value| (the JAX
# package's rule for its backward kernels, tests/test_compute.py), and
# the fused backward within 3e-2 of the split one.
GRAD_TOL = 2e-2
FUSED_SPLIT_TOL = 3e-2
# Flash vs dense logits: both paths round to bf16 at every layer, in a
# different order, through 24 layers.  |logit| averages ~0.5 (std 0.02 x
# sqrt(1024) from the tied embedding after the final norm).  The serve
# phase prints that average and the reading of a non-causal attention,
# and fails if the latter is within this limit.
LOGITS_TOL = 0.1


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> NoReturn:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def time_ms(fn, inner: int = 10, samples: int = 25) -> float:
    """Median device ms per call.  A sleep kernel holds the stream while
    the host queues each sample, so the events bracket device work and
    not the host's launch overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(samples):
        torch.cuda._sleep(5_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def phase_env() -> str:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "env", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(),
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})
    return smi


# name -> (source, kernel function, design).
KERNELS = {
    "flash_fwd": ("flash_fwd", "flash_fwd_kernel", "wgmma+tma"),
    "flash_bwd_fused": ("flash_bwd", "flash_bwd_kernel", "wgmma+tma"),
    "flash_dq": ("flash_bwd_split", "flash_dq_kernel", "mma.sync"),
    "flash_dkv": ("flash_bwd_split", "flash_bwd_kv_kernel", "mma.sync"),
}


def phase_build() -> dict[str, dict]:
    """Build every source; per kernel of KERNELS, ptxas's registers and
    spill bytes (None where the library came from the cache)."""
    from nos_tpu_torch.ops import _build

    t0 = time.perf_counter()
    report = _build.build()
    resources = {}
    for name, (source, function, _) in KERNELS.items():
        found = [r for fn, r in _build.ptxas_resources(
            report[source]["ptxas"]).items() if function in fn]
        resources[name] = found[0] if len(found) == 1 else {
            "registers": None, "spill_stores": None, "spill_loads": None}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": report, "resources": resources})
    return resources


def _qkv(gen, b, s, h, d=128):
    return [torch.randn(b, s, h, d, generator=gen, device="cuda",
                        dtype=torch.bfloat16) for _ in range(3)]


def _errors(q, k, v, causal):
    from nos_tpu_torch.ops import attention as A

    o, lse = A.flash_attention_fwd(q, k, v, causal)
    o_ref, lse_ref = A.flash_attention_fwd_reference(q, k, v, causal)
    torch.cuda.synchronize()
    if o.shape != o_ref.shape or lse.shape != lse_ref.shape:
        fail(f"flash_fwd shapes {tuple(o.shape)}/{tuple(lse.shape)}")
    if not (torch.isfinite(o).all() and torch.isfinite(lse).all()):
        fail("flash_fwd produced non-finite values")
    return ((o.float() - o_ref.float()).abs().max().item(),
            (lse - lse_ref).abs().max().item())


def _bound(flops: float, nbytes: float, peaks) -> dict:
    t_ops = flops / peaks[0] * 1e3
    t_bytes = nbytes / peaks[1] * 1e3
    return {"flops": flops, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want| (floored at 1e-3: where a gradient
    is 0 in exact arithmetic both sides hold only rounding)."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-3)).item()


def _bwd_inputs(gen, b, s, h, causal, views=False):
    """q, k, v, dO (views into one wider tensor when ``views``) and the
    plain forward's lse and delta, so kernel and plain version see the
    same inputs."""
    from nos_tpu_torch.ops import attention as A

    if views:
        wide = torch.randn(b, s, h, 4 * 128, generator=gen, device="cuda",
                           dtype=torch.bfloat16)
        q, k, v, do = (wide[..., i * 128:(i + 1) * 128] for i in range(4))
    else:
        q, k, v = _qkv(gen, b, s, h)
        do = torch.randn(b, s, h, 128, generator=gen, device="cuda",
                         dtype=torch.bfloat16)
    o, lse = A.flash_attention_fwd_reference(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta


def _bwd_kernels():
    """name -> (wrapper, plain version, TPU kernel replaced, source,
    matrix products per block pair, outputs)."""
    from nos_tpu_torch.ops import attention as A

    return {
        "flash_bwd_fused": (
            A.flash_attention_bwd_fused,
            A.flash_attention_bwd_fused_reference,
            "nos_tpu/ops/attention.py:336", "flash_bwd.cu", 5, 3),
        "flash_dq": (
            lambda *a: (A.flash_attention_dq(*a),),
            lambda *a: (A.flash_attention_dq_reference(*a),),
            "nos_tpu/ops/attention.py:267", "flash_bwd_split.cu", 3, 1),
        "flash_dkv": (
            A.flash_attention_dkv, A.flash_attention_dkv_reference,
            "nos_tpu/ops/attention.py:299", "flash_bwd_split.cu", 4, 2),
    }


def _sdpa_ms(q, k, v) -> float:
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    return time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))


def _sdpa_backward_ms(q, k, v, do) -> float:
    """One scaled_dot_product_attention backward at the same shape, timed
    as torch.autograd.grad over a graph retained from one forward."""
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2).contiguous()
    return time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                               retain_graph=True),
                   inner=5, samples=10)


# Sequence lengths around the tile edges (K1: 128 q rows and 128 keys;
# K2: 128 keys and 64 q rows; K3, K4: 64 of each), and one ragged length.
EDGE_SEQS = (127, 128, 129, 200)


def _design(name: str, resources: dict) -> dict:
    """The kernel's design and ptxas's registers (at entry, before any
    setmaxnreg) and spill bytes from this run's build."""
    return {"design": KERNELS[name][2],
            "ptxas_registers": resources[name]["registers"],
            "ptxas_spill_bytes": {"stores": resources[name]["spill_stores"],
                                  "loads": resources[name]["spill_loads"]}}


def phase_kernels(resources: dict) -> list[dict]:
    from nos_tpu_torch.ops import attention as A
    from nos_tpu_torch.ops.roofline import peaks_for

    peaks = peaks_for(torch.cuda.get_device_name(0))
    gen = torch.Generator(device="cuda").manual_seed(0)

    # K1, the forward: the serving shape, ragged and strided cases.
    checks = []
    b, s, h, d = 8, 512, 8, 128          # the serving shape
    q, k, v = _qkv(gen, b, s, h, d)
    cases = [("serving B8 S512 H8 causal", (q, k, v), True)]
    for seq in EDGE_SEQS:
        for causal in (True, False):
            cases.append((f"ragged B2 S{seq} H4 causal={causal}",
                          tuple(_qkv(gen, 2, seq, 4)), causal))
    # strided: q/k/v are views into wider rows (row stride 2*H*D)
    wide = torch.randn(2, 130, 4, 256, generator=gen, device="cuda",
                       dtype=torch.bfloat16)
    cases.append(("strided B2 S130 H4 causal=True",
                  (wide[..., :128], wide[..., 128:], wide[..., 64:192]), True))
    for name, (cq, ck, cv), causal in cases:
        o_err, lse_err = _errors(cq, ck, cv, causal)
        checks.append({"kernel": "flash_fwd", "case": name,
                       "o_max_abs_err": o_err, "lse_max_abs_err": lse_err})
        if not (o_err <= O_TOL and lse_err <= LSE_TOL):
            fail(f"flash_fwd vs plain at {name}: o {o_err} (tol {O_TOL}), "
                 f"lse {lse_err} (tol {LSE_TOL})")

    serving = {
        "ms": time_ms(lambda: A.flash_attention_fwd(q, k, v, True)),
        "plain_ms": time_ms(
            lambda: A.flash_attention_fwd_reference(q, k, v, True)),
        "library_ms": _sdpa_ms(q, k, v),
        **_bound(2 * b * h * s * s * d,          # causal: half of 4*BHS^2D
                 4 * b * s * h * d * 2 + b * h * s * 4, peaks)}
    del q, k, v

    # The training shape: K1 and the three backward kernels.
    b, s, h = 8, 2048, 8
    bhs2d = b * h * s * s * d                   # one causal S x S x D product
    act = b * s * h * d * 2                     # one bf16 [B, S, H, D]
    stat = b * h * s * 4                        # one fp32 [B, H, S]
    tq, tk, tv, tdo, tlse, tdelta = _bwd_inputs(gen, b, s, h, True)
    train_fwd = {
        "ms": time_ms(lambda: A.flash_attention_fwd(tq, tk, tv, True)),
        "plain_ms": time_ms(
            lambda: A.flash_attention_fwd_reference(tq, tk, tv, True),
            inner=2, samples=5),
        "library_ms": _sdpa_ms(tq, tk, tv),
        **_bound(2 * bhs2d, 4 * act + stat, peaks)}
    o_err, lse_err = _errors(tq, tk, tv, True)
    checks.append({"kernel": "flash_fwd", "case": "training B8 S2048 H8 "
                   "causal", "o_max_abs_err": o_err,
                   "lse_max_abs_err": lse_err})
    if not (o_err <= O_TOL and lse_err <= LSE_TOL):
        fail(f"flash_fwd vs plain at the training shape: o {o_err}, "
             f"lse {lse_err}")

    bwd_cases = [("training B8 S2048 H8 causal",
                  (tq, tk, tv, tdo, tlse, tdelta), True)]
    for seq in EDGE_SEQS:
        for causal in (True, False):
            bwd_cases.append((f"ragged B2 S{seq} H4 causal={causal}",
                              _bwd_inputs(gen, 2, seq, 4, causal), causal))
    bwd_cases.append(("strided B2 S130 H3 causal=True",
                      _bwd_inputs(gen, 2, 130, 3, True, views=True), True))
    kernels = _bwd_kernels()
    errs = {name: 0.0 for name in kernels}
    outputs = {}
    for case, args, causal in bwd_cases:
        for name, (fn, plain, *_rest) in kernels.items():
            got = fn(*args, causal)
            want = plain(*args, causal)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                if g.shape != w.shape or not torch.isfinite(g).all():
                    fail(f"{name} at {case}: shape {tuple(g.shape)} or "
                         f"non-finite values")
            err = max(_rel_err(g, w) for g, w in zip(got, want))
            checks.append({"kernel": name, "case": case,
                           "max_rel_err": err})
            if not err <= GRAD_TOL:
                fail(f"{name} vs plain at {case}: {err} of max |ref| "
                     f"(tol {GRAD_TOL})")
            errs[name] = max(errs[name], err)
            if case.startswith("training"):
                outputs[name] = got
            del got, want
    fused, split = outputs["flash_bwd_fused"], (
        *outputs["flash_dq"], *outputs["flash_dkv"])
    fused_vs_split = max(
        ((f.float() - t.float()).abs().max()
         / t.float().abs().max()).item() for f, t in zip(fused, split))
    if not fused_vs_split <= FUSED_SPLIT_TOL:
        fail(f"fused vs split backward at the training shape: "
             f"{fused_vs_split} (tol {FUSED_SPLIT_TOL})")
    del outputs, fused, split

    targs = (tq, tk, tv, tdo, tlse, tdelta, True)
    library_ms = _sdpa_backward_ms(tq, tk, tv, tdo)
    entries = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "nos_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "nos_tpu/ops/attention.py:171",
        "launches": None, **_design("flash_fwd", resources),
        "max_abs_err": max(c["o_max_abs_err"] for c in checks
                           if c["kernel"] == "flash_fwd"),
        "lse_max_abs_err": max(c["lse_max_abs_err"] for c in checks
                               if c["kernel"] == "flash_fwd"),
        **{key: serving[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "shape": "serving B8 S512 H8 causal",
        "train_shape": {key: train_fwd[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    }]
    for name, (fn, plain, replaces, source, mats, outs) in kernels.items():
        bound = _bound(mats * bhs2d, (4 + outs) * act + 2 * stat, peaks)
        entries.append({
            "name": name, "route": "cuda",
            "source": f"nos_tpu_torch/ops/csrc/{source}",
            "replaces": replaces, "launches": None,
            **_design(name, resources),
            "max_abs_err": errs[name],
            "error_measure": "max |kernel - plain| / max |plain|",
            "ms": time_ms(lambda: fn(*targs), inner=5, samples=10),
            "plain_ms": time_ms(lambda: plain(*targs), inner=1, samples=3),
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "library_ms": library_ms,
            "library": "SDPA backward (dq, dk and dv), torch.autograd.grad "
                       "on a retained graph",
            "shape": "training B8 S2048 H8 causal"})
    emit({"phase": "kernels", "checks": checks,
          "tolerance": {"o": O_TOL, "lse": LSE_TOL, "grad": GRAD_TOL,
                        "fused_vs_split": FUSED_SPLIT_TOL},
          "fused_vs_split_rel": fused_vs_split,
          "serving_flash_fwd": serving, "train_flash_fwd": train_fwd,
          "train_backward": {e["name"]: {key: e[key] for key in (
              "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
              for e in entries[1:]}})
    return entries


def _noncausal_logits(dense, tokens: torch.Tensor) -> torch.Tensor:
    """Logits of ``dense`` with its attention made non-causal: the wrong
    answer the logits limit must reject."""
    from nos_tpu_torch.models import llama as L

    causal_attention = L.dense_attention
    L.dense_attention = lambda q, k, v, causal: causal_attention(
        q, k, v, causal=False)
    try:
        with torch.no_grad():
            return dense(tokens)
    finally:
        L.dense_attention = causal_attention


def phase_serve() -> dict[str, int]:
    from nos_tpu_torch.entry import (PROMPT_LEN, SERVE_BATCH, STEPS,
                                     bench_model, serve_prompt)
    from nos_tpu_torch.models.generate import generate
    from nos_tpu_torch.models.llama import Llama

    model = bench_model(device="cuda")
    cfg = model.cfg
    prompt = serve_prompt("cuda")

    _zero_launch_counts()
    out = generate(model, prompt, STEPS)
    torch.cuda.synchronize()
    launches = _launch_counts()
    _check_launches("the serve run", launches, {
        "flash_fwd": STEPS * cfg.num_layers, "flash_bwd_fused": 0,
        "flash_dq": 0, "flash_dkv": 0})
    total = PROMPT_LEN + STEPS
    if tuple(out.shape) != (SERVE_BATCH, total):
        fail(f"generate returned {tuple(out.shape)}")
    if not torch.equal(out[:, :PROMPT_LEN], prompt):
        fail("generate changed the prompt")
    if not ((out >= 0) & (out < cfg.vocab_size)).all():
        fail("generated tokens outside the vocabulary")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    again = generate(model, prompt, STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if not torch.equal(out, again):
        fail("a second generate run gave other tokens")
    peak = torch.cuda.max_memory_allocated()

    dense = Llama(dataclasses.replace(cfg, attn_impl="dense"), device="cuda")
    dense.load_state_dict(model.state_dict(), assign=True)
    with torch.no_grad():
        logits_flash = model(out)
        logits_dense = dense(out)
    torch.cuda.synchronize()
    if not (torch.isfinite(logits_flash).all()
            and torch.isfinite(logits_dense).all()):
        fail("non-finite logits")
    diff = (logits_flash - logits_dense).abs().max().item()
    if diff > LOGITS_TOL:
        fail(f"flash vs dense logits differ by {diff} (tol {LOGITS_TOL})")
    del logits_flash
    wrong_diff = (_noncausal_logits(dense, out)
                  - logits_dense).abs().max().item()
    if not wrong_diff > LOGITS_TOL:
        fail(f"a non-causal attention moves the logits by only {wrong_diff}"
             f", within the limit {LOGITS_TOL}: the check cannot see it")
    emit({"phase": "serve", "model": "BENCH_350M", "layers": cfg.num_layers,
          "param_count": model.param_count(), "batch": SERVE_BATCH,
          "prompt_len": PROMPT_LEN, "steps": STEPS, "launches": launches,
          "ms_per_step": seconds / STEPS * 1e3,
          "tokens_per_s": SERVE_BATCH * STEPS / seconds,
          "peak_mem_bytes": peak,
          "logits_max_abs_diff_vs_dense": diff,
          "logits_max_abs_diff_noncausal": wrong_diff,
          "logits_max_abs": logits_dense.abs().max().item(),
          "logits_mean_abs": logits_dense.abs().mean().item(),
          "logits_tol": LOGITS_TOL})
    return launches


# Step 0's loss on random weights: ln(vocab) plus half the logit
# variance.  After the final norm (scale 1) each activation row has unit
# RMS, so a logit x . e_v with e_v ~ N(0, 0.02^2) has variance
# 1024 * 0.02^2 = 0.41, and E[log sum exp] = ln 32000 + 0.41 / 2 for
# Gaussian logits: 10.58.  The target's own logit has mean 0.
EXPECTED_LOSS0 = math.log(32000) + 1024 * 0.02 ** 2 / 2
LOSS0_TOL = 0.2
# Flash vs dense at 4 layers: bf16 activations, and the kernels round p
# and ds to bf16 where the dense autograd keeps fp32, so the loss agrees
# to ~1e-3 and each gradient to a few bf16 ulps of its largest entry.
CUT_LOSS_TOL = 1e-2
CUT_GRAD_TOL = 5e-2
# Two loss-and-gradient passes from one state on one batch, under each
# backward.  The forward sums in a fixed order, so the losses must repeat
# bitwise, and so must the split pair's gradients (K3 and K4 sum in a
# fixed order).  The fused backward adds dq by fp32 reductions from many
# CTAs whose order may vary, so a dq entry may round to the neighbouring
# bf16 value, and the difference grows through 24 layers of bf16
# backward: two fused passes are two computations that may differ in
# rounding, as flash and dense do, and are held to the same CUT_GRAD_TOL
# of each gradient's largest |value|.  The earlier kernel (scalar atomics)
# read 1.6e-2, at layer 0's q projection, whose gradient is small at init
# (attention near uniform); a race in the kernel would move a gradient by
# O(1).
REPEAT_GRAD_TOL = CUT_GRAD_TOL
CUT_LAYERS = 4
TRAIN_UNTIMED, TRAIN_TIMED = 2, 10


def _launch_counts() -> dict[str, int]:
    from nos_tpu_torch.ops import attention as A

    return {"flash_fwd": A.FLASH_FWD_LAUNCHES,
            "flash_bwd_fused": A.FLASH_BWD_FUSED_LAUNCHES,
            "flash_dq": A.FLASH_DQ_LAUNCHES,
            "flash_dkv": A.FLASH_DKV_LAUNCHES}


def _zero_launch_counts() -> None:
    from nos_tpu_torch.ops import attention as A

    A.FLASH_FWD_LAUNCHES = A.FLASH_BWD_FUSED_LAUNCHES = 0
    A.FLASH_DQ_LAUNCHES = A.FLASH_DKV_LAUNCHES = 0


def _step_counted(trainer, batch) -> tuple[float, dict[str, int]]:
    before = _launch_counts()
    loss = trainer.train_step(batch).item()
    return loss, {k: v - before[k] for k, v in _launch_counts().items()}


def _grads_of(trainer, batch, impl: str) -> tuple[float, dict]:
    from nos_tpu_torch.ops import attention as A

    prev = A.set_backward_impl(impl)
    try:
        loss = trainer.loss_and_grads(batch).item()
    finally:
        A.set_backward_impl(prev)
    return loss, {n: p.grad.detach().clone()
                  for n, p in trainer.model.named_parameters()}


def _worst_grad_err(got: dict, want: dict) -> tuple[float, str]:
    return max((_rel_err(got[n], want[n]), n) for n in want)


def _check_launches(label: str, got: dict, want: dict) -> None:
    if got != want:
        fail(f"{label}: kernel launches {got}, expected {want}")


def phase_train() -> dict[str, int]:
    from nos_tpu_torch.entry import (TRAIN_BATCH, TRAIN_SEQ, bench_trainer,
                                     train_loader)
    from nos_tpu_torch.ops import attention as A
    from nos_tpu_torch.ops.roofline import model_flops_per_step, peaks_for

    trainer = bench_trainer("cuda")
    cfg = trainer.cfg
    layers = cfg.num_layers
    loader = train_loader()
    per_fused = {"flash_fwd": layers, "flash_bwd_fused": layers,
                 "flash_dq": 0, "flash_dkv": 0}
    per_split = {"flash_fwd": layers, "flash_bwd_fused": 0,
                 "flash_dq": layers, "flash_dkv": layers}
    if A.set_backward_impl("fused") != "fused":
        fail("the default flash backward is not the fused one")

    losses, step_launches = [], []
    _zero_launch_counts()
    for i in range(TRAIN_UNTIMED):
        loss, launches = _step_counted(trainer, loader.batch_at(i))
        losses.append(loss)
        step_launches.append(launches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed = []
    # An event between steps: the stream's time from one step's first
    # kernel to the next's, gaps the host leaves included.
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(TRAIN_TIMED + 1)]
    t0 = time.perf_counter()
    marks[0].record()
    for j, i in enumerate(range(TRAIN_UNTIMED, TRAIN_UNTIMED + TRAIN_TIMED)):
        timed.append(trainer.train_step(loader.batch_at(i)))
        marks[j + 1].record()
    torch.cuda.synchronize()
    seconds = (time.perf_counter() - t0) / TRAIN_TIMED
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    peak = torch.cuda.max_memory_allocated()
    losses += [x.item() for x in timed]
    A.set_backward_impl("split")
    try:
        split_loss, split_launches = _step_counted(
            trainer, loader.batch_at(TRAIN_UNTIMED + TRAIN_TIMED))
    finally:
        A.set_backward_impl("fused")
    torch.cuda.synchronize()
    launches = _launch_counts()
    losses.append(split_loss)
    n_fused = TRAIN_UNTIMED + TRAIN_TIMED
    want = {k: n_fused * per_fused[k] + per_split[k] for k in per_fused}
    _check_launches("the train run", launches, want)
    for i, got in enumerate(step_launches):
        _check_launches(f"fused step {i}", got, per_fused)
    _check_launches("the split step", split_launches, per_split)
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite training loss: {losses}")
    if not abs(losses[0] - EXPECTED_LOSS0) <= LOSS0_TOL:
        fail(f"step 0 loss {losses[0]}, expected {EXPECTED_LOSS0} +- "
             f"{LOSS0_TOL}")

    flops = model_flops_per_step(cfg, TRAIN_BATCH, TRAIN_SEQ)
    peak_flops = peaks_for(torch.cuda.get_device_name(0))[0]

    # Two passes from the initial state on batch 0, under each backward.
    trainer.init_state(0)
    repeat = {}
    for impl in ("fused", "split"):
        (loss_a, g_a), (loss_b, g_b) = (
            _grads_of(trainer, loader.batch_at(0), impl) for _ in range(2))
        err, worst_leaf = _worst_grad_err(g_b, g_a)
        repeat[impl] = {
            "losses": [loss_a, loss_b], "max_grad_rel": err,
            "worst_param": worst_leaf,
            "bitwise": all(torch.equal(g_a[n], g_b[n]) for n in g_a)}
        del g_a, g_b
        if loss_a != loss_b:
            fail(f"two {impl} passes from one state: losses {loss_a} and "
                 f"{loss_b} (the forward must repeat bitwise)")
    if not repeat["split"]["bitwise"]:
        fail(f"two split backward passes from one state differ: "
             f"{repeat['split']}")
    if not repeat["fused"]["max_grad_rel"] <= REPEAT_GRAD_TOL:
        fail(f"two fused backward passes from one state differ by "
             f"{repeat['fused']['max_grad_rel']} of a gradient's max "
             f"|value| (tol {REPEAT_GRAD_TOL}) at "
             f"{repeat['fused']['worst_param']}")
    param_count = trainer.model.param_count()
    del trainer

    # The cut depth: flash (fused, split) against dense attention.
    batch = loader.batch_at(0)
    flash = bench_trainer("cuda", num_layers=CUT_LAYERS)
    loss_f, g_f = _grads_of(flash, batch, "fused")
    loss_s, g_s = _grads_of(flash, batch, "split")
    del flash
    dense = bench_trainer("cuda", num_layers=CUT_LAYERS, attn_impl="dense")
    loss_d, g_d = _grads_of(dense, batch, "fused")
    del dense
    flash_vs_dense, worst = _worst_grad_err(g_f, g_d)
    fused_vs_split, worst_fs = _worst_grad_err(g_f, g_s)
    if not (abs(loss_f - loss_d) <= CUT_LOSS_TOL
            and flash_vs_dense <= CUT_GRAD_TOL):
        fail(f"{CUT_LAYERS}-layer flash vs dense: loss {loss_f} vs "
             f"{loss_d}, gradients {flash_vs_dense} at {worst} (tol "
             f"{CUT_LOSS_TOL}, {CUT_GRAD_TOL})")
    if not (abs(loss_f - loss_s) <= CUT_LOSS_TOL
            and fused_vs_split <= FUSED_SPLIT_TOL):
        fail(f"{CUT_LAYERS}-layer fused vs split: loss {loss_f} vs {loss_s}"
             f", gradients {fused_vs_split} at {worst_fs}")

    emit({"phase": "train", "model": "BENCH_350M_TRAIN", "layers": layers,
          "param_count": param_count,
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "remat_policy": cfg.remat_policy,
          "steps": {"untimed": TRAIN_UNTIMED, "timed": TRAIN_TIMED,
                    "split": 1},
          "ms_per_step": seconds * 1e3, "stream_ms_per_step": step_ms,
          "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / seconds,
          "model_flops_per_step": flops, "peak_flops": peak_flops,
          "mfu": flops / seconds / peak_flops,
          "peak_mem_bytes": peak, "losses": losses,
          "expected_loss0": EXPECTED_LOSS0, "loss0_tol": LOSS0_TOL,
          "launches": launches, "launches_per_fused_step": per_fused,
          "launches_split_step": split_launches,
          "repeat": {**repeat, "grad_tol_fused": REPEAT_GRAD_TOL},
          "cut": {"layers": CUT_LAYERS, "loss_flash_fused": loss_f,
                  "loss_flash_split": loss_s, "loss_dense": loss_d,
                  "grad_rel_flash_vs_dense": flash_vs_dense,
                  "worst_param": worst,
                  "grad_rel_fused_vs_split": fused_vs_split,
                  "loss_tol": CUT_LOSS_TOL, "grad_tol": CUT_GRAD_TOL,
                  "fused_vs_split_tol": FUSED_SPLIT_TOL}})
    return launches


def main() -> int:
    if len(sys.argv) > 1:
        fail("chip_smoke.py takes no arguments")
    if not torch.cuda.is_available():
        fail("no CUDA device: the smoke runs on the card only")
    smi = phase_env()
    resources = phase_build()
    entries = phase_kernels(resources)
    serve = phase_serve()
    train = phase_train()
    for entry in entries:
        name = entry["name"]
        entry["launches"] = serve[name] + train[name]
        entry["launches_by_path"] = {"serve": serve[name],
                                     "train": train[name]}
        if not entry["launches"] > 0:
            fail(f"{name} was not launched on the main path")
    emit({"kernels": entries})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
