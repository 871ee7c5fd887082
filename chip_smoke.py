"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero with no result:

1. env: the card (nvidia-smi name and power limit), torch and CUDA
   versions; TF32 is switched off for fp32 matmuls and convolutions.
2. build: nvcc builds every kernel in nos_tpu_torch/ops/csrc/ (all
   sources at once) into nos_tpu_torch/_kernels/.
3. kernels: each kernel's wrapper against its plain PyTorch version on
   the card, at the serving shape and at ragged and strided shapes, with
   the stated tolerances; kernel, plain and library times at the serving
   shape (CUDA events, median of 25 samples of 10 launches) and the
   bound from the card's published peaks.
4. serve: BENCH_350M at full width and depth (24 layers), bf16
   parameters from a seed, flash attention, through ``generate`` for 8
   requests: 448 prompt tokens and 64 greedy steps each.  The launch
   counts are zeroed just before the run and read just after it.  Then
   one forward on the same buffer with the plain (dense) attention,
   compared with the kernel path's logits, and one with a deliberately
   wrong (non-causal) dense attention, which the same limit must fail.

Then the kernel summary line, the card's ``name, power.limit`` and, last,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from typing import NoReturn

import torch

# Published H100 SXM peaks (NVIDIA data sheet; dense, without sparsity).
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12

O_TOL = 2e-2       # bf16 o: a few bf16 ulps of |o| <= ~1
LSE_TOL = 1e-3     # fp32 row statistics
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


def phase_build() -> None:
    from nos_tpu_torch.ops import _build

    t0 = time.perf_counter()
    report = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": report})


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


def phase_kernels() -> dict:
    from nos_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = []
    b, s, h, d = 8, 512, 8, 128          # the serving shape
    q, k, v = _qkv(gen, b, s, h, d)
    cases = [("serving B8 S512 H8 causal", (q, k, v), True)]
    for causal in (True, False):
        cases.append((f"ragged B2 S200 H4 causal={causal}",
                      tuple(_qkv(gen, 2, 200, 4)), causal))
    # strided: q/k/v are views into wider rows (row stride 2*H*D)
    wide = torch.randn(2, 130, 4, 256, generator=gen, device="cuda",
                       dtype=torch.bfloat16)
    cases.append(("strided B2 S130 H4 causal=True",
                  (wide[..., :128], wide[..., 128:], wide[..., 64:192]), True))
    for name, (cq, ck, cv), causal in cases:
        o_err, lse_err = _errors(cq, ck, cv, causal)
        checks.append({"case": name, "o_max_abs_err": o_err,
                       "lse_max_abs_err": lse_err})
        if not (o_err <= O_TOL and lse_err <= LSE_TOL):
            fail(f"flash_fwd vs plain at {name}: o {o_err} (tol {O_TOL}), "
                 f"lse {lse_err} (tol {LSE_TOL})")

    ms = time_ms(lambda: A.flash_attention_fwd(q, k, v, True))
    plain_ms = time_ms(lambda: A.flash_attention_fwd_reference(q, k, v, True))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    flops = 2 * b * h * s * s * d             # causal: half of 4*B*H*S^2*D
    nbytes = 4 * b * s * h * d * 2 + b * h * s * 4  # q, k, v, o bf16 + lse fp32
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES_PER_S * 1e3
    entry = {
        "name": "flash_fwd", "route": "cuda",
        "source": "nos_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "nos_tpu/ops/attention.py:171",
        "launches": None,
        "max_abs_err": max(c["o_max_abs_err"] for c in checks),
        "lse_max_abs_err": max(c["lse_max_abs_err"] for c in checks),
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
    }
    emit({"phase": "kernels", "checks": checks,
          "tolerance": {"o": O_TOL, "lse": LSE_TOL},
          "serving_shape": {"shape": [b, s, h, d], "flops": flops,
                            "bytes": nbytes, **{k_: entry[k_] for k_ in (
                                "ms", "plain_ms", "library_ms", "bound_ms",
                                "bound_by")}}})
    return entry


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
    from nos_tpu_torch.ops import attention as A

    model = bench_model(device="cuda")
    cfg = model.cfg
    prompt = serve_prompt("cuda")

    A.FLASH_FWD_LAUNCHES = 0
    out = generate(model, prompt, STEPS)
    torch.cuda.synchronize()
    launches = {"flash_fwd": A.FLASH_FWD_LAUNCHES}

    want = STEPS * cfg.num_layers
    if launches["flash_fwd"] != want:
        fail(f"flash_fwd launched {launches['flash_fwd']} times in the "
             f"serve run, expected {want}")
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


def main() -> int:
    if len(sys.argv) > 1:
        fail("chip_smoke.py takes no arguments")
    if not torch.cuda.is_available():
        fail("no CUDA device: the smoke runs on the card only")
    smi = phase_env()
    phase_build()
    flash = phase_kernels()
    launches = phase_serve()
    flash["launches"] = launches["flash_fwd"]
    emit({"kernels": [flash]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
