"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero with no result:

1. env: the card (nvidia-smi name and power limit), torch and CUDA
   versions; TF32 is switched off for fp32 matmuls and convolutions.
   device: in a fresh process with no CUDA context,
   ``discover(allow_cuda=False)`` must read the card through NVML
   (source "env", the model nvidia-h100-80gb-hbm3) and leave CUDA
   unstarted; then, with CUDA started, the device rung must report the
   same name, UUID and memory (within DEVICE_MEM_TOL).  The MIG mode is
   printed; on a card in MIG mode NVML's GPU instance profiles and
   possible placements are held against ``topology/known.py``.  Nothing
   is created or destroyed and no MIG mode is changed.
2. build: nvcc builds every kernel in nos_tpu_torch/ops/csrc/ (all
   sources at once) into nos_tpu_torch/_kernels/, and reports each
   compiled tile's ptxas registers and spill bytes.
3. kernels: each kernel's wrapper at every tile it is compiled for
   (``ops.attention.KERNEL_TILES``; TILES below) against its plain
   PyTorch version on the card, with the stated tolerances: the forward
   (K1) at the serving shape, and the fused backward (K2), the dq kernel
   (K3) and the dk/dv kernel (K4) at the training shape, at S 1, 63, 64,
   65, 127, 128, 129 and 200 causal and not (the edges of the 64- and
   128-row tiles), and on strided views; two launches of each tile of K3
   and K4 at the training shape must agree bitwise.  Kernel, plain and
   library times (CUDA events, median of several samples of
   back-to-back launches) of every tile at the serving and the training
   shape, and each bound from the card's published peaks
   (nos_tpu_torch.ops.roofline).  Then a timing-only long-context row,
   B1 S32768 H8 causal, where the split pair is the backward
   ``backward_impl`` picks: every tile of K2, K3, K4 and the SDPA
   backward timed, split held against fused and each tile against the
   default (the plain versions would need 34 GB of fp32 scores there).
   The autotune phase follows: ``autotune.tune_and_record`` at B8 S512
   H8 and B8 S2048 H8 causal into a cache in a temporary directory,
   every candidate's ms, ``lookup`` returning the recorded winners, the
   split backward's candidates searched, and an explicit tile that no
   kernel is compiled for refused by the op and by the C entry point.
   Every later phase sees the committed ``PRETUNED`` table and no
   measured cache, and reports its launches by tile.
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
6. train_main: the training main, ``nos_tpu_torch.cmd.train.train``, on
   BENCH_350M_TRAIN at full width and depth with its defaults (flash,
   "rots", 8 x 2048 synthetic batches from seed 0) through a process
   group of one rank (NCCL) and FSDP2: MAIN_STEPS steps logged each,
   whose step-0 loss must match the train phase's Trainer and which must
   launch 24 K1 + 24 K2 per step; then, under the split backward, 6
   steps straight, 4 steps with a checkpoint at step 4 into a temporary
   directory, and a restart into that directory to step 6, which must
   resume at step 4 and end on the straight run's loss bitwise.  The
   launch counts are zeroed before the first run and read after the
   last.  It reports ms/step, tokens/s and MFU from the main's own log
   records, save and restore times, the checkpoint's bytes and the peak
   device memory, then leaves the process group.
7. moe: the MoE family at BENCH_350M_TRAIN's widths and depth (24
   layers of 8 experts, top-2, capacity 1.25; flash attention, fp32
   parameters, bf16 activations, every block rematerialised) through
   ``make_ep_trainer`` (optax adam(1e-3)) in a one-rank NCCL group
   (ep = 1) on the train phase's 8 x 2048 batches: a forward without
   grad on batch 0 for the step-0 loss terms and each layer's drop rate,
   then MOE_UNTIMED untimed and MOE_TIMED timed steps with the counts zeroed
   just before and read just after (48 K1 + 24 K2 per step: full remat
   replays K1).  It checks every loss for finiteness, that the loss falls
   over the timed steps, the step-0 xent, the launches per step, two
   gradient passes from one state bitwise under the split backward, and,
   at a 2-layer cut on a 2 x 2048 batch, the index dispatch against the
   einsum reference (``moe_mlp_reference``) and flash against dense
   attention, loss and gradients.
8. grant: the training main as a pod runs it, ``python -m
   nos_tpu_torch.cmd.train``, in three fresh processes on train_main's
   configuration (BENCH_350M_TRAIN, 8 x 2048, seed 0, 2 steps), each
   reusing the built kernels (nvcc hidden from it, the kernel directory
   unchanged): (a) the card's UUID and a 24 GB timeshare grant must exit
   0 with the grant verified, train_main's step-0 loss, 24 K1 + 24 K2
   a step and its peak under the installed cap; (b) an 8 GB grant, a cap
   below that peak, must fail with the cap's OutOfMemoryError; (c) a
   UUID of no device on the machine must stop with ConfinementError
   before any step.  Each child's exit code, wall seconds, fraction, cap
   and peak go on the phase's line; its launches stay off the kernels
   line, which counts the in-process paths.
9. partition: the MPS partitioning planner and its loop.  (a)
   ``GeometryPlanner.plan`` on ``testing/fleet.py``'s fleet (32 nodes x
   8 H100 80GB, half full, 200 pending pods, seed 0) on the card
   machine's host, once untimed and PLAN_TIMED times timed on fresh
   snapshots: the plans must be identical, hold no GPU over 80 GB of
   shares, keep every used share, and hash to the digest
   ``testing/fleet.py`` pins (the JAX package's plan, held in the CPU
   tests).  (b) The card's own node (the model and memory discovery
   found, one GPU) in the MPS loop on an in-memory API server, on
   ``time.monotonic`` with batch windows of 0.2 s idle and 2 s timeout:
   the partitioner controller from its factory, the node's chip agent
   (the timeshare plugin and the reporter) and ``testing/bind.py``'s
   binder.  Four pending 24 GB pods are polled through bind, controller
   and agent until three are bound and Running (30 s at most); exactly
   one plan cycle must have run, the ConfigMap must hold one key for
   the node giving GPU 0 three 24 GB replicas, the plugin must
   advertise ``nvidia.com/gpu-24gb: 3``, the node's status plan id must
   equal its spec plan id (the handshake closed), the reporter must show
   GPU 0 ``24gb-used: 3``, and the fourth pod must stay pending and
   Unschedulable.  One rescan interval later the controller's next
   cycle runs on the fourth pod and must write nothing.  Each bound
   pod's grant comes from the node side: the UUID, through discovery,
   of a GPU of the applied config on which the reporter shows a used
   share of the pod's size, and the GB of its request; the smoke hands
   it over, standing in for the kubelet
   plugin's Allocate (ROADMAP item 24b).  Then one ``python -m
   nos_tpu_torch.cmd.train`` child per bound pod, all three at once,
   under its grant with grant's configuration and nvcc hidden: each as
   grant (a) must, and the three step windows (first step's start to
   last step's log line, on the host's clock) must intersect, so that
   the three ran their steps on the card at once.  The three reserved
   peaks together stay under the card's memory, which the per-child
   caps already imply.  Then the three pods are marked Succeeded: the
   reporter must show GPU 0 ``24gb-free: 3``, and the binder must bind
   the fourth pod onto a freed share with no new plan.  The phase's line
   carries the card's ``name, power.limit``, the plan cycles' host ms
   (``nos_tpu_plan_seconds``), the agent's host ms per tick,
   ``nos_tpu_actuation_latency_seconds`` and each pod's wall ms from
   creation to bound; the children's launches go on it, as grant's do.

Then the kernel summary line (one entry per compiled tile, with its
launches by path; a tile no path ran must have run in the autotune
phase), the card's ``name, power.limit`` and, last,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import datetime
import functools
import gc
import json
import logging
import math
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
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


# name -> (source, kernel function, design): one name per compiled tile,
# the default tile's under the kernel's own name.
KERNELS = {
    "flash_fwd": ("flash_fwd", "flash_fwd_kernel", "wgmma+tma"),
    "flash_fwd_64x64": ("flash_fwd", "flash_fwd_kernel", "wgmma+tma"),
    "flash_bwd_fused": ("flash_bwd", "flash_bwd_kernel", "wgmma+tma"),
    "flash_bwd_fused_64x64": ("flash_bwd", "flash_bwd_kernel", "wgmma+tma"),
    "flash_dq": ("flash_bwd_split", "flash_dq_kernel", "wgmma+tma"),
    "flash_dq_64x64": ("flash_bwd_split", "flash_dq_kernel", "wgmma+tma"),
    "flash_dkv": ("flash_bwd_split", "flash_bwd_kernel", "wgmma+tma"),
    "flash_dkv_64x64": ("flash_bwd_split", "flash_bwd_kernel", "wgmma+tma"),
}
# name -> (the wrapper's kernel in ops.attention.KERNEL_TILES, its tile
# (block_q, block_k), the template arguments of the compiled instance as
# ptxas's mangled entry name spells them).
TILES = {
    "flash_fwd": ("flash_fwd", (128, 128), "ILi2ELi128EE"),
    "flash_fwd_64x64": ("flash_fwd", (64, 64), "ILi1ELi64EE"),
    "flash_bwd_fused": ("flash_bwd_fused", (64, 128), "ILb1ELi2ELi2EE"),
    "flash_bwd_fused_64x64": ("flash_bwd_fused", (64, 64),
                              "ILb1ELi2ELi1EE"),
    "flash_dq": ("flash_dq", (128, 64), "ILi2ELi4EE"),
    "flash_dq_64x64": ("flash_dq", (64, 64), "ILi1ELi2EE"),
    "flash_dkv": ("flash_dkv", (64, 128), "ILb0ELi4ELi2EE"),
    "flash_dkv_64x64": ("flash_dkv", (64, 64), "ILb0ELi2ELi1EE"),
}


def phase_build() -> dict[str, dict]:
    """Build every source; per compiled tile of KERNELS, ptxas's
    registers (at entry) and spill bytes (None where the library came
    from the cache)."""
    from nos_tpu_torch.ops import _build

    t0 = time.perf_counter()
    report = _build.build()
    resources = {}
    for name, (source, function, _) in KERNELS.items():
        entry = function + TILES[name][2]
        found = [r for fn, r in _build.ptxas_resources(
            report[source]["ptxas"]).items() if entry in fn]
        resources[name] = found[0] if len(found) == 1 else {
            "registers": None, "spill_stores": None, "spill_loads": None}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": report, "resources": resources})
    return resources


def _qkv(gen, b, s, h, d=128):
    return [torch.randn(b, s, h, d, generator=gen, device="cuda",
                        dtype=torch.bfloat16) for _ in range(3)]


def _errors(q, k, v, causal, tile=None, ref=None):
    """(max |o - plain o|, max |lse - plain lse|) of K1 at ``tile`` (None:
    its default); ``ref`` is the plain version's (o, lse) where the
    caller has it."""
    from nos_tpu_torch.ops import attention as A

    o, lse = A.flash_attention_fwd(q, k, v, causal, tile)
    o_ref, lse_ref = (A.flash_attention_fwd_reference(q, k, v, causal)
                      if ref is None else ref)
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


# Sequence lengths around the tile edges (K1: 128 or 64 q rows and 128 or
# 64 keys; K2 and K4: 128 or 64 keys and 64 q rows; K3: 128 or 64 q rows
# and 64 keys), and one ragged length.
EDGE_SEQS = (1, 63, 64, 65, 127, 128, 129, 200)
# The long-context row: at 8 heads and batch 1 the JAX rule's dq partials
# are 2^31 bytes, past FUSED_PARTIAL_BUDGET, so the split pair runs.
LONG_SHAPE = (1, 32768, 8)


def _design(name: str, resources: dict) -> dict:
    """The kernel's design and ptxas's registers (at entry, before any
    setmaxnreg) and spill bytes from this run's build."""
    return {"design": KERNELS[name][2],
            "ptxas_registers": resources[name]["registers"],
            "ptxas_spill_bytes": {"stores": resources[name]["spill_stores"],
                                  "loads": resources[name]["spill_loads"]}}


def _tiles_of(kernel: str) -> list[tuple[str, tuple[int, int]]]:
    """(name, tile) of every compiled tile of ``kernel``, default first."""
    return [(name, tile) for name, (k, tile, _) in TILES.items()
            if k == kernel]


def phase_kernels(resources: dict) -> list[dict]:
    from nos_tpu_torch.ops import attention as A
    from nos_tpu_torch.ops.roofline import peaks_for

    peaks = peaks_for(torch.cuda.get_device_name(0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    fwd_tiles = _tiles_of("flash_fwd")

    # K1, the forward, at every tile: the serving shape, ragged and
    # strided cases.
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
    for case, (cq, ck, cv), causal in cases:
        ref = A.flash_attention_fwd_reference(cq, ck, cv, causal)
        for name, tile in fwd_tiles:
            o_err, lse_err = _errors(cq, ck, cv, causal, tile, ref)
            checks.append({"kernel": name, "case": case,
                           "o_max_abs_err": o_err, "lse_max_abs_err": lse_err})
            if not (o_err <= O_TOL and lse_err <= LSE_TOL):
                fail(f"{name} vs plain at {case}: o {o_err} (tol {O_TOL}), "
                     f"lse {lse_err} (tol {LSE_TOL})")

    serving_plain = time_ms(
        lambda: A.flash_attention_fwd_reference(q, k, v, True))
    serving_sdpa = _sdpa_ms(q, k, v)
    serving_bound = _bound(2 * b * h * s * s * d,   # causal: half of 4BHS^2D
                           4 * b * s * h * d * 2 + b * h * s * 4, peaks)
    serving = {name: {
        "ms": time_ms(lambda t=tile: A.flash_attention_fwd(q, k, v, True, t)),
        "plain_ms": serving_plain, "library_ms": serving_sdpa,
        **serving_bound} for name, tile in fwd_tiles}
    # the backward kernels at the serving shape, for the tile comparison
    sq, sk, sv, sdo, slse, sdelta = _bwd_inputs(gen, b, s, h, True)
    del q, k, v

    # The training shape: K1 and the three backward kernels.
    b, s, h = 8, 2048, 8
    bhs2d = b * h * s * s * d                   # one causal S x S x D product
    act = b * s * h * d * 2                     # one bf16 [B, S, H, D]
    stat = b * h * s * 4                        # one fp32 [B, H, S]
    tq, tk, tv, tdo, tlse, tdelta = _bwd_inputs(gen, b, s, h, True)
    train_plain = time_ms(
        lambda: A.flash_attention_fwd_reference(tq, tk, tv, True),
        inner=2, samples=5)
    train_sdpa = _sdpa_ms(tq, tk, tv)
    train_bound = _bound(2 * bhs2d, 4 * act + stat, peaks)
    train_fwd = {name: {
        "ms": time_ms(lambda t=tile: A.flash_attention_fwd(
            tq, tk, tv, True, t)),
        "plain_ms": train_plain, "library_ms": train_sdpa,
        **train_bound} for name, tile in fwd_tiles}
    ref = A.flash_attention_fwd_reference(tq, tk, tv, True)
    for name, tile in fwd_tiles:
        o_err, lse_err = _errors(tq, tk, tv, True, tile, ref)
        checks.append({"kernel": name, "case": "training B8 S2048 H8 "
                       "causal", "o_max_abs_err": o_err,
                       "lse_max_abs_err": lse_err})
        if not (o_err <= O_TOL and lse_err <= LSE_TOL):
            fail(f"{name} vs plain at the training shape: o {o_err}, "
                 f"lse {lse_err}")
    del ref

    bwd_cases = [("training B8 S2048 H8 causal",
                  (tq, tk, tv, tdo, tlse, tdelta), True)]
    for seq in EDGE_SEQS:
        for causal in (True, False):
            bwd_cases.append((f"ragged B2 S{seq} H4 causal={causal}",
                              _bwd_inputs(gen, 2, seq, 4, causal), causal))
    bwd_cases.append(("strided B2 S130 H3 causal=True",
                      _bwd_inputs(gen, 2, 130, 3, True, views=True), True))
    kernels = _bwd_kernels()
    errs = {name: 0.0 for name in TILES}
    outputs = {}
    for case, args, causal in bwd_cases:
        for kernel, (fn, plain, *_rest) in kernels.items():
            want = plain(*args, causal)
            for name, tile in _tiles_of(kernel):
                got = fn(*args, causal, tile)
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
                if case.startswith("training") and name == kernel:
                    outputs[name] = got
                del got
            del want
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
    # The split pair writes every output row from one CTA after a loop in
    # a fixed order, at every tile: two launches on the same inputs agree
    # bitwise.
    repeat = {}
    for kernel in ("flash_dq", "flash_dkv"):
        for name, tile in _tiles_of(kernel):
            first = kernels[kernel][0](*targs, tile)
            second = kernels[kernel][0](*targs, tile)
            torch.cuda.synchronize()
            repeat[name] = all(torch.equal(x, y)
                               for x, y in zip(first, second))
            if not repeat[name]:
                fail(f"two {name} launches on the training inputs differ")
            del first, second
    library_ms = _sdpa_backward_ms(tq, tk, tv, tdo)
    serving_library_ms = _sdpa_backward_ms(sq, sk, sv, sdo)
    sargs = (sq, sk, sv, sdo, slse, sdelta, True)
    entries = []
    for name, tile in fwd_tiles:
        entries.append({
            "name": name, "route": "cuda",
            "source": "nos_tpu_torch/ops/csrc/flash_fwd.cu",
            "replaces": "nos_tpu/ops/attention.py:171",
            "tile": list(tile), "launches": None, **_design(name, resources),
            "max_abs_err": max(c["o_max_abs_err"] for c in checks
                               if c["kernel"] == name),
            "lse_max_abs_err": max(c["lse_max_abs_err"] for c in checks
                                   if c["kernel"] == name),
            **serving[name], "shape": "serving B8 S512 H8 causal",
            "train_shape": train_fwd[name]})
    sb, ss, sh = sq.shape[0], sq.shape[1], sq.shape[2]
    for kernel, (fn, plain, replaces, source, mats, outs) in kernels.items():
        bound = _bound(mats * bhs2d, (4 + outs) * act + 2 * stat, peaks)
        sbound = _bound(mats * sb * sh * ss * ss * d,
                        (4 + outs) * sb * ss * sh * d * 2
                        + 2 * sb * sh * ss * 4, peaks)
        plain_ms = time_ms(lambda: plain(*targs), inner=1, samples=3)
        serving_plain_ms = time_ms(lambda: plain(*sargs), inner=2, samples=5)
        for name, tile in _tiles_of(kernel):
            entries.append({
                "name": name, "route": "cuda",
                "source": f"nos_tpu_torch/ops/csrc/{source}",
                "replaces": replaces, "tile": list(tile), "launches": None,
                **_design(name, resources),
                "max_abs_err": errs[name],
                "error_measure": "max |kernel - plain| / max |plain|",
                "ms": time_ms(lambda t=tile: fn(*targs, t), inner=5,
                              samples=10),
                "plain_ms": plain_ms,
                "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
                "library_ms": library_ms,
                "library": "SDPA backward (dq, dk and dv), "
                           "torch.autograd.grad on a retained graph",
                "shape": "training B8 S2048 H8 causal",
                "serving_shape": {
                    "ms": time_ms(lambda t=tile: fn(*sargs, t), inner=5,
                                  samples=10),
                    "plain_ms": serving_plain_ms,
                    "bound_ms": sbound["bound_ms"],
                    "bound_by": sbound["bound_by"],
                    "library_ms": serving_library_ms,
                    "shape": "B8 S512 H8 causal"}})
    del tq, tk, tv, tdo, tlse, tdelta, targs, sq, sk, sv, sdo, sargs
    long_rows = _long_context(gen, peaks, kernels)
    for entry in entries:
        if entry["name"] in long_rows:
            entry["long_context"] = long_rows[entry["name"]]
    emit({"phase": "kernels", "checks": checks,
          "tolerance": {"o": O_TOL, "lse": LSE_TOL, "grad": GRAD_TOL,
                        "fused_vs_split": FUSED_SPLIT_TOL},
          "fused_vs_split_rel": fused_vs_split,
          "split_repeat_bitwise": repeat,
          "serving_flash_fwd": serving, "train_flash_fwd": train_fwd,
          "train_backward": {e["name"]: {key: e[key] for key in (
              "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
              for e in entries if "serving_shape" in e},
          "serving_backward": {e["name"]: e["serving_shape"]
                               for e in entries if "serving_shape" in e}})
    return entries


def _long_context(gen, peaks, kernels) -> dict[str, dict]:
    """K2, K3 and K4 at LONG_SHAPE, causal, at every tile: split against
    fused within FUSED_SPLIT_TOL at the default tiles and each tile's
    outputs against the default's, then kernel and SDPA-backward times
    and each bound.  lse comes from K1 (the plain forward would need the
    fp32 scores)."""
    from nos_tpu_torch.ops import attention as A

    b, s, h = LONG_SHAPE
    d = 128
    q, k, v = _qkv(gen, b, s, h)
    do = torch.randn(b, s, h, d, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    impl = A.backward_impl(q, k)
    if impl != "split":
        fail(f"backward_impl picks {impl!r} at B{b} S{s} H{h}, not 'split'")
    o, lse = A.flash_attention_fwd(q, k, v, True)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    del o
    args = (q, k, v, do, lse, delta, True)
    fused = A.flash_attention_bwd_fused(*args)
    split = (A.flash_attention_dq(*args), *A.flash_attention_dkv(*args))
    torch.cuda.synchronize()
    if not all(torch.isfinite(x).all() for x in (*fused, *split)):
        fail(f"non-finite gradients at B{b} S{s} H{h}")
    fused_vs_split = max(
        ((f.float() - t.float()).abs().max()
         / t.float().abs().max()).item() for f, t in zip(fused, split))
    if not fused_vs_split <= FUSED_SPLIT_TOL:
        fail(f"fused vs split backward at B{b} S{s} H{h}: {fused_vs_split} "
             f"(tol {FUSED_SPLIT_TOL})")
    default_out = {"flash_bwd_fused": fused, "flash_dq": split[:1],
                   "flash_dkv": split[1:]}
    library_ms = _sdpa_backward_ms(q, k, v, do)
    bhs2d = b * h * s * s * d
    act, stat = b * s * h * d * 2, b * h * s * 4
    rows, vs_default = {}, {}
    for kernel, (fn, _plain, _rep, _src, mats, outs) in kernels.items():
        bound = _bound(mats * bhs2d, (4 + outs) * act + 2 * stat, peaks)
        for name, tile in _tiles_of(kernel):
            if name != kernel:
                got = fn(*args, tile)
                torch.cuda.synchronize()
                vs_default[name] = max(_rel_err(g, w) for g, w in zip(
                    got, default_out[kernel]))
                del got
                if not vs_default[name] <= FUSED_SPLIT_TOL:
                    fail(f"{name} against {kernel} at B{b} S{s} H{h}: "
                         f"{vs_default[name]} (tol {FUSED_SPLIT_TOL})")
            rows[name] = {
                "ms": time_ms(lambda t=tile: fn(*args, t), inner=5,
                              samples=10),
                "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
                "library_ms": library_ms,
                "shape": f"B{b} S{s} H{h} causal"}
    del fused, split, default_out
    emit({"phase": "long_context", "shape": f"B{b} S{s} H{h} causal",
          "backward_impl": impl, "fused_vs_split_rel": fused_vs_split,
          "variant_vs_default_rel": vs_default,
          "tolerance": FUSED_SPLIT_TOL, "kernels": rows})
    return rows


# The autotune phase's shapes: serving and training, causal.
AUTOTUNE_SHAPES = ((8, 512, 8), (8, 2048, 8))


def _no_measured_cache(tmp: str) -> None:
    """Point the autotune cache at a file that does not exist, so that
    lookups see the committed PRETUNED table only."""
    import os

    from nos_tpu_torch.ops import autotune as T

    os.environ[T._CACHE_ENV] = str(pathlib.Path(tmp) / "none.json")
    T.reload_cache()
    if T._load_cache():
        fail("a measured autotune cache is visible to the run")


def phase_autotune() -> dict:
    """``tune_and_record`` at AUTOTUNE_SHAPES into a cache in a temporary
    directory, with every candidate's ms; ``lookup`` must return the
    recorded winners, in this process and from the file.  Then the split
    backward's candidates searched at the training shape (not recorded),
    and an explicit pair no kernel is compiled for, which must raise in
    the op and be refused by the C entry point."""
    import os

    from nos_tpu_torch.ops import attention as A
    from nos_tpu_torch.ops import autotune as T

    gen = torch.Generator(device="cuda").manual_seed(3)
    kind = torch.cuda.get_device_name(0)
    results = {}
    _zero_launch_counts()
    with tempfile.TemporaryDirectory(prefix="nos-autotune-") as tmp:
        path = pathlib.Path(tmp) / "flash_autotune.json"
        os.environ[T._CACHE_ENV] = str(path)
        T.reload_cache()
        for b, s, h in AUTOTUNE_SHAPES:
            q, k, v = _qkv(gen, b, s, h)
            res = T.tune_and_record(q, k, v, True)
            for reload in (False, True):
                if reload:
                    T.reload_cache()
                for pass_ in ("fwd", "bwd"):
                    got = T.lookup(kind, pass_, s, 128, "bfloat16", True)
                    if got is None or list(got) != res[pass_]:
                        fail(f"autotune lookup {pass_} at S{s} gave {got}, "
                             f"recorded {res[pass_]} (reloaded: {reload})")
            for pass_ in ("fwd", "bwd"):
                tile = A._tile_for(
                    "flash_fwd" if pass_ == "fwd" else "flash_bwd_fused",
                    q, k, True, None, None)
                if list(tile) != res[pass_]:
                    fail(f"the op resolves {tile} for {pass_} at S{s}, "
                         f"the cache holds {res[pass_]}")
            results[f"B{b} S{s} H{h} causal"] = res
        entries = json.loads(path.read_text())["entries"]
        prev = A.set_backward_impl("split")
        try:
            split_best, split_times = T.search("bwd", q, k, v, True)
        finally:
            A.set_backward_impl(prev)
        refused = {}
        for label, call in (
                ("op forward (32, 32)",
                 lambda: A.flash_attention(q, k, v, True, 32, 32)),
                ("op backward (128, 128)",
                 lambda: A.flash_attention(
                     *(x.detach().requires_grad_() for x in (q, k, v)),
                     True, 128, 128).sum().backward()),
                ("C entry nos_flash_fwd (32, 32)",
                 lambda: A._run("nos_flash_fwd", [
                     q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     o.data_ptr(), lse.data_ptr()], q, k,
                     A._strides(q, k, v, o), True, (32, 32)))):
            o, lse = torch.empty_like(q), torch.empty(
                b, h, s, device="cuda", dtype=torch.float32)
            try:
                call()
            except (ValueError, RuntimeError) as e:
                refused[label] = f"{type(e).__name__}: {e}"
            else:
                fail(f"{label}: an uncompiled tile ran")
        # cudaErrorInvalidValue, not a launch at another tile
        if not refused["C entry nos_flash_fwd (32, 32)"].endswith(
                "CUDA error 1"):
            fail(f"nos_flash_fwd at (32, 32): {refused}")
        torch.cuda.synchronize()
        del q, k, v
    PATH_TILES["autotune"] = _tile_counts()
    out = {"phase": "autotune", "device_class": T.device_class(kind),
           "results": results, "cache_entries": entries,
           "split_search_ms": {f"{bq}x{bk}": t * 1e3
                               for (bq, bk), t in split_times.items()},
           "split_best": list(split_best), "refused": refused,
           "tile_launches": PATH_TILES["autotune"]}
    emit(out)
    return out


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
    PATH_TILES["serve"] = _tile_counts()
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
          "tile_launches": PATH_TILES["serve"],
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
    A.TILE_LAUNCHES.clear()


def _tile_counts() -> dict[str, int]:
    """Launches by compiled tile (the names of TILES)."""
    from nos_tpu_torch.ops import attention as A

    return {name: A.TILE_LAUNCHES[(kernel, tile)]
            for name, (kernel, tile, _) in TILES.items()}


# Each phase's launches by compiled tile, read where it reads its
# launches: which tile each kernel ran on each path.
PATH_TILES: dict[str, dict[str, int]] = {}


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


def phase_train() -> tuple[dict[str, int], float]:
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
    PATH_TILES["train"] = _tile_counts()
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
          "launches": launches, "tile_launches": PATH_TILES["train"],
          "launches_per_fused_step": per_fused,
          "launches_split_step": split_launches,
          "repeat": {**repeat, "grad_tol_fused": REPEAT_GRAD_TOL},
          "cut": {"layers": CUT_LAYERS, "loss_flash_fused": loss_f,
                  "loss_flash_split": loss_s, "loss_dense": loss_d,
                  "grad_rel_flash_vs_dense": flash_vs_dense,
                  "worst_param": worst,
                  "grad_rel_fused_vs_split": fused_vs_split,
                  "loss_tol": CUT_LOSS_TOL, "grad_tol": CUT_GRAD_TOL,
                  "fused_vs_split_tol": FUSED_SPLIT_TOL}})
    return launches, losses[0]


# The main's steps, logged each; then the resume runs under the split
# backward: straight to RESUME_STEPS, and to RESUME_AT with a checkpoint
# there, then restarted to RESUME_STEPS.
MAIN_STEPS = 6
RESUME_STEPS, RESUME_AT = 6, 4
# The main's step-0 loss against the Trainer's on the same seed and
# batch: the same parameter draws and the same products (FSDP2 over one
# rank gathers and reduces by copies), so they agree to rounding.
MAIN_LOSS0_RTOL = 1e-4


class _Records(logging.Handler):
    """The structured fields (``extra=``) of the port's log records."""

    FIELDS = ("train_step", "train_loss", "tokens_per_s", "mfu",
              "start_step", "checkpoint_step", "checkpoint_save_s",
              "checkpoint_restore_s")

    def __init__(self) -> None:
        super().__init__(logging.INFO)
        self.records: list[dict] = []

    def emit(self, record: logging.LogRecord) -> None:
        fields = {k: getattr(record, k) for k in self.FIELDS
                  if hasattr(record, k)}
        if fields:
            self.records.append(fields)

    def take(self, key: str) -> list:
        out = [r for r in self.records if key in r]
        self.records = [r for r in self.records if key not in r]
        return out


def _bytes_under(path: pathlib.Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def _release() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def phase_train_main(trainer_loss0: float) -> dict[str, int]:
    import torch.distributed as dist

    from nos_tpu_torch.cmd.train import TrainConfig, train
    from nos_tpu_torch.entry import TRAIN_BATCH, TRAIN_SEQ
    from nos_tpu_torch.models.llama import BENCH_350M_TRAIN
    from nos_tpu_torch.ops import attention as A

    layers = BENCH_350M_TRAIN.num_layers
    port_log = logging.getLogger("nos_tpu_torch")
    port_log.setLevel(logging.INFO)
    records = _Records()
    port_log.addHandler(records)
    if A.set_backward_impl("fused") != "fused":
        fail("the default flash backward is not the fused one")

    def cfg(**kw) -> TrainConfig:
        c = TrainConfig(model="bench350m", log_every=1, **kw)
        c.validate()
        return c

    _release()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    main_loss = train(cfg(steps=MAIN_STEPS))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    main_launches = _launch_counts()
    if not (dist.is_initialized() and dist.get_world_size() == 1
            and dist.get_backend() == "nccl"):
        fail("the main did not run in a one-rank NCCL group")
    _check_launches("the main's run", main_launches, {
        "flash_fwd": MAIN_STEPS * layers,
        "flash_bwd_fused": MAIN_STEPS * layers, "flash_dq": 0,
        "flash_dkv": 0})
    steps = records.take("train_loss")
    if [r["train_step"] for r in steps] != list(range(1, MAIN_STEPS + 1)):
        fail(f"the main logged steps {[r['train_step'] for r in steps]}")
    losses = [r["train_loss"] for r in steps]
    if not all(math.isfinite(x) for x in losses) or losses[-1] != main_loss:
        fail(f"the main's losses {losses}, returned {main_loss}")
    loss0_rel = abs(losses[0] - trainer_loss0) / abs(trainer_loss0)
    if not loss0_rel <= MAIN_LOSS0_RTOL:
        fail(f"the main's step-0 loss {losses[0]} against the Trainer's "
             f"{trainer_loss0}: {loss0_rel} relative (tol "
             f"{MAIN_LOSS0_RTOL})")
    step_ms = [TRAIN_BATCH * TRAIN_SEQ / r["tokens_per_s"] * 1e3
               for r in steps]

    # Resume under the deterministic (split) backward.
    A.set_backward_impl("split")
    _release()
    try:
        straight = train(cfg(steps=RESUME_STEPS))
        _release()
        with tempfile.TemporaryDirectory(prefix="nos-ck-") as tmp:
            first = train(cfg(steps=RESUME_AT, checkpoint_every=RESUME_AT,
                              checkpoint_dir=tmp))
            ck_bytes = _bytes_under(pathlib.Path(tmp) / str(RESUME_AT))
            _release()
            resumed = train(cfg(steps=RESUME_STEPS,
                                checkpoint_every=RESUME_AT,
                                checkpoint_dir=tmp))
    finally:
        A.set_backward_impl("fused")
    torch.cuda.synchronize()
    launches = _launch_counts()
    PATH_TILES["train_main"] = _tile_counts()
    port_log.removeHandler(records)
    _release()
    split_steps = RESUME_STEPS + RESUME_AT + (RESUME_STEPS - RESUME_AT)
    _check_launches("the train_main phase", launches, {
        "flash_fwd": (MAIN_STEPS + split_steps) * layers,
        "flash_bwd_fused": MAIN_STEPS * layers,
        "flash_dq": split_steps * layers, "flash_dkv": split_steps * layers})
    starts = [r["start_step"] for r in records.take("start_step")]
    if starts != [RESUME_AT]:
        fail(f"the restarted main resumed at {starts}, not [{RESUME_AT}]")
    if resumed != straight:
        fail(f"the resumed run ended on loss {resumed!r}, the straight run "
             f"on {straight!r}: not bitwise equal")
    saves = [r["checkpoint_save_s"]
             for r in records.take("checkpoint_save_s")]
    restores = [r["checkpoint_restore_s"]
                for r in records.take("checkpoint_restore_s")]
    mfu = [r["mfu"] for r in steps]
    emit({"phase": "train_main", "model": "BENCH_350M_TRAIN",
          "layers": layers, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "world_size": dist.get_world_size(),
          "backend": dist.get_backend(), "steps": MAIN_STEPS,
          "losses": losses, "trainer_loss0": trainer_loss0,
          "loss0_rel_diff": loss0_rel, "loss0_rtol": MAIN_LOSS0_RTOL,
          "ms_per_step": step_ms,
          "ms_per_step_median": statistics.median(step_ms[1:]),
          "tokens_per_s": [r["tokens_per_s"] for r in steps],
          "mfu": mfu, "mfu_median": statistics.median(mfu[1:]),
          "peak_mem_bytes": peak, "launches_main_run": main_launches,
          "launches": launches, "tile_launches": PATH_TILES["train_main"],
          "resume": {"backward": "split", "straight_loss": straight,
                     "first_loss": first, "resumed_loss": resumed,
                     "start_step": starts[0], "bitwise": True,
                     "save_ms": [x * 1e3 for x in saves],
                     "restore_ms": [x * 1e3 for x in restores],
                     "checkpoint_bytes": ck_bytes}})
    dist.destroy_process_group()
    return launches, losses[0]


# The moe phase: untimed and timed steps; the cut's depth and batch rows.
# From random weights optax adam(1e-3) (no warm-up, no clip) overshoots:
# on the H100 the loss rose over the first 3 steps, to 11.42 from 10.86,
# then came down with a spread of ~0.1 from step to step (PERF.md §6).
# The untimed steps cover the rise; the check holds the later half of the
# timed steps' losses, on average, below the earlier half.
MOE_UNTIMED, MOE_TIMED = 4, 8
MOE_CUT_LAYERS, MOE_CUT_ROWS = 2, 2


def _moe_flops_per_step(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one MoE step, counting the k experts each token is
    routed to and no capacity padding: the dense model's (one SwiGLU per
    token, ``ops.roofline.model_flops_per_step``) plus k - 1 more SwiGLUs,
    3 D F weights each at 6 FLOPs per weight and token (forward 2,
    backward 4).  The router's 6 T D E per layer is left out, and remat's
    recompute is not credited."""
    from nos_tpu_torch.ops.roofline import model_flops_per_step

    extra = 6 * batch * seq * (cfg.top_k - 1) * 3 * cfg.hidden_size \
        * cfg.intermediate_size * cfg.num_layers
    return model_flops_per_step(cfg, batch, seq) + extra


def _full_grads(model) -> dict[str, torch.Tensor]:
    from torch.distributed.tensor import DTensor

    return {n: (p.grad.to_local() if isinstance(p.grad, DTensor)
                else p.grad).detach().clone()
            for n, p in model.named_parameters()}


def _moe_pass(model, tokens, impl: str = "fused") -> tuple[float, dict]:
    """One loss-and-gradient pass of ``moe_loss`` (no update)."""
    from nos_tpu_torch.models.moe import moe_loss
    from nos_tpu_torch.ops import attention as A

    for p in model.parameters():
        p.grad = None
    prev = A.set_backward_impl(impl)
    try:
        loss = moe_loss(model, tokens)
        loss.backward()
    finally:
        A.set_backward_impl(prev)
    return loss.item(), _full_grads(model)


# One MoE layer, index dispatch against the einsum reference on the same
# input and output cotangent: the same routing and roundings but for the
# order of fp32 sums (cuBLAS's bf16 products against fp32 einsums), so a
# few bf16 ulps of each output's largest |value|.
MOE_LAYER_TOL = 1e-2


def _moe_layer_check(moe, x: torch.Tensor, dy: torch.Tensor) -> float:
    """max over y, dx and the layer's parameter gradients of |index -
    einsum| / max |einsum| for one MoE layer on input x, cotangent dy."""
    from nos_tpu_torch.models.moe import MoEMLP, moe_mlp_reference

    outs = []
    for fn in (functools.partial(MoEMLP.forward, moe),
               functools.partial(moe_mlp_reference, moe)):
        moe.zero_grad(set_to_none=True)
        xx = x.clone().requires_grad_()
        y, aux = fn(xx)
        ((y.float() * dy.float()).sum() + aux).backward()
        outs.append([y.detach(), xx.grad] + [p.grad.clone()
                                            for p in moe.parameters()])
    return max(_rel_err(a, b) for a, b in zip(*outs))


def _moe_cut(loader) -> dict:
    """At MOE_CUT_LAYERS layers on MOE_CUT_ROWS x 2048 tokens, without a
    mesh, on one set of parameters: the flash model's loss against the
    einsum reference's, each layer's index dispatch against the reference
    on the layer's own input and cotangent from that pass, and flash
    against dense attention with the dense pass replaying the flash
    pass's expert choices.  (A bf16 rounding in an early layer can flip
    a near-tied choice in a later one, and a flipped token's output
    changes wholly: end-to-end gradients of two MoE models differ by
    routing, not by the numerics under test.)"""
    from nos_tpu_torch.entry import bench_moe_config
    from nos_tpu_torch.models.moe import (MoELlama, init_moe_params,
                                          moe_mlp_reference)

    cfg = bench_moe_config(MOE_CUT_LAYERS)
    params = init_moe_params(
        cfg, torch.Generator(device="cuda").manual_seed(1), "cuda")
    tokens = torch.from_numpy(loader.batch_at(0)[:MOE_CUT_ROWS]).cuda()

    def model(attn):
        m = MoELlama(dataclasses.replace(cfg, attn_impl=attn), "cuda")
        m.load_state_dict(params)
        return m

    # The flash pass, recording each layer's first (forward) routing,
    # input and output cotangent; backward's recompute is not recorded.
    flash, seen = model("flash"), [{} for _ in range(MOE_CUT_LAYERS)]
    for layer, rec in zip(flash.layers, seen):
        route, forward = layer.moe.route, layer.moe.forward

        def recording_route(x, route=route, rec=rec):
            r = route(x)
            rec.setdefault("routing", dataclasses.replace(
                r, probs=r.probs.detach(), gates=r.gates.detach()))
            return r

        def recording_forward(x, forward=forward, rec=rec):
            y, aux = forward(x)
            if "x" not in rec:
                rec["x"] = x.detach()
                y.register_hook(lambda g: rec.setdefault("dy", g))
            return y, aux

        layer.moe.route, layer.moe.forward = recording_route, recording_forward
    loss_f, g_f = _moe_pass(flash, tokens)
    del flash

    einsum = model("flash")
    for layer in einsum.layers:
        layer.moe.forward = functools.partial(moe_mlp_reference, layer.moe)
    loss_e = _moe_pass(einsum, tokens)[0]
    layer_errs = [_moe_layer_check(layer.moe, rec["x"], rec["dy"])
                  for layer, rec in zip(einsum.layers, seen)]
    del einsum

    dense = model("dense")
    for layer, rec in zip(dense.layers, seen):
        def replayed_route(x, moe=layer.moe, r=rec["routing"]):
            # the recorded choices, gated by this model's own router
            probs = torch.softmax(moe.router(x.reshape(-1, x.shape[-1])),
                                  dim=-1)
            vals = probs.gather(1, r.expert)
            return dataclasses.replace(r, probs=probs, gates=vals / torch.clamp(
                vals.sum(-1, keepdim=True), min=1e-9))

        layer.moe.route = replayed_route
    loss_d, g_d = _moe_pass(dense, tokens)
    del dense
    dense_err, dense_worst = _worst_grad_err(g_f, g_d)
    out = {"layers": MOE_CUT_LAYERS, "rows": MOE_CUT_ROWS,
           "loss_flash_index": loss_f, "loss_flash_einsum": loss_e,
           "loss_dense_replayed": loss_d,
           "layer_rel_index_vs_einsum": layer_errs,
           "grad_rel_flash_vs_dense": dense_err,
           "worst_param_flash_vs_dense": dense_worst,
           "loss_tol": CUT_LOSS_TOL, "layer_tol": MOE_LAYER_TOL,
           "grad_tol": CUT_GRAD_TOL}
    if not (abs(loss_f - loss_e) <= CUT_LOSS_TOL
            and max(layer_errs) <= MOE_LAYER_TOL):
        fail(f"{MOE_CUT_LAYERS}-layer MoE index dispatch vs einsum: {out}")
    if not (abs(loss_f - loss_d) <= CUT_LOSS_TOL
            and dense_err <= CUT_GRAD_TOL):
        fail(f"{MOE_CUT_LAYERS}-layer MoE flash vs dense: {out}")
    return out


def phase_moe() -> dict[str, int]:
    import torch.distributed as dist

    from nos_tpu_torch.entry import (TRAIN_BATCH, TRAIN_SEQ,
                                     bench_moe_trainer, moe_launches_per_step,
                                     train_loader)
    from nos_tpu_torch.models.moe import capacity
    from nos_tpu_torch.ops import attention as A
    from nos_tpu_torch.ops.roofline import peaks_for

    _release()
    if A.set_backward_impl("fused") != "fused":
        fail("the default flash backward is not the fused one")
    state, step = bench_moe_trainer("cuda")
    model, cfg = state.model, state.model.cfg
    if not (dist.get_world_size() == 1 and dist.get_backend() == "nccl"):
        fail("the MoE trainer did not run in a one-rank NCCL group")
    per_step = moe_launches_per_step(cfg)
    loader = train_loader()

    # Step 0's loss terms, and each layer's share of (token, choice)
    # pairs over capacity, from a forward without grad.
    drops: list[float] = []

    def record_drops(moe, args, _out):
        drops.append(1.0 - moe.route(args[0]).kept.float().mean().item())

    hooks = [layer.moe.register_forward_hook(record_drops)
             for layer in model.layers]
    batch0 = torch.from_numpy(loader.batch_at(0)).cuda()
    with torch.no_grad():
        xent0, aux0 = model.loss_terms(batch0, batch0)
    for h in hooks:
        h.remove()
    xent0, aux0, drops0 = xent0.item(), aux0.tolist(), list(drops)
    # The same random-weight argument as the train phase: the final norm
    # and the tied embedding are the dense model's.
    if not abs(xent0 - EXPECTED_LOSS0) <= LOSS0_TOL:
        fail(f"MoE step-0 xent {xent0}, expected {EXPECTED_LOSS0} +- "
             f"{LOSS0_TOL}")

    losses, step_launches = [], []
    torch.cuda.synchronize()
    _zero_launch_counts()
    for i in range(MOE_UNTIMED):
        before = _launch_counts()
        state, loss = step(state, loader.batch_at(i))
        losses.append(loss.item())
        step_launches.append({k: v - before[k]
                              for k, v in _launch_counts().items()})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(MOE_TIMED + 1)]
    timed = []
    t0 = time.perf_counter()
    marks[0].record()
    for j in range(MOE_TIMED):
        state, loss = step(state, loader.batch_at(MOE_UNTIMED + j))
        timed.append(loss)
        marks[j + 1].record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / MOE_TIMED * 1e3
    launches = _launch_counts()
    PATH_TILES["moe"] = _tile_counts()
    peak = torch.cuda.max_memory_allocated()
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    losses += [x.item() for x in timed]
    _check_launches("the moe run", launches, {
        k: (MOE_UNTIMED + MOE_TIMED) * v for k, v in per_step.items()})
    for i, got in enumerate(step_launches):
        _check_launches(f"moe step {i}", got, per_step)
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite MoE loss: {losses}")
    # Training must make progress over the timed steps (a sign error or a
    # dead gradient path would not): see MOE_UNTIMED.
    half = MOE_TIMED // 2
    early = statistics.mean(losses[MOE_UNTIMED:MOE_UNTIMED + half])
    late = statistics.mean(losses[MOE_UNTIMED + half:])
    if not late < early:
        fail(f"the MoE loss did not fall over the timed steps: mean "
             f"{early} then {late}; {losses}")
    # The loss terms and drop rates after training, on batch 0.
    drops.clear()
    hooks = [layer.moe.register_forward_hook(record_drops)
             for layer in model.layers]
    with torch.no_grad():
        xent_end, aux_end = model.loss_terms(batch0, batch0)
    for h in hooks:
        h.remove()
    # shard FSDP2's root again before the next backward (as the step does)
    model.reshard()
    end = {"xent": xent_end.item(), "aux_per_layer": aux_end.tolist(),
           "drop_rate_per_layer": list(drops)}

    # Two passes from one state: the index path adds no atomics, so under
    # the split backward the gradients repeat bitwise.
    batch = torch.from_numpy(loader.batch_at(0)).cuda()
    loss_a, g_a = _moe_pass(model, batch, "split")
    loss_b, g_b = _moe_pass(model, batch, "split")
    bitwise = loss_a == loss_b and all(torch.equal(g_a[n], g_b[n])
                                       for n in g_a)
    repeat_err, repeat_worst = _worst_grad_err(g_b, g_a)
    del g_a, g_b
    if not bitwise:
        fail(f"two split MoE passes from one state differ: losses {loss_a}"
             f", {loss_b}; gradients {repeat_err} at {repeat_worst}")
    param_count = sum(p.numel() for p in model.parameters())
    del state, step, model
    _release()
    cut = _moe_cut(loader)
    dist.destroy_process_group()
    _release()

    ms = statistics.median(step_ms)
    flops = _moe_flops_per_step(cfg, TRAIN_BATCH, TRAIN_SEQ)
    peak_flops = peaks_for(torch.cuda.get_device_name(0))[0]
    emit({"phase": "moe", "model": "MoE at BENCH_350M_TRAIN widths",
          "layers": cfg.num_layers, "experts": cfg.num_experts,
          "top_k": cfg.top_k, "capacity_factor": cfg.capacity_factor,
          "param_count": param_count, "batch": TRAIN_BATCH,
          "seq": TRAIN_SEQ,
          "steps": {"untimed": MOE_UNTIMED, "timed": MOE_TIMED},
          "ms_per_step": ms, "stream_ms_per_step": step_ms,
          "host_ms_per_step": host_ms,
          "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / ms * 1e3,
          "active_flops_per_step": flops, "peak_flops": peak_flops,
          "mfu": flops / (ms * 1e-3) / peak_flops,
          "peak_mem_bytes": peak, "losses": losses,
          "xent0": xent0, "expected_loss0": EXPECTED_LOSS0,
          "loss0_tol": LOSS0_TOL, "aux0_per_layer": aux0,
          "drop_rate_per_layer": drops0,
          "loss_mean_early_late": [early, late], "after_training": end,
          "capacity": capacity(cfg, TRAIN_BATCH * TRAIN_SEQ),
          "launches": launches, "tile_launches": PATH_TILES["moe"],
          "launches_per_step": per_step,
          "repeat_split": {"losses": [loss_a, loss_b], "bitwise": bitwise},
          "cut": cut})
    return launches



# The device phase: NVML's total memory of the card against CUDA's.
DEVICE_MEM_TOL = 1 << 20
ROOT = pathlib.Path(__file__).resolve().parent


def device_probe() -> dict:
    """The device phase's child, in a process with no CUDA context: NVML
    first (``discover(allow_cuda=False)``, the runtime's topology, MIG
    devices and, on a card in MIG mode, the profile table), then CUDA
    started and the device rung read."""
    from nos_tpu_torch.device import discovery, nvml

    env = discovery.discover(allow_cuda=False)
    out = {"env": dataclasses.asdict(env) | {"model": env.model.name},
           "cuda_initialized_after_env": torch.cuda.is_initialized()}
    runtime = nvml.NvmlGpuRuntime()
    try:
        out["topology"] = runtime.topology()
        out["nvml_gpus"] = nvml.read_gpus(runtime.nvml)
        out["mig_devices"] = runtime.list_devices().ids()
        out["mig_tables"] = {}
        for g in out["nvml_gpus"]:
            if g["mig"]:
                table = nvml.read_profile_table(
                    runtime.nvml, runtime.nvml.handle(g["index"]),
                    runtime.model)
                out["mig_tables"][g["uuid"]] = {
                    "observed": table, "mismatches":
                        nvml.profile_table_mismatches(runtime.model, table)}
    finally:
        runtime.close()
    out["cuda_initialized_after_runtime"] = torch.cuda.is_initialized()
    torch.cuda.init()
    dev = discovery.discover(allow_cuda=True)
    out["device"] = dataclasses.asdict(dev) | {"model": dev.model.name}
    out["sm_count"] = torch.cuda.get_device_properties(0).multi_processor_count
    return out


def _child_env(**grant: str) -> dict[str, str]:
    """The environment of a child process: this one's without any grant
    or CUDA visibility key, with ``grant`` added and the repo on the
    path."""
    import os

    env = {k: v for k, v in os.environ.items()
           if not k.startswith("NOS_TPU_VISIBLE_CHIPS")
           and not k.startswith("NOS_TPU_TIMESHARE_GB")
           and k not in ("NOS_TPU_SLICE_IDS", "NOS_TPU_TORCH_MEM_FRACTION",
                         "CUDA_VISIBLE_DEVICES", "CUDA_DEVICE_ORDER")}
    env["PYTHONPATH"] = str(ROOT)
    env.update(grant)
    return env


def phase_device() -> dict:
    """Discovery on the card: NVML without a CUDA context, agreeing with
    the CUDA rung; the MIG table checked where the card is in MIG mode.
    Changes no MIG mode and creates or destroys nothing."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", "import json, chip_smoke; "
         "print(json.dumps(chip_smoke.device_probe()))"],
        cwd=ROOT, env=_child_env(), capture_output=True, text=True,
        timeout=300)
    if proc.returncode != 0:
        fail(f"the device probe exited {proc.returncode}:\n"
             f"{proc.stderr[-4000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    env, dev = got["env"], got["device"]
    if env["source"] != "env":
        fail(f"discover(allow_cuda=False) came from {env['source']!r}, "
             f"not NVML ('env')")
    if env["model"] != "nvidia-h100-80gb-hbm3":
        fail(f"NVML discovered {env['model']!r} ({env['product_name']!r})")
    if got["cuda_initialized_after_env"] \
            or got["cuda_initialized_after_runtime"]:
        fail("NVML discovery started CUDA")
    if dev["source"] != "device":
        fail(f"discover() with CUDA up came from {dev['source']!r}")
    nvml_by_uuid = {u.lower(): (m, i) for i, (u, m) in enumerate(
        zip(env["uuids"], env["memory_bytes"]))}
    cuda_uuid = dev["uuids"][0].lower()
    if cuda_uuid not in nvml_by_uuid:
        fail(f"CUDA device 0 ({cuda_uuid}) is not among NVML's GPUs "
             f"{env['uuids']}")
    nvml_mem, index = nvml_by_uuid[cuda_uuid]
    nvml_gpu = got["nvml_gpus"][index]
    mem_diff = abs(dev["memory_bytes"][0] - nvml_mem)
    if dev["product_name"] != env["product_name"] \
            or mem_diff > DEVICE_MEM_TOL:
        fail(f"NVML read {env['product_name']!r} with {nvml_mem} B, CUDA "
             f"{dev['product_name']!r} with {dev['memory_bytes'][0]} B")
    mig = env["mig_modes"][index]
    mismatches = {u: t["mismatches"] for u, t in got["mig_tables"].items()}
    if mig and not got["mig_tables"]:
        fail("the card is in MIG mode but no profile table was read")
    if any(mismatches.values()):
        fail(f"NVML's MIG profiles disagree with topology/known.py: "
             f"{mismatches}")
    emit({"phase": "device", "seconds": time.perf_counter() - t0,
          "source_nvml": env["source"], "source_cuda": dev["source"],
          "model": env["model"], "product_name": env["product_name"],
          "gpus_nvml": env["num_local_gpus"], "gpus_cuda":
              dev["num_local_gpus"], "uuid": dev["uuids"][0],
          "memory_bytes_nvml": nvml_mem,
          "memory_total_nvml": nvml_gpu["memory_total"],
          "memory_reserved_nvml": nvml_gpu["memory_reserved"],
          "memory_bytes_cuda": dev["memory_bytes"][0],
          "memory_diff_bytes": mem_diff, "sm_count": got["sm_count"],
          "cuda_initialized_after_nvml": False,
          "mig": "enabled" if mig else "disabled",
          "mig_devices": got["mig_devices"],
          "mig_table": got["mig_tables"] if mig else "not checked: MIG "
                                                     "is disabled"})
    # "uuids": CUDA's devices in index order, which the partition phase
    # maps a GPU index of the node's config through
    return {"uuid": dev["uuids"][0], "uuids": dev["uuids"],
            "memory_bytes": dev["memory_bytes"][0], "model": env["model"]}


# The grant phase: three children of the training main on train_main's
# configuration, two steps each.  (a) a 24 GB timeshare grant of the
# card: a cap of 24 / 80 x 0.9 of its memory, above the run's peak;
# (b) 8 GB, a cap below it, which must fail the step with torch's OOM;
# (c) a well-formed UUID of no device here, which must stop the main
# with ConfinementError before any step.
GRANT_STEPS = 2
GRANT_GB = {"a": 24, "b": 8}
ABSENT_UUID = "GPU-deadbeef-0000-4000-8000-000000000000"
_STEP_LINE = re.compile(r"step (\d+)/\d+ loss (\S+) \(([\d.]+) tokens/s")
# the training main's log format: "%(asctime)s %(levelname)s %(name)s: ..."
_STEP_STAMP = re.compile(r"^(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3}) \S+ \S+: "
                         r"step (\d+)/\d+ loss \S+ \(([\d.]+) tokens/s", re.M)
_PORT_FRAME = re.compile(r'File "[^"]*/(nos_tpu_torch/[^"]+)", line (\d+), '
                         r'in (\S+)')


def _run_grant_child(case: str, cfg_path: str, grant: dict,
                     no_nvcc: str) -> dict:
    import os

    env = _child_env(**grant)
    # the kernels are built: a child that starts nvcc finds none
    env["CUDA_HOME"] = no_nvcc
    env["PATH"] = os.pathsep.join(
        d for d in env.get("PATH", "").split(os.pathsep)
        if d and not pathlib.Path(d, "nvcc").exists())
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "nos_tpu_torch.cmd.train", "--config",
         cfg_path], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=600)
    wall = time.perf_counter() - t0
    err = proc.stderr
    steps = [(int(m.group(1)), float(m.group(2)), float(m.group(3)))
             for m in _STEP_LINE.finditer(err)]
    # (step, host wall-clock seconds of its log line, tokens/s)
    stamps = [(int(m.group(2)), datetime.datetime.strptime(
                   m.group(1), "%Y-%m-%d %H:%M:%S,%f").timestamp(),
               float(m.group(3))) for m in _STEP_STAMP.finditer(err)]
    done = [ln for ln in err.splitlines() if "done: " in ln and " grant " in ln]
    report = (json.loads(done[-1].split(" grant ", 1)[1]) if done else None)
    frames = _PORT_FRAME.findall(err)
    return {"case": case, "grant": grant, "rc": proc.returncode,
            "wall_s": wall, "steps": steps, "stamps": stamps,
            "report": report,
            "last_port_frame": ":".join(frames[-1]) if frames else None,
            "stderr": err}


def _grant_workdir(tmp: str) -> tuple[str, str]:
    """In ``tmp``: the children's training config (train_main's, GRANT_STEPS
    steps) and an empty CUDA_HOME that holds no nvcc."""
    from nos_tpu_torch.entry import TRAIN_BATCH, TRAIN_SEQ

    cfg_path = str(pathlib.Path(tmp) / "train.json")
    pathlib.Path(cfg_path).write_text(json.dumps({
        "model": "bench350m", "batch_size": TRAIN_BATCH,
        "seq_len": TRAIN_SEQ, "steps": GRANT_STEPS, "data_seed": 0,
        "log_every": 1}))
    no_nvcc = str(pathlib.Path(tmp) / "no-cuda-home")
    pathlib.Path(no_nvcc).mkdir()
    return cfg_path, no_nvcc


def _grant_cap(gb: int, total: int) -> tuple[float, int]:
    """The memory fraction and cap in bytes a ``gb`` GB timeshare grant
    installs on a card of ``total`` bytes (``device/workload_env.py``)."""
    from nos_tpu_torch.device.workload_env import CEILING, SAFETY
    from nos_tpu_torch.topology import H100_80GB

    fraction = round(min(gb / H100_80GB.memory_gb * SAFETY, CEILING), 3)
    return fraction, int(fraction * total)


def _check_granted_child(label: str, child: dict, uuid: str,
                         main_loss0: float) -> dict:
    """A training-main child that must pass under its timeshare grant:
    exit 0, the grant verified on ``uuid`` at the child's fraction and
    cap, GRANT_STEPS finite steps logged, 24 K1 + 24 K2 a step, the
    train_main phase's step-0 loss within MAIN_LOSS0_RTOL, and its peak
    under the cap.  Records the peaks and the loss's distance on
    ``child``; returns the main's report."""
    from nos_tpu_torch.models.llama import BENCH_350M_TRAIN

    layers = BENCH_350M_TRAIN.num_layers
    r = child["report"]
    if child["rc"] != 0 or r is None:
        fail(f"{label} exited {child['rc']}:\n{child['stderr'][-4000:]}")
    if not (r["verified"] and r["devices"] == [uuid]
            and r["fraction"] == child["fraction"]
            and r["cap_bytes"] == child["cap_bytes"]):
        fail(f"{label} verified {r}, expected {uuid} at fraction "
             f"{child['fraction']}")
    _check_launches(label, r["launches"], {
        "flash_fwd": GRANT_STEPS * layers,
        "flash_bwd_fused": GRANT_STEPS * layers})
    steps = child["steps"]
    if [s[0] for s in steps] != list(range(1, GRANT_STEPS + 1)) \
            or not all(math.isfinite(s[1]) for s in steps):
        fail(f"{label} logged steps {steps}")
    loss0_rel = abs(steps[0][1] - main_loss0) / abs(main_loss0)
    if not loss0_rel <= MAIN_LOSS0_RTOL:
        fail(f"{label}'s step-0 loss {steps[0][1]} against the "
             f"train_main phase's {main_loss0}: {loss0_rel} relative (tol "
             f"{MAIN_LOSS0_RTOL})")
    child["loss0_rel_diff"] = loss0_rel
    child["peak_bytes"] = r["max_memory_allocated"]
    child["peak_reserved_bytes"] = r["max_memory_reserved"]
    if not (r["max_memory_allocated"] < child["cap_bytes"]
            and r["max_memory_reserved"] <= child["cap_bytes"]):
        fail(f"{label} peaked at {r['max_memory_allocated']} B allocated, "
             f"{r['max_memory_reserved']} B reserved, over its cap "
             f"{child['cap_bytes']} B")
    return r


def phase_grant(main_loss0: float, device: dict) -> dict:
    """The training main under three grants, each a fresh process that
    reuses the built kernels (nvcc hidden from it, the kernel directory
    unchanged): see GRANT_GB."""
    from nos_tpu_torch.entry import TRAIN_BATCH, TRAIN_SEQ
    from nos_tpu_torch.models.llama import BENCH_350M_TRAIN
    from nos_tpu_torch.ops import _build

    layers = BENCH_350M_TRAIN.num_layers
    uuid, total = device["uuid"], device["memory_bytes"]
    kernels_before = sorted(p.name for p in _build.KERNEL_DIR.iterdir())
    _release()
    children = {}
    with tempfile.TemporaryDirectory(prefix="nos-grant-") as tmp:
        cfg_path, no_nvcc = _grant_workdir(tmp)
        for case, gb in GRANT_GB.items():
            children[case] = _run_grant_child(
                case, cfg_path, {"NOS_TPU_VISIBLE_CHIPS": uuid,
                                 "NOS_TPU_TIMESHARE_GB": str(gb)}, no_nvcc)
        children["c"] = _run_grant_child(
            "c", cfg_path, {"NOS_TPU_VISIBLE_CHIPS": ABSENT_UUID}, no_nvcc)
    kernels_after = sorted(p.name for p in _build.KERNEL_DIR.iterdir())
    if kernels_after != kernels_before:
        fail(f"a grant child built kernels: {kernels_before} -> "
             f"{kernels_after}")
    for case, gb in GRANT_GB.items():
        children[case]["fraction"], children[case]["cap_bytes"] = \
            _grant_cap(gb, total)

    a = children["a"]
    r = _check_granted_child("grant (a)", a, uuid, main_loss0)

    b = children["b"]
    # torch names the cap ("... allowed;") when the fraction refused it
    if b["rc"] == 0 or "OutOfMemoryError" not in b["stderr"] \
            or " allowed;" not in b["stderr"]:
        fail(f"grant (b), a cap of {b['cap_bytes']} B below the run's peak, "
             f"exited {b['rc']} without the cap's OutOfMemoryError: the cap "
             f"did not bind\n{b['stderr'][-4000:]}")
    if b["report"] is not None:
        fail("grant (b) reached the end of the main")

    c = children["c"]
    if c["rc"] == 0 or "ConfinementError" not in c["stderr"] \
            or c["steps"]:
        fail(f"grant (c), a device not on the host, exited {c['rc']} "
             f"after steps {c['steps']}:\n{c['stderr'][-4000:]}")
    emit({"phase": "grant", "model": "BENCH_350M_TRAIN", "layers": layers,
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": GRANT_STEPS,
          "card_memory_bytes": total, "main_loss0": main_loss0,
          "loss0_rel_diff": a["loss0_rel_diff"],
          "loss0_rtol": MAIN_LOSS0_RTOL, "launches": r["launches"],
          "children": [
              {k: v for k, v in ch.items() if k not in ("stderr", "stamps")}
              | {"oom_at_cap": " allowed;" in ch["stderr"]}
              for ch in children.values()]})
    return r["launches"]

# The partition phase.  (a) The MPS planner on testing/fleet.py's fleet
# (32 nodes x 8 H100 80GB, 200 pending pods, seed 0): PLAN_TIMED timed
# plans after one untimed, on fresh snapshots, on the card machine's
# host.  (b) The card's own node in the MPS loop (the partitioner
# controller, its chip agent and the test binder, on time.monotonic with
# the batch windows below and the default plan deadline, 3 x the
# timeout): CARD_PODS pods of CARD_SHARE_GB, of which the card's config
# holds three; the pods bound and Running within CARD_BIND_LIMIT_S,
# polled every CARD_POLL_S; then shared by the children their grants
# stand for.
PLAN_TIMED = 5
CARD_PODS = 4
CARD_SHARE_GB = 24
CARD_NODE = "h100-node-0"
CARD_BATCH_IDLE_S = 0.2
CARD_BATCH_TIMEOUT_S = 2.0
CARD_BIND_LIMIT_S = 30.0
CARD_POLL_S = 0.01


def _fleet_plans() -> dict:
    """The fleet plan, once untimed and PLAN_TIMED times timed, each on
    a fresh snapshot; every run's summary must be the pinned one."""
    from nos_tpu_torch.obs import trace
    from nos_tpu_torch.partitioning.core import GeometryPlanner
    from nos_tpu_torch.partitioning.timeshare import (
        TimesharePartitionCalculator, TimeshareProfileCalculator,
        TimeshareSnapshotTaker)
    from nos_tpu_torch.scheduler.framework import Framework
    from nos_tpu_torch.testing import fleet
    from nos_tpu_torch.topology import H100_80GB

    spec = fleet.fleet_spec(0)
    bound = {b["name"] for n in spec["nodes"] for b in n["bound"]}
    planner = GeometryPlanner(Framework(), TimeshareProfileCalculator(),
                              TimesharePartitionCalculator())
    runs = []
    for _ in range(1 + PLAN_TIMED):
        snap = TimeshareSnapshotTaker().take_snapshot(
            fleet.build_cluster(spec))
        pending = fleet.build_pending(spec)
        before = {name: {u.index: (dict(u.used), u.geometry_names())
                         for u in node.units}
                  for name, node in snap.nodes().items()}
        tracer = trace.Tracer()
        prev = trace.set_tracer(tracer)
        try:
            t0 = time.perf_counter()
            planner.plan(snap, pending)
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            trace.set_tracer(prev)
        (span,) = [sp for sp in tracer.ring.dump()
                   if sp["name"] == "planner.plan"]
        runs.append({"ms": ms, "counts": span["counts"], "before": before,
                     "summary": fleet.plan_summary(snap, pending, bound)})
    first = runs[0]
    if any(r["summary"] != first["summary"] or r["counts"] != first["counts"]
           for r in runs):
        fail("the fleet's plans differ between runs")
    digest = fleet.plan_digest(first["summary"])
    if digest != fleet.FLEET_DIGEST:
        fail(f"the fleet plan's digest {digest} is not the pinned "
             f"{fleet.FLEET_DIGEST} (the JAX package's plan on the CPU)")
    carved, shares = 0, {}
    for name, gpus in first["summary"]["geometries"].items():
        for index, geometry in gpus.items():
            used, geometry_before = first["before"][name][int(index)]
            gb = sum(int(p[:-2]) * q for p, q in geometry.items())
            if gb > H100_80GB.memory_gb:
                fail(f"{name} GPU {index} holds {gb} GB of shares: {geometry}")
            lost = {f"{g}gb": c for g, c in used.items()
                    if geometry.get(f"{g}gb", 0) < c}
            if lost:
                fail(f"{name} GPU {index}'s used shares {lost} are gone "
                     f"from {geometry}")
            carved += geometry != geometry_before
            for p, q in geometry.items():
                shares[p] = shares.get(p, 0) + q
    timed = [r["ms"] for r in runs[1:]]
    return {"nodes": len(spec["nodes"]), "gpus": sum(
                n["gpus"] for n in spec["nodes"]),
            "pending": len(spec["pending"]),
            "plan_ms_median": statistics.median(timed),
            "plan_ms_max": max(timed), "plan_ms_untimed": runs[0]["ms"],
            "plan_ms": timed,
            "forks": first["counts"].get("forks", 0),
            "commits": first["counts"].get("commits", 0),
            "reverts": first["counts"].get("reverts", 0),
            "filter_runs": first["counts"].get("filter_runs", 0),
            "pods_placed": sum(len(v) for v in
                               first["summary"]["placed"].values()),
            "gpus_carved": carved,
            "shares_by_size": dict(sorted(
                shares.items(), key=lambda kv: int(kv[0][:-2]))),
            "lacking_after": first["summary"]["lacking"], "digest": digest}


class _CardLoop:
    """The MPS loop on the card's node (the model and memory discovery
    found, one GPU), on an in-memory API server: node and pod
    controllers feeding a ClusterState, the partitioner controller from
    its factory, the node's chip agent, and ``testing/bind.py``'s binder
    standing in for the scheduler.  ``step`` is one pass of the loop:
    bind, poll the controller, tick the agent (timed)."""

    def __init__(self, device: dict) -> None:
        from nos_tpu_torch.controllers.chipagent import ChipAgent
        from nos_tpu_torch.controllers.node_controller import NodeController
        from nos_tpu_torch.controllers.pod_controller import PodController
        from nos_tpu_torch.kube.client import APIServer, KIND_NODE
        from nos_tpu_torch.partitioning.state import ClusterState
        from nos_tpu_torch.partitioning.timeshare import (
            new_timeshare_partitioner_controller)
        from nos_tpu_torch.scheduler.framework import Framework
        from nos_tpu_torch.testing.factory import make_gpu_node
        from nos_tpu_torch.topology import DEFAULT_REGISTRY

        self.model = DEFAULT_REGISTRY.get(device["model"])
        if self.model.memory_gb * 1e9 > device["memory_bytes"]:
            fail(f"the card has {device['memory_bytes']} B, less than its "
                 f"model's {self.model.memory_gb} GB")
        self.api = APIServer()
        state = ClusterState()
        NodeController(self.api, state).bind()
        PodController(self.api, state).bind()
        self.controller = new_timeshare_partitioner_controller(
            self.api, state, batch_timeout_s=CARD_BATCH_TIMEOUT_S,
            batch_idle_s=CARD_BATCH_IDLE_S)
        self.controller.bind()
        self.api.create(KIND_NODE, make_gpu_node(CARD_NODE, model=self.model,
                                                 gpus=1))
        self.agent = ChipAgent(self.api, CARD_NODE)
        self.agent.start()
        self.framework = Framework()
        self.cycles = 0
        self.tick_ms: list[float] = []
        self.created: dict[str, float] = {}
        self.bound_ms: dict[str, float] = {}

    def create_pods(self) -> None:
        from nos_tpu_torch.kube.client import KIND_POD
        from nos_tpu_torch.testing.factory import make_timeshare_pod

        for i in range(CARD_PODS):
            name = f"train-{i}"
            self.created[name] = time.perf_counter()
            self.api.create(KIND_POD, make_timeshare_pod(CARD_SHARE_GB,
                                                         name=name))

    def bind(self) -> int:
        from nos_tpu_torch.kube.client import KIND_POD
        from nos_tpu_torch.testing.bind import bind_pending

        bound = bind_pending(self.api, self.framework)
        now = time.perf_counter()
        for pod in self.api.list(KIND_POD):
            name = pod.metadata.name
            if pod.spec.node_name and name not in self.bound_ms:
                self.bound_ms[name] = (now - self.created[name]) * 1e3
        return bound

    def process(self) -> bool:
        ran = self.controller.process_if_ready()
        self.cycles += ran
        return ran

    def tick(self) -> None:
        t0 = time.perf_counter()
        self.agent.tick()
        self.tick_ms.append((time.perf_counter() - t0) * 1e3)

    def step(self) -> None:
        self.bind()
        self.process()
        self.tick()

    def run_until(self, done, what: str) -> float:
        """Step until ``done()``; fail after CARD_BIND_LIMIT_S.  Returns
        the seconds it took."""
        t0 = time.monotonic()
        while not done():
            if time.monotonic() - t0 > CARD_BIND_LIMIT_S:
                fail(f"the MPS loop did not {what} within "
                     f"{CARD_BIND_LIMIT_S} s")
            self.step()
            time.sleep(CARD_POLL_S)
        return time.monotonic() - t0

    # -- reading ----------------------------------------------------------
    def node(self):
        from nos_tpu_torch.kube.client import KIND_NODE

        return self.api.get(KIND_NODE, CARD_NODE)

    def pods(self) -> dict:
        from nos_tpu_torch.kube.client import KIND_POD

        return {p.metadata.name: p for p in self.api.list(KIND_POD)}

    def configmap(self):
        from nos_tpu_torch.kube.client import KIND_CONFIGMAP
        from nos_tpu_torch.partitioning.timeshare import (
            DEVICE_PLUGIN_CM_NAME, DEVICE_PLUGIN_CM_NAMESPACE)

        return self.api.get(KIND_CONFIGMAP, DEVICE_PLUGIN_CM_NAME,
                            DEVICE_PLUGIN_CM_NAMESPACE)

    def running(self) -> list[str]:
        return sorted(n for n, p in self.pods().items()
                      if p.spec.node_name == CARD_NODE
                      and p.status.phase == "Running")

    def status(self, index: int, share: str, what: str) -> str | None:
        from nos_tpu_torch.api import constants as C

        return self.node().metadata.annotations.get(
            f"{C.ANNOT_STATUS_PREFIX}{index}-{share}-{what}")

    def written(self) -> tuple:
        """What a plan writes: the ConfigMap (data and version) and the
        node's plan label and spec plan id."""
        from nos_tpu_torch.api import constants as C

        cm, node = self.configmap(), self.node()
        return (dict(cm.data), cm.metadata.resource_version,
                node.metadata.labels.get(C.LABEL_DEVICE_PLUGIN_CONFIG),
                node.metadata.annotations.get(
                    C.spec_plan_annotation(C.MPS_KIND)))


def _plan_seconds() -> tuple[int, float]:
    from nos_tpu_torch.api import constants as C
    from nos_tpu_torch.exporter.metrics import REGISTRY

    got = REGISTRY.summary("nos_tpu_plan_seconds", {"kind": C.MPS_KIND})
    return (0, 0.0) if got is None else got[:2]


def _plans_total() -> float:
    from nos_tpu_torch.api import constants as C
    from nos_tpu_torch.exporter.metrics import REGISTRY

    return REGISTRY.value("nos_tpu_plans_total", {"kind": C.MPS_KIND}) or 0.0


def _card_loop(device: dict) -> tuple[_CardLoop, dict, list[dict]]:
    """Phase 9 (b) up to the children: four pending 24 GB pods through
    the MPS loop until three are bound and Running, the checks on what
    the controller, the plugin and the reporter wrote, one more
    (rescan) cycle that must write nothing, and each bound pod's grant
    derived from the node side.  Returns the loop, the phase's fields
    and the grants (the pod's name under "pod", its environment)."""
    from nos_tpu_torch.api import constants as C
    from nos_tpu_torch.kube.resources import pod_request
    from nos_tpu_torch.partitioning.timeshare import config_key
    from nos_tpu_torch.topology.profile import extract_timeshare_requests

    share = f"{CARD_SHARE_GB}gb"
    loop = _CardLoop(device)
    plans0, (samples0, plan_s0) = _plans_total(), _plan_seconds()
    landed0, latency_s0 = _actuation_latency()
    loop.create_pods()
    bind_s = loop.run_until(lambda: len(loop.running()) == 3,
                            "bind three pods and run them")
    (samples1, plan_s1) = _plan_seconds()
    if loop.cycles != 1 or _plans_total() - plans0 != 1 \
            or samples1 - samples0 != 1:
        fail(f"{loop.cycles} plan cycles ran ({_plans_total() - plans0} "
             f"counted), not one")
    node = loop.node()
    annots = node.metadata.annotations
    spec = annots.get(C.spec_plan_annotation(C.MPS_KIND), "")
    cm = loop.configmap()
    if list(cm.data) != [config_key(CARD_NODE, spec)]:
        fail(f"the ConfigMap holds {list(cm.data)}, not one key for "
             f"{CARD_NODE} under its plan {spec!r}")
    config = json.loads(cm.data[config_key(CARD_NODE, spec)])
    resources = config["sharing"]["mps"]["resources"]
    res = f"{C.RESOURCE_TIMESHARE_PREFIX}{share}"
    if [(r["rename"], r["memoryGB"], r["replicas"], r["devices"])
            for r in resources] != [(res, CARD_SHARE_GB, 3, ["0"])]:
        fail(f"the config gives GPU 0 {resources}, not three "
             f"{CARD_SHARE_GB} GB replicas")
    advertised = {r: q for r, q in node.status.allocatable.items()
                  if r.startswith(C.RESOURCE_TIMESHARE_PREFIX)}
    if advertised != {res: 3.0}:
        fail(f"the plugin advertises {advertised}, not {res}: 3")
    status = annots.get(C.status_plan_annotation(C.MPS_KIND), "")
    if not spec or status != spec:
        fail(f"the handshake is open: status plan {status!r}, spec {spec!r}")
    if loop.status(0, share, "used") != "3":
        fail(f"the reporter shows GPU 0 {share}-used "
             f"{loop.status(0, share, 'used')!r}, not 3")
    pods = loop.pods()
    (left,) = [n for n in pods if n not in loop.running()]
    if pods[left].status.phase != "Pending" or pods[left].spec.node_name \
            or not pods[left].is_unschedulable():
        fail(f"{left} is {pods[left].status}, not pending and "
             f"Unschedulable")
    landed, latency_s = _actuation_latency()
    if landed - landed0 != 1:
        fail(f"{landed - landed0} nos_tpu_actuation_latency_seconds "
             f"samples, not one")
    actuation = (latency_s - latency_s0) * 1e3

    # one rescan interval on: a cycle on the fourth pod that writes nothing
    written = loop.written()
    rescan_s = loop.run_until(lambda: loop.cycles == 2,
                              "run its rescan cycle")
    samples2, plan_s2 = _plan_seconds()
    if loop.written() != written:
        fail(f"the rescan cycle wrote: {written} -> {loop.written()}")
    from nos_tpu_torch.exporter.metrics import REGISTRY
    if REGISTRY.value("nos_tpu_plan_pending_pods",
                      {"kind": C.MPS_KIND}) != 1.0:
        fail("the rescan cycle did not plan for the fourth pod")

    # each bound pod's grant: a GPU of the applied config on which the
    # reporter shows a used share of the pod's size (one pod per used
    # share), mapped to the card's UUID through discovery, and the GB of
    # its request; the smoke stands in for the kubelet plugin's
    # Allocate, which would hand the pod this grant
    gpus = loop.agent.plugin.gpu_config(annots[C.ANNOT_PLUGIN_APPLIED_CONFIG])
    used = {s: [i for i in sorted(gpus)
                for _ in range(int(loop.status(i, s, "used") or 0))]
            for t in gpus.values() for s in t}
    grants = []
    for name in loop.running():
        (gb,) = extract_timeshare_requests(pod_request(pods[name]))
        if not used.get(f"{gb}gb"):
            fail(f"the reporter shows no used {gb}gb share for {name}")
        index = used[f"{gb}gb"].pop(0)
        grants.append({"pod": name, "gpu": index, "env": {
            "NOS_TPU_VISIBLE_CHIPS": device["uuids"][index],
            "NOS_TPU_TIMESHARE_GB": str(gb)}})
    fields = {
        "node": CARD_NODE, "model": loop.model.name, "pods": CARD_PODS,
        "share_gb": CARD_SHARE_GB, "batch_idle_s": CARD_BATCH_IDLE_S,
        "batch_timeout_s": CARD_BATCH_TIMEOUT_S,
        "running": loop.running(), "unschedulable": left,
        "config_keys": len(cm.data), "config": resources,
        "advertised": advertised, "plan_cycles": loop.cycles,
        "plan_cycle_ms": [(plan_s1 - plan_s0) * 1e3,
                          (plan_s2 - plan_s1) * 1e3],
        "actuation_latency_ms": actuation, "bind_s": bind_s,
        "rescan_s": rescan_s,
        "grants": [{"pod": g["pod"], "gpu": g["gpu"],
                    "gb": int(g["env"]["NOS_TPU_TIMESHARE_GB"])}
                   for g in grants]}
    return loop, fields, grants


def _actuation_latency() -> tuple[int, float]:
    """The count and sum of nos_tpu_actuation_latency_seconds."""
    from nos_tpu_torch.api import constants as C
    from nos_tpu_torch.exporter.metrics import REGISTRY

    got = REGISTRY.summary("nos_tpu_actuation_latency_seconds",
                           {"kind": C.MPS_KIND, "pool": "-"})
    return (0, 0.0) if got is None else got[:2]


def _card_release(loop: _CardLoop) -> dict:
    """Phase 9 (b) after the children: their pods marked Succeeded (as
    the kubelet would report them), the reporter must free the three
    shares, and the binder must bind the fourth pod onto one with no new
    plan."""
    from nos_tpu_torch.kube.client import KIND_POD

    share = f"{CARD_SHARE_GB}gb"
    done = loop.running()
    for name in done:
        loop.api.patch(KIND_POD, name, "default", mutate=lambda p:
                       setattr(p.status, "phase", "Succeeded"))
    loop.tick()
    freed = (loop.status(0, share, "free"), loop.status(0, share, "used"))
    if freed != ("3", None):
        fail(f"after the children the reporter shows GPU 0 {share} "
             f"(free, used) {freed}, not 3 free")
    written, cycles, plans = loop.written(), loop.cycles, _plans_total()
    if loop.bind() != 1:
        fail("the binder did not bind the fourth pod onto a freed share")
    loop.process()
    loop.tick()
    (last,) = loop.running()
    if loop.written() != written or loop.cycles != cycles \
            or _plans_total() != plans:
        fail("binding the fourth pod took a new plan")
    if loop.status(0, share, "used") != "1":
        fail(f"the reporter shows GPU 0 {share}-used "
             f"{loop.status(0, share, 'used')!r} after the fourth pod")
    return {"succeeded": done, "rebound": last,
            "free_used_after_children": freed}


def _step_windows(children: list[dict]) -> tuple[list[list[float]], float]:
    """Each child's window on the host's wall clock, from the start of
    its first step to the log line of its last (the main logs a step
    after its loss has come back from the card), relative to the
    earliest start; and how long all the windows held at once.  The
    first step's start is its log line less the step's tokens over its
    logged tokens/s."""
    from nos_tpu_torch.entry import TRAIN_BATCH, TRAIN_SEQ

    spans = []
    for ch in children:
        (first, t_first, tokens_s), last = ch["stamps"][0], ch["stamps"][-1]
        if first != 1 or last[0] != GRANT_STEPS:
            fail(f"partition {ch['case']} logged step times {ch['stamps']}")
        spans.append((t_first - TRAIN_BATCH * TRAIN_SEQ / tokens_s, last[1]))
    origin = min(a for a, _ in spans)
    overlap = min(b for _, b in spans) - max(a for a, _ in spans)
    return [[a - origin, b - origin] for a, b in spans], overlap


def phase_partition(main_loss0: float, device: dict, smi: str) -> dict:
    """The MPS planner and its loop: (a) the fleet plan on the host, five
    timed runs against the pinned digest; (b) the card's node driven by
    the partitioner controller, its chip agent (timeshare plugin and
    reporter) and the test binder (``_card_loop``), then one
    ``python -m nos_tpu_torch.cmd.train`` child per bound pod, all at
    once, each under the grant derived from the applied config and the
    pod's request, then the pods' release (``_card_release``).  The smoke
    stands in for the kubelet plugin's Allocate (ROADMAP item 24b),
    which would hand each pod its grant."""
    from nos_tpu_torch.ops import _build

    t0 = time.perf_counter()
    fleet_line = _fleet_plans()
    loop, card, grants = _card_loop(device)
    total = device["memory_bytes"]
    kernels_before = sorted(p.name for p in _build.KERNEL_DIR.iterdir())
    _release()
    parent_reserved = torch.cuda.memory_reserved()
    with tempfile.TemporaryDirectory(prefix="nos-partition-") as tmp:
        cfg_path, no_nvcc = _grant_workdir(tmp)
        t1 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(grants)) as pool:
            children = list(pool.map(
                lambda g: _run_grant_child(g["pod"], cfg_path, g["env"],
                                           no_nvcc), grants))
        concurrent_s = time.perf_counter() - t1
    kernels_after = sorted(p.name for p in _build.KERNEL_DIR.iterdir())
    if kernels_after != kernels_before:
        fail(f"a partition child built kernels: {kernels_before} -> "
             f"{kernels_after}")
    for child in children:
        child["fraction"], child["cap_bytes"] = _grant_cap(
            int(child["grant"]["NOS_TPU_TIMESHARE_GB"]), total)
        _check_granted_child(f"partition {child['case']}", child,
                             child["grant"]["NOS_TPU_VISIBLE_CHIPS"],
                             main_loss0)
    windows, overlap_s = _step_windows(children)
    if not overlap_s > 0:
        fail(f"the children's steps did not overlap: windows {windows} s "
             f"from the first start")
    for child, window in zip(children, windows):
        child["step_window_s"] = window
    # implied by the caps each child was held to (3 x 24 / 80 x 0.9 of
    # the card): kept as the sum a reader of the line looks for
    reserved = sum(ch["peak_reserved_bytes"] for ch in children)
    if not reserved < total:
        fail(f"the three children reserved {reserved} B at their peaks, "
             f"not under the card's {total} B")
    card["release"] = _card_release(loop)
    card["tick_ms_median"] = statistics.median(loop.tick_ms)
    card["tick_ms_max"] = max(loop.tick_ms)
    card["ticks"] = len(loop.tick_ms)
    card["bound_ms"] = dict(sorted(loop.bound_ms.items()))
    emit({"phase": "partition", "nvidia_smi": smi,
          "seconds": time.perf_counter() - t0,
          "fleet": fleet_line, "card": card,
          "card_memory_bytes": total, "parent_reserved_bytes":
              parent_reserved, "main_loss0": main_loss0,
          "loss0_rtol": MAIN_LOSS0_RTOL, "concurrent_wall_s": concurrent_s,
          "steps_overlap_s": overlap_s,
          "peak_reserved_sum_bytes": reserved,
          "peak_allocated_sum_bytes": sum(ch["peak_bytes"]
                                          for ch in children),
          "children": [{k: v for k, v in ch.items()
                        if k not in ("stderr", "report", "stamps")}
                       | {"launches": ch["report"]["launches"]}
                       for ch in children]})
    return {ch["case"]: ch["report"]["launches"] for ch in children}


def main() -> int:
    if len(sys.argv) > 1:
        fail("chip_smoke.py takes no arguments")
    if not torch.cuda.is_available():
        fail("no CUDA device: the smoke runs on the card only")
    smi = phase_env()
    device = phase_device()
    resources = phase_build()
    with tempfile.TemporaryDirectory(prefix="nos-no-cache-") as empty:
        _no_measured_cache(empty)
        entries = phase_kernels(resources)
        phase_autotune()
        # serve, train, train_main and moe see the committed PRETUNED only
        _no_measured_cache(empty)
        serve = phase_serve()
        train, loss0 = phase_train()
        train_main, main_loss0 = phase_train_main(loss0)
        moe = phase_moe()
        # the grant and partition children see the same PRETUNED-only
        # cache
        phase_grant(main_loss0, device)
        phase_partition(main_loss0, device, smi)
    paths = {"serve": serve, "train": train, "train_main": train_main,
             "moe": moe}
    for entry in entries:
        name = entry["name"]
        kernel = TILES[name][0]
        entry["launches_by_path"] = {p: PATH_TILES[p][name] for p in paths}
        entry["launches"] = sum(entry["launches_by_path"].values())
        entry["launches_autotune"] = PATH_TILES["autotune"][name]
        # every kernel runs on the main path at one tile or another
        if not sum(paths[p][kernel] for p in paths) > 0:
            fail(f"{kernel} was not launched on the main path")
        if not (entry["launches"] > 0 or entry["launches_autotune"] > 0):
            fail(f"{name} was launched neither on the main path nor by "
                 f"the autotune phase")
    for p, counts in paths.items():
        by_tile = {k: sum(PATH_TILES[p][n] for n, (kk, _, _) in
                          TILES.items() if kk == k) for k in counts}
        if by_tile != counts:
            fail(f"the {p} phase's launches by tile {PATH_TILES[p]} do not "
                 f"add up to its launches {counts}")
    emit({"kernels": entries})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
