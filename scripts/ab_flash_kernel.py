"""Time a changed copy of one of the port's flash kernels against the
committed kernel on one card.

    python3 scripts/ab_flash_kernel.py VARIANT.cu [VARIANT.cu ...]

A variant is a copy of a source in ``nos_tpu_torch/ops/csrc/`` with a
change; it keeps its C entry points (``nos_flash_fwd``, ``nos_flash_bwd``,
``nos_flash_dq``, ``nos_flash_dkv``).  A header beside the variant takes
the place of the package's header of that name; the others come from
``csrc/``.  Each variant is built by ``_build.build_file`` (the package's
nvcc flags) and, for each entry point it exports, checked against the
plain version at S 129 (causal and not) and at the training shape (B 8,
S 2048, H 8, causal) with chip_smoke.py's tolerances, then timed against
the committed kernel in turns (committed, variant, variant, committed)
at the training shape, and for the forward also at B 8 S 512 (serving)
and B 8 S 1024.  One JSON line per variant and entry point, after
chip_smoke.py's env line (the card's name and power limit).
"""

from __future__ import annotations

import contextlib
import ctypes
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as C  # noqa: E402
from nos_tpu_torch.ops import _build  # noqa: E402
from nos_tpu_torch.ops import attention as A  # noqa: E402

# The backward entry points and chip_smoke.py's names for their kernels.
_BWD = {"nos_flash_bwd": "flash_bwd_fused", "nos_flash_dq": "flash_dq",
        "nos_flash_dkv": "flash_dkv"}
_FWD_SHAPES = (("serving", 8, 512, 8), ("S1024", 8, 1024, 8))


def entries_of(lib: ctypes.CDLL) -> dict[str, object]:
    fns = {}
    for name in A._ARGTYPES:
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = A._ARGTYPES[name]
            fn.restype = ctypes.c_int
            fns[name] = fn
    if not fns:
        C.fail("a variant exports none of the flash entry points")
    return fns


@contextlib.contextmanager
def using(name: str, fn):
    """The wrappers launch ``fn`` for ``name`` inside the block."""
    committed = A._c_fn(name)
    A._C_FNS[name] = fn
    try:
        yield
    finally:
        A._C_FNS[name] = committed


def errors(name: str, gen) -> float:
    """The largest error over the checked cases, in chip_smoke's measure
    (o: max abs; gradients: max abs over max |plain|); fails past the
    tolerance."""
    worst = 0.0
    for b, s, h, causal in ((2, 129, 4, True), (2, 129, 4, False),
                            (8, 2048, 8, True)):
        args = C._bwd_inputs(gen, b, s, h, causal)
        if name == "nos_flash_fwd":
            o_err, lse_err = C._errors(*args[:3], causal)
            if not (o_err <= C.O_TOL and lse_err <= C.LSE_TOL):
                C.fail(f"forward variant: o {o_err}, lse {lse_err}")
            worst = max(worst, o_err)
            continue
        kernel = _BWD[name]
        fn, plain, *_ = C._bwd_kernels()[kernel]
        got, want = fn(*args, causal), plain(*args, causal)
        err = max(C._rel_err(g, w) for g, w in zip(got, want))
        if not err <= C.GRAD_TOL:
            C.fail(f"{kernel} variant: {err} of max |plain|")
        worst = max(worst, err)
    return worst


def timings(name: str, variant, gen) -> dict:
    shapes = [("training", 8, 2048, 8)]
    if name == "nos_flash_fwd":
        shapes += _FWD_SHAPES
    out = {}
    for label, b, s, h in shapes:
        args = C._bwd_inputs(gen, b, s, h, True)
        if name == "nos_flash_fwd":
            call = lambda: A.flash_attention_fwd(*args[:3], True)  # noqa: E731
        else:
            fn = C._bwd_kernels()[_BWD[name]][0]
            call = lambda: fn(*args, True)  # noqa: E731
        runs = {"committed": [], "variant": []}
        for side in ("committed", "variant", "variant", "committed"):
            if side == "committed":
                runs[side].append(C.time_ms(call, inner=5, samples=10))
                continue
            with using(name, variant):
                runs[side].append(C.time_ms(call, inner=5, samples=10))
        out[label] = runs
    return out


def main() -> int:
    if len(sys.argv) < 2:
        C.fail("usage: ab_flash_kernel.py VARIANT.cu [VARIANT.cu ...]")
    if not torch.cuda.is_available():
        C.fail("no CUDA device: the A/B runs on the card only")
    C.phase_env()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for src in map(Path, sys.argv[1:]):
        path, ptxas = _build.build_file(src)
        for name, variant in entries_of(ctypes.CDLL(str(path))).items():
            with using(name, variant):
                err = errors(name, gen)
            C.emit({"variant": str(src), "entry": name,
                    "ptxas": _build.ptxas_resources(ptxas), "max_err": err,
                    "ms": timings(name, variant, gen)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
