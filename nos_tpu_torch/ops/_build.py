"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface, loaded with ``ctypes``.  Nothing is
built at import: the first ``load(name)`` (or an explicit ``build()``)
compiles what is missing.  Libraries go to ``nos_tpu_torch/_kernels/``
under a name that carries a hash of the sources and flags, so an edited
source is never served by a stale library.  An exclusive ``flock`` on
``_kernels/build.lock`` keeps two processes from building at once.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
KERNEL_DIR = Path(__file__).resolve().parent.parent / "_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of the kernel sources in ``csrc/`` (``flash_fwd`` for
    ``csrc/flash_fwd.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"no kernel source {src}")
    h = hashlib.sha256()
    for path in (src, *sorted(CSRC.glob("*.cuh"))):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return KERNEL_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").is_file():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: set CUDA_HOME or put nvcc on PATH to build "
            "the CUDA kernels")
    return found


def build(names: list[str] | None = None) -> dict[str, dict]:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together.  Returns, per name, whether the
    library came from the cache, the wall seconds of the build and the
    compiler's resource report (``-Xptxas=-v``).  Raises RuntimeError
    with the compiler output if any build fails."""
    names = sources() if names is None else names
    KERNEL_DIR.mkdir(parents=True, exist_ok=True)
    report: dict[str, dict] = {}
    with open(KERNEL_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        todo = {n: library_path(n) for n in names}
        todo = {n: p for n, p in todo.items() if not p.exists()}
        for n in names:
            if n not in todo:
                report[n] = {"cached": True, "seconds": 0.0, "ptxas": []}
        if todo:
            nvcc = _nvcc()
            t0 = time.perf_counter()
            procs = {}
            for n, path in todo.items():
                tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
                procs[n] = (tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            failures = []
            for n, (tmp, proc) in procs.items():
                out, _ = proc.communicate()
                if proc.returncode != 0:
                    failures.append(f"{n}.cu (exit {proc.returncode}):\n{out}")
                    tmp.unlink(missing_ok=True)
                    continue
                os.replace(tmp, todo[n])
                report[n] = {
                    "cached": False,
                    "ptxas": [ln.strip() for ln in out.splitlines()
                              if "registers" in ln or "spill" in ln],
                }
            seconds = time.perf_counter() - t0
            if failures:
                raise RuntimeError("nvcc failed for " + "\n".join(failures))
            for n in todo:
                report[n]["seconds"] = seconds
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib
