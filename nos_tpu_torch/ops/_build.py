"""Build and load the port's CUDA kernels and its host C++ shim.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface, loaded with ``ctypes``.  Nothing is
built at import: the first ``load(name)`` (or an explicit ``build()``)
compiles what is missing.  Libraries go to ``nos_tpu_torch/_kernels/``
under a name that carries a hash of the sources and flags, so an edited
source is never served by a stale library.  An exclusive ``flock`` on
``_kernels/build.lock`` keeps two processes from building at once.

``build_host(name)`` compiles ``nos_tpu_torch/native/<name>.cc``, host
code with no device part, with the host compiler (``$CXX``, else
``g++``) the same way: hashed name, same directory, same lock.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
NATIVE = Path(__file__).resolve().parent.parent / "native"
KERNEL_DIR = Path(__file__).resolve().parent.parent / "_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
HOST_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17", "-Wall")

_LIBS: dict[str, ctypes.CDLL] = {}

_PTXAS_KEEP = ("Compiling entry function", "registers", "spill", "warning")
_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_REGISTERS = re.compile(r"Used (\d+) registers")
_SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def sources() -> list[str]:
    """Names of the kernel sources in ``csrc/`` (``flash_fwd`` for
    ``csrc/flash_fwd.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _digest(paths, flags=NVCC_FLAGS) -> str:
    h = hashlib.sha256()
    for path in paths:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"no kernel source {src}")
    digest = _digest([src, *sorted(CSRC.glob("*.cuh"))])
    return KERNEL_DIR / f"lib{name}-{digest}.so"


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


def _start(src: Path, out: Path) -> tuple[Path, subprocess.Popen]:
    """Start nvcc on ``src`` into a temporary file beside ``out``.  The
    package's headers are found through ``-I csrc/``; a header beside
    ``src`` comes first, as ``#include "..."`` searches there."""
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
    return tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def _finish(tmp: Path, proc: subprocess.Popen, out: Path) -> list[str]:
    """Wait for ``_start``'s nvcc; on success move the library to ``out``
    and return ptxas's lines.  Raises RuntimeError with the compiler
    output if the build failed."""
    text, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"(exit {proc.returncode}):\n{text}")
    os.replace(tmp, out)
    return [ln.strip() for ln in text.splitlines()
            if any(key in ln for key in _PTXAS_KEEP)]


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
            t0 = time.perf_counter()
            procs = {n: _start(CSRC / f"{n}.cu", path)
                     for n, path in todo.items()}
            failures = []
            for n, (tmp, proc) in procs.items():
                try:
                    report[n] = {"cached": False,
                                 "ptxas": _finish(tmp, proc, todo[n])}
                except RuntimeError as e:
                    failures.append(f"{n}.cu {e}")
            seconds = time.perf_counter() - t0
            if failures:
                raise RuntimeError("nvcc failed for " + "\n".join(failures))
            for n in todo:
                report[n]["seconds"] = seconds
    return report


def build_file(src: Path) -> tuple[Path, list[str]]:
    """Compile one source from outside ``csrc/`` (a changed copy of a
    kernel, with any changed header beside it) as ``build`` compiles the
    package's own.  Returns the library and ptxas's lines (empty where
    the library was cached)."""
    src = Path(src).resolve()
    headers = sorted({p.name: p for p in (*CSRC.glob("*.cuh"),
                                          *src.parent.glob("*.cuh"))}.values())
    out = KERNEL_DIR / f"lib{src.stem}-file-{_digest([src, *headers])}.so"
    KERNEL_DIR.mkdir(parents=True, exist_ok=True)
    with open(KERNEL_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out, []
        try:
            return out, _finish(*_start(src, out), out)
        except RuntimeError as e:
            raise RuntimeError(f"nvcc failed for {src} {e}") from None


def ptxas_resources(lines: list[str]) -> dict[str, dict]:
    """Per kernel (its mangled name), the registers and spill bytes that
    ``ptxas -v`` reported in ``lines`` (a build report's ``ptxas``)."""
    kernels: dict[str, dict] = {}
    current = None
    for line in lines:
        entry = _ENTRY.search(line)
        if entry:
            current = kernels.setdefault(entry.group(1), {
                "registers": None, "spill_stores": None, "spill_loads": None})
            continue
        if current is None:
            continue
        regs = _REGISTERS.search(line)
        if regs:
            current["registers"] = int(regs.group(1))
        spills = _SPILLS.search(line)
        if spills:
            current["spill_stores"] = int(spills.group(1))
            current["spill_loads"] = int(spills.group(2))
    return kernels


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


def host_compiler() -> str:
    """The host C++ compiler: ``$CXX``, else ``g++``."""
    return os.environ.get("CXX") or "g++"


def host_library_path(name: str) -> Path:
    src = NATIVE / f"{name}.cc"
    if not src.is_file():
        raise FileNotFoundError(f"no host source {src}")
    return KERNEL_DIR / f"lib{name}-{_digest([src], HOST_FLAGS)}.so"


def build_host(name: str) -> dict:
    """Compile ``native/<name>.cc`` with the host compiler unless its
    library exists.  Returns whether it came from the cache, the wall
    seconds of the build and the library's path.  Raises RuntimeError
    with the compiler's output if the build fails or the compiler is
    missing."""
    out = host_library_path(name)
    KERNEL_DIR.mkdir(parents=True, exist_ok=True)
    with open(KERNEL_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return {"cached": True, "seconds": 0.0, "path": out}
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [host_compiler(), *HOST_FLAGS, "-o", str(tmp),
               str(NATIVE / f"{name}.cc")]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"{cmd[0]} failed for {name}.cc: {e}") from None
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"{cmd[0]} failed for {name}.cc (exit {proc.returncode}):\n"
                f"{proc.stderr}{proc.stdout}")
        os.replace(tmp, out)
        return {"cached": False, "seconds": time.perf_counter() - t0,
                "path": out}


def host_compiler_version() -> str:
    """The first line of the host compiler's ``--version``."""
    proc = subprocess.run([host_compiler(), "--version"],
                          capture_output=True, text=True, check=True)
    return proc.stdout.splitlines()[0].strip()
