"""The native scheduling shim's bindings, ``nos_tpu/device/native.py``
for the port.

``native/gpu_shim.cc`` is host C++ with a plain C interface: the batch
Filter screen (``nos_fit_batch``), the Score argmin
(``nos_score_batch``) with its sorted window-busy table
(``nos_window_busy``), the preemption walk's empty-node screen
(``nos_victim_prescreen``) and a GIL handshake.  It is compiled with the
host compiler at the first ``load()`` into ``nos_tpu_torch/_kernels/``
(``ops/_build.py`` ``build_host``) and bound with ``ctypes.CDLL``, which
releases the GIL for each call, so plan shards screening at once overlap
inside the shim.

A failed build raises ``NativeBuildError`` with the compiler's output,
and the functions raise ``ValueError`` where the shim refuses its
arguments: nothing falls back to Python quietly.  The Python rules
(``NodeResourcesFit.filter``, ``Scheduler._score_key``,
``capacityscheduling._fits_empty``) stay the reference; a caller runs
them only where it asks for them by name.

Not ported: the JAX package's ``NativeTpuRuntime`` (the port's device
table is NVML, ``device/nvml.py``), its packer seam (``nos_pack``) and
its ``make`` build; ``gpu_shim.cc``'s header says why.
"""

from __future__ import annotations

import ctypes
import threading

from nos_tpu_torch.ops import _build

SHIM = "gpu_shim"
# Bits 63 and 62 of a nos_fit_batch miss mask flag the compute-slice and
# memory-slot guards; resource indices take bits 0..61.
FIT_MISS_COMPUTE_GUARD = 1 << 63
FIT_MISS_MEMORY_GUARD = 1 << 62
FIT_MAX_RESOURCES = 62

_lib: ctypes.CDLL | None = None
_build_report: dict | None = None
_load_lock = threading.Lock()


class NativeBuildError(RuntimeError):
    """The shim did not build or load; the message carries the
    compiler's output."""


def _bind(path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    dbl = ctypes.POINTER(ctypes.c_double)
    ll = ctypes.POINTER(ctypes.c_longlong)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.nos_fit_batch.restype = ctypes.c_int
    lib.nos_fit_batch.argtypes = [
        dbl, dbl, dbl, dbl, dbl, dbl, dbl, dbl,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        u8, ctypes.POINTER(ctypes.c_uint64)]
    lib.nos_window_busy.restype = ctypes.c_int
    lib.nos_window_busy.argtypes = [ll, ll, u8, ctypes.c_longlong]
    lib.nos_score_batch.restype = ctypes.c_int
    lib.nos_score_batch.argtypes = [
        u8, dbl, ll, ll, ll, ll, ll, ll, ll, ll, u8,
        ctypes.c_longlong, ctypes.c_longlong, ll]
    lib.nos_victim_prescreen.restype = ctypes.c_int
    lib.nos_victim_prescreen.argtypes = [
        dbl, dbl, ll, ll, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, u8]
    lib.nos_gil_handshake.restype = ctypes.c_int
    lib.nos_gil_handshake.argtypes = [ll, ctypes.c_double]
    return lib


def load() -> ctypes.CDLL:
    """The bound shim, built on first use.  Raises NativeBuildError if
    it does not build or load."""
    global _lib, _build_report
    lib = _lib
    if lib is not None:
        return lib
    with _load_lock:
        if _lib is None:
            try:
                report = _build.build_host(SHIM)
                _lib = _bind(report["path"])
            except (RuntimeError, OSError, AttributeError) as e:
                raise NativeBuildError(
                    f"the native scheduling shim did not build: {e}") from e
            _build_report = report
        return _lib


def build_report() -> dict:
    """How ``load()`` got the library: {cached, seconds, path}."""
    load()
    assert _build_report is not None
    return dict(_build_report)


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise ValueError(f"{name} refused its arguments (rc {rc})")


def _sized(name: str, arrays, n: int) -> None:
    """Every array holds at least ``n`` entries: the shim reads that
    many through the pointer."""
    for arr in arrays:
        if len(arr) < n:
            raise ValueError(f"{name}: an array of {len(arr)} entries "
                             f"where {n} are read")


def fit_batch_raw(free_arr, req_arr, cap_g, used_g, cap_m, used_m,
                  class_g, class_m, n_nodes: int, n_classes: int,
                  n_res: int, out_arr, miss_arr=None) -> None:
    """nos_fit_batch on ctypes arrays the caller built (and reuses): the
    planner marshals its classes once a plan and one node row a
    candidate.  Raises ValueError where an array is short or the shim
    refuses the arguments."""
    if min(n_nodes, n_classes, n_res) >= 0:
        _sized("nos_fit_batch", (free_arr,), n_nodes * n_res)
        _sized("nos_fit_batch", (req_arr,), n_classes * n_res)
        _sized("nos_fit_batch", (cap_g, used_g, cap_m, used_m), n_nodes)
        _sized("nos_fit_batch", (class_g, class_m), n_classes)
        _sized("nos_fit_batch", (out_arr,) if miss_arr is None
               else (out_arr, miss_arr), n_nodes * n_classes)
    _check(load().nos_fit_batch(free_arr, req_arr, cap_g, used_g, cap_m,
                                used_m, class_g, class_m, n_nodes,
                                n_classes, n_res, out_arr, miss_arr),
           "nos_fit_batch")


def _doubles(values) -> ctypes.Array:
    values = list(values)
    return (ctypes.c_double * max(1, len(values)))(*values)


def fit_batch(free_flat, req_flat, cap_g, used_g, cap_m, used_m,
              class_g, class_m, n_nodes: int, n_classes: int, n_res: int,
              want_miss: bool = True) -> tuple[bytes, list[int] | None]:
    """N nodes x M classes of NodeResourcesFit's verdicts.  Per node
    ``cap_g, used_g, cap_m, used_m`` (compute slices, memory slots), per
    class ``class_g, class_m``; ``free_flat`` and ``req_flat`` a row a
    node and a class over one resource order.  Returns the verdict bytes
    (``[i * n_classes + j] == 1``: class j fits node i) and the miss
    masks (resource indices as bits, FIT_MISS_COMPUTE_GUARD,
    FIT_MISS_MEMORY_GUARD)."""
    cells = n_nodes * n_classes
    out = (ctypes.c_uint8 * max(1, cells))()
    miss = (ctypes.c_uint64 * max(1, cells))() if want_miss else None
    fit_batch_raw(_doubles(free_flat), _doubles(req_flat), _doubles(cap_g),
                  _doubles(used_g), _doubles(cap_m), _doubles(used_m),
                  _doubles(class_g), _doubles(class_m), n_nodes, n_classes,
                  n_res, out, miss)
    return bytes(out[:cells]), (list(miss[:cells])
                                if miss is not None else None)


def window_busy_sort(gid_arr, idx_arr, val_arr, n: int) -> None:
    """Sort the n (group id, host index, busy) triples of the window-busy
    table in place, lexicographically: ``sorted()`` of them, in one
    call."""
    if n > 0:
        _sized("nos_window_busy", (gid_arr, idx_arr, val_arr), n)
    _check(load().nos_window_busy(gid_arr, idx_arr, val_arr, n),
           "nos_window_busy")


def score_batch(avoided, headroom, gids, widx, hidx, rank, wsizes, woff,
                busy_gid, busy_idx, busy_val, n: int, m: int) -> int:
    """nos_score_batch over n marshalled candidates and an m-entry
    sorted window table: the index of the least score tuple."""
    if n > 0 and m >= 0:
        _sized("nos_score_batch", (avoided, headroom, gids, widx, hidx,
                                   rank), n)
        _sized("nos_score_batch", (woff,), n + 1)
        _sized("nos_score_batch", (wsizes,), max(
            (woff[i + 1] for i in range(n) if gids[i] >= 0), default=0))
        _sized("nos_score_batch", (busy_gid, busy_idx, busy_val), m)
    out = ctypes.c_longlong(-1)
    _check(load().nos_score_batch(avoided, headroom, gids, widx, hidx, rank,
                                  wsizes, woff, busy_gid, busy_idx, busy_val,
                                  n, m, ctypes.byref(out)),
           "nos_score_batch")
    if not 0 <= out.value < n:
        raise ValueError(f"nos_score_batch chose {out.value} of {n}")
    return out.value


def victim_prescreen(alloc_rows, req, cap_g, cap_m, pod_g: int,
                     pod_m: int) -> list[bool]:
    """Per node, whether the request fits it with no pod on it:
    ``alloc_rows`` a row a node over ``req``'s resources, the node's
    compute slices ``cap_g`` and memory slots ``cap_m``, the request's
    ``pod_g`` and ``pod_m``."""
    n, n_res = len(alloc_rows), len(req)
    if any(len(row) != n_res for row in alloc_rows) \
            or len(cap_g) != n or len(cap_m) != n:
        raise ValueError("nos_victim_prescreen: a row or a cap list of "
                         "the wrong length")
    flat = [v for row in alloc_rows for v in row]
    out = (ctypes.c_uint8 * max(1, n))()
    _check(load().nos_victim_prescreen(
        _doubles(flat), _doubles(req),
        (ctypes.c_longlong * max(1, n))(*cap_g),
        (ctypes.c_longlong * max(1, n))(*cap_m),
        pod_g, pod_m, n, n_res, out), "nos_victim_prescreen")
    return [bool(v) for v in out[:n]]


def gil_handshake(timeout_s: float = 30.0) -> list[int]:
    """Two threads in ``nos_gil_handshake`` at once: each returns 1 only
    if both were inside the shim together, which needs the binding to
    release the GIL for the call."""
    lib = load()
    cell = (ctypes.c_longlong * 1)()
    results = [-1, -1]

    def enter(i: int) -> None:
        results[i] = lib.nos_gil_handshake(cell, timeout_s)

    threads = [threading.Thread(target=enter, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results
