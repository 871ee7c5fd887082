"""The native batch fit screen for the Filter hot loop,
``nos_tpu/scheduler/native_filter.py`` for the port.

The scheduler's cycle and the planner's what-ifs run the Filter
pipeline per (pod equivalence class, node); at fleet size nearly every
verdict is a plain resource comparison.  ``FitPrescreen`` makes that
comparison for many nodes or classes in one call into the shim
(``native/gpu_shim.cc`` ``nos_fit_batch``), which releases the GIL.

It never decides on its own:

- the shim replays ``NodeResourcesFit.filter`` on the same numbers:
  each requested resource against the free one, then, where all fit,
  the compute-slice guard and then the memory-slot guard.  A native
  fail is exactly a NodeResourcesFit fail;
- a chain holding the plain ``NodeResourcesFit`` fails wherever it
  fails, so native fails may be recorded without running the pipeline
  (``verdict_sound``: the planner's use);
- where ``NodeResourcesFit`` also runs first, the pipeline's failure on
  such a node is NodeResourcesFit's own, and its message is rebuilt
  from the miss mask byte for byte (``message_exact``: the scheduler's
  use, whose journal and explain output keep their text);
- a native pass decides nothing: the pipeline runs there.

The memory guard reads the node's GPU model from its accelerator label,
as ``NodeResourcesFit`` does; a node of no known model is held to its
compute slices alone, here as there.  ``CompiledClasses`` marshals a
plan's classes once, so a candidate node costs one free row and one
call.
"""

from __future__ import annotations

import ctypes

from nos_tpu_torch.api.constants import LABEL_ACCELERATOR
from nos_tpu_torch.device import native
from nos_tpu_torch.kube.resources import ResourceList
from nos_tpu_torch.topology.known import DEFAULT_REGISTRY, GpuModel

from .framework import Framework, NodeInfo, NodeResourcesFit, _mig_slots


def node_model(ni: NodeInfo) -> GpuModel | None:
    """The node's GPU model, as ``NodeResourcesFit`` reads it."""
    return DEFAULT_REGISTRY.models.get(
        ni.node.metadata.labels.get(LABEL_ACCELERATOR, ""))


def node_guards(ni: NodeInfo, model: GpuModel | None
                ) -> tuple[int, int, int, int]:
    """(cap_g, used_g, cap_m, used_m): the node's carved and held compute
    slices and memory slots."""
    cap_g, cap_m = _mig_slots(ni.allocatable, model)
    used_g, used_m = _mig_slots(ni.requested, model)
    return cap_g, used_g, cap_m, used_m


class CompiledClasses:
    """A plan's classes marshalled once with scratch buffers.  Not
    thread-safe: each plan shard compiles its own."""

    __slots__ = ("universe", "requests", "n", "n_res", "req_arr", "g_arr",
                 "any_g", "free_arr", "cap_g", "used_g", "cap_m", "used_m",
                 "out_arr", "_m_arrs")

    def __init__(self, universe: list[str],
                 requests: list[ResourceList]) -> None:
        self.universe = universe
        self.requests = requests
        self.n = len(requests)
        self.n_res = len(universe)
        req_flat = [float(request.get(name, 0.0))
                    for request in requests for name in universe]
        self.req_arr = (ctypes.c_double * max(1, len(req_flat)))(*req_flat)
        gs = [_mig_slots(request, None)[0] for request in requests]
        self.g_arr = (ctypes.c_double * self.n)(*gs)
        self.any_g = any(gs)
        self.free_arr = (ctypes.c_double * max(1, self.n_res))()
        self.cap_g = (ctypes.c_double * 1)()
        self.used_g = (ctypes.c_double * 1)()
        self.cap_m = (ctypes.c_double * 1)()
        self.used_m = (ctypes.c_double * 1)()
        self.out_arr = (ctypes.c_uint8 * self.n)()
        # memory slots per class depend on the node's model (keyed by
        # the registry's instance, as models compare by identity)
        self._m_arrs: dict[GpuModel | None, ctypes.Array] = {}

    def m_arr(self, model: GpuModel | None) -> ctypes.Array:
        arr = self._m_arrs.get(model)
        if arr is None:
            arr = (ctypes.c_double * self.n)(*[
                _mig_slots(request, model)[1] for request in self.requests])
            self._m_arrs[model] = arr
        return arr


class FitPrescreen:
    """The batch fit screen bound to one framework's Filter chain."""

    def __init__(self, framework: Framework) -> None:
        chain = framework.filter_chain
        self.verdict_sound = any(type(p) is NodeResourcesFit for p in chain)
        self.message_exact = bool(chain) and \
            type(chain[0]) is NodeResourcesFit

    # -- the planner: one node x the plan's classes, verdicts only -------
    def compile_classes(
            self, requests: list[ResourceList]) -> CompiledClasses | None:
        """The plan's class requests marshalled once; None where the
        screen cannot run (an unsound chain, no class, more resources
        than the miss mask holds)."""
        if not self.verdict_sound or not requests:
            return None
        universe = sorted({name for request in requests
                           for name, qty in request.items() if qty > 0})
        if len(universe) > native.FIT_MAX_RESOURCES:
            return None
        return CompiledClasses(universe, requests)

    def screen_compiled(self, node_info: NodeInfo,
                        compiled: CompiledClasses) -> list[bool]:
        """Per compiled class, whether it may fit the node (False: the
        pipeline fails there)."""
        free = node_info.free()
        for i, name in enumerate(compiled.universe):
            compiled.free_arr[i] = free.get(name, 0.0)
        model = None
        if compiled.any_g:
            model = node_model(node_info)
            (compiled.cap_g[0], compiled.used_g[0], compiled.cap_m[0],
             compiled.used_m[0]) = node_guards(node_info, model)
        native.fit_batch_raw(
            compiled.free_arr, compiled.req_arr, compiled.cap_g,
            compiled.used_g, compiled.cap_m, compiled.used_m,
            compiled.g_arr, compiled.m_arr(model), 1, compiled.n,
            compiled.n_res, compiled.out_arr)
        return [compiled.out_arr[j] == 1 for j in range(compiled.n)]

    # -- the scheduler: many nodes x one class, exact messages -----------
    def screen_nodes(
            self, node_infos: list[NodeInfo], request: ResourceList,
            guard_cache: dict[str, tuple[int, int, int, int]] | None = None,
    ) -> list[str | None] | None:
        """Per node, the memoised rejection ("NodeResourcesFit: ...")
        where the shim fails the request, None where it passes (the
        pipeline runs there).  None overall where the screen cannot run
        (not ``message_exact``, or more resources than the miss mask
        holds).  ``guard_cache`` (node name -> node_guards)
        carries the guards across the classes of a cycle; its owner
        drops a node's entry whenever the node's pods change."""
        if not self.message_exact:
            return None
        universe = sorted(name for name, qty in request.items() if qty > 0)
        if len(universe) > native.FIT_MAX_RESOURCES:
            return None
        pod_g = _mig_slots(request, None)[0]
        # one call per GPU model: the request's memory slots are the
        # model's
        groups: dict[GpuModel | None, list[int]] = {}
        guards: list[tuple[int, int, int, int]] = []
        free_rows: list[list[float]] = []
        for i, ni in enumerate(node_infos):
            free = ni.free()
            free_rows.append([free.get(name, 0.0) for name in universe])
            model = node_model(ni) if pod_g else None
            groups.setdefault(model, []).append(i)
            if not pod_g:
                guards.append((0, 0, 0, 0))
                continue
            cached = guard_cache.get(ni.name) if guard_cache is not None \
                else None
            if cached is None:
                cached = node_guards(ni, model)
                if guard_cache is not None:
                    guard_cache[ni.name] = cached
            guards.append(cached)
        req_flat = [float(request[name]) for name in universe]
        out: list[str | None] = [None] * len(node_infos)
        for model, idxs in groups.items():
            pod_m = _mig_slots(request, model)[1] if pod_g else 0
            verdicts, miss = native.fit_batch(
                [v for i in idxs for v in free_rows[i]], req_flat,
                [float(guards[i][0]) for i in idxs],
                [float(guards[i][1]) for i in idxs],
                [float(guards[i][2]) for i in idxs],
                [float(guards[i][3]) for i in idxs],
                [float(pod_g)], [float(pod_m)], len(idxs), 1, len(universe))
            assert miss is not None
            for k, i in enumerate(idxs):
                if verdicts[k] == 1:
                    continue
                out[i] = self._message(miss[k], universe, guards[i],
                                       pod_g, pod_m)
        return out

    @staticmethod
    def _message(mask: int, universe: list[str],
                 guards: tuple[int, int, int, int], pod_g: int,
                 pod_m: int) -> str:
        cap_g, used_g, cap_m, used_m = guards
        if mask & native.FIT_MISS_COMPUTE_GUARD:
            return (f"NodeResourcesFit: insufficient MIG compute slices "
                    f"({used_g}+{pod_g} over {cap_g}; geometry in flux)")
        if mask & native.FIT_MISS_MEMORY_GUARD:
            return (f"NodeResourcesFit: insufficient MIG memory slots "
                    f"({used_m}+{pod_m} over {cap_m}; geometry in flux)")
        missing = [universe[r] for r in range(len(universe))
                   if mask & (1 << r)]
        return "NodeResourcesFit: insufficient " + ", ".join(missing)
