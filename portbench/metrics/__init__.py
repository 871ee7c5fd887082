"""Per-layer metrics, one module each, named as in ``BENCHMARK.json``.
Each has ``read(trace, cell, kind) -> float | None`` (``trace`` a
``portbench.trace.Trace`` of the traced window, ``cell`` a
``portbench.cells.Cell``, ``kind`` the device's name) and returns None
where it finds nothing to read.  A module that groups device time by the
op that launched it also has ``MATCH(op_name) -> bool``: a kernel is the
group's whose rule matches the innermost op of its chain that any rule
of ``GROUPS`` and the group's own matches (``owned``).

``GROUPS`` is the fixed yardstick: the groups that
``elementwise_ms_step`` subtracts.  A group added later resolves against
these and itself, so adding its module moves no time between the groups
here, nor out of ``elementwise_ms_step``."""

from __future__ import annotations

import importlib


def module(name: str):
    return importlib.import_module(f"portbench.metrics.{name}")


GROUPS = ("attn_fwd_roofline", "attn_bwd_roofline", "gemm_ms_step",
          "optimizer_ms_step")


def rules(groups) -> dict:
    """name -> MATCH of each group named."""
    return {g: module(g).MATCH for g in groups}


def owned(trace, group: str) -> list[tuple[object, int]]:
    """(activity, the op that claims it) for every activity of the window
    that ``group`` claims against ``GROUPS``."""
    table = rules(GROUPS + ((group,) if group not in GROUPS else ()))
    out = []
    for act in trace.device:
        g, op = trace.owner(act, table)
        if g == group:
            out.append((act, op))
    return out


def ms_per_step(trace, acts) -> float | None:
    if not trace.steps or not acts:
        return None
    return sum(a.dur for a, _ in acts) * 1e-3 / trace.steps
