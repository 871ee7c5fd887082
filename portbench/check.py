"""The comparison that decides ``correct``.  A cell compares the numbers
its file gives a limit for, of these:

- ``loss_gap``: the largest |program - reference| over the checked
  steps' losses;
- ``grad_gap``: over the parameters, the largest gap between the
  program's and the reference's norm of the first gradient as the
  optimizer gets it, over the larger of the reference's norm of that
  parameter and of the median parameter;
- ``update_gap``: the same for the norm of each parameter's change over
  the checked steps, leaving out parameters whose reference first
  gradient is under a thousandth of the median parameter's (Adam moves
  those by round-off alone);
- ``grad_median_gap``: the median over the parameters of the first
  gradient's gap as ``grad_gap`` takes it, steady where one small
  parameter's gap swings (a router's, with near-tie routes).

A number that is not finite fails."""

from __future__ import annotations

import dataclasses
import math
import statistics

NAMES = ("loss_gap", "grad_gap", "update_gap", "grad_median_gap")
_NOUGHT = 1e-3


@dataclasses.dataclass
class Readings:
    """One side's reading of the checked steps: the losses, and per
    parameter the first gradient's norm and the change's norm."""

    losses: list[float]
    grad_norms: dict[str, float]
    update_norms: dict[str, float]


def _leaf_gaps(side: dict[str, float], ref: dict[str, float],
               names: list[str]) -> dict[str, float]:
    median = statistics.median(ref[n] for n in names)
    out = {}
    for n in names:
        gap = abs(side[n] - ref[n]) / max(ref[n], median, 1e-30)
        out[n] = gap if math.isfinite(gap) else math.inf
    return out


def _worst(gaps: dict[str, float]) -> tuple[float, str]:
    at = max(gaps, key=gaps.__getitem__)
    return gaps[at], at


def gaps(side: Readings, ref: Readings) -> dict[str, dict]:
    """Each number, with the step or parameter it was taken at."""
    if set(side.grad_norms) != set(ref.grad_norms) \
            or len(side.losses) != len(ref.losses):
        raise ValueError("the two readings cover different parameters or "
                         "steps")
    names = sorted(ref.grad_norms)
    loss = [abs(a - b) if math.isfinite(a) else math.inf
            for a, b in zip(side.losses, ref.losses)]
    step = max(range(len(loss)), key=loss.__getitem__)
    grads = _leaf_gaps(side.grad_norms, ref.grad_norms, names)
    median = statistics.median(ref.grad_norms[n] for n in names)
    moved = [n for n in names if ref.grad_norms[n] >= _NOUGHT * median]
    grad, grad_at = _worst(grads)
    update, update_at = _worst(_leaf_gaps(side.update_norms,
                                          ref.update_norms, moved))
    return {"loss_gap": {"value": loss[step], "at": f"step {step + 1}"},
            "grad_gap": {"value": grad, "at": grad_at},
            "update_gap": {"value": update, "at": update_at},
            "grad_median_gap": {"value": statistics.median(grads.values()),
                                "at": f"median of {len(grads)}"},
            "left_out": sorted(set(names) - set(moved))}


def verdict(found: dict[str, dict], limits: dict[str, float]
            ) -> tuple[bool, dict[str, dict]]:
    """(correct, each number the limits name beside its limit)."""
    shown = {n: {"value": found[n]["value"], "limit": limits[n],
                 "at": found[n]["at"]} for n in NAMES if n in limits}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in shown.values())
    return ok, shown
