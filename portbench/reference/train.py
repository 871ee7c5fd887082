"""The reference's first training steps, and what the check reads from
them: each step's loss, each parameter's norm of the first gradient as
the optimizer gets it, and the parameters after the last step.

Optimizers as the configuration states them: ``adamw`` is optax's
chain(clip_by_global_norm(clip), adamw(schedule)) with the learning rate
of warmup_cosine_decay at the update count before the update (so the
first step's is 0) and the decay on every parameter; ``adam`` a constant
rate, no clip, no decay."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from portbench.reference.model import Numerics, loss


def warmup_cosine(count: int, peak: float, warmup: int, decay_steps: int,
                  end: float) -> float:
    if count < warmup:
        return peak * count / warmup
    frac = min(count - warmup, decay_steps - warmup) / (decay_steps - warmup)
    return end + (peak - end) * 0.5 * (1 + math.cos(math.pi * frac))


def learning_rate(opt: dict, count: int) -> float:
    sched = opt.get("schedule")
    if sched is None:
        return opt["lr"]
    return warmup_cosine(count, opt["lr"], sched["warmup"],
                         sched["decay_steps"], sched["end_lr"])


@dataclasses.dataclass
class Adam:
    """Adam(W) state over named fp32 parameters, updated in place."""

    opt: dict
    m: dict = dataclasses.field(default_factory=dict)
    v: dict = dataclasses.field(default_factory=dict)
    count: int = 0

    def step(self, params: dict, grads: dict) -> None:
        o = self.opt
        lr = learning_rate(o, self.count)
        self.count += 1
        b1, b2, eps = o["b1"], o["b2"], o["eps"]
        wd = o.get("weight_decay", 0.0)
        c1, c2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        with torch.no_grad():
            for name, p in params.items():
                g = grads[name]
                m = self.m.setdefault(name, torch.zeros_like(p))
                v = self.v.setdefault(name, torch.zeros_like(p))
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                if wd:
                    p.mul_(1 - lr * wd)
                p.addcdiv_(m / c1, (v / c2).sqrt_().add_(eps), value=-lr)


def clip(grads: dict, limit: float) -> None:
    """Scale by limit / max(global norm, limit), in place."""
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads.values()]))
    scale = limit / torch.clamp(norm, min=limit)
    for g in grads.values():
        g.mul_(scale)


@dataclasses.dataclass
class Steps:
    """What the reference's first steps give: each step's loss, the first
    gradient's norm per parameter as the optimizer got it, and the
    parameters after the last step (the dict it was given, updated)."""

    losses: list[float]
    grad_norms: dict[str, float]
    params: dict[str, torch.Tensor]


def run(spec, params: dict[str, torch.Tensor], batches: list[np.ndarray],
        fp8: bool = False) -> Steps:
    """len(batches) training steps from ``params`` (fp32 tensors on the
    card or the CPU, updated in place) with TF32 off."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _run(spec, params, batches, Numerics(fp8))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def _run(spec, params, batches, num: Numerics) -> Steps:
    device = next(iter(params.values())).device
    opt = Adam(spec.optimizer)
    losses, grad_norms = [], {}
    for p in params.values():
        p.requires_grad_(True)
    for i, arr in enumerate(batches):
        tokens = torch.from_numpy(arr).to(device)
        value = loss(params, tokens, spec, num)
        value.backward()
        losses.append(float(value.detach()))
        grads = {n: p.grad for n, p in params.items()}
        if spec.optimizer.get("clip"):
            clip(grads, spec.optimizer["clip"])
        if i == 0:
            grad_norms = {n: float(torch.linalg.vector_norm(g))
                          for n, g in grads.items()}
        opt.step(params, grads)
        for p in params.values():
            p.grad = None
    for p in params.values():
        p.requires_grad_(False)
    return Steps(losses, grad_norms, params)
