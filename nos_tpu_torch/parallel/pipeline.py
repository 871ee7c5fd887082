"""Pipeline parallelism: GPipe microbatched stages over a ``pp`` group,
``nos_tpu/parallel/pipeline.py`` over ``torch.distributed``.

Rank i of the group holds stage i's parameters and runs the skewed
schedule of the JAX module: M + P - 1 ticks, stage i on microbatch m at
tick m + i, its output sent point to point to stage i + 1.  Stage P - 1
collects the microbatches' outputs, and the reassembled [batch, ...]
output is broadcast so every pp rank returns it, as the JAX module's
psum replicates it.  The stage function must preserve the activation's
shape and dtype ([microbatch, seq, embed] for transformer blocks).

Torch has no differentiable point-to-point op, so one
``autograd.Function`` runs both directions: its forward keeps each
microbatch's stage graph, its backward runs the reverse schedule, stage
i + 1 sending its input's cotangent to stage i, and sums each stage's
parameter gradients over the microbatches.  Every pp rank computes the
same loss from the same replicated output; the gradient is that of one
loss, so only the last stage's copy of the output's cotangent enters
(a sum over the pp ranks would scale every gradient by P), and the input
gradient is broadcast from stage 0.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten


def _group(group_or_mesh):
    """The process group of a ``pp`` DeviceMesh (1-D, or with a ``pp``
    dim) or a process group itself."""
    if hasattr(group_or_mesh, "get_group"):
        names = group_or_mesh.mesh_dim_names or ()
        return group_or_mesh.get_group("pp" if "pp" in names else None)
    return group_or_mesh


class _Pipeline(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, stage_fn, spec, group, num_microbatches, *leaves):
        n, stage = dist.get_world_size(group), dist.get_rank(group)
        last = n - 1
        peer = [dist.get_global_rank(group, i) for i in range(n)]
        micro = x.chunk(num_microbatches)
        params = [p.detach().requires_grad_(p.requires_grad) for p in leaves]
        tree = tree_unflatten(params, spec)
        inputs, outputs = [], []
        for t in range(num_microbatches + n - 1):
            m = t - stage
            if not 0 <= m < num_microbatches:
                continue
            if stage == 0:
                inp = micro[m].detach()
            else:
                inp = torch.empty_like(micro[m])
                dist.recv(inp, peer[stage - 1], group=group)
            inp.requires_grad_(x.requires_grad or stage > 0)
            with torch.enable_grad():
                out = stage_fn(tree, inp)
            if stage < last:
                dist.send(out.detach().contiguous(), peer[stage + 1],
                          group=group)
            inputs.append(inp)
            outputs.append(out)
        y = torch.cat([o.detach() for o in outputs]) if stage == last \
            else torch.empty_like(x)
        dist.broadcast(y, peer[last], group=group)
        ctx.group, ctx.peer, ctx.params = group, peer, params
        ctx.inputs, ctx.outputs = inputs, outputs
        return y

    @staticmethod
    def backward(ctx, dy):
        group, peer, params = ctx.group, ctx.peer, ctx.params
        n, stage = len(peer), dist.get_rank(group)
        inputs, outputs = ctx.inputs, ctx.outputs
        num = len(inputs)
        cot_y = dy.chunk(num)
        grads = [torch.zeros_like(p) if p.requires_grad else None
                 for p in params]
        dx = [None] * num
        wrt = [p for p in params if p.requires_grad]
        for m in reversed(range(num)):
            if stage == n - 1:
                cot = cot_y[m]
            else:
                cot = torch.empty_like(outputs[m])
                dist.recv(cot, peer[stage + 1], group=group)
            need_inp = inputs[m].requires_grad
            got = torch.autograd.grad(
                outputs[m], ([inputs[m]] if need_inp else []) + wrt, cot,
                allow_unused=True)
            d_inp, d_params = (got[0], got[1:]) if need_inp else (None, got)
            it = iter(d_params)
            for i, p in enumerate(params):
                if p.requires_grad:
                    g = next(it)
                    if g is not None:
                        grads[i] += g
            if stage > 0:
                dist.send(d_inp.contiguous(), peer[stage - 1], group=group)
            else:
                dx[m] = d_inp
        ctx.inputs = ctx.outputs = None
        if ctx.needs_input_grad[0]:
            dx = torch.cat(dx) if stage == 0 else torch.empty_like(dy)
            dist.broadcast(dx, peer[0], group=group)
        else:
            dx = None
        return (dx, None, None, None, None, *grads)


def pipeline_apply(group_or_mesh, stage_fn: Callable, stage_params,
                   x: torch.Tensor, num_microbatches: int) -> torch.Tensor:
    """Run ``x`` through the P stages of a pipeline over ``group_or_mesh``
    (a ``pp`` DeviceMesh or a process group of P ranks; every rank calls
    it).

    - ``stage_params``: this rank's stage's parameters, a pytree of
      tensors (rank i holds stage i's);
    - ``stage_fn(params, activation) -> activation``, shape and dtype
      preserving;
    - ``x``: [batch, ...], the same on every rank, with batch divisible
      by ``num_microbatches``.

    Returns stage P-1's output for every microbatch, reassembled to
    [batch, ...] and replicated on every pp rank.  Differentiable in
    ``x`` and the stage parameters."""
    batch = x.shape[0]
    if batch % num_microbatches:
        raise ValueError(f"batch {batch} not divisible by "
                         f"{num_microbatches} microbatches")
    leaves, spec = tree_flatten(stage_params)
    return _Pipeline.apply(x, stage_fn, spec, _group(group_or_mesh),
                           num_microbatches, *leaves)


def stack_stage_params(per_stage_params: list):
    """[stage0_tree, stage1_tree, ...] -> one tree with a leading stage
    axis (the JAX helper's layout; rank i takes slice i)."""
    return tree_map(lambda *leaves: torch.stack(leaves, dim=0),
                    *per_stage_params)
