"""Training, the port of ``nos_tpu/models/train.py``.

``cross_entropy_loss`` is a copy of the JAX module's function and
``DefaultOptimizer`` the port of its ``default_optimizer``.
``ShardedTrainer`` is the port of its ``ShardedTrainer``: the model over
a ``parallel.mesh`` DeviceMesh, FSDP2 (``fully_shard``) per ``Block``
and at the root over the data-parallel dims, tensor and sequence
parallelism inside the model (``models/llama.py``).  ``Trainer`` is the
same step on one device without a mesh: it builds ``Llama(cfg)``, takes
seeded or converted parameters and runs ``train_step(tokens) -> loss`` =
value-and-grad of ``Llama(tokens, targets=tokens)`` followed by the
optimizer update.

``DefaultOptimizer`` keeps optax's semantics where a torch optimizer
differs by default:

- the learning rate comes from ``warmup_cosine_decay`` evaluated at the
  update count *before* the update, so the first step's rate is 0;
- the clip scales by c / max(||g||, c) on the global norm, with no 1e-6
  added as ``torch.nn.utils.clip_grad_norm_`` adds;
- one parameter group: weight decay applies to every parameter,
  the norm scales and the embedding too (optax ``adamw`` without a mask).

``torch.optim.AdamW`` then computes what optax's adamw computes
(p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)), up to rounding.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.fsdp import fully_shard
from torch.distributed.tensor import DTensor

from nos_tpu_torch import resolve_device
from nos_tpu_torch.models.llama import (Llama, LlamaConfig, init_params,
                                        tp_dim, tp_slice)
from nos_tpu_torch.parallel.mesh import mesh_spec


def cross_entropy_loss(logits: torch.Tensor, tokens: torch.Tensor
                       ) -> torch.Tensor:
    """Next-token loss: logits [B, S, V] vs tokens [B, S] (shift inside)."""
    logp = F.log_softmax(logits[:, :-1].float(), dim=-1)
    ll = torch.gather(logp, -1, tokens[:, 1:, None].long())[..., 0]
    return -ll.mean()


def warmup_cosine_decay(step: int, peak: float, warmup: int,
                        decay_steps: int = 10_000,
                        end_value: float = 0.0) -> float:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup, decay_steps,
    end_value) at ``step``: linear from 0 to ``peak`` over ``warmup``
    steps, then cosine decay to ``end_value`` at ``decay_steps``."""
    if step < warmup:
        return peak * step / warmup
    alpha = 0.0 if peak == 0.0 else end_value / peak
    count = min(step - warmup, decay_steps - warmup)
    cosine = 0.5 * (1 + math.cos(math.pi * count / (decay_steps - warmup)))
    return peak * ((1 - alpha) * cosine + alpha)


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (a view of it), any other tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def _on_device(tokens, device: torch.device) -> torch.Tensor:
    if isinstance(tokens, np.ndarray):
        tokens = torch.from_numpy(tokens)
    return tokens.to(device, non_blocking=True)


def local_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """The global norm of gradients that are all on this rank."""
    return torch.linalg.vector_norm(torch.stack(
        [n.float() for n in torch._foreach_norm(grads)]))


class DefaultOptimizer:
    """``default_optimizer`` of nos_tpu/models/train.py:
    optax.chain(clip_by_global_norm(clip), adamw(schedule, b1=0.9,
    b2=0.95, eps=1e-8, weight_decay)) over ``params``; ``step()`` applies
    one update from the parameters' ``.grad``.  ``global_norm`` maps the
    gradients' local tensors to their global norm (``local_norm`` when
    None; ``ShardedTrainer`` passes one that sums over the mesh)."""

    def __init__(self, params, lr: float = 3e-4, weight_decay: float = 0.1,
                 warmup: int = 100, clip: float = 1.0,
                 global_norm: Callable | None = None) -> None:
        self.params = [p for p in params]
        self.lr, self.warmup, self.clip = lr, warmup, clip
        self.global_norm = global_norm or local_norm
        self.count = 0
        self.adamw = torch.optim.AdamW(
            self.params, lr=0.0, betas=(0.9, 0.95), eps=1e-8,
            weight_decay=weight_decay)

    def learning_rate(self) -> float:
        return warmup_cosine_decay(self.count, self.lr, self.warmup,
                                   end_value=self.lr * 0.1)

    def step(self) -> None:
        grads = [_local(p.grad) for p in self.params]
        norm = self.global_norm(grads)
        torch._foreach_mul_(grads, self.clip / torch.clamp(norm, min=self.clip))
        self.adamw.param_groups[0]["lr"] = self.learning_rate()
        self.adamw.step()
        self.count += 1


class Trainer:
    """Llama training on one device (``cuda`` unless asked otherwise):
    ``init_state(seed)`` or ``load_params(state_dict)``, then
    ``train_step(tokens [B, S]) -> loss``.  ``optimizer_factory`` makes
    the optimizer from the parameters (``DefaultOptimizer`` when None, as
    ``ShardedTrainer`` defaults to ``default_optimizer()``)."""

    def __init__(self, cfg: LlamaConfig,
                 device: str | torch.device = "cuda",
                 optimizer_factory: Callable | None = None) -> None:
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = Llama(cfg, device=self.device)
        self.optimizer_factory = optimizer_factory or DefaultOptimizer
        self.optimizer = None

    def init_state(self, seed: int = 0) -> None:
        """Parameters drawn from a generator seeded ``seed`` on the
        trainer's device (``init_params``) and a fresh optimizer."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.load_params(init_params(self.cfg, gen, self.device))

    def load_params(self, state_dict: dict[str, torch.Tensor]) -> None:
        """Install a ``state_dict`` (e.g. ``convert.params_from_jax``) and
        a fresh optimizer."""
        self.model.load_state_dict(
            {k: v.to(self.device) for k, v in state_dict.items()},
            assign=True)
        self.optimizer = self.optimizer_factory(self.model.parameters())

    def loss_and_grads(self, tokens) -> torch.Tensor:
        """The loss of ``tokens``, with its gradients left in the
        parameters' ``.grad`` (no update)."""
        for p in self.model.parameters():
            p.grad = None
        tokens = _on_device(tokens, self.device)
        loss = self.model(tokens, targets=tokens)
        loss.backward()
        return loss.detach()

    def train_step(self, tokens) -> torch.Tensor:
        """One step: loss and gradients, then the optimizer update.
        Returns the loss (a device scalar: reading it synchronises)."""
        if self.optimizer is None:
            raise RuntimeError("no parameters: call init_state or "
                               "load_params first")
        loss = self.loss_and_grads(tokens)
        self.optimizer.step()
        return loss


@dataclasses.dataclass
class TrainState:
    """A ``ShardedTrainer``'s state (JAX's ``TrainState``): the sharded
    model, which holds the parameters, and its optimizer, which holds the
    AdamW moments and the update count ``step``."""

    model: Llama
    optimizer: DefaultOptimizer

    @property
    def step(self) -> int:
        return self.optimizer.count


def _fsdp_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """The mesh FSDP2 shards over for this rank's tp coordinate: dp
    replicates (HSDP when dp > 1) and (fsdp, sp, ep) shard as one flat
    dim, since the sp ranks of a row block hold the same parameters."""
    spec = mesh_spec(mesh)
    ranks = mesh.mesh.permute(0, 1, 3, 4, 2).reshape(
        spec.dp, spec.fsdp * spec.sp * spec.ep, spec.tp)
    flat = DeviceMesh(mesh.device_type, ranks,
                      mesh_dim_names=("replicate", "shard", "tp"))
    return flat["replicate", "shard"] if spec.dp > 1 else flat["shard"]


class ShardedTrainer:
    """Sharded state and train step for a Llama model over a mesh (a
    ``parallel.mesh.make_mesh`` DeviceMesh; every rank builds its own).

    ``optimizer`` makes the optimizer from the parameters and a
    ``global_norm`` keyword (``DefaultOptimizer`` when None).  The
    parameters are fp32 masters as in ``Trainer``, sharded by FSDP2 per
    ``Block`` and at the root; tp and sp ranks run their share of each
    layer (``models/llama.py``).  A step takes this rank's block of the
    global [batch_size, seq_len] batch (``parallel.mesh.local_block``,
    what ``TokenLoader.device_iter`` yields) and returns the global
    batch's mean loss, the same on every rank."""

    def __init__(self, cfg: LlamaConfig, mesh: DeviceMesh,
                 optimizer: Callable | None = None, batch_size: int = 8,
                 seq_len: int | None = None,
                 device: str | torch.device = "cuda") -> None:
        self.device = resolve_device(device)
        self.cfg, self.mesh = cfg, mesh
        self.spec = mesh_spec(mesh)
        self.optimizer_factory = optimizer or DefaultOptimizer
        self.batch_size = batch_size
        self.seq_len = seq_len or min(cfg.max_seq_len, 2048)
        rows = self.spec.dp * self.spec.fsdp
        if batch_size % rows or self.seq_len % self.spec.sp:
            raise ValueError(
                f"batch {batch_size} x {self.seq_len} does not split over "
                f"dp x fsdp = {rows} and sp = {self.spec.sp}")
        self.fsdp_mesh = _fsdp_mesh(mesh)
        self._shard_group = self.fsdp_mesh.get_group(
            "shard" if self.spec.dp > 1 else None)
        self._tp_group = mesh.get_group("tp")

    # -- state --------------------------------------------------------------
    def _shard(self, model: Llama) -> Llama:
        for block in model.layers:
            fully_shard(block, mesh=self.fsdp_mesh)
        fully_shard(model, mesh=self.fsdp_mesh)
        return model

    def _state(self, model: Llama) -> TrainState:
        split = torch.tensor([tp_dim(n) is not None
                              for n, _ in model.named_parameters()],
                             device=self.device)
        return TrainState(model, self.optimizer_factory(
            model.parameters(),
            global_norm=lambda grads: self._global_norm(grads, split)))

    def _global_norm(self, grads: list[torch.Tensor],
                     split: torch.Tensor) -> torch.Tensor:
        """sqrt of the sum of squares over every shard: local squares
        summed over the FSDP shard dim, then the tp-split parameters' sum
        over tp; replicated copies (dp; tp for whole parameters) count
        once."""
        sq = torch.stack([n.float() for n in torch._foreach_norm(grads)]) ** 2
        parts = torch.stack([torch.where(split, sq, 0.0).sum(),
                             torch.where(split, 0.0, sq).sum()])
        if self._shard_group.size() > 1:
            dist.all_reduce(parts, group=self._shard_group)
        if self.spec.tp > 1:
            tp_part = parts[:1].clone()
            dist.all_reduce(tp_part, group=self._tp_group)
            parts = torch.cat([tp_part, parts[1:]])
        return parts.sum().sqrt()

    def load_params(self, state_dict: dict[str, torch.Tensor]) -> TrainState:
        """A fresh state from a full ``state_dict`` (``init_params`` or
        ``convert.params_from_jax``): this rank's tp share, sharded by
        FSDP2, and a fresh optimizer."""
        model = Llama(self.cfg, device=self.device, mesh=self.mesh)
        model.load_state_dict(
            {k: v.to(self.device) for k, v in tp_slice(
                state_dict, self.spec.tp,
                self.mesh["tp"].get_local_rank()).items()}, assign=True)
        return self._state(self._shard(model))

    def init_state(self, seed: int = 0) -> TrainState:
        """Parameters from a generator seeded ``seed`` on the trainer's
        device (``init_params``, the draws ``Trainer.init_state`` makes),
        and a fresh optimizer."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return self.load_params(init_params(self.cfg, gen, self.device))

    def abstract_state(self) -> TrainState:
        """The state's structure without its values: the model built on
        ``meta`` and sharded, then given uninitialised storage on the
        device (no init compute), and a fresh optimizer.  The restore
        target for ``models/checkpoint.py``."""
        model = self._shard(Llama(self.cfg, device="meta", mesh=self.mesh))
        model.to_empty(device=self.device)
        return self._state(model)

    def full_params(self, state: TrainState) -> dict[str, torch.Tensor]:
        """The whole model's parameters, gathered over FSDP and tp, on
        the CPU of every rank (the layout of ``init_params``)."""
        out = {}
        with torch.no_grad():
            for name, p in state.model.named_parameters():
                t = p.full_tensor() if isinstance(p, DTensor) else p
                dim = tp_dim(name)
                if dim is not None and self.spec.tp > 1:
                    parts = [torch.empty_like(t) for _ in range(self.spec.tp)]
                    dist.all_gather(parts, t.contiguous(),
                                    group=self._tp_group)
                    t = torch.cat(parts, dim=dim)
                out[name] = t.cpu()
        return out

    # -- step ---------------------------------------------------------------
    def _mean_over_rows(self, loss: torch.Tensor) -> torch.Tensor:
        """The mean of the row blocks' losses (every rank of a row block
        holds its loss already summed over sp; tp ranks hold copies)."""
        for axis in ("fsdp", "dp"):
            if self.mesh[axis].size() > 1:
                dist.all_reduce(loss, group=self.mesh.get_group(axis))
        return loss / (self.spec.dp * self.spec.fsdp)

    def _step(self, state: TrainState, tokens) -> tuple[TrainState,
                                                         torch.Tensor]:
        model = state.model
        # A forward without grad (``forward()``) leaves FSDP2's root
        # parameters unsharded, and the next backward then reduces the
        # root's gradients (embed, final_norm) wrong: start sharded.
        model.reshard()
        for p in model.parameters():
            p.grad = None
        tokens = _on_device(tokens, self.device)
        loss = model(tokens, targets=tokens)
        # FSDP2 averages gradients over its dp x fsdp x sp ranks; the sp
        # ranks' losses are shares of one sum, so scale by sp to make the
        # average the global batch's mean gradient
        (loss * self.spec.sp).backward()
        state.optimizer.step()
        return state, self._mean_over_rows(loss.detach().clone())

    def train_step(self) -> Callable:
        """The train step: (state, tokens) -> (state, loss).  The state is
        updated in place and returned; the loss is a device scalar."""
        return self._step

    # -- inference ----------------------------------------------------------
    def forward(self) -> Callable:
        """(state, tokens) -> this rank's fp32 logits [B, S, vocab] of its
        block of the batch, without gradients."""
        def fwd(state: TrainState, tokens) -> torch.Tensor:
            with torch.no_grad():
                return state.model(_on_device(tokens, self.device))
        return fwd
