"""Single-device training, the port of ``nos_tpu/models/train.py``.

``cross_entropy_loss`` is a copy of the JAX module's function and
``DefaultOptimizer`` the port of its ``default_optimizer``; ``Trainer`` is
the counterpart of ``ShardedTrainer`` without a mesh (the mesh is a later
slice): it builds ``Llama(cfg)`` on one device, takes seeded or converted
parameters and runs ``train_step(tokens) -> loss`` = value-and-grad of
``Llama(tokens, targets=tokens)`` followed by the optimizer update.

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

import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from nos_tpu_torch import resolve_device
from nos_tpu_torch.models.llama import Llama, LlamaConfig, init_params


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


class DefaultOptimizer:
    """``default_optimizer`` of nos_tpu/models/train.py:
    optax.chain(clip_by_global_norm(clip), adamw(schedule, b1=0.9,
    b2=0.95, eps=1e-8, weight_decay)) over ``params``; ``step()`` applies
    one update from the parameters' ``.grad``."""

    def __init__(self, params, lr: float = 3e-4, weight_decay: float = 0.1,
                 warmup: int = 100, clip: float = 1.0) -> None:
        self.params = [p for p in params]
        self.lr, self.warmup, self.clip = lr, warmup, clip
        self.count = 0
        self.adamw = torch.optim.AdamW(
            self.params, lr=0.0, betas=(0.9, 0.95), eps=1e-8,
            weight_decay=weight_decay)

    def learning_rate(self) -> float:
        return warmup_cosine_decay(self.count, self.lr, self.warmup,
                                   end_value=self.lr * 0.1)

    def step(self) -> None:
        grads = [p.grad for p in self.params]
        norm = torch.linalg.vector_norm(torch.stack(
            [n.float() for n in torch._foreach_norm(grads)]))
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

    def _tokens(self, tokens) -> torch.Tensor:
        if isinstance(tokens, np.ndarray):
            tokens = torch.from_numpy(tokens)
        return tokens.to(self.device, non_blocking=True)

    def loss_and_grads(self, tokens) -> torch.Tensor:
        """The loss of ``tokens``, with its gradients left in the
        parameters' ``.grad`` (no update)."""
        for p in self.model.parameters():
            p.grad = None
        tokens = self._tokens(tokens)
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
