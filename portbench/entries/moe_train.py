"""A routed-expert decoder's training step: the ``step`` of
``make_ep_trainer`` on a one-rank mesh (FSDP2 over the experts and the
rest, optax adam(1e-3)), fed each step's global batch from the host as
the trainer takes it."""

from __future__ import annotations

import itertools

import torch

from nos_tpu_torch.models.moe import MoEConfig, make_ep_trainer
from portbench import inputs
from portbench.entries import common
from portbench.entries.dense_train import llama_config


class Session:
    def __init__(self, cell, seed: int, device: torch.device):
        spec = cell.spec
        base = llama_config(spec)
        cfg = MoEConfig(**{f: getattr(base, f) for f in
                           base.__dataclass_fields__},
                        num_experts=spec.num_experts, top_k=spec.top_k,
                        capacity_factor=spec.capacity_factor,
                        router_aux_weight=spec.router_aux_weight)
        self.cell, self.seed = cell, seed
        mesh = common.one_rank_mesh(device)
        self.state, self._step = make_ep_trainer(
            cfg, mesh, self._batch(0), device,
            params=inputs.make_params(spec, seed, device))
        group = self.state.optimizer.param_groups[0]
        common.check_hyper(group, spec.optimizer)
        if group["lr"] != spec.optimizer["lr"]:
            raise RuntimeError("the program's learning rate differs from "
                               "the configuration's")
        self.beta1 = spec.optimizer["b1"]

    def _batch(self, step: int):
        c = self.cell
        return inputs.batch(self.seed, step, c.batch_size, c.seq_len,
                            c.spec.vocab_size)

    def batches(self):
        return (self._batch(i) for i in itertools.count())

    def step(self, batch) -> torch.Tensor:
        self.state, loss = self._step(self.state, batch)
        return loss

    def first_grad_norms(self) -> dict[str, torch.Tensor]:
        return common.first_moment_norms(self.state.model,
                                         self.state.optimizer, self.beta1)

    def params(self) -> dict[str, torch.Tensor]:
        return {n: common.local(p.data)
                for n, p in self.state.model.named_parameters()}

    def close(self) -> None:
        self.state = self._step = None
        common.close()
