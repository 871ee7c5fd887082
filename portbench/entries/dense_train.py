"""A dense decoder's training step as ``cmd/train.py`` runs it: the
``ShardedTrainer`` step on a one-rank mesh (FSDP2 per block and at the
root, ``DefaultOptimizer``: clip, then AdamW on the warm-up schedule),
fed by ``TokenLoader.device_iter`` (a pinned copy one batch ahead)."""

from __future__ import annotations

import numpy as np
import torch

from nos_tpu_torch.models.data import TokenLoader
from nos_tpu_torch.models.llama import LlamaConfig
from nos_tpu_torch.models.train import ShardedTrainer
from portbench import inputs
from portbench.entries import common


def llama_config(spec) -> LlamaConfig:
    return LlamaConfig(
        vocab_size=spec.vocab_size, hidden_size=spec.hidden_size,
        intermediate_size=spec.intermediate_size,
        num_layers=spec.num_layers, num_heads=spec.num_heads,
        num_kv_heads=spec.num_kv_heads, head_dim=spec.head_dim,
        max_seq_len=spec.max_positions, rope_theta=spec.rope_theta,
        norm_eps=spec.norm_eps,
        dtype=getattr(torch, spec.activation_dtype),
        param_dtype=torch.float32, attn_impl=spec.attn_impl,
        loss_chunk=spec.loss_chunk, remat=True,
        remat_policy=spec.remat_policy)


class SeededLoader(TokenLoader):
    """The main's loader with the benchmark's batches: step i's batch is
    ``inputs.batch(seed, i, ...)``."""

    def __init__(self, seed: int, batch_size: int, seq_len: int,
                 vocab_size: int):
        super().__init__(np.zeros(batch_size * seq_len, np.int32),
                         batch_size, seq_len, seed=seed)
        self.vocab_size = vocab_size

    def batch_at(self, step: int) -> np.ndarray:
        return inputs.batch(self.seed, step, self.batch_size, self.seq_len,
                            self.vocab_size)


class Session:
    def __init__(self, cell, seed: int, device: torch.device):
        spec = cell.spec
        self.mesh = common.one_rank_mesh(device)
        self.loader = SeededLoader(seed, cell.batch_size, cell.seq_len,
                                   spec.vocab_size)
        self.trainer = ShardedTrainer(
            llama_config(spec), self.mesh, batch_size=cell.batch_size,
            seq_len=cell.seq_len, device=device)
        self.state = self.trainer.load_params(
            inputs.make_params(spec, seed, device))
        opt = self.state.optimizer
        common.check_hyper(opt.adamw.param_groups[0], spec.optimizer)
        if (opt.lr, opt.clip, opt.warmup) != (
                spec.optimizer["lr"], spec.optimizer["clip"],
                spec.optimizer["schedule"]["warmup"]):
            raise RuntimeError("the program's schedule or clip differs from "
                               "the configuration's")
        self.beta1 = spec.optimizer["b1"]
        self._step = self.trainer.train_step()

    def batches(self):
        return self.loader.device_iter(mesh=self.mesh)

    def step(self, batch) -> torch.Tensor:
        self.state, loss = self._step(self.state, batch)
        return loss

    def first_grad_norms(self) -> dict[str, torch.Tensor]:
        return common.first_moment_norms(
            self.state.model, self.state.optimizer.adamw, self.beta1)

    def params(self) -> dict[str, torch.Tensor]:
        return {n: common.local(p.data)
                for n, p in self.state.model.named_parameters()}

    def close(self) -> None:
        self.state = self.trainer = self._step = None
        common.close()
