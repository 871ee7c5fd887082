"""Entry point of the port, the counterpart of ``__graft_entry__.entry``,
and the builders that ``entry``, ``chip_smoke.py`` and the profile
scripts share: the seeded BENCH_350M serving model (``bench_model``) and
the BENCH_350M_TRAIN trainer with its synthetic batches
(``bench_trainer``, ``train_loader``)."""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import torch

from nos_tpu_torch import resolve_device
from nos_tpu_torch.models.data import TokenLoader
from nos_tpu_torch.models.llama import (BENCH_350M, BENCH_350M_TRAIN, Llama,
                                        init_params)
from nos_tpu_torch.models.train import Trainer

# The serving run: 8 requests, 448 prompt tokens and 64 generated tokens
# each, so the buffer that every step re-runs is 8 x 512.
SERVE_BATCH, PROMPT_LEN, STEPS = 8, 448, 64
# The training run: nos_tpu/cmd/train.py's defaults, batch 8 x seq 2048.
TRAIN_BATCH, TRAIN_SEQ = 8, 2048


def bench_model(num_layers: int = BENCH_350M.num_layers,
                device: str | torch.device = "cuda") -> Llama:
    """BENCH_350M with flash attention and bf16 parameters drawn from a
    generator seeded 0 on ``device``."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(
        BENCH_350M, num_layers=num_layers, attn_impl="flash",
        param_dtype=torch.bfloat16)
    model = Llama(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    model.load_state_dict(init_params(cfg, gen, dev), assign=True)
    return model


def serve_prompt(device: str | torch.device = "cuda") -> torch.Tensor:
    """The serving run's prompts: int32 token ids [SERVE_BATCH, PROMPT_LEN]
    in BENCH_350M's vocabulary, drawn on the CPU from a generator seeded
    1, so every device gets the same ids."""
    dev = resolve_device(device)
    return torch.randint(
        0, BENCH_350M.vocab_size, (SERVE_BATCH, PROMPT_LEN), dtype=torch.int32,
        generator=torch.Generator().manual_seed(1)).to(dev)


def entry(device: str | torch.device = "cuda"
          ) -> tuple[Callable[..., torch.Tensor], tuple]:
    """Returns (fn, example_args): one forward of ``bench_model`` cut to 4
    layers on zero tokens [1, 512].  ``fn(model, tokens)`` -> fp32 logits
    [1, 512, vocab]."""
    dev = resolve_device(device)
    model = bench_model(4, dev)
    tokens = torch.zeros((1, 512), dtype=torch.int32, device=dev)

    def fn(model: Llama, tokens: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return model(tokens)

    return fn, (model, tokens)


def bench_trainer(device: str | torch.device = "cuda",
                  num_layers: int = BENCH_350M_TRAIN.num_layers,
                  **changes) -> Trainer:
    """A ``Trainer`` for BENCH_350M_TRAIN (flash attention, "rots" remat,
    fp32 parameters, bf16 activations) with parameters drawn from a
    generator seeded 0 on ``device``.  ``num_layers`` cuts the depth;
    ``changes`` replace other config fields (e.g. attn_impl)."""
    cfg = dataclasses.replace(BENCH_350M_TRAIN, num_layers=num_layers,
                              **changes)
    trainer = Trainer(cfg, device=device)
    trainer.init_state(0)
    return trainer


def train_loader() -> TokenLoader:
    """The training run's batches, as nos_tpu/cmd/train.py builds them
    without a data path: a synthetic stream seeded 0."""
    return TokenLoader.synthetic(
        BENCH_350M_TRAIN.vocab_size,
        max(TRAIN_BATCH * TRAIN_SEQ * 8, 1 << 16), TRAIN_BATCH, TRAIN_SEQ,
        seed=0)
