"""Entry points of the port, the counterparts of ``__graft_entry__.entry``
and ``dryrun_multichip`` (``dryrun_multigpu``), and the builders that
``entry``, ``chip_smoke.py`` and the profile scripts share: the seeded
BENCH_350M serving model (``bench_model``) and the BENCH_350M_TRAIN
trainer with its synthetic batches (``bench_trainer``,
``train_loader``)."""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import math

import torch

from nos_tpu_torch import resolve_device
from nos_tpu_torch.models.data import TokenLoader
from nos_tpu_torch.models.llama import (BENCH_350M, BENCH_350M_TRAIN, TINY,
                                        Llama, init_params)
from nos_tpu_torch.models.train import ShardedTrainer, Trainer
from nos_tpu_torch.parallel.mesh import (MeshSpec, local_block, make_mesh,
                                         run_ranks)

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


def dryrun_multigpu(n_devices: int, device: str = "cuda") -> float:
    """One full sharded training step over an n-rank mesh on tiny shapes:
    ``MeshSpec.for_device_count(n)``, TINY with ring attention when
    sp > 1, a batch of at least 4 rows that splits over dp x fsdp, seq 64.
    Runs n ranks (``run_ranks``: NCCL over n cards, or gloo processes on
    the CPU with ``device="cpu"``), checks the loss is finite and returns
    it.  The JAX dryrun's MoE and pipeline legs wait for the port's MoE
    and pipeline (ROADMAP.md items 16-17)."""
    loss, spec, attn = run_ranks(_dryrun_rank, n_devices, n_devices, device,
                                 device_type=resolve_device(device).type)[0]
    if not math.isfinite(loss):
        raise RuntimeError(f"dryrun_multigpu({n_devices}): non-finite loss "
                           f"{loss}")
    print(f"dryrun_multigpu({n_devices}): mesh={spec} attn={attn} "
          f"loss={loss:.4f}")
    return loss


def _dryrun_rank(n_devices: int, device: str) -> tuple[float, dict, str]:
    spec = MeshSpec.for_device_count(n_devices)
    dev = resolve_device(device)
    mesh = make_mesh(spec, dev.type)
    cfg = dataclasses.replace(
        TINY, attn_impl="ring" if spec.sp > 1 else "dense")
    per_replica = spec.dp * spec.fsdp
    batch = per_replica * max(1, -(-4 // per_replica))  # >=4, divisible
    trainer = ShardedTrainer(cfg, mesh, batch_size=batch, seq_len=64,
                             device=dev)
    state = trainer.init_state(0)
    tokens = torch.randint(0, cfg.vocab_size, (batch, 64), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    _, loss = trainer.train_step()(
        state, local_block(tokens.numpy(), mesh))
    return loss.item(), spec.shape(), cfg.attn_impl
