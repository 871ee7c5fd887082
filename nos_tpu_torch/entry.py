"""Entry points of the port, the counterparts of ``__graft_entry__.entry``
and ``dryrun_multichip`` (``dryrun_multigpu``), and the builders that
``entry``, ``chip_smoke.py`` and the profile scripts share: the seeded
BENCH_350M serving model (``bench_model``), the BENCH_350M_TRAIN
trainer with its synthetic batches (``bench_trainer``,
``train_loader``), and the MoE family at BENCH_350M_TRAIN's widths
(``bench_moe_trainer``)."""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import math

import torch

from nos_tpu_torch import resolve_device
from nos_tpu_torch.cmd.train import maybe_init_distributed
from nos_tpu_torch.models.data import TokenLoader
from nos_tpu_torch.models.llama import (BENCH_350M, BENCH_350M_TRAIN, TINY,
                                        Llama, init_params)
from nos_tpu_torch.models.moe import TINY_MOE, MoEConfig, make_ep_trainer
from nos_tpu_torch.models.train import ShardedTrainer, Trainer
from nos_tpu_torch.parallel.mesh import (MeshSpec, local_block, make_mesh,
                                         run_ranks)
from nos_tpu_torch.parallel.pipeline import pipeline_apply

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


def bench_moe_config(num_layers: int = BENCH_350M_TRAIN.num_layers
                     ) -> MoEConfig:
    """The MoE family at BENCH_350M_TRAIN's widths (vocab 32000, hidden
    1024, intermediate 2816, 8 heads over 4 KV heads of 128, flash
    attention, fp32 parameters and bf16 activations) with MoEConfig's
    own defaults: 8 experts, top-2, capacity 1.25, aux weight 0.01.
    Every block is rematerialised whole, as MoELlama does."""
    fields = {f.name: getattr(BENCH_350M_TRAIN, f.name)
              for f in dataclasses.fields(BENCH_350M_TRAIN)}
    return MoEConfig(**{**fields, "num_layers": num_layers})


def moe_launches_per_step(cfg: MoEConfig) -> dict[str, int]:
    """The flash kernels one fused train step of ``MoELlama(cfg)``
    launches: K1 once per layer in the forward and again when backward
    replays each rematerialised block, K2 once per layer."""
    layers = cfg.num_layers
    return {"flash_fwd": layers * (2 if cfg.remat else 1),
            "flash_bwd_fused": layers, "flash_dq": 0, "flash_dkv": 0}


def bench_moe_trainer(device: str | torch.device = "cuda",
                      num_layers: int = BENCH_350M_TRAIN.num_layers):
    """``make_ep_trainer`` for ``bench_moe_config(num_layers)`` on a mesh
    of one rank (ep = 1), in the default process group, which it makes
    when there is none (one rank; NCCL on the card, as the train main
    makes it).  Parameters from a generator seeded 1; ``train_loader``'s
    first batch is the example.  Returns (state, step)."""
    dev = resolve_device(device)
    maybe_init_distributed(dev)
    mesh = make_mesh(MeshSpec(), dev.type)
    return make_ep_trainer(bench_moe_config(num_layers), mesh,
                           train_loader().batch_at(0), device=dev)


def dryrun_multigpu(n_devices: int, device: str = "cuda") -> float:
    """One full sharded training step over an n-rank mesh on tiny shapes:
    ``MeshSpec.for_device_count(n)``, TINY with ring attention when
    sp > 1, a batch of at least 4 rows that splits over dp x fsdp, seq 64.
    When n is a multiple of 8, as ``__graft_entry__.dryrun_multichip``,
    two more legs: an MoE train step (TINY_MOE, ring attention) over a
    mesh with an ep axis, and the GPipe pipeline over pp = 4 against the
    sequential stages.  Runs n ranks (``run_ranks``: NCCL over n cards,
    or gloo processes on the CPU with ``device="cpu"``), checks each
    loss is finite and returns the dense leg's."""
    out = run_ranks(_dryrun_rank, n_devices, n_devices, device,
                    device_type=resolve_device(device).type)[0]
    loss, spec, attn = out["dense"]
    if not math.isfinite(loss):
        raise RuntimeError(f"dryrun_multigpu({n_devices}): non-finite loss "
                           f"{loss}")
    print(f"dryrun_multigpu({n_devices}): mesh={spec} attn={attn} "
          f"loss={loss:.4f}")
    if "moe" in out:
        moe_loss, moe_spec = out["moe"]
        if not math.isfinite(moe_loss):
            raise RuntimeError(f"dryrun_multigpu({n_devices}): non-finite "
                               f"MoE loss {moe_loss}")
        print(f"dryrun_multigpu({n_devices}): moe mesh={moe_spec} "
              f"experts={TINY_MOE.num_experts} loss={moe_loss:.4f}")
        err = out["pipeline"]
        if not err < 1e-5:
            raise RuntimeError(f"dryrun_multigpu: pipeline mismatch {err}")
        print(f"dryrun_multigpu: pipeline pp=4 microbatches=4 "
              f"max_err={err:.2e}")
    return loss


def _dryrun_rank(n_devices: int, device: str) -> dict:
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
    out = {"dense": (loss.item(), spec.shape(), cfg.attn_impl)}
    if n_devices >= 8 and n_devices % 8 == 0:
        out["moe"] = _dryrun_moe_ep(n_devices, dev)
        out["pipeline"] = _dryrun_pipeline(n_devices, dev)
    return out


def _dryrun_moe_ep(n_devices: int, dev: torch.device) -> tuple[float, dict]:
    """The expert-parallel leg: one MoE train step over a mesh whose ep
    axis splits the experts; ep is capped to divide the expert count and
    the rest of the ranks fold into dp (and, where the JAX leg would
    leave devices out, to a mesh of all n ranks)."""
    ep = min(TINY_MOE.num_experts, n_devices // 4)
    while TINY_MOE.num_experts % ep or n_devices % (4 * ep):
        ep -= 1
    spec = MeshSpec(dp=n_devices // (4 * ep), fsdp=2, sp=2, ep=ep)
    mesh = make_mesh(spec, dev.type)
    cfg = dataclasses.replace(TINY_MOE, attn_impl="ring")
    batch = 2 * spec.dp * spec.fsdp
    tokens = torch.randint(0, cfg.vocab_size, (batch, 64), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(2))
    state, step = make_ep_trainer(cfg, mesh, tokens, device=dev)
    _, loss = step(state, tokens)
    return loss.item(), spec.shape()


def _dryrun_pipeline(n_devices: int, dev: torch.device) -> float:
    """The pipeline leg: tanh(x w) + b over a pp = 4 chain (each group of
    4 ranks one pipeline), held against the stages run in sequence."""
    from torch.distributed.device_mesh import init_device_mesh

    pp = init_device_mesh(dev.type, (n_devices // 4, 4),
                          mesh_dim_names=("replica", "pp"))["pp"]
    gen = torch.Generator().manual_seed(4)
    stages = [{"w": torch.randn(32, 32, generator=gen) / 6.0,
               "b": torch.zeros(32)} for _ in range(4)]
    x = torch.randn(8, 32, generator=gen)

    def stage(params, act):
        return torch.tanh(act @ params["w"]) + params["b"]

    mine = {k: v.to(dev) for k, v in stages[pp.get_local_rank()].items()}
    got = pipeline_apply(pp, stage, mine, x.to(dev), 4).cpu()
    want = x
    for params in stages:
        want = stage(params, want)
    return (got - want).abs().max().item()
