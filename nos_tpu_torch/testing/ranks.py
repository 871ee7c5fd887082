"""Rank bodies for the port's multi-process tests (``tests/test_torch_*``):
each runs on every rank of a ``parallel.mesh.run_ranks`` launch and
returns numpy arrays and plain values for the test to hold against the
JAX package.  This module imports torch and the port only, so a spawned
rank never imports JAX."""

from __future__ import annotations

import functools
import pathlib
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from nos_tpu_torch.models.checkpoint import TrainCheckpointer
from nos_tpu_torch.models.data import TokenLoader
from nos_tpu_torch.models.moe import make_ep_trainer
from nos_tpu_torch.models.train import DefaultOptimizer, ShardedTrainer
from nos_tpu_torch.parallel.mesh import (MeshSpec, local_block, make_mesh,
                                         mesh_spec)
from nos_tpu_torch.parallel.pipeline import pipeline_apply
from nos_tpu_torch.parallel.ring import ring_attention_local


def _numpy(sd: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    return {k: v.detach().float().numpy() for k, v in sd.items()}


def _plain(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


# -- the launcher -------------------------------------------------------------

def rank_and_world() -> tuple[int, int]:
    return dist.get_rank(), dist.get_world_size()


def raise_on(rank: int) -> int:
    if dist.get_rank() == rank:
        raise ValueError(f"rank {rank} raised on purpose")
    return dist.get_rank()


def hang_on(rank: int) -> None:
    """Rank ``rank`` never arrives at the barrier the others wait in."""
    if dist.get_rank() == rank:
        time.sleep(3600)
    dist.barrier()


# -- mesh ---------------------------------------------------------------------

def mesh_cases(spec_text: str, batch: np.ndarray) -> dict:
    """This rank's coordinates, dim names and sizes on ``make_mesh(spec)``,
    its ``local_block`` of ``batch``, and the error of a spec that does
    not fit the world."""
    spec = MeshSpec.parse(spec_text)
    mesh = make_mesh(spec, "cpu")
    wrong = MeshSpec(fsdp=2 * spec.size)
    try:
        make_mesh(wrong, "cpu")
        error = None
    except ValueError as e:
        error = str(e)
    return {"names": mesh.mesh_dim_names,
            "shape": tuple(mesh.mesh.shape),
            "coords": {ax: mesh[ax].get_local_rank()
                       for ax in mesh.mesh_dim_names},
            "spec": mesh_spec(mesh),
            "block": local_block(batch, mesh), "error": error}


# -- ring attention -----------------------------------------------------------

def ring_attention_cases(q, k, v, do, cases) -> list[dict]:
    """This rank's sequence shard of ``ring_attention_local``'s output and
    of the gradients of sum(out * do) with respect to q, k and v, for
    global [B, S, H, D] numpy inputs split over the default group, one
    entry per (causal, overlap) of ``cases``."""
    n, r = dist.get_world_size(), dist.get_rank()

    def shard(x):
        return torch.from_numpy(x).chunk(n, dim=1)[r].clone()

    out = []
    for causal, overlap in cases:
        ql, kl, vl = (shard(x).requires_grad_() for x in (q, k, v))
        o = ring_attention_local(ql, kl, vl, None, causal, overlap)
        o.backward(shard(do))
        out.append({"o": o.detach().numpy(), "dq": ql.grad.numpy(),
                    "dk": kl.grad.numpy(), "dv": vl.grad.numpy()})
    return out


# -- training -----------------------------------------------------------------

def _trainer(spec_text: str, cfg, batch: int, seq: int, lr: float,
             warmup: int) -> ShardedTrainer:
    mesh = make_mesh(MeshSpec.parse(spec_text), "cpu")
    return ShardedTrainer(
        cfg, mesh, optimizer=functools.partial(DefaultOptimizer, lr=lr,
                                               warmup=warmup),
        batch_size=batch, seq_len=seq, device="cpu")


def _steps(trainer, state, batches):
    step = trainer.train_step()
    losses = []
    for b in batches:
        state, loss = step(state, local_block(b, trainer.mesh))
        losses.append(loss.item())
    return state, losses


def sharded_steps(spec_text: str, cfg, state_dict, batches, lr: float,
                  warmup: int) -> dict:
    """``ShardedTrainer`` on the mesh ``spec_text`` from ``state_dict``:
    the loss of each global batch of ``batches`` and the whole parameters
    after the last step."""
    b, s = batches[0].shape
    trainer = _trainer(spec_text, cfg, b, s, lr, warmup)
    state, losses = _steps(trainer, trainer.load_params(state_dict), batches)
    return {"losses": losses, "step": state.step,
            "params": _numpy(trainer.full_params(state))}


def device_iter_blocks(spec_text: str, loader_args: tuple, start: int,
                       num: int) -> list[np.ndarray]:
    """This rank's ``device_iter`` blocks for ``num`` steps from
    ``start`` of ``TokenLoader.synthetic(*loader_args)``."""
    mesh = make_mesh(MeshSpec.parse(spec_text), "cpu")
    loader = TokenLoader.synthetic(*loader_args)
    return [t.numpy() for t in loader.device_iter(mesh, start, num)]


def checkpoint_contract(spec_text: str, cfg, directory: str) -> dict:
    """The ``TrainCheckpointer`` contract on one mesh: what a fresh
    directory reports, five saves with ``max_to_keep=3``, a second save
    of a step, and a restore into a fresh trainer's abstract state."""
    trainer = _trainer(spec_text, cfg, 4, 32, 1e-3, 2)
    batch = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 32), dtype=np.int32)
    ck = TrainCheckpointer(directory)
    out = {"fresh_latest": ck.latest_step()}
    try:
        ck.restore(trainer.abstract_state())
        out["fresh_restore"] = None
    except FileNotFoundError as e:
        out["fresh_restore"] = str(e)
    state = trainer.init_state(0)
    step = trainer.train_step()
    saved = []
    for i in range(1, 6):
        state, _ = step(state, local_block(batch, trainer.mesh))
        saved.append(ck.save(i, state))
    out["saved"] = saved
    out["again"] = ck.save(5, state)
    out["latest"] = ck.latest_step()
    out["kept"] = sorted(p.name for p in pathlib.Path(directory).iterdir())
    fresh = _trainer(spec_text, cfg, 4, 32, 1e-3, 2)
    restored = ck.restore(fresh.abstract_state())
    out["restored_step"] = restored.step
    want, got = trainer.full_params(state), fresh.full_params(restored)
    out["params_equal"] = all(torch.equal(want[n], got[n]) for n in want)
    moments = [(state.optimizer.adamw.state[p], restored.optimizer.adamw
                .state[q]) for p, q in zip(state.optimizer.params,
                                           restored.optimizer.params)]
    out["moments_equal"] = all(
        torch.equal(_plain(a[key]), _plain(b[key]))
        for a, b in moments for key in ("exp_avg", "exp_avg_sq", "step"))
    old = ck.restore(fresh.abstract_state(), step=4)
    out["restored_old_step"] = old.step
    ck.close()
    return out


def resume_bitwise(spec_text: str, cfg, batches, directory: str) -> dict:
    """Six steps straight against three steps, a checkpoint, a restore
    into a fresh trainer's abstract state and three more: the losses and
    the final parameters of both."""
    b, s = batches[0].shape
    half = len(batches) // 2
    trainer = _trainer(spec_text, cfg, b, s, 1e-3, 2)
    state, straight = _steps(trainer, trainer.init_state(0), batches)
    want = trainer.full_params(state)

    first = _trainer(spec_text, cfg, b, s, 1e-3, 2)
    state, resumed = _steps(first, first.init_state(0), batches[:half])
    ck = TrainCheckpointer(directory)
    ck.save(half, state)
    second = _trainer(spec_text, cfg, b, s, 1e-3, 2)
    state = ck.restore(second.abstract_state())
    state, rest = _steps(second, state, batches[half:])
    got = second.full_params(state)
    return {"straight": straight, "resumed": resumed + rest,
            "step": state.step,
            "params_bitwise": all(torch.equal(want[n], got[n])
                                  for n in want)}


def train_main_scenarios(directory: str, base: dict) -> dict:
    """The train main's contract, ``tests/test_train_cmd.py``'s
    TestTrainMain and the exits at a checkpoint, on this launch's ranks:
    each scenario's outcome by name (a raised ConfigError as its
    message)."""
    from nos_tpu_torch.api.config import ConfigError
    from nos_tpu_torch.cmd.train import TrainConfig, build, train

    root = pathlib.Path(directory)

    def cfg(**kw):
        c = TrainConfig(**{**base, **kw})
        c.validate()
        return c

    out = {}
    used = str(root / "used")
    fracs = []
    loss = train(cfg(checkpoint_dir=used), progress_cb=fracs.append,
                 device="cpu")
    out["loop"] = {"loss": loss, "progress": fracs,
                   "latest": TrainCheckpointer(used).latest_step()}
    # a "restarted pod": same config, more steps — must resume at 6
    _, _, _, state, start = build(cfg(checkpoint_dir=used, steps=9), "cpu")
    out["resume_build"] = {"start_step": start, "state_step": state.step}
    out["resume"] = train(cfg(checkpoint_dir=used, steps=9), device="cpu")
    out["complete"] = [train(cfg(checkpoint_dir=used, steps=n),
                             device="cpu") for n in (9, 3)]
    try:
        build(cfg(checkpoint_dir=used, resume=False), "cpu")
        out["fresh_into_used"] = None
    except ConfigError as e:
        out["fresh_into_used"] = str(e)

    # the chip smoke's resume check: straight, and 4 steps + restart
    straight = train(cfg(steps=6), device="cpu")
    d = str(root / "restart")
    train(cfg(steps=4, checkpoint_every=4, checkpoint_dir=d), device="cpu")
    out["restart"] = {"straight": straight, "resumed": train(
        cfg(steps=6, checkpoint_every=4, checkpoint_dir=d), device="cpu"),
        "latest": TrainCheckpointer(d).latest_step()}

    world = dist.get_world_size()
    for name, kw in (
            ("resize", {"resize_cb": lambda: world // 2}),
            ("same_size", {"resize_cb": lambda: world}),
            ("migrate", {"migrate_cb": lambda: "maintenance"})):
        d = str(root / name)
        fracs = []
        loss = train(cfg(checkpoint_dir=d, steps=6, checkpoint_every=2),
                     progress_cb=fracs.append, device="cpu", **kw)
        out[name] = {"loss": loss, "progress": fracs,
                     "latest": TrainCheckpointer(d).latest_step()}
    return out


def forward_between_steps(which: str, spec_text: str, cfg) -> bool:
    """Whether two steps on one batch leave the same parameters with and
    without a forward without grad between them, for ``which`` trainer
    ("sharded": ``ShardedTrainer``, "ep": ``make_ep_trainer``)."""
    mesh = make_mesh(MeshSpec.parse(spec_text), "cpu")
    batch = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 32),
                                              dtype=np.int32)
    block = local_block(batch, mesh)
    params = []
    for forward in (False, True):
        if which == "sharded":
            trainer = ShardedTrainer(cfg, mesh, batch_size=4, seq_len=32,
                                     device="cpu")
            state, step = trainer.init_state(0), trainer.train_step()
            for i in range(2):
                if forward and i:
                    trainer.forward()(state, block)
                state, _ = step(state, block)
            params.append(trainer.full_params(state))
        else:
            state, step = make_ep_trainer(cfg, mesh, batch, device="cpu")
            for i in range(2):
                if forward and i:
                    with torch.no_grad():
                        state.model(torch.from_numpy(block))
                state, _ = step(state, batch)
            params.append(state.full())
    return all(torch.equal(params[0][n], params[1][n]) for n in params[0])


# -- mixture of experts --------------------------------------------------------

def ep_trainer_steps(cases) -> list[dict]:
    """``make_ep_trainer`` on each mesh of ``cases`` ((spec_text, cfg,
    state_dict, batches) each, world-size meshes of the default group),
    from the full ``state_dict``: the loss of each global batch, the
    gradients of the first step and the parameters after the last, all
    whole."""
    out = []
    for spec_text, cfg, state_dict, batches in cases:
        mesh = make_mesh(MeshSpec.parse(spec_text), "cpu")
        state, step = make_ep_trainer(cfg, mesh, batches[0], device="cpu",
                                      params=state_dict)
        losses, grads0 = [], None
        for b in batches:
            state, loss = step(state, b)
            losses.append(loss.item())
            if grads0 is None:
                grads0 = _numpy(state.full(grads=True))
        out.append({"losses": losses, "step": state.step, "grads0": grads0,
                    "params": _numpy(state.full())})
    return out


# -- pipeline ------------------------------------------------------------------

def mlp_stage(params, x):
    """``tests/test_pipeline.py``'s stage: tanh(x w1 + b1) w2 + b2."""
    h = torch.tanh(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def _stage(stacked, i: int):
    return torch.utils._pytree.tree_map(lambda p: p[i].clone(), stacked)


def pipeline_cases(stacked, x: np.ndarray, counts, grad_count: int | None,
                   indivisible: int | None) -> dict:
    """``pipeline_apply`` of ``mlp_stage`` over the default group as pp,
    each rank taking its stage of ``stacked``: the output for each
    microbatch count of ``counts``; with ``grad_count``, the gradients
    of sum(y^2) with respect to this rank's stage and to x; with
    ``indivisible``, the error for that microbatch count."""
    stage = _stage(stacked, dist.get_rank())
    xt = torch.from_numpy(x)
    out = {"y": {m: pipeline_apply(dist.group.WORLD, mlp_stage, stage, xt, m
                                   ).numpy() for m in counts}}
    if grad_count is not None:
        params = {k: v.requires_grad_() for k, v in stage.items()}
        xg = xt.clone().requires_grad_()
        y = pipeline_apply(dist.group.WORLD, mlp_stage, params, xg,
                           grad_count)
        (y ** 2).sum().backward()
        out["grads"] = {k: v.grad.numpy() for k, v in params.items()}
        out["dx"] = xg.grad.numpy()
    if indivisible is not None:
        try:
            pipeline_apply(dist.group.WORLD, mlp_stage, stage, xt,
                           indivisible)
            out["indivisible"] = None
        except ValueError as e:
            out["indivisible"] = str(e)
    return out


def pipeline_blocks(cfg, stacked, x: np.ndarray, microbatches: int
                    ) -> np.ndarray:
    """Llama ``Block``s over the default group as pp: ``stacked`` holds
    each stage's layers' state dicts (a leading stage axis, then one
    entry per layer); every rank returns the pipeline's output."""
    from nos_tpu_torch.models.llama import Block, rope_tables

    block = Block(cfg, "cpu")
    xt = torch.from_numpy(x)
    positions = torch.arange(x.shape[1], dtype=torch.int32)[None]
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)

    def stage_fn(params, act):
        for layer in params:
            act = torch.func.functional_call(block, layer, (act, rope))
        return act

    with torch.no_grad():
        return pipeline_apply(dist.group.WORLD, stage_fn,
                              _stage(stacked, dist.get_rank()), xt,
                              microbatches).numpy()
