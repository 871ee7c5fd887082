"""Training main, ``nos_tpu/cmd/train.py`` for the port:

    python -m nos_tpu_torch.cmd.train --config train.json
    torchrun --nproc-per-node 4 -m nos_tpu_torch.cmd.train --config ...

Composes the training stack from one typed config: the process group
(torchrun's environment, or a group of one rank without it), the mesh
(``parallel.mesh``, from a MeshSpec string), model and sharded trainer
(``models.train.ShardedTrainer``), the deterministic token loader
(memmapped corpus or synthetic), periodic checkpoints
(``models.checkpoint``) and resume: restarting the process (after the
capacity scheduler preempted the gang and the partitioner re-carved)
continues from the last checkpoint with the exact batch sequence.

This is the workload side of the framework: the control plane carves a
slice and gang-schedules the pods; each pod runs this main.  The entry
points run on the card unless ``device="cpu"`` is passed (the tests do).

``main`` honors the pod's device grant as the JAX main does
(``device/workload_env``): ``apply`` before the first CUDA call sets the
granted visibility, and ``validate_confinement``, once CUDA is up and
before the process group or any allocation, proves that CUDA shows
exactly the granted devices and installs a timeshare grant's memory cap
(a ConfinementError stops the run before any step).  At exit it logs the
grant it verified, the cap, the peak memory and the flash launches.

Not in the port yet: the pod hooks' kube client and the ``/healthz`` +
``/metrics`` server (``cmd/_runtime.Main``) are control-plane modules
(ROADMAP.md item 32), so a ``kubeconfig``, ``health_probe_addr`` or
``metrics_addr`` raises NotImplementedError instead of being ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import math
import os
import pathlib
import sys
import time

import torch
import torch.distributed as dist

from nos_tpu_torch import resolve_device
from nos_tpu_torch.api.config import ConfigError, ManagerConfig, load_config
from nos_tpu_torch.device import workload_env
from nos_tpu_torch.exporter.metrics import REGISTRY
from nos_tpu_torch.parallel.mesh import backend_for

logger = logging.getLogger("nos_tpu_torch.cmd.train")

REGISTRY.describe("nos_tpu_train_loss", "Last training step loss")
REGISTRY.describe("nos_tpu_train_step", "Last completed training step")
REGISTRY.describe("nos_tpu_train_tokens_per_s",
                  "Training throughput over the last log interval")
REGISTRY.describe("nos_tpu_train_mfu",
                  "Model FLOPs utilization over the last log interval "
                  "(analytic fwd+bwd FLOPs vs the device bf16 peak)")

_CONTROL_PLANE = ("the kube client and the health/metrics server are not "
                  "in the port yet (ROADMAP.md item 32)")


@dataclasses.dataclass
class TrainConfig(ManagerConfig):
    """health_probe_addr/metrics_addr (+ validation) come from the
    ManagerConfig embed, like every other main."""

    model: str = "bench350m"      # tiny | bench350m | llama3-8b
    # defaults mirror models/llama.py BENCH_350M_TRAIN
    attn_impl: str = "flash"
    remat_policy: str = "rots"
    scan_layers: bool = True
    batch_size: int = 8
    seq_len: int = 2048
    steps: int = 100
    # MeshSpec string, e.g. "fsdp=4,tp=2,sp=2" or a topology "2x2x4";
    # "" = a sensible factorization of the world size.
    mesh: str = ""
    # Packed uint16 token file; "" = deterministic synthetic stream.
    data_path: str = ""
    data_seed: int = 0
    checkpoint_dir: str = ""
    checkpoint_every: int = 50
    resume: bool = True
    log_every: int = 10

    def validate(self) -> None:
        super().validate()
        if self.model not in _MODELS:
            raise ConfigError(
                f"model must be one of {sorted(_MODELS)}, got {self.model!r}")
        if self.batch_size <= 0 or self.seq_len <= 0 or self.steps <= 0:
            raise ConfigError("batch_size, seq_len, steps must be positive")
        if self.checkpoint_every <= 0:
            raise ConfigError("checkpoint_every must be positive")
        if self.data_path and not pathlib.Path(self.data_path).is_file():
            raise ConfigError(f"data_path {self.data_path!r} does not exist")


_MODELS = {"tiny": "TINY", "bench350m": "BENCH_350M", "llama3-8b": "LLAMA3_8B"}


def _env_int(env, name: str, default: int | None = None) -> int:
    raw = env.get(name)
    if raw is None:
        if default is None:
            raise RuntimeError(f"{name} is unset")
        return default
    try:
        return int(raw)
    except ValueError:
        raise RuntimeError(f"{name}={raw!r} is not an integer") from None


def maybe_init_distributed(device: str | torch.device = "cuda",
                           environ=None) -> bool:
    """Join the default process group, unless one exists; returns whether
    it made one.  Several processes: torchrun's ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``, failing fast on a
    rank that is unset, not an integer or out of range.  One process and
    no torchrun environment: a group of one rank, so one card runs the
    same sharded code as many.  NCCL on the card (after
    ``torch.cuda.set_device(LOCAL_RANK)``), gloo on the CPU."""
    if dist.is_initialized():
        return False
    env = environ if environ is not None else os.environ
    dev = resolve_device(device)
    world = _env_int(env, "WORLD_SIZE", 1)
    if world > 1:
        if env.get("RANK") is None:
            # every rank defaulting to 0 would hang the rendezvous with
            # duplicate ranks and no hint why
            raise RuntimeError(
                f"WORLD_SIZE lists {world} workers but RANK is unset — "
                f"cannot identify this process")
        rank = _env_int(env, "RANK")
        if not 0 <= rank < world:
            raise RuntimeError(
                f"RANK={rank} out of range for {world} workers")
    else:
        rank = 0
    local_rank = _env_int(env, "LOCAL_RANK", rank)
    backend = backend_for(dev.type)
    device_id = None
    if dev.type == "cuda":
        device_id = torch.device("cuda", local_rank)
        torch.cuda.set_device(device_id)
    if world > 1:
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world, device_id=device_id)
        logger.info("torch.distributed: rank %d/%d (%s, master %s)", rank,
                    world, backend, env.get("MASTER_ADDR"))
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, device_id=device_id)
    return True


def boot_world_size(environ=None) -> int:
    """The worker count this process booted with (torchrun's
    ``WORLD_SIZE``, from which the mesh was derived); 1 without it."""
    env = environ if environ is not None else os.environ
    return max(1, _env_int(env, "WORLD_SIZE", 1))


def _refuse_control_plane(cfg: TrainConfig) -> None:
    for field in ("kubeconfig", "health_probe_addr", "metrics_addr"):
        if getattr(cfg, field):
            raise NotImplementedError(f"{field} is set, but {_CONTROL_PLANE}")


def _probe_identity(cfg: TrainConfig, environ, hook: str):
    """Whether a per-checkpoint pod hook has what it needs: the pod's
    identity from the downward API (``POD_NAME`` and ``POD_NAMESPACE``,
    both or nothing) and a kubeconfig.  None, as in the JAX main, when
    either is missing; NotImplementedError when both are there, since the
    kube client is not ported."""
    env = environ if environ is not None else os.environ
    name = env.get("POD_NAME", "")
    namespace = env.get("POD_NAMESPACE", "")
    if not name or not namespace or not cfg.kubeconfig:
        return None
    raise NotImplementedError(f"{hook} for {namespace}/{name}: "
                              f"{_CONTROL_PLANE}")


def signal_checker(cfg: TrainConfig, environ=None):
    """The per-checkpoint control-signal probe — () -> (desired dp
    replica count or None, migration cause or None) — or None when pod
    identity or cluster access is unavailable."""
    return _probe_identity(cfg, environ, "signal checker")


def progress_reporter(cfg: TrainConfig, environ=None):
    """The per-checkpoint progress callback, or None when pod identity or
    cluster access is unavailable."""
    return _probe_identity(cfg, environ, "progress reporter")


def build(cfg: TrainConfig, device: str | torch.device = "cuda"):
    """(trainer, loader, checkpointer, start_state, start_step) from the
    config, separated from ``train`` so tests drive it.  Joins a process
    group first when there is none (``maybe_init_distributed``)."""
    from nos_tpu_torch.models import llama
    from nos_tpu_torch.models.checkpoint import TrainCheckpointer
    from nos_tpu_torch.models.data import TokenLoader
    from nos_tpu_torch.models.train import ShardedTrainer
    from nos_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    dev = resolve_device(device)
    maybe_init_distributed(dev)
    model_cfg = dataclasses.replace(
        getattr(llama, _MODELS[cfg.model]),
        attn_impl=cfg.attn_impl, remat_policy=cfg.remat_policy,
        scan_layers=cfg.scan_layers)
    spec = (MeshSpec.parse(cfg.mesh) if cfg.mesh
            else MeshSpec.for_device_count(dist.get_world_size()))
    mesh = make_mesh(spec, dev.type)
    trainer = ShardedTrainer(model_cfg, mesh, batch_size=cfg.batch_size,
                             seq_len=cfg.seq_len, device=dev)

    if cfg.data_path:
        loader = TokenLoader.from_memmap(
            cfg.data_path, cfg.batch_size, cfg.seq_len, seed=cfg.data_seed)
    else:
        loader = TokenLoader.synthetic(
            model_cfg.vocab_size,
            num_tokens=max(cfg.batch_size * cfg.seq_len * 8, 1 << 16),
            batch_size=cfg.batch_size, seq_len=cfg.seq_len,
            seed=cfg.data_seed)

    checkpointer = None
    start_step = 0
    state = None
    if cfg.checkpoint_dir:
        checkpointer = TrainCheckpointer(cfg.checkpoint_dir)
        latest = checkpointer.latest_step()
        if latest is not None and not cfg.resume:
            # a fresh run writing into an old run's directory would have
            # its saves silently skipped and later resumes would mix runs
            raise ConfigError(
                f"checkpoint_dir {cfg.checkpoint_dir!r} already holds "
                f"step {latest} and resume is false — use a fresh "
                f"directory or enable resume")
        if cfg.resume and latest is not None:
            state = checkpointer.restore(trainer.abstract_state())
            start_step = latest
            logger.info("resuming from checkpoint step %d", start_step,
                        extra={"start_step": start_step})
    if state is None:
        state = trainer.init_state(0)
    return trainer, loader, checkpointer, state, start_step


def train(cfg: TrainConfig, progress_cb=None, resize_cb=None,
          migrate_cb=None, device: str | torch.device = "cuda"
          ) -> float | None:
    """Run the loop; returns the final loss, or None when the checkpoint
    already covers every requested step (nothing to do).  ``progress_cb``
    (fraction in [0, 1]) is called after each landed checkpoint, never
    before.

    ``resize_cb`` (no args -> desired dp replica count or None) and
    ``migrate_cb`` (no args -> migration cause or None) are probed after
    each landed checkpoint: when the elastic machinery resized the gang,
    or drain-then-migrate asked the job to move, the loop exits cleanly
    AT THE CHECKPOINT, and the restart resumes it.  Without injected
    callbacks the pod hooks (``progress_reporter``, ``signal_checker``)
    supply them.

    Each log interval sets the ``nos_tpu_train_*`` gauges; the MFU is the
    analytic step FLOPs over every rank's card peak (``ops.roofline``),
    and is left unset on the CPU, which has no peak."""
    from nos_tpu_torch.ops.roofline import model_flops_per_step, peaks_for

    _refuse_control_plane(cfg)
    if progress_cb is None:
        progress_cb = progress_reporter(cfg)
    if resize_cb is None and migrate_cb is None:
        signal_cb = signal_checker(cfg)
    else:
        # injected probes (tests / embedders) keep their own reads
        _r, _m = resize_cb, migrate_cb
        signal_cb = lambda: (_r() if _r else None,  # noqa: E731
                             _m() if _m else None)
    world = boot_world_size()
    trainer, loader, checkpointer, state, start_step = build(cfg, device)
    if start_step >= cfg.steps:
        logger.info("checkpoint step %d >= steps %d: training already "
                    "complete", start_step, cfg.steps)
        if checkpointer is not None:
            checkpointer.close()
        return None
    step_fn = trainer.train_step()
    step_flops = model_flops_per_step(trainer.cfg, cfg.batch_size,
                                      cfg.seq_len)
    fleet_peak = None
    if trainer.device.type == "cuda":
        fleet_peak = peaks_for(torch.cuda.get_device_name(
            trainer.device))[0] * trainer.mesh.size()
    loss = math.nan
    t0 = time.perf_counter()
    logged_at = start_step
    batches = loader.device_iter(
        mesh=trainer.mesh, start_step=start_step,
        num_steps=cfg.steps - start_step)
    for step, batch in enumerate(batches, start=start_step + 1):
        state, loss_t = step_fn(state, batch)
        if step % cfg.log_every == 0 or step == cfg.steps:
            loss = float(loss_t)
            dt = max(time.perf_counter() - t0, 1e-9)
            interval = step - logged_at
            tokens_s = interval * cfg.batch_size * cfg.seq_len / dt
            mfu = (None if fleet_peak is None
                   else step_flops * interval / dt / fleet_peak)
            logger.info("step %d/%d loss %.4f (%.0f tokens/s, mfu %s)",
                        step, cfg.steps, loss, tokens_s,
                        "n/a" if mfu is None else f"{mfu:.3f}",
                        extra={"train_step": step, "train_loss": loss,
                               "tokens_per_s": tokens_s, "mfu": mfu})
            REGISTRY.set("nos_tpu_train_loss", loss)
            REGISTRY.set("nos_tpu_train_step", float(step))
            REGISTRY.set("nos_tpu_train_tokens_per_s", tokens_s)
            if mfu is not None:
                REGISTRY.set("nos_tpu_train_mfu", mfu)
            logged_at = step
            t0 = time.perf_counter()
        if checkpointer is not None and step % cfg.checkpoint_every == 0:
            if checkpointer.save(step, state):
                if progress_cb is not None:
                    # progress is only as durable as the checkpoint
                    # backing it: report AFTER the save lands
                    progress_cb(step / cfg.steps)
                if signal_cb is not None:
                    desired, cause = signal_cb()
                    if desired is not None and desired != world:
                        logger.info(
                            "dp resize requested (%d -> %d workers): "
                            "exiting at checkpoint step %d for re-mesh",
                            world, desired, step)
                        checkpointer.close()
                        return float(loss_t)
                    if cause:
                        logger.info(
                            "migration requested (%s): exiting at "
                            "checkpoint step %d for reschedule",
                            cause, step)
                        checkpointer.close()
                        return float(loss_t)
    if checkpointer is not None:
        if cfg.steps % cfg.checkpoint_every:
            if checkpointer.save(cfg.steps, state) \
                    and progress_cb is not None:
                progress_cb(1.0)
        checkpointer.close()
    return float(loss)


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default=None,
                    help="YAML/JSON TrainConfig file")
    args = ap.parse_args(argv)
    try:
        cfg = load_config(args.config, TrainConfig)
    except ConfigError as e:
        print(f"invalid config: {e}", file=sys.stderr)
        return 2
    _refuse_control_plane(cfg)
    # honor the device grant BEFORE the first CUDA call: CUDA reads its
    # visibility once, when it starts
    workload_env.apply()
    # ... and once CUDA is up, before the process group and any
    # allocation, PROVE the grant took and install the memory cap: a
    # ConfinementError stops the run before a step can use another
    # workload's device or memory
    verified = workload_env.validate_confinement()
    created = maybe_init_distributed("cuda")
    try:
        loss = train(cfg)
    finally:
        if created:
            dist.destroy_process_group()
    done = ("done: already complete" if loss is None
            else f"done: final loss {loss:.4f}")
    logger.info("%s grant %s", done, json.dumps(grant_report(verified)))
    return 0


def grant_report(verified: bool, environ=None) -> dict:
    """What the main's last line says of its grant: the devices and GB
    granted, whether validate_confinement verified them, the memory cap
    installed (fraction and bytes of device 0), the peak memory, and the
    flash kernels' launches (K1, K2)."""
    from nos_tpu_torch.ops import attention as A

    env = environ if environ is not None else os.environ
    report = {"verified": verified,
              "devices": workload_env.granted_device_ids(env),
              "timeshare_gb": workload_env.granted_timeshare_gb(env),
              "fraction": workload_env.memory_fraction(env),
              "cap_bytes": None, "max_memory_allocated": None,
              "max_memory_reserved": None,
              "launches": {"flash_fwd": A.FLASH_FWD_LAUNCHES,
                           "flash_bwd_fused": A.FLASH_BWD_FUSED_LAUNCHES}}
    if torch.cuda.is_initialized():
        total = torch.cuda.get_device_properties(0).total_memory
        if verified and report["fraction"] is not None:
            report["cap_bytes"] = int(report["fraction"] * total)
        report["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        report["max_memory_reserved"] = torch.cuda.max_memory_reserved()
    return report


if __name__ == "__main__":
    sys.exit(main())
