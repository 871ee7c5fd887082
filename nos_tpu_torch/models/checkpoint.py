"""Sharded training-state checkpoints, ``nos_tpu/models/checkpoint.py``
on ``torch.distributed.checkpoint`` (DCP).

The compute-side half of preempt -> re-carve -> resume: a gang that the
capacity scheduler evicted restarts from its last step instead of from
scratch.  The contract is the JAX module's:

- one directory per step under ``directory``, the newest
  ``max_to_keep`` kept;
- saves are synchronous (a checkpoint still in flight when preemption
  lands is the failure this exists to prevent);
- ``save`` of a step that exists returns False and logs, never
  overwrites;
- ``restore(state_like, step=None)`` loads into the structure of a
  freshly built trainer's ``abstract_state()`` on the same mesh shape.

Every rank of the default process group calls each method.  A state is
saved as DCP's sharded model and optimizer state dicts
(``get_state_dict``: the FSDP2 parameters and AdamW's moments and step
counts, each rank writing its own shards; one set per tp rank) and the
update count, so a restored run continues bitwise.  A step is written
into ``<step>.tmp`` and renamed to ``<step>`` once complete, so a
directory named by a step is always a whole checkpoint.
"""

from __future__ import annotations

import logging
import pathlib
import shutil
import time

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint.state_dict import (get_state_dict,
                                                     set_state_dict)

logger = logging.getLogger(__name__)


def _state_dict(state) -> dict:
    """What a checkpoint holds.  Under tp each rank's parameters are its
    own share under the whole parameter's name, which DCP would take for
    one tensor, so each tp rank's state goes under a key of its own."""
    model, optim = get_state_dict(state.model, state.optimizer.adamw)
    return {f"tp{state.model.par.tp_rank}": {"model": model, "optim": optim},
            "count": torch.tensor(state.optimizer.count, dtype=torch.int64)}


def _on_rank0(fn, *args):
    """fn(*args) on rank 0, its result on every rank."""
    out = [fn(*args) if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(out, src=0)
    return out[0]


class TrainCheckpointer:
    """Step-numbered ``TrainState`` checkpoints under one directory."""

    def __init__(self, directory: str | pathlib.Path,
                 max_to_keep: int = 3) -> None:
        self.directory = pathlib.Path(directory).absolute()
        self.max_to_keep = max_to_keep
        if dist.get_rank() == 0:
            self.directory.mkdir(parents=True, exist_ok=True)
        dist.barrier()

    def _steps(self) -> list[int]:
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.is_dir() and p.name.isdigit())

    def save(self, step: int, state) -> bool:
        path = self.directory / str(step)
        if _on_rank0(path.exists):
            logger.warning("checkpoint: step %d already exists, NOT "
                           "overwritten (reusing a checkpoint_dir across "
                           "runs without resume?)", step)
            return False
        tmp = self.directory / f"{step}.tmp"
        if dist.get_rank() == 0 and tmp.exists():
            shutil.rmtree(tmp)                 # an interrupted earlier save
        dist.barrier()
        t0 = time.perf_counter()
        dcp.save(_state_dict(state), checkpoint_id=tmp)
        dist.barrier()
        if dist.get_rank() == 0:
            tmp.rename(path)
            for old in self._steps()[:-self.max_to_keep]:
                shutil.rmtree(self.directory / str(old))
        dist.barrier()
        seconds = time.perf_counter() - t0
        logger.info("checkpoint: saved step %d (%.3f s)", step, seconds,
                    extra={"checkpoint_step": step,
                           "checkpoint_save_s": seconds})
        return True

    def latest_step(self) -> int | None:
        steps = _on_rank0(self._steps)
        return steps[-1] if steps else None

    def restore(self, state_like, step: int | None = None):
        """Load step ``step`` (the latest when None) into ``state_like``,
        preferably ``trainer.abstract_state()``, and return it."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError("no checkpoint to restore")
        t0 = time.perf_counter()
        sd = _state_dict(state_like)
        dcp.load(sd, checkpoint_id=self.directory / str(step))
        own = sd[f"tp{state_like.model.par.tp_rank}"]
        set_state_dict(state_like.model, state_like.optimizer.adamw,
                       model_state_dict=own["model"],
                       optim_state_dict=own["optim"])
        state_like.optimizer.count = int(sd["count"])
        seconds = time.perf_counter() - t0
        logger.info("checkpoint: restored step %d (%.3f s)", step, seconds,
                    extra={"checkpoint_step": step,
                           "checkpoint_restore_s": seconds})
        return state_like

    def close(self) -> None:
        """Saves are synchronous, so nothing is in flight: a no-op kept
        for the JAX module's interface."""
