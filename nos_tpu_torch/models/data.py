"""Token-batch input for training, the port of ``nos_tpu/models/data.py``.

``TokenLoader`` is a copy of the JAX package's numpy loader: fixed-shape
[batch, seq_len] int32 windows over a flat token stream (a numpy array
or a memmapped token file), deterministic per seed and epoch, so the
same seed gives the same batches in both packages.  ``device_iter``
feeds a mesh: each rank gets its block of every global batch, copied to
its device one batch ahead of the consumer.
"""

from __future__ import annotations

import itertools
import pathlib
from typing import Iterator

import numpy as np
import torch

from nos_tpu_torch import resolve_device
from nos_tpu_torch.parallel.mesh import local_block


class TokenLoader:
    """Deterministic [batch, seq_len] windows over a flat token stream."""

    def __init__(self, tokens: np.ndarray, batch_size: int, seq_len: int,
                 seed: int = 0) -> None:
        if tokens.ndim != 1:
            raise ValueError(f"token stream must be flat, got shape "
                             f"{tokens.shape}")
        self.tokens = tokens
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.seed = seed
        self.windows_per_epoch = len(tokens) // seq_len
        self.steps_per_epoch = self.windows_per_epoch // batch_size
        self._order_cache: tuple[int, np.ndarray] | None = None
        if self.steps_per_epoch == 0:
            raise ValueError(
                f"stream of {len(tokens)} tokens yields "
                f"{self.windows_per_epoch} windows of {seq_len} — fewer "
                f"than one batch of {batch_size}")

    @classmethod
    def from_memmap(cls, path: str | pathlib.Path, batch_size: int,
                    seq_len: int, dtype=np.uint16,
                    seed: int = 0) -> "TokenLoader":
        """A binary token file (e.g. uint16 little-endian), memory-mapped."""
        tokens = np.memmap(path, dtype=dtype, mode="r")
        return cls(tokens, batch_size, seq_len, seed=seed)

    @classmethod
    def synthetic(cls, vocab_size: int, num_tokens: int, batch_size: int,
                  seq_len: int, seed: int = 0) -> "TokenLoader":
        """Deterministic fake stream (benchmarks, tests, dryruns)."""
        rng = np.random.default_rng(seed)
        tokens = rng.integers(0, vocab_size, size=num_tokens,
                              dtype=np.int32)
        return cls(tokens, batch_size, seq_len, seed=seed)

    def _order(self, epoch: int) -> np.ndarray:
        # one permutation per epoch, cached
        if self._order_cache is None or self._order_cache[0] != epoch:
            rng = np.random.default_rng((self.seed, epoch))
            self._order_cache = (epoch, rng.permutation(
                self.windows_per_epoch))
        return self._order_cache[1]

    def batch_at(self, step: int) -> np.ndarray:
        """The [batch, seq_len] int32 batch for global step ``step``."""
        epoch, within = divmod(step, self.steps_per_epoch)
        order = self._order(epoch)
        idx = order[within * self.batch_size:(within + 1) * self.batch_size]
        out = np.empty((self.batch_size, self.seq_len), np.int32)
        for row, w in enumerate(idx):
            start = int(w) * self.seq_len
            out[row] = self.tokens[start:start + self.seq_len]
        return out

    def batches(self, start_step: int = 0) -> Iterator[np.ndarray]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1

    # -- device feeding -----------------------------------------------------
    def device_iter(self, mesh=None, start_step: int = 0,
                    num_steps: int | None = None) -> Iterator[torch.Tensor]:
        """int32 batches on the device from ``start_step`` on (``num_steps``
        of them, or without end): this rank's block of each global batch
        under ``mesh`` (``parallel.mesh.local_block``: rows over dp x fsdp,
        the sequence over sp) on the mesh's device, or the whole batch on
        ``cuda`` without a mesh.  The next batch's copy is issued before
        the previous one is yielded; on the card it runs from pinned
        memory without blocking, so it overlaps the step."""
        device = resolve_device(None if mesh is None else mesh.device_type)

        def put(arr: np.ndarray) -> torch.Tensor:
            block = arr if mesh is None else local_block(arr, mesh)
            host = torch.from_numpy(np.ascontiguousarray(block))
            if device.type == "cuda":
                return host.pin_memory().to(device, non_blocking=True)
            return host.to(device)

        it = self.batches(start_step)
        if num_steps is not None:
            it = itertools.islice(it, num_steps)
        pending = None
        for arr in it:
            nxt = put(arr)     # issue the copy before yielding the previous
            if pending is not None:
                yield pending
            pending = nxt
        if pending is not None:
            yield pending
