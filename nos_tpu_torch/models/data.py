"""Token-batch input for training, the port of ``nos_tpu/models/data.py``.

``TokenLoader`` is a copy of the JAX package's numpy loader: fixed-shape
[batch, seq_len] int32 windows over a flat token stream (a numpy array
or a memmapped token file), deterministic per seed and epoch, so the
same seed gives the same batches in both packages.  The JAX loader's
``device_iter`` (sharded, prefetched transfer) belongs to the multi-GPU
slice; ``Trainer.train_step`` takes the numpy batch and copies it.
"""

from __future__ import annotations

import pathlib
from typing import Iterator

import numpy as np


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
