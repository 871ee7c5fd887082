"""A whole run at test size on the CPU (the harness's look for a card
skipped), once sound and once with the timed path broken underneath:
``correct`` comes out true, then false for each fault a training cell
can have on one chip."""

import contextlib
import importlib
import time

import numpy as np
import pytest
import torch

from portbench import calibrate, run
from portbench.tests.conftest import tiny_bench, tiny_cell

SEED = 2 ** 31 + 11


def _run(cell, trace=False):
    return run.run_cell(cell, tiny_bench(), SEED, 1.0, trace, "cpu",
                        time.time(), trace_dir=None if not trace else
                        run.CACHE / "test-traces")


def _break_feed(monkeypatch, cell, wrap):
    entry = importlib.import_module(f"portbench.entries.{cell.entry}")
    batches = entry.Session.batches
    monkeypatch.setattr(entry.Session, "batches",
                        lambda self: wrap(batches(self)))


def _altered(feed):
    for b in feed:
        b = b.clone() if isinstance(b, torch.Tensor) else np.array(b)
        b[0, 5] = (b[0, 5] + 1) % 256
        yield b


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_sound_run_is_correct(family):
    result = _run(tiny_cell(family))
    assert result["correct"] and result["failed"] == 0
    assert list(result)[-1] == "check"
    assert result["metrics"]["train_tokens_per_s"]["value"] > 0


@pytest.mark.parametrize("family", ["dense", "moe"])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "token"])
def test_fault_is_caught(monkeypatch, family, fault):
    cell = tiny_cell(family)
    ctx = contextlib.nullcontext()
    if fault == "unchanged":
        ctx = calibrate.unchanged()
    elif fault == "half_batch":
        _break_feed(monkeypatch, cell, calibrate.half_batch)
    else:
        _break_feed(monkeypatch, cell, _altered)
    with ctx:
        result = _run(cell)
    assert not result["correct"], result["check"]


def test_traced_run_reads_its_window():
    result = _run(tiny_cell("dense"), trace=True)
    assert result["correct"]
    assert result["device"]["window_s"] > 0
    assert result["attempted"] == 2
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
