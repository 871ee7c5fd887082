"""The benchmark's own tests: on the CPU, with those that need a card
marked ``cuda`` (they skip here, deciding inside the test).  Run from
the checkout's root: ``python -m pytest portbench/tests -q``; on the
card, ``python -m pytest portbench/tests -q -m cuda``."""

import json
from pathlib import Path

import pytest

DATA = Path(__file__).resolve().parent / "data"
ROOT = Path(__file__).resolve().parents[2]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips with its reason "
        "without one; select with `-m cuda`")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


def tiny_bench() -> dict:
    """BENCHMARK.json with the test-size configurations and cells in
    place of the real ones."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [
        {"name": f"tiny-{k}", "file": f"portbench/tests/data/tiny-{k}.json"}
        for k in ("dense", "moe")]
    bench["workloads"] = [
        {"name": f"tiny-{k}-train", "config": f"tiny-{k}",
         "traffic": "train-b2-s32", "chips": 1} for k in ("dense", "moe")]
    return bench


def tiny_cell(family: str):
    from portbench.cells import load_cell

    return load_cell(f"tiny-{family}-train", tiny_bench(),
                     workloads=DATA / "workloads", root=ROOT)


@pytest.fixture(autouse=True)
def _one_group():
    """Each test leaves no process group behind."""
    yield
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
