"""The MFU sweep (``scripts/mfu_explore_torch.py``) against the JAX sweep
(``scripts/mfu_explore.py``, read with ``ast``, never imported: it
imports jax and bench_compute at import) on the CPU: the variants and
the ``--quick`` cut, a row of one variant at test widths, what is
caught, and the card-only entry point."""

from __future__ import annotations

import ast
import dataclasses
import json
import math
import pathlib

import pytest
import torch
import torch.distributed as dist

import chip_smoke
from nos_tpu_torch.models.llama import BENCH_350M, TINY

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_SWEEP = ROOT / "scripts" / "mfu_explore.py"


mfu = chip_smoke._mfu_module()

# head_dim 128, so attn_impl="flash" reaches the port's flash op (its
# plain version on the CPU).
BASE = dataclasses.replace(TINY, hidden_size=128, num_heads=2,
                           num_kv_heads=1, head_dim=128)
SEQ = 32
H100_PEAK = 989e12
ROW_KEYS = {"batch", "fused", "remat", "step_ms", "tokens_per_s", "mfu",
            "loss0", "loss", "peak_mem_bytes", "launches_per_step", "device"}


def _jax_variants() -> tuple[list[tuple], int]:
    """JAX's variant list and the length its ``--quick`` keeps."""
    tree = ast.parse(JAX_SWEEP.read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    variants = quick = None
    for node in ast.walk(main):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.List) \
                and [t.id for t in node.targets] == ["variants"]:
            variants = ast.literal_eval(node.value)
        if isinstance(node, ast.Subscript) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "variants" \
                and isinstance(node.slice, ast.Slice):
            quick = ast.literal_eval(node.slice.upper)
    return variants, quick


@pytest.fixture
def one_rank_group():
    """The sweep makes a one-rank group where there is none; the test
    leaves none behind."""
    had = dist.is_initialized()
    yield
    if not had and dist.is_initialized():
        dist.destroy_process_group()


class TestVariants:
    """(c) JAX's six variants in JAX's order, and its --quick cut."""

    def test_variants_and_quick_are_jax_s(self):
        variants, quick = _jax_variants()
        assert [tuple(v) for v in variants] == mfu.VARIANTS
        assert quick == mfu.QUICK == 3

    def test_the_model_is_bench_350m_unscanned_flash(self):
        cfg = mfu.variant_config(True, "all_mats")
        assert dataclasses.replace(
            cfg, attn_impl="dense", remat_policy="nothing", scan_layers=True,
            fused_qkv=False, fused_gate_up=False) == BENCH_350M
        assert (cfg.attn_impl, cfg.remat_policy, cfg.scan_layers,
                cfg.fused_qkv, cfg.fused_gate_up) == (
                    "flash", "all_mats", False, True, True)
        assert mfu.SEQ == 2048

    def test_repeats_give_a_band(self):
        assert mfu.REPEATS >= 3 and mfu.STEPS >= 1


class TestRow:
    """(d) One variant on the CPU at test widths."""

    @pytest.fixture(scope="class")
    def row(self):
        had = dist.is_initialized()
        try:
            yield mfu.time_variant(8, True, "mats", H100_PEAK, "cpu",
                                   base=BASE, seq=SEQ)
        finally:
            if not had and dist.is_initialized():
                dist.destroy_process_group()

    def test_every_key(self, row):
        assert set(row) == ROW_KEYS
        assert (row["batch"], row["fused"], row["remat"]) == (8, True, "mats")
        assert set(row["launches_per_step"]) == {
            "flash_fwd", "flash_bwd_fused", "flash_dq", "flash_dkv"}

    def test_a_band_and_a_finite_mfu(self, row):
        band = row["step_ms"]
        assert 0 < band["min"] <= band["median"] <= band["max"]
        assert math.isfinite(row["mfu"]) and row["mfu"] > 0
        cfg = mfu.variant_config(True, "mats", BASE)
        seconds = band["median"] / 1e3
        assert row["mfu"] == pytest.approx(
            mfu.model_flops_per_step(cfg, 8, SEQ) / seconds / H100_PEAK)
        assert row["tokens_per_s"] == pytest.approx(8 * SEQ / seconds)
        assert math.isfinite(row["loss"])

    def test_the_first_loss_is_the_loss_at_initialisation(self, row):
        # log(vocab) + hidden x std^2 / 2: chip_smoke's EXPECTED_LOSS0 at
        # these widths (0.02, the init's std)
        want = math.log(BASE.vocab_size) + BASE.hidden_size * 0.02 ** 2 / 2
        assert abs(row["loss0"] - want) <= chip_smoke.LOSS0_TOL
        assert chip_smoke.EXPECTED_LOSS0 == pytest.approx(
            math.log(BENCH_350M.vocab_size)
            + BENCH_350M.hidden_size * 0.02 ** 2 / 2)

    def test_a_cpu_row_names_the_cpu_and_no_device_figures(self, row):
        assert row["device"] == "cpu" and row["peak_mem_bytes"] is None
        # the plain versions run on the CPU: no kernel is launched
        assert set(row["launches_per_step"].values()) == {0}


class TestSweep:
    """(e) Only running out of device memory becomes a row."""

    def test_an_oom_becomes_an_error_row(self, monkeypatch, capsys):
        def oom(batch, fused, remat, peak, dev):
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to "
                                         "allocate 2.00 GiB")

        monkeypatch.setattr(mfu, "time_variant", oom)
        rows = mfu.sweep(mfu.VARIANTS[:2], H100_PEAK, "cpu")
        assert [(r["batch"], r["fused"], r["remat"]) for r in rows] == \
            mfu.VARIANTS[:2]
        assert all(r["error"].startswith("CUDA out of memory") for r in rows)
        lines = capsys.readouterr().out.splitlines()
        assert [json.loads(line) for line in lines] == rows

    def test_any_other_failure_raises(self, monkeypatch):
        def broken(batch, fused, remat, peak, dev):
            raise ValueError("unknown remat_policy")

        monkeypatch.setattr(mfu, "time_variant", broken)
        with pytest.raises(ValueError, match="remat_policy"):
            mfu.sweep(mfu.VARIANTS, H100_PEAK, "cpu")

    def test_the_rows_come_in_variant_order(self, one_rank_group, capsys):
        rows = mfu.sweep([(4, False, "mats"), (4, True, "all_mats")],
                         H100_PEAK, "cpu", base=BASE, seq=SEQ)
        assert [(r["batch"], r["fused"], r["remat"]) for r in rows] == [
            (4, False, "mats"), (4, True, "all_mats")]
        assert all(set(r) == ROW_KEYS for r in rows)
        assert len(capsys.readouterr().out.splitlines()) == 2


class TestNoQuietCPU:
    """(f) The sweep's entry point and functions raise without a card
    unless asked for the CPU."""

    @pytest.fixture(autouse=True)
    def no_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    @pytest.mark.parametrize("argv", [[], ["--quick"]])
    def test_main_raises(self, argv):
        with pytest.raises(RuntimeError, match="CUDA"):
            mfu.main(argv)

    def test_functions_default_to_the_card(self):
        with pytest.raises(RuntimeError, match="CUDA"):
            mfu.time_variant(8, False, "mats", H100_PEAK)
        with pytest.raises(RuntimeError, match="CUDA"):
            mfu.sweep(mfu.VARIANTS, H100_PEAK)


class TestSmokeMfu:
    """chip_smoke.py's phase 22 checks (``check_mfu``)."""

    ROW = {"batch": 8, "fused": False, "remat": "mats", "mfu": 0.11,
           "loss0": 10.58, "loss": 8.9, "launches_per_step": {
               "flash_fwd": 24.0, "flash_bwd_fused": 24.0, "flash_dq": 0.0,
               "flash_dkv": 0.0}}

    def test_a_card_row_passes(self):
        split = dict(self.ROW, launches_per_step={
            "flash_fwd": 24.0, "flash_bwd_fused": 0.0, "flash_dq": 24.0,
            "flash_dkv": 24.0})
        chip_smoke.check_mfu([self.ROW, split])

    @pytest.mark.parametrize("fault", [
        {"error": "CUDA out of memory"}, {"loss": float("nan")},
        {"loss0": 10.1}, {"loss0": 11.0}, {"loss0": float("nan")},
        {"mfu": 0.0}, {"mfu": 1.2},
        {"launches_per_step": {"flash_fwd": 0.0, "flash_bwd_fused": 24.0,
                               "flash_dq": 0.0, "flash_dkv": 0.0}},
        {"launches_per_step": {"flash_fwd": 24.0, "flash_bwd_fused": 0.0,
                               "flash_dq": 24.0, "flash_dkv": 0.0}},
    ])
    def test_a_fault_fails(self, fault):
        with pytest.raises(SystemExit, match="MFU sweep"):
            chip_smoke.check_mfu([self.ROW, dict(self.ROW, **fault)])


def test_card_line_is_nvidia_smi_s_first_card(monkeypatch):
    """The demo's and the sweep's ``name, power.limit`` (ops.roofline)."""
    import subprocess

    from nos_tpu_torch.ops import roofline

    calls = []

    def run(cmd, **kwargs):
        calls.append(cmd)
        return subprocess.CompletedProcess(
            cmd, 0, stdout="NVIDIA H100 80GB HBM3, 700.00 W\n"
                           "NVIDIA H100 80GB HBM3, 700.00 W\n")

    monkeypatch.setattr(roofline.subprocess, "run", run)
    assert roofline.card_line("cuda") == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert calls == [["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"]]
    assert roofline.card_line("cpu") == "cpu" and len(calls) == 1
