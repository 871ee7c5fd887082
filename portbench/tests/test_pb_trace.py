"""The trace reader and the per-layer readers on a saved small profile
(``data/small_trace.json``: Kineto's Chrome trace format, two steps,
one of them with a recompute of the flash forward inside another
node's backward), against hand counts."""

import sys
import types

import pytest

from portbench import flops, metrics, trace
from portbench.metrics import module
from portbench.tests.conftest import DATA, tiny_cell

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(scope="module")
def tr():
    return trace.load(DATA / "small_trace.json")


class Cell:
    """1 x 1024 tokens through Mistral's attention widths."""

    def __init__(self):
        self.spec = tiny_cell("dense").spec.__class__(**{
            **tiny_cell("dense").spec.__dict__, "num_heads": 32,
            "num_kv_heads": 8, "head_dim": 128})
        self.batch_size, self.seq_len = 1, 1024


def test_window_steps_busy(tr):
    assert tr.steps == 2
    assert tr.window_s == pytest.approx(1e-3)
    # 40-280, 290-295, 350-380, 540-640, 700-750, 760-860 us
    assert tr.busy_s == pytest.approx(525e-6)
    assert len(tr.device) == 10       # the copy after the window is out
    assert module("device_idle_share").read(tr, None, H100) == \
        pytest.approx(47.5)


def test_groups_by_launching_op(tr):
    read = {n: module(n).read(tr, None, H100) for n in
            ("gemm_ms_step", "elementwise_ms_step", "optimizer_ms_step")}
    assert read["gemm_ms_step"] == pytest.approx(0.030)
    # the add, and the memset tied to it by its External id
    assert read["elementwise_ms_step"] == pytest.approx(0.0125)
    assert read["optimizer_ms_step"] == pytest.approx(0.015)


@pytest.mark.parametrize("names", [
    {"aten::add", "aten::mul"},                  # what elementwise counts
    {"aten::mm", "aten::_foreach_add_"},         # what the groups claim
    {"portbench.step", "portbench.window"},      # outer ops of every chain
])
def test_a_metric_added_later_moves_nothing(tr, monkeypatch, names):
    """A metric module added later with a MATCH of its own leaves every
    group's time, and what ``elementwise_ms_step`` counts, as they were:
    the groups resolve against the fixed ``GROUPS`` alone."""
    fixed = ("gemm_ms_step", "elementwise_ms_step", "optimizer_ms_step",
             "attn_fwd_roofline", "attn_bwd_roofline")
    before = {n: module(n).read(tr, Cell(), H100) for n in fixed}
    probe = types.ModuleType("portbench.metrics.probe_ms_step")
    probe.MATCH = lambda name: name in names
    monkeypatch.setitem(sys.modules, probe.__name__, probe)
    assert {n: module(n).read(tr, Cell(), H100) for n in fixed} == before
    claimed = metrics.owned(tr, "probe_ms_step")
    assert claimed and all(tr.ops[op].name in names for _, op in claimed)


def test_attention_rooflines(tr):
    cell = Cell()
    peak, bw = flops.peaks_for(H100)
    fwd, bwd = module("attn_fwd_roofline"), module("attn_bwd_roofline")
    # three forward calls (one a recompute under MulBackward0) in 300 us
    least = 3 * max(fwd.call_flops(cell) / peak, fwd.call_bytes(cell) / bw)
    assert fwd.read(tr, cell, H100) == pytest.approx(100 * least / 300e-6)
    assert fwd.call_flops(cell) / peak == pytest.approx(8.686e-6, rel=1e-3)
    # two backward calls: delta's mul and the kernel, then a kernel
    least = 2 * max(bwd.call_flops(cell) / peak, bwd.call_bytes(cell) / bw)
    assert bwd.read(tr, cell, H100) == pytest.approx(100 * least / 110e-6)
    assert fwd.read(tr, cell, "cpu") is None


def test_step_mfu(tr):
    cell = Cell()
    want = 100 * flops.model_flops(cell.spec, 1, 1024) / 0.5e-3 / 989e12
    assert module("step_mfu").read(tr, cell, H100) == pytest.approx(want)


def test_nothing_to_read_gives_nothing(tr):
    empty = trace.Trace(tr.ops, [], tr.window, tr.steps)
    for name in ("gemm_ms_step", "elementwise_ms_step", "optimizer_ms_step",
                 "attn_fwd_roofline", "attn_bwd_roofline",
                 "device_idle_share"):
        assert module(name).read(empty, Cell(), H100) is None


def test_breakdown(tr):
    out = trace.breakdown(tr)
    ops = dict(out["device_ops"])
    assert ops["nos_tpu_torch::flash_fwd > flash_fwd_kernel"] == \
        pytest.approx(200e-6)
    assert sum(ops.values()) == pytest.approx(525e-6)
    gaps = [s for _, s in out["idle_gaps"]]
    assert gaps == sorted(gaps, reverse=True)
    assert gaps[0] == pytest.approx(160e-6)      # 380-540 us
    assert sum(gaps) == pytest.approx(1e-3 - 525e-6)
