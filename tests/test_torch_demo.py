"""The GPU sharing demo (``demos/gpu-sharing-comparison/run.py``) against
the JAX demo (``demos/tpu-sharing-comparison/run.py``) on the CPU: the
request on converted parameters against the flax forward, the client
processes' protocol, the JSON lines' keys, and the card-only entry
point.  The JAX demo is read with ``ast``, never imported (it imports
jax at call time and prints "skipped" off a TPU)."""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from nos_tpu.models import llama as jl
from nos_tpu_torch.models import llama as tl
from nos_tpu_torch.models.convert import params_from_jax
from nos_tpu_torch.ops import attention as A
from test_torch_llama import flax_params, port_cfg, tokens_for

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_DEMO = ROOT / "demos" / "tpu-sharing-comparison" / "run.py"


demo = chip_smoke._demo_module()

# The demo's model at test widths: head_dim 128, so attn_impl="flash"
# reaches the port's flash op (its plain version on the CPU) while the
# flax model takes its dense path, as tests/test_torch_llama.py's TOY.
WIDTHS = dict(vocab_size=256, hidden_size=128, intermediate_size=128,
              num_layers=2, num_heads=2, num_kv_heads=1, head_dim=128,
              max_seq_len=128)
BATCH, SEQ = 2, 32
# fp32 through two layers: each last-position logit within 1e-4 of
# flax's (tests/test_torch_llama.py's limit), and their sum over batch x
# vocab (512 values) within 1e-3.
LOGITS_ATOL = 1e-4
SCALAR_ATOL = 1e-3


def _jax_main_dicts() -> list[ast.Dict]:
    tree = ast.parse(JAX_DEMO.read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    return [n for n in ast.walk(main) if isinstance(n, ast.Dict)
            and all(isinstance(k, ast.Constant) for k in n.keys)]


def _keys(d: ast.Dict) -> set[str]:
    return {k.value for k in d.keys}


class TestContract:
    def test_sizes_and_counts_are_jax_s(self):
        tree = ast.parse(JAX_DEMO.read_text())
        consts = {}
        for node in tree.body:
            if isinstance(node, ast.Assign):
                value = ast.literal_eval(node.value)
                for target in node.targets:
                    if isinstance(target, ast.Name):
                        consts[target.id] = value
                    elif isinstance(target, ast.Tuple):
                        for t, v in zip(target.elts, value):
                            consts[t.id] = v
        assert consts["REQUESTS_PER_CLIENT"] == demo.REQUESTS_PER_CLIENT == 6
        assert consts["CLIENT_COUNTS"] == demo.CLIENT_COUNTS == [1, 2, 4, 7]
        assert (consts["BATCH"], consts["SEQ"]) == (demo.BATCH, demo.SEQ)

    def test_the_model_is_bench_350m_flash_without_remat(self):
        cfg = demo.demo_config()
        assert dataclasses.replace(cfg, attn_impl="dense", remat=True) \
            == tl.BENCH_350M
        assert cfg.attn_impl == "flash" and not cfg.remat
        assert demo.demo_config(attn_impl="dense").attn_impl == "dense"

    def test_seven_grants_fit_the_card(self):
        assert max(demo.CLIENT_COUNTS) * demo.GRANT_GB <= 80

    def test_row_and_summary_keys_are_jax_s(self):
        dicts = _jax_main_dicts()
        jax_row = next(d for d in dicts if "clients" in _keys(d))
        jax_summary = next(d for d in dicts if "summary" in _keys(d))
        rows = [demo.row(n, [0.1 * n] * (n * demo.REQUESTS_PER_CLIENT))
                for n in demo.CLIENT_COUNTS]
        assert all(set(r) == _keys(jax_row) for r in rows)
        out = demo.summary(rows, "cpu")
        assert set(out) == _keys(jax_summary)
        assert out["dedicated_mean_s"] == rows[0]["mean_s"]
        assert out["degradation"] == {"1": 1.0, "2": 2.0, "4": 4.0,
                                      "7": 7.0}
        assert [r["requests"] for r in rows] == [6, 12, 24, 42]

    def test_the_isolated_row_skips_on_a_host_of_one_gpu(self):
        out = demo.run_isolated("cpu")
        assert out["isolated_row"] == "skipped"
        assert "needs >=2 local GPUs" in out["reason"]
        assert demo.run_isolated("cpu", ["GPU-0"])["isolated_row"] \
            == "skipped"


# A neighbour that records its grant and its pid, then idles as long as
# the matmul hammer runs.
_STUB_HAMMER = (
    "import os, pathlib, time\n"
    "pathlib.Path({out!r}, str(os.getpid())).write_text(\n"
    "    os.environ['NOS_TPU_VISIBLE_CHIPS'])\n"
    "time.sleep(60)\n"
)


class TestIsolated:
    """run_isolated's branch for a host of two or more GPUs, on the CPU:
    the host's GPUs given as UUIDs, the neighbours a stub that records
    its grant."""

    @pytest.mark.parametrize("n_gpus, neighbours", [(2, 1), (5, 3)])
    def test_one_client_beside_confined_neighbours(
            self, tmp_path, monkeypatch, n_gpus, neighbours):
        monkeypatch.setenv("OMP_NUM_THREADS", "1")
        uuids = [f"GPU-{i}" for i in range(n_gpus)]
        out = demo.run_isolated(
            "cpu", uuids, _STUB_HAMMER.format(out=str(tmp_path)),
            model=WIDTHS, batch=BATCH, seq=SEQ)
        assert set(out) == {"isolated_mean_s", "isolated_max_s",
                            "neighbours"}
        assert 0 < out["isolated_mean_s"] <= out["isolated_max_s"]
        assert out["neighbours"] == neighbours
        grants = {f.name: f.read_text() for f in tmp_path.iterdir()}
        # each neighbour confined to one of GPUs 1-3, GPU 0 left to the
        # client
        assert sorted(grants.values()) == uuids[1:1 + neighbours]
        for pid in grants:       # every neighbour stopped with the row
            with pytest.raises(ProcessLookupError):
                os.kill(int(pid), 0)


class TestMain:
    def test_the_device_flag_reaches_every_row(self, monkeypatch, capsys):
        seen = []
        rows = [demo.row(n, [0.1 * n] * (n * demo.REQUESTS_PER_CLIENT))
                for n in demo.CLIENT_COUNTS]

        def timeshare(dev):
            seen.append(("timeshare", dev))
            return rows, []

        def isolated(dev):
            seen.append(("isolated", dev))
            return {"isolated_row": "skipped", "reason": "one GPU"}

        monkeypatch.setattr(demo, "run_timeshare", timeshare)
        monkeypatch.setattr(demo, "run_isolated", isolated)
        demo.main(["--device", "cpu"])
        assert seen == [("timeshare", torch.device("cpu")),
                        ("isolated", torch.device("cpu"))]
        lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
        assert lines[:4] == rows
        assert lines[4] == demo.summary(rows, "cpu")
        assert lines[5] == {"isolated_row": "skipped", "reason": "one GPU"}


class TestRequestAgainstJax:
    """(a) The demo's request on converted parameters against the flax
    model's ``apply(params, tokens)[:, -1, :].sum()``."""

    @pytest.fixture(scope="class")
    def pair(self):
        jcfg = dataclasses.replace(
            jl.BENCH_350M, attn_impl="flash", remat=False,
            dtype=jnp.float32, **WIDTHS)
        params = flax_params(jcfg)
        tokens = tokens_for(jcfg, 1, batch=BATCH, seq=SEQ)
        last = jl.Llama(jcfg).apply(params, jnp.asarray(tokens))[:, -1, :]
        want, want_logits = float(last.sum()), np.asarray(last, np.float32)
        cfg = port_cfg(jcfg)
        assert cfg == demo.demo_config(dtype=torch.float32, **WIDTHS)
        model = tl.Llama(cfg, device="cpu")
        model.load_state_dict(params_from_jax(params, cfg), assign=True)
        request = demo.Request(model, torch.from_numpy(tokens))
        got = request()
        return got, request.last.numpy(), want, want_logits

    def test_the_scalar_is_flax_s(self, pair):
        got, _, want, _ = pair
        assert isinstance(got, float)
        assert got == pytest.approx(want, abs=SCALAR_ATOL)

    def test_the_last_logits_are_flax_s(self, pair):
        _, logits, _, want = pair
        assert logits.shape == (BATCH, WIDTHS["vocab_size"])
        np.testing.assert_allclose(logits, want, atol=LOGITS_ATOL, rtol=0)

    def test_build_model_is_seeded(self):
        cfg = demo.demo_config(**WIDTHS)
        a = demo.build_model("cpu", cfg, BATCH, SEQ)
        b = demo.build_model("cpu", cfg, BATCH, SEQ)
        assert torch.equal(a.tokens, b.tokens)
        assert tuple(a.tokens.shape) == (BATCH, SEQ)
        assert a() == b()
        assert torch.equal(a.last, b.last)


class TestClients:
    """(b) The client processes at two CPU workers."""

    @pytest.fixture(scope="class")
    def run(self):
        mp = pytest.MonkeyPatch()
        mp.setattr(demo, "CLIENT_COUNTS", [1, 2])
        mp.setenv("OMP_NUM_THREADS", "1")
        try:
            yield demo.run_timeshare("cpu", model=WIDTHS, batch=BATCH,
                                     seq=SEQ)
        finally:
            mp.undo()

    def test_each_row_holds_clients_x_6_latencies(self, run):
        rows, _ = run
        assert [(r["clients"], r["requests"]) for r in rows] == \
            [(1, 6), (2, 12)]
        assert all(0 < r["mean_s"] <= r["max_s"] for r in rows)

    def test_every_client_made_its_requests_and_equal_scalars(self, run):
        _, reports = run
        # a build warm-up, then a warm and 6 timed requests a row joined
        assert [r["requests"] for r in reports] == [1 + 7 * 2, 1 + 7]
        assert [len(r["scalars"]) for r in reports] == [12, 6]
        assert len({s for r in reports for s in r["scalars"]}) == 1
        logits = [demo.logits_of(r) for r in reports]
        assert torch.equal(logits[0], logits[1])
        assert tuple(logits[0].shape) == (BATCH, WIDTHS["vocab_size"])

    def test_the_clients_scalar_is_the_in_process_request_s(self, run):
        _, reports = run
        # one thread, as the clients run, so the sums round alike
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            request = demo.build_model("cpu", demo.demo_config(**WIDTHS),
                                       BATCH, SEQ)
            assert reports[0]["scalars"][0] == request()
        finally:
            torch.set_num_threads(threads)

    def test_the_cpu_launches_no_kernel_and_reads_no_cap(self, run):
        _, reports = run
        for r in reports:
            assert r["k1_launches"] == 0 and r["tile_launches"] == {}
            assert "cap_bytes" not in r

    def test_a_client_that_fails_fails_the_demo(self, monkeypatch):
        monkeypatch.setenv("OMP_NUM_THREADS", "1")
        with pytest.raises(RuntimeError, match="client 0 exited"):
            demo.Clients(1, "cpu", model=dict(WIDTHS, remat_policy="none"),
                         batch=BATCH, seq=SEQ)


class TestNoQuietCPU:
    """(f) The demo's entry point and functions raise without a card
    unless asked for the CPU."""

    @pytest.fixture(autouse=True)
    def no_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def test_main_raises(self):
        with pytest.raises(RuntimeError, match="CUDA"):
            demo.main([])

    def test_functions_default_to_the_card(self):
        with pytest.raises(RuntimeError, match="CUDA"):
            demo.build_model()
        with pytest.raises(RuntimeError, match="CUDA"):
            demo.Clients(1)
        with pytest.raises(RuntimeError, match="CUDA"):
            demo.run_isolated()


class TestSmokeDemo:
    """chip_smoke.py's phase 21 checks (``check_demo``) on the CPU
    clients' reports, with the K1 counts and peaks a card would report
    filled in: they pass, and each fault they exist for fails them."""

    @pytest.fixture(scope="class")
    def run(self):
        mp = pytest.MonkeyPatch()
        mp.setattr(demo, "CLIENT_COUNTS", [1, 2])
        mp.setenv("OMP_NUM_THREADS", "1")
        try:
            rows, reports = demo.run_timeshare("cpu", model=WIDTHS,
                                               batch=BATCH, seq=SEQ)
            request = demo.build_model(
                "cpu", demo.demo_config(attn_impl="dense", **WIDTHS), BATCH,
                SEQ)
            noncausal = chip_smoke._noncausal_logits(
                request.model, request.tokens)[:, -1, :]
            yield rows, reports, request.last, noncausal
        finally:
            mp.undo()

    @staticmethod
    def on_card(reports: list[dict]) -> list[dict]:
        layers = WIDTHS["num_layers"]
        return [r | {"k1_launches": layers * r["requests"],
                     "tile_launches": {"flash_fwd": layers * r["requests"]},
                     "peak_reserved_bytes": 7 << 30, "cap_bytes": 9 << 30}
                for r in reports]

    @pytest.fixture
    def check(self, run, monkeypatch):
        monkeypatch.setattr(demo, "CLIENT_COUNTS", [1, 2])
        rows, reports, dense, noncausal = run

        def check(rows=rows, reports=self.on_card(reports), dense=dense,
                  noncausal=noncausal):
            return chip_smoke.check_demo(demo, rows, reports, dense,
                                         noncausal, WIDTHS["num_layers"])
        return check

    def test_the_clients_pass(self, check, run):
        out = check()
        _, reports, _, _ = run
        assert out["tiles"]["flash_fwd"] == 2 * (15 + 8)
        assert sum(out["tiles"].values()) == out["tiles"]["flash_fwd"]
        assert out["scalar"] == reports[0]["scalars"][0]
        assert 0 < out["logits_diff"] <= chip_smoke.LOGITS_TOL
        assert out["noncausal_diff"] > chip_smoke.LOGITS_TOL

    def test_the_clients_name_tiles_as_the_smoke_does(self):
        assert set(chip_smoke.TILES) == {
            A.tile_name(kernel, tile)
            for kernel, tiles in A.KERNEL_TILES.items() for tile in tiles}
        for name, (kernel, tile, _) in chip_smoke.TILES.items():
            assert A.tile_name(kernel, tile) == name

    @pytest.mark.parametrize("fault, message", [
        ({"k1_launches": 1}, "K1 launches"),
        ({"tile_launches": {"flash_fwd": 30, "flash_bwd_fused": 1}},
         "not K1 alone"),
        ({"tile_launches": {"flash_fwd_32x32": 30}}, "not K1 alone"),
        ({"peak_reserved_bytes": 9 << 30}, "at its cap"),
        ({"scalars": [1.0] * 12}, "scalars differ"),
    ])
    def test_a_fault_fails(self, check, run, fault, message):
        _, reports, _, _ = run
        bad = self.on_card(reports)
        bad[0] = bad[0] | fault
        with pytest.raises(SystemExit, match=message):
            check(reports=bad)

    def test_a_short_row_fails(self, check, run):
        rows, _, _, _ = run
        with pytest.raises(SystemExit, match="does not hold clients x 6"):
            check(rows=[rows[0], rows[1] | {"requests": 11}])

    def test_logits_off_the_dense_forward_fail(self, check, run):
        _, _, dense, _ = run
        with pytest.raises(SystemExit, match="differ from the dense"):
            check(dense=dense + 0.5, noncausal=dense + 1.5)

    def test_a_limit_that_cannot_see_a_wrong_attention_fails(self, check,
                                                             run):
        _, _, dense, _ = run
        with pytest.raises(SystemExit, match="cannot see it"):
            check(noncausal=dense + chip_smoke.LOGITS_TOL / 2)
