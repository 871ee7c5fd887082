"""The port's tile autotuner (nos_tpu_torch.ops.autotune) and the flash
op's tile parameters (nos_tpu_torch.ops.attention) against the JAX
package's autotuner and op, on the CPU.

Device classes, keys and the cache file are the JAX module's, so a
cache written by either package is read by the other.  Tile resolution
follows the JAX op's precedence (explicit, then the measured cache, then
PRETUNED, then each kernel's default), with the port's rule of no
fallback: an explicit tile a kernel is not compiled for raises.  On the
CPU the wrappers run their plain versions, which ignore tiles, so the op
at every legal explicit tile must equal the JAX op in interpret mode.
The kernels themselves run at every tile on the card (chip_smoke.py).
"""

import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from nos_tpu.ops import attention as jattn
from nos_tpu.ops import autotune as jtune
from nos_tpu_torch.ops import _build
from nos_tpu_torch.ops import attention as tattn
from nos_tpu_torch.ops import autotune as ttune

FP32_TOL = 1e-5     # the op's plain versions against interpret mode, fp32
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def tmp_cache(tmp_path, monkeypatch):
    """Both packages' caches at a per-test file, their in-memory views
    reset: no test reads the host's ~/.cache entries."""
    path = tmp_path / "flash_autotune.json"
    monkeypatch.setenv(ttune._CACHE_ENV, str(path))
    assert jtune._CACHE_ENV == ttune._CACHE_ENV
    ttune.reload_cache()
    jtune.reload_cache()
    yield path
    ttune.reload_cache()
    jtune.reload_cache()


def _inputs(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


class TestDeviceClass:
    @pytest.mark.parametrize("kind", [
        "TPU v5 lite", "v5litepod-16", "TPU v5e", "TPU v5p", "TPU v6e",
        "trillium", "TPU v4", "cpu", ""])
    def test_tpu_kinds_match_jax(self, kind):
        assert ttune.device_class(kind) == jtune.device_class(kind)

    @pytest.mark.parametrize("name", [
        "NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe", "NVIDIA H100 NVL"])
    def test_h100_names(self, name):
        assert ttune.device_class(name) == "h100"

    def test_unknown_card_passes_through_lowercased(self):
        assert ttune.device_class("NVIDIA A100-SXM4-80GB") == \
            "nvidia_a100-sxm4-80gb"


class TestKey:
    @pytest.mark.parametrize("args", [
        ("h100", "fwd", 2048, 128, "bfloat16", True),
        ("v5e", "bwd", 512, 64, "float32", False),
        ("cpu", "fwd", 1, 128, "float16", True),
    ])
    def test_byte_equal_to_jax(self, args):
        assert ttune._key(*args) == jtune._key(*args)

    def test_cache_format_matches_jax(self):
        assert ttune._CACHE_VERSION == jtune._CACHE_VERSION
        assert ttune.cache_path() == jtune.cache_path()


class TestCacheInterop:
    def test_jax_record_read_by_the_port(self, tmp_cache):
        # JAX knows no H100 family: its class of the card's name is the
        # name itself, and of "h100" the port's class
        assert jtune.device_class(H100) != ttune.device_class(H100)
        key = jtune.record("h100", "fwd", 2048, 128, "bfloat16", True,
                           (64, 64))
        assert json.loads(tmp_cache.read_text())["entries"][key] == [64, 64]
        ttune.reload_cache()
        assert ttune.lookup(H100, "fwd", 2048, 128, "bfloat16",
                            True) == (64, 64)

    def test_port_record_read_by_jax(self, tmp_cache):
        key = ttune.record("TPU v5e", "bwd", 1024, 128, "bfloat16", False,
                           (256, 512))
        raw = json.loads(tmp_cache.read_text())
        assert raw == {"version": 1, "entries": {key: [256, 512]}}
        jtune.reload_cache()
        assert jtune.lookup("TPU v5e", "bwd", 1024, 128, "bfloat16",
                            False) == (256, 512)

    def test_bad_pass_rejected(self):
        with pytest.raises(ValueError):
            ttune.record(H100, "sideways", 2048, 128, "bfloat16", True,
                         (64, 64))


class TestDegradedCache:
    def test_corrupt_cache_degrades_to_pretuned(self, tmp_cache,
                                                monkeypatch):
        key = ttune._key("h100", "fwd", 777, 128, "bfloat16", True)
        monkeypatch.setitem(ttune.PRETUNED, key, (64, 64))
        for text in ("{not json", '{"entries": [1, 2]}', '"a string"'):
            tmp_cache.write_text(text)
            ttune.reload_cache()
            assert ttune.lookup(H100, "fwd", 777, 128, "bfloat16",
                                True) == (64, 64)
            assert ttune.lookup(H100, "bwd", 777, 128, "bfloat16",
                                True) is None

    def test_unwritable_cache_keeps_the_entry_in_memory(self, tmp_path,
                                                        monkeypatch):
        blocker = tmp_path / "not_a_dir"
        blocker.write_text("")
        monkeypatch.setenv(ttune._CACHE_ENV,
                           str(blocker / "flash_autotune.json"))
        ttune.reload_cache()
        ttune.record(H100, "bwd", 512, 128, "bfloat16", True, (64, 64))
        assert ttune.lookup(H100, "bwd", 512, 128, "bfloat16",
                            True) == (64, 64)
        assert blocker.read_text() == ""


def _resolve(kernel, explicit=(None, None), seq=2048, causal=True):
    return tattn.resolve_tiles(kernel, seq, seq, 128, causal, "bfloat16",
                               *explicit, device_class="h100")


class TestPrecedence:
    """explicit > measured cache > PRETUNED > each kernel's default, on
    a table of the tests' own (the shipped one is TestPretuned's)."""

    @pytest.fixture(autouse=True)
    def own_table(self, monkeypatch):
        monkeypatch.setattr(ttune, "PRETUNED", {})
        ttune.reload_cache()

    def _pretune(self, monkeypatch, pass_, tile):
        key = ttune._key("h100", pass_, 2048, 128, "bfloat16", True)
        monkeypatch.setitem(ttune.PRETUNED, key, tile)
        ttune.reload_cache()

    def test_defaults_without_entries(self):
        for kernel, tiles in tattn.KERNEL_TILES.items():
            assert _resolve(kernel) == tiles[0]
        # a shape with no entry runs every default
        assert tattn.resolve_tiles("flash_fwd", 777, 777, 128, True,
                                   "bfloat16",
                                   device_class="h100") == (128, 128)

    def test_pretuned_then_measured_then_explicit(self, monkeypatch):
        self._pretune(monkeypatch, "fwd", (64, 64))
        assert _resolve("flash_fwd") == (64, 64)
        ttune.record(H100, "fwd", 2048, 128, "bfloat16", True, (128, 128))
        assert _resolve("flash_fwd") == (128, 128)
        ttune.record(H100, "fwd", 2048, 128, "bfloat16", True, (64, 64))
        assert _resolve("flash_fwd", (128, 128)) == (128, 128)
        # one explicit side: the other from the kernel's default, and
        # the pair must be compiled
        assert _resolve("flash_bwd_fused", (None, 64)) == (64, 64)
        with pytest.raises(ValueError, match="compiled"):
            _resolve("flash_fwd", (64, None))

    def test_other_device_class_or_rectangle_misses(self):
        ttune.record(H100, "fwd", 2048, 128, "bfloat16", True, (64, 64))
        assert tattn.resolve_tiles("flash_fwd", 2048, 2048, 128, True,
                                   "bfloat16",
                                   device_class="cpu") == (128, 128)
        assert tattn.resolve_tiles("flash_fwd", 2048, 4096, 128, False,
                                   "bfloat16",
                                   device_class="h100") == (128, 128)
        assert _resolve("flash_fwd", causal=False) == (128, 128)

    def test_uncompiled_cached_pair_falls_through_per_kernel(self):
        # (128, 64) is K3's default and no tile of K2 or K4
        ttune.record(H100, "bwd", 2048, 128, "bfloat16", True, (128, 64))
        assert _resolve("flash_dq") == (128, 64)
        assert _resolve("flash_dkv") == (64, 128)
        assert _resolve("flash_bwd_fused") == (64, 128)
        ttune.record(H100, "bwd", 2048, 128, "bfloat16", True, (64, 64))
        assert [_resolve(k) for k in ("flash_bwd_fused", "flash_dq",
                                      "flash_dkv")] == [(64, 64)] * 3
        ttune.record(H100, "fwd", 2048, 128, "bfloat16", True, (32, 32))
        assert _resolve("flash_fwd") == (128, 128)

    @pytest.mark.parametrize("kernel,tile", [
        ("flash_fwd", (64, 128)), ("flash_fwd", (32, 32)),
        ("flash_bwd_fused", (128, 128)), ("flash_dq", (64, 128)),
        ("flash_dkv", (128, 64))])
    def test_explicit_uncompiled_pair_raises(self, kernel, tile):
        with pytest.raises(ValueError, match="compiled"):
            _resolve(kernel, tile)

    def test_wrappers_refuse_uncompiled_tiles(self):
        q, k, v, g = (torch.from_numpy(x) for x in _inputs(
            1, [(1, 8, 1, 128)] * 4))
        lse = torch.zeros(1, 1, 8)
        with pytest.raises(ValueError):
            tattn.flash_attention_fwd(q, k, v, True, (32, 32))
        with pytest.raises(ValueError):
            tattn.flash_attention_bwd_fused(q, k, v, g, lse, lse, True,
                                            (128, 128))
        with pytest.raises(ValueError):
            tattn.flash_attention_dq(q, k, v, g, lse, lse, True, (64, 128))
        with pytest.raises(ValueError):
            tattn.flash_attention_dkv(q, k, v, g, lse, lse, True, (128, 64))


class _Spy:
    """Records the tile each wrapper is called with through the op."""

    def __init__(self, monkeypatch):
        self.tiles: dict[str, list] = {}
        for name in ("flash_attention_fwd", "flash_attention_bwd_fused",
                     "flash_attention_dq", "flash_attention_dkv"):
            fn = getattr(tattn, name)
            monkeypatch.setattr(tattn, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def call(*a):
            self.tiles.setdefault(name, []).append(a[-1])
            return fn(*a)
        return call


class TestOpResolution:
    """The op's tiles as its wrappers receive them, on CPU tensors (the
    device class "cpu")."""

    @staticmethod
    def _run(impl="fused", *tiles):
        q, k, v = (torch.from_numpy(x).requires_grad_() for x in _inputs(
            2, [(1, 64, 2, 128)] * 3))
        prev = tattn.set_backward_impl(impl)
        try:
            tattn.flash_attention(q, k, v, True, *tiles).sum().backward()
        finally:
            tattn.set_backward_impl(prev)

    def test_measured_entries_reach_the_wrappers(self, monkeypatch):
        spy = _Spy(monkeypatch)
        ttune.record("cpu", "fwd", 64, 128, "float32", True, (64, 64))
        ttune.record("cpu", "bwd", 64, 128, "float32", True, (64, 64))
        self._run()
        assert spy.tiles == {"flash_attention_fwd": [(64, 64)],
                             "flash_attention_bwd_fused": [(64, 64)]}

    def test_bwd_pin_applies_to_the_backward_alone(self, monkeypatch):
        spy = _Spy(monkeypatch)
        self._run("fused", 64, 64, 64, 128)
        assert spy.tiles == {"flash_attention_fwd": [(64, 64)],
                             "flash_attention_bwd_fused": [(64, 128)]}

    def test_split_pair_shares_the_backward_tile(self, monkeypatch):
        spy = _Spy(monkeypatch)
        self._run("split", None, None, 64, 64)
        assert spy.tiles == {"flash_attention_fwd": [(128, 128)],
                             "flash_attention_dq": [(64, 64)],
                             "flash_attention_dkv": [(64, 64)]}

    def test_cached_pair_a_kernel_lacks_falls_through(self, monkeypatch):
        spy = _Spy(monkeypatch)
        ttune.record("cpu", "bwd", 64, 128, "float32", True, (64, 128))
        self._run("split")
        assert spy.tiles["flash_attention_dq"] == [(128, 64)]
        assert spy.tiles["flash_attention_dkv"] == [(64, 128)]

    def test_explicit_pair_a_kernel_lacks_raises(self):
        # (128, 128) is K1's default and no tile of K2: the shared pair
        # reaches the backward, which refuses it
        with pytest.raises(ValueError, match="compiled"):
            self._run("fused", 128, 128)
        with pytest.raises(ValueError, match="compiled"):
            self._run("fused", 32, 32)

    def test_resolution_is_memoised_and_dropped_on_record(self,
                                                          monkeypatch):
        self._run()
        calls = []
        resolve = tattn.resolve_tiles
        monkeypatch.setattr(tattn, "resolve_tiles",
                            lambda *a: calls.append(a) or resolve(*a))
        self._run()
        assert calls == []
        ttune.record("cpu", "fwd", 64, 128, "float32", True, (64, 64))
        self._run()
        assert len(calls) == 2      # forward and fused backward, once each


# (forward pair, backward pair or None for the shared one, backward)
LEGAL = [((128, 128), (64, 128), "fused"), ((128, 128), (64, 64), "fused"),
         ((64, 64), (64, 128), "fused"), ((64, 64), None, "fused"),
         ((128, 128), (64, 64), "split"), ((64, 64), None, "split")]


@pytest.fixture(scope="module")
def jax_reference():
    """JAX's op in interpret mode at its default blocks: o and the
    gradients of sum(o * g), per causal."""
    q, k, v, g = _inputs(7, [(1, 128, 2, 128)] * 4)
    out = {}
    for causal in (True, False):
        def loss(q, k, v):
            o = jattn.flash_attention(q, k, v, causal, None, None, True)
            return (o * jnp.asarray(g)).sum(), o
        (_, o), grads = jax.value_and_grad(loss, (0, 1, 2), has_aux=True)(
            *(jnp.asarray(x) for x in (q, k, v)))
        out[causal] = (np.asarray(o), [np.asarray(x) for x in grads])
    return (q, k, v, g), out


class TestLegalPairsMatchJax:
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("fwd,bwd,impl", LEGAL,
                             ids=lambda x: str(x).replace(" ", ""))
    def test_forward_and_gradients(self, jax_reference, fwd, bwd, impl,
                                   causal):
        (q, k, v, g), want = jax_reference
        o_want, g_want = want[causal]
        qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
        prev = tattn.set_backward_impl(impl)
        try:
            o = tattn.flash_attention(qt, kt, vt, causal, *fwd,
                                      *(bwd or (None, None)))
            grads = torch.autograd.grad(o, (qt, kt, vt),
                                        torch.from_numpy(g))
        finally:
            tattn.set_backward_impl(prev)
        np.testing.assert_allclose(o.detach().numpy(), o_want,
                                   atol=FP32_TOL, rtol=0)
        for got, w in zip(grads, g_want):
            np.testing.assert_allclose(got.numpy(), w, atol=FP32_TOL,
                                       rtol=0)


class TestCandidates:
    def test_pass_candidates(self):
        assert ttune.candidates("fwd", 2048, 2048, 128) == [(128, 128),
                                                            (64, 64)]
        assert ttune.candidates("bwd", 2048, 2048, 128) == [(64, 128),
                                                            (64, 64)]
        # as a recorded entry runs them: (128, 64) is K3's default and
        # leaves K4 at its own, as (64, 128) would, so it stands for
        # both defaults; (64, 64) for both second tiles
        assert ttune.candidates("bwd", 2048, 2048, 128,
                                impl="split") == [(128, 64), (64, 64)]

    def test_only_what_the_kernels_take(self):
        assert ttune.candidates("fwd", 2048, 2048, 64) == []
        assert ttune.candidates("fwd", 2048, 2048, 128, 4) == []

    def test_every_compiled_tile_fits_the_card(self):
        budget = ttune.smem_budget("h100")
        assert budget == 227 * 1024
        for kernel, tiles in tattn.KERNEL_TILES.items():
            for tile in tiles:
                assert ttune._smem_estimate(kernel, *tile, 128, 2) <= \
                    budget, (kernel, tile)

    def test_the_budget_filters(self):
        # K2's default needs 231,464 bytes
        assert ttune.candidates("bwd", 2048, 2048, 128,
                                budget=200_000) == [(64, 64)]

    @pytest.mark.parametrize("kernel", ["flash_fwd", "flash_dq",
                                        "flash_dkv"])
    def test_one_consumer_tiles_fit_two_ctas_an_sm(self, kernel):
        # 228 KB an SM, 1 KB of it reserved per CTA
        tile = tattn.KERNEL_TILES[kernel][1]
        assert 2 * (ttune._smem_estimate(kernel, *tile, 128, 2) + 1024) \
            <= 228 * 1024

    def test_shipped_tiles_reach_the_kernels(self):
        # the sweep's winners: the 64-row forward at the serving shape
        # (generate re-runs the 512-token buffer, causal), the defaults
        # at the training shape
        assert _resolve("flash_fwd", seq=512) == (64, 64)
        assert _resolve("flash_fwd", seq=512, causal=False) == (128, 128)
        for kernel, tiles in tattn.KERNEL_TILES.items():
            assert _resolve(kernel) == tiles[0], kernel

    def test_pretuned_entries_are_candidates_within_budget(self):
        for key, tile in ttune.PRETUNED.items():
            cls, pass_, seq, dim, dtype, mask = key.split("|")
            assert cls == "h100" and dtype == "bfloat16", key
            assert tuple(tile) in ttune.candidates(
                pass_, int(seq[1:]), int(seq[1:]), int(dim[1:]), 2,
                budget=ttune.smem_budget(cls)), key

    def test_pretuned_covers_the_shipped_shapes(self):
        for seq in (512, 1024, 2048, 4096, 8192):
            for causal in (True, False):
                for pass_ in ("fwd", "bwd"):
                    assert ttune.lookup(H100, pass_, seq, 128, "bfloat16",
                                        causal) is not None, (seq, pass_)
        assert {k.split("|")[0] for k in ttune.PRETUNED} == {"h100"}


class TestSearch:
    def test_cpu_search_returns_a_legal_candidate(self, tmp_cache):
        q, k, v = (torch.from_numpy(x).bfloat16() for x in _inputs(
            3, [(1, 64, 1, 128)] * 3))
        for pass_ in ("fwd", "bwd"):
            best, timings = ttune.search(pass_, q, k, v, True, cpu=True,
                                         samples=1, inner=1)
            assert set(timings) == set(ttune.candidates(pass_, 64, 64, 128))
            assert best in timings and all(t > 0 for t in timings.values())
        assert not tmp_cache.exists()

    def test_split_search_times_each_kernel_set_once(self, monkeypatch,
                                                     tmp_cache):
        # each candidate runs as a recorded entry would: (128, 64) gives
        # both kernels their defaults, (64, 64) both second tiles, and
        # nothing stays in the cache afterwards
        spy = _Spy(monkeypatch)
        q, k, v = (torch.from_numpy(x).bfloat16() for x in _inputs(
            4, [(1, 64, 1, 128)] * 3))
        prev = tattn.set_backward_impl("split")
        try:
            best, timings = ttune.search("bwd", q, k, v, True, cpu=True,
                                         samples=1, inner=1)
        finally:
            tattn.set_backward_impl(prev)
        assert set(timings) == {(128, 64), (64, 64)}
        assert set(spy.tiles["flash_attention_dq"]) == {(128, 64), (64, 64)}
        assert set(spy.tiles["flash_attention_dkv"]) == {(64, 128), (64, 64)}
        assert set(spy.tiles["flash_attention_fwd"]) == {(128, 128)}
        assert ttune.lookup("cpu", "bwd", 64, 128, "bfloat16", True) is None
        assert not tmp_cache.exists()

    def test_search_keeps_an_earlier_entry(self):
        ttune.record("cpu", "fwd", 64, 128, "bfloat16", True, (64, 64),
                     persist=False)
        q = torch.zeros(1, 64, 1, 128, dtype=torch.bfloat16)
        ttune.search("fwd", q, q, q, cpu=True, samples=1, inner=1)
        assert ttune.lookup("cpu", "fwd", 64, 128, "bfloat16",
                            True) == (64, 64)

    def test_search_rejects_what_it_cannot_time(self):
        q = torch.zeros(1, 8, 1, 128, dtype=torch.bfloat16)
        with pytest.raises(ValueError):
            ttune.search("sideways", q, q, q, cpu=True)
        with pytest.raises(ValueError, match="cuda"):
            ttune.search("fwd", q, q, q)
        with pytest.raises(ValueError, match="candidates"):
            ttune.search("fwd", q[..., :64], q[..., :64], q[..., :64],
                         cpu=True)
        with pytest.raises(ValueError, match="self-attention"):
            ttune.search("fwd", q, q[:, :4], q[:, :4], cpu=True)

    def test_cli_cpu_never_persists(self, tmp_cache, capsys):
        assert ttune.main(["--cpu", "--batch", "1", "--seq", "32",
                           "--heads", "1"]) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["persisted"] is False and out["device"] == "cpu"
        assert out["fwd"] in [list(c) for c in ttune.candidates(
            "fwd", 32, 32, 128)]
        assert out["cache"] == str(tmp_cache) and not tmp_cache.exists()
        # recorded in memory only
        assert ttune.lookup("cpu", "fwd", 32, 128, "bfloat16",
                            True) == tuple(out["fwd"])


class TestCompiledTiles:
    """The tiles the Python side knows are the ones the C entry points
    dispatch, and chip_smoke.py checks every one of them."""

    ENTRY = {"flash_fwd": ("flash_fwd", "nos_flash_fwd"),
             "flash_bwd_fused": ("flash_bwd", "nos_flash_bwd"),
             "flash_dq": ("flash_bwd_split", "nos_flash_dq"),
             "flash_dkv": ("flash_bwd_split", "nos_flash_dkv")}

    @pytest.mark.parametrize("kernel", sorted(ENTRY))
    def test_entry_point_dispatches_the_kernel_tiles(self, kernel):
        source, entry = self.ENTRY[kernel]
        text = (_build.CSRC / f"{source}.cu").read_text()
        body = text[text.index(f'extern "C" int {entry}('):]
        body = body[:body.index("\n}\n")]
        pairs = re.findall(r"block_q == (\d+) && block_k == (\d+)", body)
        assert [tuple(map(int, p)) for p in pairs] == \
            list(tattn.KERNEL_TILES[kernel])
        assert "return static_cast<int>(cudaErrorInvalidValue);" in body
        assert "int block_q, int block_k" in " ".join(body.split())

    def test_smoke_checks_every_tile(self):
        want = {(k, t) for k, ts in tattn.KERNEL_TILES.items() for t in ts}
        got = {(k, t) for k, t, _ in chip_smoke.TILES.values()}
        assert got == want and len(chip_smoke.TILES) == len(want)
        assert set(chip_smoke.TILES) == set(chip_smoke.KERNELS)
        for name, (kernel, tile, _) in chip_smoke.TILES.items():
            default = tattn.KERNEL_TILES[kernel][0] == tile
            assert name == (kernel if default
                            else f"{kernel}_{tile[0]}x{tile[1]}")

    def test_argtypes_carry_the_tile(self):
        for name, types in tattn._ARGTYPES.items():
            assert types[-5:] == tattn._TAIL, name

    def test_sweep_script_is_committed(self):
        root = Path(__file__).resolve().parent.parent
        assert (root / "scripts" / "sweep_flash_torch.py").is_file()
