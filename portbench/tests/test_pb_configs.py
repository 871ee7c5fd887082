"""The configuration files, the cells and BENCHMARK.json in the shape
the benchmark's format requires."""

import importlib
import json
import math
import re

import pytest

from portbench import inputs
from portbench.cells import ModelSpec, benchmark, load_cell, load_file
from portbench.tests.conftest import ROOT

BENCH = benchmark(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

# The published values (the models' config.json) this benchmark keeps.
PUBLISHED = {
    "mistral-7b-v0.3-8l": {
        "hidden_size": 4096, "intermediate_size": 14336,
        "num_attention_heads": 32, "num_key_value_heads": 8,
        "head_dim": 128, "vocab_size": 32768, "rope_theta": 1e6,
        "rms_norm_eps": 1e-5, "max_position_embeddings": 32768,
        "sliding_window": None, "hidden_act": "silu"},
    "mixtral-8x7b-v0.1-2l": {
        "hidden_size": 4096, "intermediate_size": 14336,
        "num_attention_heads": 32, "num_key_value_heads": 8,
        "head_dim": 128, "vocab_size": 32000, "rope_theta": 1e6,
        "rms_norm_eps": 1e-5, "max_position_embeddings": 32768,
        "num_local_experts": 8, "num_experts_per_tok": 2,
        "router_aux_loss_coef": 0.02, "sliding_window": None,
        "hidden_act": "silu"},
}
REDUCED = {
    "mistral-7b-v0.3-8l": {"num_hidden_layers": (32, 8)},
    "mixtral-8x7b-v0.1-2l": {"num_hidden_layers": (32, 2)},
}
# a width: a hidden, intermediate, latent, state or projection size, a
# head size, an expansion factor, experts per token
WIDTH = re.compile(r"(_size$|_dim$|_rank$|expansion|experts_per_tok)")


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_keeps_published_values(conf):
    cfg = load_file(ROOT / conf["file"])
    assert cfg["name"] == conf["name"]
    assert cfg["source"] == conf["source"]
    for key, value in PUBLISHED[conf["name"]].items():
        assert cfg[key] == value, key
    assert set(cfg["reduced"]) == set(conf["reduced"]) \
        == set(REDUCED[conf["name"]])
    for key, (published, run) in REDUCED[conf["name"]].items():
        assert cfg["reduced"][key]["published"] == published
        assert cfg["reduced"][key]["run"] == cfg[key] == run
        assert not WIDTH.search(key), f"{key} is a width"
    for key in ("assumed", "departures", "deployment"):
        assert cfg[key]
    # the tied head departs from the architecture and cuts no scale: it is
    # stated, with what it leaves out, under departures and not reduced
    tied = [d for d in cfg["departures"] if isinstance(d, dict)
            and d["key"] == "tie_word_embeddings"]
    assert len(tied) == 1 and (tied[0]["published"], tied[0]["run"]) == \
        (False, True) and tied[0]["leaves_out"]
    assert "tie_word_embeddings" not in cfg
    spec = ModelSpec.from_file(cfg)
    assert cfg["parameters"] == inputs.param_count(spec)
    assert cfg["state_bytes"] == 16 * cfg["parameters"]


def test_mixtral_capacity_holds_every_token():
    cfg = load_file(ROOT / "portbench/configs/mixtral-8x7b-v0.1-2l.json")
    assert cfg["capacity_factor"] == \
        cfg["num_local_experts"] / cfg["num_experts_per_tok"]
    assert "capacity_factor" in cfg["assumed"]


def test_benchmark_file_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1].startswith("portbench/")
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"])
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        mod = importlib.import_module(f"portbench.metrics.{m['name']}")
        assert callable(mod.read)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cells_load(w):
    cell = load_cell(w["name"], BENCH, root=ROOT)
    assert cell.chips == 1 and len(w["why"]) <= 200
    from portbench.check import NAMES
    assert cell.limits and set(cell.limits) <= set(NAMES)
    assert all(math.isfinite(v) and v > 0 for v in cell.limits.values())
    importlib.import_module(f"portbench.entries.{cell.entry}")


def test_cell_sizes():
    s8k = load_cell("mistral7b-train-s8k", BENCH, root=ROOT)
    assert (s8k.batch_size, s8k.seq_len, s8k.tokens_per_step) == \
        (4, 8192, 32768)
    moe = load_cell("mixtral8x7b-train-s8k", BENCH, root=ROOT)
    assert (moe.batch_size, moe.seq_len) == (1, 8192)
    # each expert sees 2048 routed tokens on average, in 8192 slots
    spec = moe.spec
    assert moe.tokens_per_step * spec.top_k // spec.num_experts == 2048
    from portbench.reference.model import capacity
    assert capacity(spec, moe.tokens_per_step) == 8192


def test_inputs_repeat_from_the_seed():
    spec = ModelSpec.from_file(load_file(ROOT / "portbench/tests/data/tiny-dense.json"))
    a = inputs.make_params(spec, 2 ** 31 + 7, "cpu")
    b = inputs.make_params(spec, 2 ** 31 + 7, "cpu")
    assert all((a[n] == b[n]).all() for n in a)
    assert (a["layers.0.attn_norm.scale"] == 1).all()
    x = inputs.batch(2 ** 31 + 7, 3, 2, 32, 256)
    assert (x == inputs.batch(2 ** 31 + 7, 3, 2, 32, 256)).all()
    assert not (x == inputs.batch(2 ** 31 + 7, 4, 2, 32, 256)).all()
    assert x.dtype.name == "int32" and x.min() >= 0 and x.max() < 256
