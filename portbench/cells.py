"""Cells as data: ``BENCHMARK.json`` at the checkout's root names them,
``workloads/<cell>.json`` holds a cell's traffic and limits, and
``configs/<config>.json`` the model configuration it runs.  Nothing here
lists a cell, a configuration or a metric: each is found by its name."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """The sizes and numerics a configuration file states, under the
    names the harness uses (the file keeps the published key names)."""

    family: str                  # "dense" or "moe"
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float
    norm_eps: float
    max_positions: int
    activation_dtype: str        # "bfloat16" or "float32"
    attn_impl: str
    remat_policy: str
    loss_chunk: int
    optimizer: dict
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 0.0
    router_aux_weight: float = 0.0

    @classmethod
    def from_file(cls, cfg: dict) -> "ModelSpec":
        run = cfg["training"]
        moe = cfg.get("num_local_experts")
        return cls(
            family="moe" if moe else "dense",
            vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
            intermediate_size=cfg["intermediate_size"],
            num_layers=cfg["num_hidden_layers"],
            num_heads=cfg["num_attention_heads"],
            num_kv_heads=cfg["num_key_value_heads"],
            head_dim=cfg["head_dim"], rope_theta=float(cfg["rope_theta"]),
            norm_eps=float(cfg["rms_norm_eps"]),
            max_positions=cfg["max_position_embeddings"],
            activation_dtype=run["activation_dtype"],
            attn_impl=run["attn_impl"], remat_policy=run["remat_policy"],
            loss_chunk=run["loss_chunk"], optimizer=run["optimizer"],
            num_experts=moe or 0, top_k=cfg.get("num_experts_per_tok", 0),
            capacity_factor=float(cfg.get("capacity_factor", 0.0)),
            router_aux_weight=float(cfg.get("router_aux_loss_coef", 0.0)))


@dataclasses.dataclass(frozen=True)
class Cell:
    """One entry of ``workloads``: its name, its configuration (the file
    as read and as a ``ModelSpec``), its traffic and its limits."""

    name: str
    config_name: str
    config: dict
    spec: ModelSpec
    traffic: dict
    chips: int
    limits: dict

    @property
    def batch_size(self) -> int:
        return self.traffic["batch_size"]

    @property
    def seq_len(self) -> int:
        return self.traffic["seq_len"]

    @property
    def tokens_per_step(self) -> int:
        return self.batch_size * self.seq_len

    @property
    def entry(self) -> str:
        """The module under ``entries/`` that drives the program."""
        return f"{self.spec.family}_{self.traffic['kind']}"


def benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    return json.loads(path.read_text())


def _named(items: list[dict], name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"BENCHMARK.json has no {what} {name!r}")


def load_file(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_cell(name: str, bench: dict | None = None,
              workloads: Path = HERE / "workloads",
              root: Path = ROOT) -> Cell:
    """The cell ``name``: its ``BENCHMARK.json`` entry, held to its file
    ``workloads/<name>.json`` and its configuration's file."""
    if bench is None:
        bench = benchmark(root)
    entry = _named(bench["workloads"], name, "workload")
    work = load_file(workloads / f"{name}.json")
    for key in ("config", "chips"):
        if work[key] != entry[key]:
            raise ValueError(f"{name}: {key} {work[key]!r} in its file, "
                             f"{entry[key]!r} in BENCHMARK.json")
    if work["traffic"]["name"] != entry["traffic"]:
        raise ValueError(f"{name}: traffic {work['traffic']['name']!r} in "
                         f"its file, {entry['traffic']!r} in BENCHMARK.json")
    conf = _named(bench["configs"], entry["config"], "config")
    config = load_file(root / conf["file"])
    return Cell(name, entry["config"], config, ModelSpec.from_file(config),
                work["traffic"], entry["chips"], work["limits"])
