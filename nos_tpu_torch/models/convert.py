"""Carry JAX (flax) Llama parameters across to the port.

``params_from_jax(tree, cfg)`` takes the flax parameter tree of
``nos_tpu.models.llama.Llama``, already unboxed and turned into nested
dicts of numpy arrays, and returns a ``state_dict`` for
``nos_tpu_torch.models.llama.Llama(cfg)``.  It handles both layer
layouts: the scanned one (one ``layers`` subtree whose leaves carry a
leading layer axis) and the unrolled one (``layer_0`` ... from
``scan_layers=False``), the DenseGeneral kernel layouts (q/k/v
[E, H, D], o_proj [H, D, E], MLP [E, I] / [I, E]) and the tied embed
[V, E].  Tensors come out on the CPU in ``cfg.param_dtype`` (norm scales
in fp32); move them with the module.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from nos_tpu_torch.models.llama import LlamaConfig


def _tensor(x, dtype: torch.dtype) -> torch.Tensor:
    # via fp32: numpy has no bfloat16 that torch.from_numpy accepts
    return torch.from_numpy(np.asarray(x, dtype=np.float32).copy()).to(dtype)


def params_from_jax(tree: Mapping, cfg: LlamaConfig
                    ) -> dict[str, torch.Tensor]:
    if set(tree) == {"params"}:
        tree = tree["params"]
    scanned = "layers" in tree
    if not scanned and "layer_0" not in tree:
        raise ValueError("no 'layers' or 'layer_0' subtree in the flax tree")

    def layer(n: int) -> Mapping:
        return tree["layers"] if scanned else tree[f"layer_{n}"]

    def leaf(n: int, *path: str) -> np.ndarray:
        x = layer(n)
        for key in path:
            x = x[key]
        x = np.asarray(x)
        return x[n] if scanned else x

    if "qkv_proj" in layer(0)["attn"] or "gate_up_proj" in layer(0)["mlp"]:
        raise NotImplementedError(
            "fused_qkv / fused_gate_up parameters are the training slice's "
            "work")

    pd = cfg.param_dtype
    sd = {"embed": _tensor(tree["embed"], pd)}
    for n in range(cfg.num_layers):
        p = f"layers.{n}."
        sd[p + "attn_norm.scale"] = _tensor(
            leaf(n, "attn_norm", "scale"), torch.float32)
        for proj in ("q_proj", "k_proj", "v_proj"):
            w = leaf(n, "attn", proj, "kernel")             # [E, H, D]
            sd[p + f"attn.{proj}.weight"] = _tensor(
                w.reshape(w.shape[0], -1).T, pd)
        w = leaf(n, "attn", "o_proj", "kernel")             # [H, D, E]
        sd[p + "attn.o_proj.weight"] = _tensor(
            w.reshape(-1, w.shape[-1]).T, pd)
        sd[p + "mlp_norm.scale"] = _tensor(
            leaf(n, "mlp_norm", "scale"), torch.float32)
        for proj in ("gate_proj", "up_proj", "down_proj"):
            sd[p + f"mlp.{proj}.weight"] = _tensor(
                leaf(n, "mlp", proj, "kernel").T, pd)
    sd["final_norm.scale"] = _tensor(tree["final_norm"]["scale"],
                                     torch.float32)
    return sd
