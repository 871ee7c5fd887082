"""Carry JAX (flax) Llama parameters across to the port.

``params_from_jax(tree, cfg)`` takes the flax parameter tree of
``nos_tpu.models.llama.Llama``, already unboxed and turned into nested
dicts of numpy arrays, and returns a ``state_dict`` for
``nos_tpu_torch.models.llama.Llama(cfg)``.  It handles both layer
layouts: the scanned one (one ``layers`` subtree whose leaves carry a
leading layer axis) and the unrolled one (``layer_0`` ... from
``scan_layers=False``), the DenseGeneral kernel layouts (q/k/v
[E, H, D] or the fused qkv_proj [E, H+2Hkv, D], o_proj [H, D, E], MLP
[E, I] / [I, E] or the fused gate_up_proj [E, 2I]) and the tied embed
[V, E].  Tensors come out on the CPU in ``cfg.param_dtype`` (norm scales
in fp32); move them with the module.  ``moe_params_from_jax`` does
the same for ``nos_tpu.models.moe.MoELlama``'s tree.
"""

from __future__ import annotations

import functools
from collections.abc import Mapping

import numpy as np
import torch

from nos_tpu_torch.models.llama import LlamaConfig


def _tensor(x, dtype: torch.dtype) -> torch.Tensor:
    # via fp32: numpy has no bfloat16 that torch.from_numpy accepts
    return torch.from_numpy(np.asarray(x, dtype=np.float32).copy()).to(dtype)


def _attention(sd: dict, prefix: str, leaf, fused_qkv: bool,
               pd: torch.dtype) -> None:
    """One layer's attention norm and projections; ``leaf(*path)`` reads
    the layer's flax subtree."""
    sd[prefix + "attn_norm.scale"] = _tensor(leaf("attn_norm", "scale"),
                                             torch.float32)
    qkv = ("qkv_proj",) if fused_qkv else ("q_proj", "k_proj", "v_proj")
    for proj in qkv:
        w = leaf("attn", proj, "kernel")                    # [E, H, D]
        sd[prefix + f"attn.{proj}.weight"] = _tensor(
            w.reshape(w.shape[0], -1).T, pd)
    w = leaf("attn", "o_proj", "kernel")                    # [H, D, E]
    sd[prefix + "attn.o_proj.weight"] = _tensor(
        w.reshape(-1, w.shape[-1]).T, pd)


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

    fused_qkv = "qkv_proj" in layer(0)["attn"]
    fused_gate_up = "gate_up_proj" in layer(0)["mlp"]
    if (fused_qkv, fused_gate_up) != (cfg.fused_qkv, cfg.fused_gate_up):
        raise ValueError(
            f"the flax tree has fused_qkv={fused_qkv}, fused_gate_up="
            f"{fused_gate_up}; the config asks for {cfg.fused_qkv}, "
            f"{cfg.fused_gate_up}")

    pd = cfg.param_dtype
    sd = {"embed": _tensor(tree["embed"], pd)}
    for n in range(cfg.num_layers):
        p = f"layers.{n}."
        _attention(sd, p, functools.partial(leaf, n), fused_qkv, pd)
        sd[p + "mlp_norm.scale"] = _tensor(
            leaf(n, "mlp_norm", "scale"), torch.float32)
        mlp = ("gate_up_proj",) if fused_gate_up else ("gate_proj", "up_proj")
        for proj in (*mlp, "down_proj"):
            sd[p + f"mlp.{proj}.weight"] = _tensor(
                leaf(n, "mlp", proj, "kernel").T, pd)
    sd["final_norm.scale"] = _tensor(tree["final_norm"]["scale"],
                                     torch.float32)
    return sd


def moe_params_from_jax(tree: Mapping, cfg) -> dict[str, torch.Tensor]:
    """The ``state_dict`` for ``nos_tpu_torch.models.moe.MoELlama(cfg)``
    from the flax tree of ``nos_tpu.models.moe.MoELlama`` (unrolled
    ``layer_{i}`` subtrees: attn_norm, attn, moe_norm and moe with
    router/kernel [E_dim, E], w_gate and w_up [E, D, F], w_down
    [E, F, D]).  The router becomes a [E, D] fp32 weight; the experts keep
    JAX's layout."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    if "layer_0" not in tree:
        raise ValueError("no 'layer_0' subtree in the flax MoE tree")
    pd = cfg.param_dtype
    sd = {"embed": _tensor(tree["embed"], pd)}
    for n in range(cfg.num_layers):
        layer, p = tree[f"layer_{n}"], f"layers.{n}."

        def leaf(*path, layer=layer):
            x = layer
            for key in path:
                x = x[key]
            return np.asarray(x)

        _attention(sd, p, leaf, cfg.fused_qkv, pd)
        sd[p + "moe_norm.scale"] = _tensor(leaf("moe_norm", "scale"),
                                           torch.float32)
        sd[p + "moe.router.weight"] = _tensor(
            leaf("moe", "router", "kernel").T, torch.float32)
        for name in ("w_gate", "w_up", "w_down"):
            sd[p + f"moe.experts.{name}"] = _tensor(leaf("moe", name), pd)
    sd["final_norm.scale"] = _tensor(tree["final_norm"]["scale"],
                                     torch.float32)
    return sd
