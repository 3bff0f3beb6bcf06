"""Weight and cache bridge from the JAX package's trees to the port's.

The tests hand over a JAX tree as numpy arrays
(``jax.tree.map(np.asarray, tree)``); nothing here imports JAX. Layouts
are kept as they are (``wq (D, H, hd)``, ``wk``/``wv (D, KH, hd)``,
``wo (H, hd, D)``, MLP ``gate``/``up (D, F)``, ``down (F, D)``); the only
change is that the JAX package stacks every layer parameter under a
leading ``num_periods`` axis per period slot ``b{j}``, and the port keeps
one dict per layer, layer ``i = n * period + j``; the other entries
(``embed``, ``lm_head``, ``final_norm``, a frontend's ``{"proj": ...}``)
come across as they are. Caches go the other way: the port stacks each
kind of state over the layers of that kind. An optimizer state ``{"step",
"mu", "nu"}`` comes across with its moments as params, and JAX gradients,
which share the params' tree, through ``params_from_jax``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def _tensor(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: torch.from_numpy does not take it
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16 if dtype is None else dtype)
    t = torch.from_numpy(np.array(a))  # a copy: JAX hands out read-only buffers
    return t.to(device=device, dtype=dtype or t.dtype)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(tree: dict, cfg: ModelConfig, device="cpu", dtype=None) -> dict:
    """The JAX param tree (numpy leaves) as the port's parameter dict."""
    p = cfg.period
    layers = []
    for i in range(cfg.num_layers):
        n, j = divmod(i, p)
        layers.append(_map(tree["layers"][f"b{j}"], lambda a, n=n: _tensor(np.asarray(a)[n], device, dtype)))
    out = {k: _map(v, lambda a: _tensor(a, device, dtype)) for k, v in tree.items() if k != "layers"}
    out["layers"] = layers
    return out


def opt_state_from_jax(tree: dict, cfg: ModelConfig, device="cpu") -> dict:
    """The JAX AdamW state (numpy leaves) as the port's: ``mu`` and ``nu``
    as param trees in their own dtype, ``step`` a 0-d int32 tensor."""
    return {
        "step": torch.tensor(int(np.asarray(tree["step"])), dtype=torch.int32, device=device),
        "mu": params_from_jax(tree["mu"], cfg, device),
        "nu": params_from_jax(tree["nu"], cfg, device),
    }


def _stack(trees: list):
    """Stack a list of same-shaped dict trees of tensors leaf by leaf."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def cache_from_jax(tree: dict, cfg: ModelConfig, device="cpu") -> dict:
    """A JAX decode cache ``{"pos", "layers": {"b{j}": {kind: ...}}}``
    (numpy leaves) as the port's cache (``models/model.py::init_cache``):
    ``{"pos", "k", "v"}`` for attention, ``{"pos", "mlstm", "slstm": {"h",
    "c", "n", "m"}}`` for xLSTM, ``"mamba": {"conv_x", "conv_b", "conv_c",
    "ssm"}`` for Mamba-2 (beside ``k`` and ``v`` in the hybrid), each kind
    stacked over its layers. The JAX sLSTM state is the tuple ``(h, c, n,
    m)``."""
    p = cfg.period
    per_kind: dict[str, list] = {}
    for i in range(cfg.num_layers):
        n, j = divmod(i, p)
        kind = cfg.layer_kind(i)
        blk = tree["layers"][f"b{j}"][kind]
        if kind == "attn":
            leaf = {"k": blk["k"], "v": blk["v"]}
        elif kind == "mlstm":
            leaf = {"mlstm": blk["state"]}
        elif kind == "slstm":
            leaf = {"slstm": dict(zip(("h", "c", "n", "m"), blk["state"]))}
        else:
            leaf = {"mamba": {k: blk[k] for k in ("conv_x", "conv_b", "conv_c", "ssm")}}
        per_kind.setdefault(kind, []).append(_map(leaf, lambda a, n=n: _tensor(np.asarray(a)[n], device, None)))
    out = {"pos": torch.from_numpy(np.asarray(tree["pos"]).astype(np.int64)).to(device)}
    for layers in per_kind.values():
        out.update(_stack(layers))
    return out
