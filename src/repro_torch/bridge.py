"""Weight and cache bridge from the JAX package's trees to the port's.

The tests hand over a JAX tree as numpy arrays
(``jax.tree.map(np.asarray, tree)``); nothing here imports JAX. Layouts
are kept as they are (``wq (D, H, hd)``, ``wk``/``wv (D, KH, hd)``,
``wo (H, hd, D)``, MLP ``gate``/``up (D, F)``, ``down (F, D)``); the only
change is that the JAX package stacks every layer parameter under a
leading ``num_periods`` axis per period slot ``b{j}``, and the port keeps
one dict per layer, layer ``i = n * period + j``.
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
    out = {k: _tensor(v, device, dtype) for k, v in tree.items() if k != "layers" and not isinstance(v, dict)}
    out["layers"] = layers
    return out


def cache_from_jax(tree: dict, cfg: ModelConfig, device="cpu") -> dict:
    """A JAX decode cache ``{"pos", "layers": {"b{j}": {"attn": {"k", "v"}}}}``
    (numpy leaves) as the port's ``{"pos", "k", "v"}`` with layers stacked."""
    p = cfg.period
    sides = {}
    for side in ("k", "v"):
        per_layer = []
        for i in range(cfg.num_layers):
            n, j = divmod(i, p)
            per_layer.append(_tensor(np.asarray(tree["layers"][f"b{j}"]["attn"][side])[n], device, None))
        sides[side] = torch.stack(per_layer)
    pos = torch.from_numpy(np.asarray(tree["pos"]).astype(np.int64)).to(device)
    return {"pos": pos, **sides}
