"""Shared building blocks: declarative params, norms, RoPE, SwiGLU MLP.

Port of ``repro/models/common.py``. A parameter is declared once as a
:class:`ParamDef` (shape, logical sharding axes, init); :func:`build_params`
materialises a tree of them on a ``torch.Generator`` and :func:`build_specs`
derives the PartitionSpec tree from the same source, so sharding can never
drift from shapes. The specs become DTensor placements in
``parallel/sharding.py``; ``models/model.py`` (``model_specs``,
``cache_specs``), ``models/moe.py::resolve_moe_axes``,
``optim/adamw.py::opt_state_specs`` and ``launch/steps.py::distribute_tree``
build on them, and :func:`build_shapes` gives the dry-run's
allocation-free stand-ins (``meta`` tensors). ``tree_leaves``, ``tree_map`` and ``tree_unflatten`` stand in for
``jax.tree`` in the optimizer, the training steps and the checkpoints.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.parallel.sharding import PartitionSpec, ShardingRules

# init(generator, shape, device) -> fp32 tensor
InitFn = Callable[[torch.Generator, Sequence[int], torch.device], torch.Tensor]


@dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]  # logical sharding axis per dim
    init: InitFn

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def nrm(scale: float = 1.0, fan_in_axis: int = 0) -> InitFn:
    """Normal init with 1/sqrt(fan_in) scaling (fan-in read from shape)."""

    def init(gen, shape, device):
        fan_in = shape[fan_in_axis]
        x = torch.randn(tuple(shape), generator=gen, device=device)
        return x * (scale / math.sqrt(max(1, fan_in)))

    return init


def trunc_nrm(std: float) -> InitFn:
    """``std`` times a standard normal truncated to [-2, 2] (inverse-CDF sampling)."""

    def init(gen, shape, device):
        lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0, (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0
        u = torch.rand(tuple(shape), generator=gen, device=device) * (hi - lo) + lo
        x = torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)
        return x.clamp_(-2.0, 2.0) * std

    return init


def zeros_init(gen, shape, device):
    return torch.zeros(tuple(shape), device=device)


def ones_init(gen, shape, device):
    return torch.ones(tuple(shape), device=device)


def const_init(value: float) -> InitFn:
    def init(gen, shape, device):
        return torch.full(tuple(shape), value, device=device)

    return init


def uniform_init(lo: float, hi: float) -> InitFn:
    def init(gen, shape, device):
        return torch.rand(tuple(shape), generator=gen, device=device) * (hi - lo) + lo

    return init


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def build_params(defs, gen: torch.Generator, device, dtype=torch.float32):
    """Materialise a (nested dict / list) tree of ParamDefs, in tree order."""
    if is_def(defs):
        return defs.init(gen, defs.shape, device).to(dtype)
    if isinstance(defs, dict):
        return {k: build_params(v, gen, device, dtype) for k, v in defs.items()}
    return [build_params(v, gen, device, dtype) for v in defs]


def build_specs(defs, rules: Optional[ShardingRules]):
    """The PartitionSpec tree of a tree of ParamDefs (``P()`` everywhere
    without rules)."""
    if is_def(defs):
        return PartitionSpec() if rules is None else rules.spec(defs.axes, defs.shape)
    if isinstance(defs, dict):
        return {k: build_specs(v, rules) for k, v in defs.items()}
    return [build_specs(v, rules) for v in defs]


def build_shapes(defs, dtype=torch.float32):
    """``meta`` tensors of the defs' shapes in ``dtype`` (the params'
    stand-ins for the dry-run: no memory, no values)."""
    if is_def(defs):
        return torch.empty(defs.shape, dtype=dtype, device="meta")
    if isinstance(defs, dict):
        return {k: build_shapes(v, dtype) for k, v in defs.items()}
    return [build_shapes(v, dtype) for v in defs]


def param_count(defs) -> int:
    if is_def(defs):
        return math.prod(defs.shape)
    items = defs.values() if isinstance(defs, dict) else defs
    return sum(param_count(v) for v in items)


# --- trees of tensors -----------------------------------------------------------
# A tree is nested dicts, lists and tuples; every other value is a leaf. Dicts
# are walked in sorted key order (as ``jax.tree`` walks them), so an order of
# leaves depends on the keys alone, never on a device or an insertion order.


def tree_leaves(tree, is_leaf=None) -> list:
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t, is_leaf)]
    return [tree]


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of ``tree`` and the matching nodes of ``rest``."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest), is_leaf=is_leaf) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest), is_leaf=is_leaf) for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(template, leaves: list):
    """The tree of ``template``'s structure whose leaves, in
    :func:`tree_leaves` order, are ``leaves``."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), template)
    if next(it, it) is not it:
        raise ValueError("tree_unflatten: more leaves than the template holds")
    return out


# ---------------------------------------------------------------------------
# Numerics helpers
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def norm_def(dim: int) -> ParamDef:
    # zero-centred scale (`1 + g`), standard for stable bf16 training.
    return ParamDef((dim,), (None,), zeros_init)


# --- rotary embeddings ------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponent)  # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs  # (..., S, D/2)
    angles = angles[..., None, :]  # head axis
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --- SwiGLU MLP ---------------------------------------------------------------


def mlp_defs(d_model: int, d_ff: int) -> dict:
    return {
        "gate": ParamDef((d_model, d_ff), ("fsdp", "tp"), nrm()),
        "up": ParamDef((d_model, d_ff), ("fsdp", "tp"), nrm()),
        "down": ParamDef((d_ff, d_model), ("tp", "fsdp"), nrm()),
    }


def mlp_apply(params: dict, x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    g = x @ params["gate"].to(compute_dtype)
    u = x @ params["up"].to(compute_dtype)
    return (F.silu(g) * u) @ params["down"].to(compute_dtype)


# --- misc ---------------------------------------------------------------------


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return logits
    return cap * torch.tanh(logits / cap)


def causal_mask(sq: int, skv: int, q_offset: int = 0, window: int = 0, device=None) -> torch.Tensor:
    """(sq, skv) boolean mask. True = attend. Supports sliding window."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(skv, device=device)[None, :]
    m = kpos <= qpos
    if window:
        m &= kpos > qpos - window
    return m
