"""AdamW with fp32 moments, global-norm clipping, warmup-cosine schedule.

Port of ``repro/optim/adamw.py``. The optimizer state mirrors the
parameter tree: ``{"step": 0-d int32, "mu": tree, "nu": tree}``. The JAX
package's update is functional; here :func:`adamw_update` writes the new
params and moments into the tensors it was given (under
``torch.no_grad()``) and returns the same trees. At qwen3-1.7b's width a
functional update would hold a second copy of the fp32 params and both
moments (20.7 GB) beside the first, on top of the gradients and
activations of a training step, more than an 80 GB card holds. The
gradients are clipped leaf by leaf as the update reaches them. The
schedule and the bias corrections are computed in fp32 tensors, as the
reference computes them, not in Python floats. ``opt_state_specs`` gives
the state's PartitionSpec tree; on DTensor leaves the update runs shard
by shard and the global norm reduces each leaf to a plain fp32 scalar
first. ``opt_state_shapes`` gives the dry-run's allocation-free stand-ins.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.parallel.sharding import PartitionSpec, is_dtensor


def init_opt_state(params, moments_dtype=torch.float32) -> dict:
    """Zero moments of ``moments_dtype`` on each parameter's device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=moments_dtype, device=p.device)

    step = torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)
    return {"step": step, "mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}


def opt_state_specs(param_specs) -> dict:
    """The optimizer state's PartitionSpec tree: each moment lives where its
    parameter shard lives (ZeRO-style), ``step`` is replicated."""
    return {"step": PartitionSpec(), "mu": param_specs, "nu": param_specs}


def opt_state_shapes(param_shapes, moments_dtype=torch.float32) -> dict:
    """``meta`` stand-ins of :func:`init_opt_state`'s output for params of
    ``param_shapes`` (the dry-run: no memory, no values)."""
    def f(p):
        return torch.empty(p.shape, dtype=moments_dtype, device="meta")

    return {"step": torch.empty((), dtype=torch.int32, device="meta"), "mu": tree_map(f, param_shapes),
            "nu": tree_map(f, param_shapes)}


def lr_schedule(run: RunConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay to 10% of peak (0-d fp32 tensor)."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(run.warmup_steps, 1), max=1.0)
    total = max(run.total_steps - run.warmup_steps, 1)
    frac = torch.clamp((step - run.warmup_steps) / total, 0.0, 1.0)
    cos = 0.1 + 0.45 * (1.0 + torch.cos(math.pi * frac))
    return run.learning_rate * warm * cos


def _square_sum(x: torch.Tensor) -> torch.Tensor:
    """sum(x²) in fp32 as a plain 0-d tensor (a DTensor's is reduced over
    its mesh first: its shards' partial sums do not add to plain tensors)."""
    s = torch.sum(torch.square(x.to(torch.float32)))
    return s.full_tensor() if is_dtensor(s) else s


def global_norm(tree) -> torch.Tensor:
    """The fp32 L2 norm over every leaf of ``tree`` (0-d tensor)."""
    return torch.sqrt(sum(_square_sum(x) for x in tree_leaves(tree)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree, max_norm: float):
    """``(tree scaled to a global norm of at most max_norm, norm)``, the
    leaves in fp32."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.to(torch.float32) * scale, tree), norm


@torch.no_grad()
def adamw_update(run: RunConfig, params, grads, state):
    """One AdamW step on ``params`` and ``state`` in place, the gradients
    clipped to ``run.grad_clip`` leaf by leaf (no clipped copy of the
    whole tree). Returns ``(params, state, metrics)``, the same ``params``
    and ``state`` objects."""
    state["step"].add_(1)
    step = state["step"]
    lr = lr_schedule(run, step)
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, run.grad_clip)
    b1, b2, eps = run.beta1, run.beta2, run.eps
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m32, v32 = m.to(torch.float32), v.to(torch.float32)  # moments may be bf16 (run.optimizer_dtype)
        m32 = b1 * m32 + (1 - b1) * g
        v32 = b2 * v32 + (1 - b2) * torch.square(g)
        mh = m32 / bc1
        vh = v32 / bc2
        delta = mh / (torch.sqrt(vh) + eps) + run.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * delta)
        m.copy_(m32)
        v.copy_(v32)

    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state["mu"]),
                          tree_leaves(state["nu"])):
        upd(p, g, m, v)
    return params, state, {"grad_norm": gnorm, "lr": lr}
