"""Step functions shared by the trainer, the coordinator and the dry-run.

Port of ``repro/launch/steps.py``. PyTorch runs eagerly, so each
``make_*`` function returns the step itself:
``make_grad_step`` gives ``(params, batch) → (grads, metrics)`` for the
het-DP coordinator, and ``make_train_step`` gives ``(params, opt_state,
batch) → (params, opt_state, metrics)`` with ``run.grad_accum_steps``
sequential microbatches. A batch is the numpy dict of
``data/dataset.py``; it goes to the params' device here. Activation
recomputation follows ``RunConfig.remat`` per period of blocks, as the
reference's ``jax.checkpoint`` of its scan body.

With ``rules`` (``parallel/sharding.py``) the steps are sharded: params
and optimizer state are DTensors placed by ``model_specs`` and
``opt_state_specs`` (:func:`distribute_tree`), the batch is placed along
its ``batch`` axis, each gradient is laid out as its parameter, and the
update runs shard by shard. ``make_prefill_step`` and ``make_serve_step``
are the serve side: ``models/model.py::prefill`` and ``decode_step`` with
the same ``rules`` (the cache a DTensor tree laid out by ``cache_specs``).

``cell_artifacts`` gives what the dry-run (``launch/dryrun.py``) needs for
one (arch × shape × mesh) cell: the step, its stand-in arguments
(``meta`` tensors: ``model_shapes``, ``opt_state_shapes``,
``configs.input_specs``, :func:`cache_shapes`), the PartitionSpec tree of
each argument, and the donated arguments, as the reference returns them.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs import input_shardings, input_specs
from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.models import model as M
from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import (
    ShardingRules,
    is_dtensor,
    rules_from_mesh,
    sharded_context,
    spec_placements,
    whole,
)

_LONG = ("tokens", "labels")  # index tensors: embedding rows, gathered logits


def distribute_tree(tree, spec_tree, mesh):
    """``tree``'s tensors as DTensors on ``mesh``, each placed by its
    PartitionSpec in ``spec_tree`` (``torch.distributed.tensor.
    distribute_tensor``: every rank passes the same whole tensor)."""
    from torch.distributed.tensor import distribute_tensor

    return tree_map(lambda t, spec: distribute_tensor(t, mesh, spec_placements(mesh, spec)), tree, spec_tree)


def _to_device(batch: dict, device, rules: Optional[ShardingRules] = None) -> dict:
    """The batch's arrays as tensors on ``device`` (index tensors int64),
    placed along their ``batch`` axis with ``rules``. A DTensor input is
    already placed and passes as it is."""
    if any(is_dtensor(x) for x in batch.values()):
        return dict(batch)
    out = {key: torch.as_tensor(x, device=device) for key, x in batch.items()}
    out = {key: t.long() if key in _LONG else t for key, t in out.items()}
    if rules is None:
        return out
    # every input's first dim is the batch
    return {key: distribute_tree(t, rules.spec(("batch",) + (None,) * (t.dim() - 1), t.shape), rules.mesh)
            for key, t in out.items()}


def make_grad_step(cfg: ModelConfig, run: RunConfig, rules: Optional[ShardingRules] = None):
    """(params, batch) → (grads, metrics), used by the het-DP coordinator,
    which accumulates a pod-local number of microbatches before the
    weighted cross-pod combine (``core/coordinator.py``). Gradients come
    from ``torch.autograd.grad`` over the param leaves (made to require
    grad here, on the params' own storage), in the leaves' dtypes; a leaf
    the loss does not reach gets zeros, as ``jax.grad`` gives. Metrics are
    0-d tensors, detached: nothing here waits for the device.
    ``run.remat`` ("none", "dots" or "full") sets what the forward keeps
    for the backward and what it recomputes (``models/model.py::forward``).
    With ``rules``, params are DTensors, each gradient comes back laid out
    as its parameter, and the metrics are replicated plain tensors.
    """

    def loss_fn(params, batch):
        logits, aux = M.forward(cfg, run, params, batch["tokens"], batch.get("prefix_features"), rules=rules)
        if is_dtensor(logits):
            # sharded: the labels are shifted, not the logits (a slice of
            # their sequence-sharded dim would gather them); the last
            # position has no next token and is masked out
            labels, mask = whole(batch["labels"]), whole(batch["mask"])
            labels = torch.cat([labels[:, 1:], labels[:, -1:]], dim=1)
            mask = torch.cat([mask[:, 1:], torch.zeros_like(mask[:, -1:])], dim=1)
            return M.lm_loss(cfg, run, logits, labels, mask, aux)
        return M.lm_loss(cfg, run, logits[:, :-1], batch["labels"][:, 1:], batch["mask"][:, 1:], aux)

    def grad_step(params, batch):
        leaves = tree_leaves(params)
        live = [p.detach().requires_grad_() for p in leaves]
        with torch.enable_grad(), sharded_context(rules):
            total, metrics = loss_fn(tree_unflatten(params, live), _to_device(batch, leaves[0].device, rules))
            grads = torch.autograd.grad(total, live, allow_unused=True, materialize_grads=True)
        if rules is not None:
            # one leaf at a time, each old gradient freed as its new layout
            # lands (a whole second list would hold a copy of every gradient)
            grads = list(grads)
            for i, p in enumerate(leaves):
                if tuple(grads[i].placements) != tuple(p.placements):
                    grads[i] = grads[i].redistribute(p.device_mesh, p.placements)
            metrics = {k: v.full_tensor() if is_dtensor(v) else v for k, v in metrics.items()}
        return tree_unflatten(params, list(grads)), {k: v.detach() for k, v in metrics.items()}

    return grad_step


def make_train_step(cfg: ModelConfig, run: RunConfig, rules: Optional[ShardingRules] = None):
    """(params, opt_state, batch) → (params, opt_state, metrics). With
    ``run.grad_accum_steps`` = k > 1 the batch is split along its first
    axis into k sequential microbatches (activation memory ÷ k); their
    gradients are summed in fp32 in place, divided by k, and their metrics
    averaged, as the reference's ``lax.scan`` does. The update is
    ``adamw_update``, in place. With ``rules`` every rank passes the same
    whole batch and keeps its shards of params and optimizer state."""
    grad_step = make_grad_step(cfg, run, rules)
    k = max(1, run.grad_accum_steps)

    def train_step(params, opt_state, batch):
        if k == 1:
            grads, metrics = grad_step(params, batch)
        else:
            n = len(batch["tokens"]) // k
            gsum, ms = None, []
            for i in range(k):
                g, m = grad_step(params, {key: x[i * n:(i + 1) * n] for key, x in batch.items()})
                gsum = tree_map(lambda x: x.to(torch.float32), g) if gsum is None else tree_map(torch.Tensor.add_, gsum, g)
                ms.append(m)
            grads = tree_map(lambda x: x.div_(k), gsum)
            metrics = {key: torch.stack([m[key] for m in ms]).mean() for key in ms[0]}
        with sharded_context(rules):
            params, opt_state, opt_metrics = adamw.adamw_update(run, params, grads, opt_state)
        metrics.update({k: v.full_tensor() if is_dtensor(v) else v for k, v in opt_metrics.items()})
        return params, opt_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# Serve (prefill + decode)
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ModelConfig, run: RunConfig, rules: Optional[ShardingRules], max_len: int):
    """(params, batch) → (last-position logits, cache): ``models/model.py::
    prefill`` with ``rules``; the batch holds ``tokens`` (and a frontend's
    ``prefix_features``), numpy arrays or tensors placed as
    :func:`batch_shardings` says."""

    def prefill_step(params, batch):
        b = _to_device(batch, tree_leaves(params)[0].device, rules)
        return M.prefill(cfg, run, params, b["tokens"], max_len, b.get("prefix_features"), rules=rules)

    return prefill_step


def make_serve_step(cfg: ModelConfig, run: RunConfig, rules: Optional[ShardingRules]):
    """(params, cache, batch) → (logits, cache): one-token decode with the
    KV/state cache (``models/model.py::decode_step`` with ``rules``), the
    reference's serve_step. The cache is updated in place."""

    def serve_step(params, cache, batch):
        b = _to_device(batch, tree_leaves(params)[0].device, rules)
        return M.decode_step(cfg, run, params, cache, b["tokens"], rules=rules)

    return serve_step


# ---------------------------------------------------------------------------
# Shardings / shapes for a workload cell
# ---------------------------------------------------------------------------


def batch_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh, rules: ShardingRules) -> dict:
    """The placements on ``mesh`` of each input of ``configs.input_specs``
    (batch over the DP axes)."""
    return {k: spec_placements(mesh, spec) for k, spec in input_shardings(cfg, shape, rules).items()}


def cache_shapes(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """``meta`` stand-ins of the decode cache (allocation-free)."""
    return M.init_cache(cfg, shape.global_batch, shape.seq_len, "meta")


def cell_artifacts(cfg: ModelConfig, run: RunConfig, shape: ShapeConfig, mesh) -> dict:
    """Everything needed to run one (arch × shape × mesh) cell: ``fn``, its
    stand-in ``args`` (``meta`` tensors), ``in_shardings`` (the
    PartitionSpec tree of each argument, ``named_tree``'s input: place
    with :func:`distribute_tree` or ``parallel/sharding.py::placed_full``),
    ``donate_argnums`` and the ``rules``."""
    rules = rules_from_mesh(mesh, fsdp=run.fsdp, sequence_parallel=run.sequence_parallel)
    pspecs = M.model_specs(cfg, rules)
    pshapes = M.model_shapes(cfg)
    batch = input_specs(cfg, shape)
    bspecs = input_shardings(cfg, shape, rules)
    if shape.kind == "train":
        oshapes = adamw.opt_state_shapes(pshapes, getattr(torch, run.optimizer_dtype))
        return dict(fn=make_train_step(cfg, run, rules), args=(pshapes, oshapes, batch),
                    in_shardings=(pspecs, adamw.opt_state_specs(pspecs), bspecs), donate_argnums=(0, 1), rules=rules)
    if shape.kind == "prefill":
        return dict(fn=make_prefill_step(cfg, run, rules, max_len=shape.seq_len), args=(pshapes, batch),
                    in_shardings=(pspecs, bspecs), donate_argnums=(), rules=rules)
    cspecs = M.cache_specs(cfg, rules, shape.global_batch, shape.seq_len)
    return dict(fn=make_serve_step(cfg, run, rules), args=(pshapes, cache_shapes(cfg, shape), batch),
                in_shardings=(pspecs, cspecs, bspecs), donate_argnums=(1,), rules=rules)
