"""Training step functions shared by the trainer and the coordinator.

Port of the training half of ``repro/launch/steps.py``. PyTorch runs
eagerly, so each ``make_*`` function returns the step itself:
``make_grad_step`` gives ``(params, batch) → (grads, metrics)`` for the
het-DP coordinator, and ``make_train_step`` gives ``(params, opt_state,
batch) → (params, opt_state, metrics)`` with ``run.grad_accum_steps``
sequential microbatches. A batch is the numpy dict of
``data/dataset.py``; it goes to the params' device here. Activation
recomputation follows ``RunConfig.remat`` per period of blocks, as the
reference's ``jax.checkpoint`` of its scan body. The serve and
prefill steps, the shardings and the dry-run artifacts belong to
distribution and are not ported.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import model as M
from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import adamw

_LONG = ("tokens", "labels")  # index tensors: embedding rows, gathered logits


def _to_device(batch: dict, device) -> dict:
    out = {key: torch.as_tensor(x, device=device) for key, x in batch.items()}
    return {key: t.long() if key in _LONG else t for key, t in out.items()}


def make_grad_step(cfg: ModelConfig, run: RunConfig):
    """(params, batch) → (grads, metrics), used by the het-DP coordinator,
    which accumulates a pod-local number of microbatches before the
    weighted cross-pod combine (``core/coordinator.py``). Gradients come
    from ``torch.autograd.grad`` over the param leaves (made to require
    grad here, on the params' own storage), in the leaves' dtypes; a leaf
    the loss does not reach gets zeros, as ``jax.grad`` gives. Metrics are
    0-d tensors, detached: nothing here waits for the device.
    ``run.remat`` ("none", "dots" or "full") sets what the forward keeps
    for the backward and what it recomputes (``models/model.py::forward``).
    """

    def loss_fn(params, batch):
        logits, aux = M.forward(cfg, run, params, batch["tokens"], batch.get("prefix_features"))
        return M.lm_loss(cfg, run, logits[:, :-1], batch["labels"][:, 1:], batch["mask"][:, 1:], aux)

    def grad_step(params, batch):
        leaves = tree_leaves(params)
        live = [p.detach().requires_grad_() for p in leaves]
        with torch.enable_grad():
            total, metrics = loss_fn(tree_unflatten(params, live), _to_device(batch, leaves[0].device))
            grads = torch.autograd.grad(total, live, allow_unused=True, materialize_grads=True)
        return tree_unflatten(params, list(grads)), {k: v.detach() for k, v in metrics.items()}

    return grad_step


def make_train_step(cfg: ModelConfig, run: RunConfig):
    """(params, opt_state, batch) → (params, opt_state, metrics). With
    ``run.grad_accum_steps`` = k > 1 the batch is split along its first
    axis into k sequential microbatches (activation memory ÷ k); their
    gradients are summed in fp32 in place, divided by k, and their metrics
    averaged, as the reference's ``lax.scan`` does. The update is
    ``adamw_update``, in place."""
    grad_step = make_grad_step(cfg, run)
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
        params, opt_state, opt_metrics = adamw.adamw_update(run, params, grads, opt_state)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step
