"""Mixture-of-experts FFN with grouped, capacity-bounded dispatch.

Port of ``repro/models/moe.py``. Routing is a softmax over the experts, the
top ``k`` with their probabilities renormalised (the Mixtral convention).
The sequence is cut into dispatch groups of ``moe_group_size`` tokens, and
in each group every expert takes at most ``C = ceil(group * k * cf / E)``
(token, slot) pairs, counted in token-major, slot-minor order; a pair past
its expert's capacity is dropped and loses its gate weight. ``cf`` is
``moe_capacity_factor`` for training and ``moe_eval_capacity_factor`` for
prefill and decode (``inference=True``).

The JAX package dispatches and combines with one-hot ``(g, E, C)`` einsums.
Each of those sums has a single nonzero term, so here each kept pair is
scattered into its (expert, position) row of the same static
``(E, groups * C, D)`` buffer, and gathered back from the experts' output
rows: the same values, with no shape that depends on the data and no host
sync, so a decode step replays as a CUDA graph. The experts run as one
batched product over E (``torch.bmm``), which the JAX package also computes
outside any Pallas kernel. Dispatch runs in the compute dtype, and the
combine weights the expert outputs by the gates cast to it, as there.

Selection follows ``jax.lax.top_k``: among equal probabilities the lower
expert index comes first. ``torch.topk`` breaks such ties otherwise, so
the port takes the first ``k`` of a stable descending sort. The order
picks the experts and fixes the order in which capacity positions count.

With ``rules`` on DTensors, each data rank routes its own groups, as the
JAX package lets XLA keep the group dim on the batch's devices. A group
never crosses a sequence, so the rank's batch rows (its sequences made
whole over ``model``) hold whole groups, and its routing decisions are the
whole path's exactly. Each rank builds its ``(E, ng_local * C, D)`` buffer,
the global buffer's group dim split over the DP axes. The expert products
shard as the JAX package's do: the expert dim over ``model`` where E
divides it (expert parallelism), else the slot dim (``resolve_moe_axes``);
each ``model`` rank takes its slice of the buffer (no communication) and
the outputs are all-gathered back over ``model`` for the combine. The
routing, scatter and gather run on each rank's local tensors
(``parallel/sharding.py::local_map``): DTensor has no sharding rule for
them. ``moe_aux`` is averaged over the data ranks (equal groups: the
whole path's mean) and the kept pairs summed. A batch that no DP axis
divides stays whole on every rank and is routed whole, as the reference
routes it.

**Dropless, DeepSeek-V3-style** (``moe_dropless``; the port's own, for
``moonlight-16b-a3b``): no groups and no capacity. The router's scores are
the sigmoid of an fp32 product; the ``k`` experts are chosen on the scores
plus a per-expert correction bias (the parameter ``bias``), the gates are
the chosen scores without it, renormalised and times ``routed_scale``. The (token, slot) pairs are
sorted by expert (stable: a token's pairs keep their order), the experts'
offsets into the sorted rows found on the device (``searchsorted``), and
each projection runs as one grouped product over the experts' runs of
rows (``torch._grouped_mm``; an expert with no rows takes none). The
outputs go back to their pairs and are summed by their gates in fp32. No
shape depends on the data and nothing waits for the device, so a decode
step that routes this way replays as a CUDA graph. ``shared_d_ff`` adds
the shared experts, one SwiGLU every token goes through. Spans (when
``repro_torch.spans`` records): ``moe.apply`` around each such layer (with
CUDA events on the card), its children ``moe.route``, ``moe.experts`` and
``moe.shared``. With a ``load`` tensor, each call adds its pairs and the
most that one expert took, on the device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch import spans
from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamDef, mlp_apply, mlp_defs, nrm, zeros_init
from repro_torch.parallel.sharding import (
    ShardingRules,
    gather_over,
    is_dtensor,
    local_map,
    partial_reduce,
    shard_constraint,
    split_over,
)


def moe_defs(cfg: ModelConfig) -> dict:
    e, d, f = cfg.num_experts, cfg.d_model, cfg.ffn_dim
    defs = {
        "router": ParamDef((d, e), ("fsdp", None), nrm()),
        "gate": ParamDef((e, d, f), ("expert", "fsdp", None), nrm(fan_in_axis=1)),
        "up": ParamDef((e, d, f), ("expert", "fsdp", None), nrm(fan_in_axis=1)),
        "down": ParamDef((e, f, d), ("expert", None, "fsdp"), nrm(fan_in_axis=1)),
    }
    if cfg.moe_dropless:
        defs["bias"] = ParamDef((e,), (None,), zeros_init)
    if cfg.shared_d_ff:
        defs["shared"] = mlp_defs(d, cfg.shared_d_ff)
    return defs


def resolve_moe_axes(cfg: ModelConfig, rules: Optional[ShardingRules]) -> bool:
    """True where the expert dim takes the ``model`` axis (expert
    parallelism: E divides it); else the experts replicate and shard
    inside each expert (in-expert TP)."""
    if rules is None:
        return False
    return cfg.num_experts % max(1, rules.tp_size) == 0


def _top_k_routing(logits: torch.Tensor, k: int):
    """logits (..., E) -> (probs fp32, renormalised top-k probs, top-k
    indices), the lower index first among equal probabilities."""
    probs = torch.softmax(logits.float(), dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[..., :k], top_i[..., :k]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, top_p, top_i


class Routing(NamedTuple):
    """Where each (token, slot) of the groups goes; ``(ng, g, k)`` unless noted."""

    probs: torch.Tensor  # (ng, g, E) fp32 router probabilities
    top_p: torch.Tensor  # renormalised gate of each slot, fp32
    top_i: torch.Tensor  # expert of each slot, int64
    pos: torch.Tensor  # position in that expert's queue of the group, int64
    keep: torch.Tensor  # pos < cap
    counts: torch.Tensor  # (ng, E) slots routed to each expert, before the drop
    cap: int  # capacity per expert and group


def route(cfg: ModelConfig, params: dict, xg: torch.Tensor, inference: bool) -> Routing:
    """Route the groups ``xg`` (ng, g, D)."""
    ng, g, _ = xg.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    logits = xg @ params["router"].to(xg.dtype)
    probs, top_p, top_i = _top_k_routing(logits, k)
    cf = cfg.moe_eval_capacity_factor if inference else cfg.moe_capacity_factor
    cap = int(max(1, min(g, -(-g * k * cf // e))))  # ceil, at most the group
    # a pair's position: the pairs before it in the group that chose its expert
    flat = top_i.reshape(ng, g * k, 1)
    sel = torch.zeros((ng, g * k, e), dtype=torch.int32, device=xg.device).scatter_(2, flat, 1)
    pos = (sel.cumsum(1) - sel).gather(2, flat).view(ng, g, k)
    return Routing(probs, top_p, top_i, pos, pos < cap, sel.sum(1), cap)


def _experts(w: dict, xe: torch.Tensor) -> torch.Tensor:
    """The SwiGLU experts on their rows: xe (E', rows, D) -> (E', rows, D),
    one batched product over the experts per projection, the weights cast
    to ``xe``'s dtype."""
    dt = xe.dtype
    h = F.silu(torch.bmm(xe, w["gate"].to(dt))) * torch.bmm(xe, w["up"].to(dt))
    return torch.bmm(h, w["down"].to(dt))


def _scatter(xg: torch.Tensor, row: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The expert buffer (n_rows, D): each token's copy at its pairs' rows
    ``row`` (tokens, k), written from the tokens broadcast over the slots
    (no (tokens, k, D) copy); a dropped pair's row is the spare last one,
    which is cut off."""
    tok = xg.reshape(-1, 1, xg.shape[-1])
    xe = xg.new_zeros((n_rows + 1, tok.shape[-1]))
    return xe.index_put_((row,), tok.expand(-1, row.shape[1], -1))[:n_rows]


def _dispatch_combine(cfg: ModelConfig, router: torch.Tensor, xg: torch.Tensor, inference: bool, experts):
    """Route the groups ``xg`` (ng, g, D), scatter each kept pair into its
    row of the ``(E, ng * C, D)`` buffer, run ``experts`` on it and gather
    the pairs back, weighted by their gates. Plain tensors. Returns ``(y
    (ng, g, D), Routing)``."""
    ng, g, d = xg.shape
    dt = xg.dtype
    e, k = cfg.num_experts, cfg.experts_per_token
    r = route(cfg, {"router": router}, xg, inference)
    # each pair's row of the expert buffer (E, ng * C, D); a dropped pair
    # goes to a spare last row that nothing reads
    n_rows = e * ng * r.cap
    grp = torch.arange(ng, device=xg.device).view(ng, 1, 1)
    row = torch.where(r.keep, r.top_i * (ng * r.cap) + grp * r.cap + r.pos, n_rows).view(ng * g, k)
    # the buffer is no one's but the experts': it is freed once they ran
    ye = experts(_scatter(xg, row, n_rows).view(e, ng * r.cap, d)).reshape(n_rows, d)
    # a dropped pair reads any row and weighs it by a gate of 0
    out = ye[row.reshape(-1).clamp_max(n_rows - 1)].view(ng, g, k, d)
    gates = (r.top_p * r.keep).to(dt)
    return (out.float() * gates.float()[..., None]).sum(2).to(dt), r


def _aux(r: Routing, g: int) -> torch.Tensor:
    """The GShard load-balance loss of the routed groups, averaged over them."""
    # counts over a count as the JAX package takes them: times the fp32
    # reciprocal of the count
    f_e = r.counts.float() * (1.0 / g)
    return r.probs.shape[-1] * (f_e * r.probs.mean(1)).sum(-1).mean()


def _gates(cfg: ModelConfig, params: dict, x: torch.Tensor):
    """Dropless routing of the tokens x (T, D): ``(gates (T, k) fp32,
    experts (T, k) int64)``, the lower expert index first among equal
    selection scores."""
    scores = torch.sigmoid(x.float() @ params["router"].float())
    choice = scores + params["bias"].float()
    top_i = torch.sort(choice, dim=-1, descending=True, stable=True)[1][:, :cfg.experts_per_token]
    top_w = scores.gather(-1, top_i)
    return top_w / (top_w.sum(-1, keepdim=True) + 1e-20) * cfg.routed_scale, top_i


def _grouped_experts(w: dict, xs: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """The SwiGLU experts on the pairs' rows xs (P, D), sorted by expert,
    expert e's rows ending at ``offs[e]``: one grouped product per
    projection, the weights cast to xs's dtype."""
    dt = xs.dtype
    h = F.silu(torch._grouped_mm(xs, w["gate"].to(dt), offs=offs)) * torch._grouped_mm(xs, w["up"].to(dt), offs=offs)
    return torch._grouped_mm(h, w["down"].to(dt), offs=offs)


def _moe_dropless(cfg: ModelConfig, params: dict, x: torch.Tensor, load: Optional[torch.Tensor]):
    """:func:`moe_apply` without capacity (see the module docstring): x (T,
    D) -> y (T, D)."""
    t, d = x.shape
    k, e = cfg.experts_per_token, cfg.num_experts
    child = spans.begin("moe.route") if spans.on else -1
    gates, top_i = _gates(cfg, params, x)
    experts, order = torch.sort(top_i.reshape(-1), stable=True)
    offs = torch.searchsorted(experts, torch.arange(e, device=x.device), right=True).to(torch.int32)
    if load is not None:  # the pairs, and the most that one expert took
        counts = torch.diff(offs, prepend=offs.new_zeros(1))
        load.add_(torch.stack([counts.sum(), counts.max()]).to(load.dtype))
    if child >= 0:
        child = spans.then(child, "moe.experts")
    ys = _grouped_experts(params, x[order // k], offs)
    # each output back at its pair, then the pairs of a token summed by their gates
    ys = torch.empty_like(ys).index_copy_(0, order, ys).view(t, k, d)
    y = (ys.float() * gates[..., None]).sum(1).to(x.dtype)
    if "shared" in params:
        if child >= 0:
            child = spans.then(child, "moe.shared")
        y = y + mlp_apply(params["shared"], x, x.dtype)
    if child >= 0:
        spans.end(child)
    return y


def moe_apply(cfg: ModelConfig, params: dict, x: torch.Tensor, inference: bool = False,
              rules: Optional[ShardingRules] = None, load: Optional[torch.Tensor] = None):
    """x (B, S, D) -> (y (B, S, D), {"moe_aux", "moe_drop_frac"}). S must be
    at most ``moe_group_size`` or a multiple of it (the JAX package asserts
    the same; neither pads), except under ``moe_dropless``.

    ``moe_aux`` is the GShard load-balance loss ``E * sum_e f_e * p_e``
    (``f_e`` the share of slots routed to e before the drop, ``p_e`` the
    mean router probability), per group and averaged; ``moe_drop_frac``
    the share of (token, slot) pairs dropped. Dropless, both are 0: the
    correction bias balances the load in place of a loss, and no pair is
    dropped. ``load`` (a (2,) int64 tensor) gains the dropless routing's
    pairs and the most that one expert took.
    """
    b, s, d = x.shape
    if cfg.moe_dropless:
        if rules is not None:
            raise NotImplementedError("dropless MoE has no sharded path")
        span = spans.begin("moe.apply", device=True) if spans.on else -1
        y = _moe_dropless(cfg, params, x.reshape(b * s, d), load).view(b, s, d)
        if span >= 0:
            spans.end(span)
        zero = torch.zeros((), device=x.device)
        return y, {"moe_aux": zero, "moe_drop_frac": zero}
    g = min(cfg.moe_group_size, s)
    if s % g:
        raise ValueError(f"moe_apply: sequence {s} is not a multiple of the dispatch group {g}")
    if rules is not None and is_dtensor(x):
        return _moe_sharded(cfg, params, x, inference, rules, g)
    y, r = _dispatch_combine(cfg, params["router"], x.reshape(b * (s // g), g, d), inference,
                             lambda xe: _experts(params, xe))
    # the drop share times the fp32 reciprocal of the count, as the JAX
    # package takes it, so that it is the same bits
    dropped = 1.0 - r.keep.float().sum() * (1.0 / r.keep.numel())
    return y.reshape(b, s, d), {"moe_aux": _aux(r, g), "moe_drop_frac": dropped}


def _moe_sharded(cfg: ModelConfig, params: dict, x, inference: bool, rules: ShardingRules, g: int):
    """:func:`moe_apply` on DTensors, each data rank routing its own groups
    (see the module docstring)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    b, s, d = x.shape
    k = cfg.experts_per_token
    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    # each data rank's own batch rows, whole sequences: whole groups
    x = shard_constraint(x, rules, ("batch", None, None))
    rows = tuple(n for n, pl in zip(names, x.placements) if pl.is_shard(0))
    # a replicated weight used for this rank's rows only: its gradient is a term
    on_rows = [Partial() if n in rows else Replicate() for n in names]
    ep = "model" in names and params["gate"].placements[names.index("model")].is_shard(0)
    # the experts gathered over the DP dims (fsdp); over model their own
    # slice under expert parallelism, else whole (each rank takes its slots)
    w_at = [pl if n == "model" else Replicate() for n, pl in zip(names, params["gate"].placements)]
    # the experts' gradients: each model rank's own experts, or a term (its slots)
    w_grad = [(Shard(0) if ep else Partial()) if n == "model" else pl for n, pl in zip(names, on_rows)]
    dt = x.dtype
    ws = [params[n].to(dt).redistribute(mesh, w_at) for n in ("gate", "up", "down")]

    def local(xl, router, gate, up, down):
        w = {"gate": gate, "up": up, "down": down}

        def experts(xe):
            """The experts over this data row's buffer, the same on each rank
            of ``model``: each rank runs its experts (or its slots) and the
            outputs are gathered back whole over ``model``."""
            if "model" not in names:
                return _experts(w, xe)
            cut = 0 if ep else 1
            return gather_over(_experts(w, split_over(xe, mesh, "model", cut)), mesh, "model", cut, xe.shape[cut])

        b_l = xl.shape[0]
        y, r = _dispatch_combine(cfg, router, xl.reshape(b_l * (s // g), g, d), inference, experts)
        # the groups are equal in size: the mean of the ranks' means is the
        # whole mean, and the kept pairs' count adds up exactly
        aux = partial_reduce(_aux(r, g), mesh, rows, "mean")
        kept = partial_reduce(r.keep.float().sum(), mesh, rows)
        dropped = 1.0 - kept * (1.0 / (b * s * k))
        return y.reshape(b_l, s, d), aux, dropped

    y, aux, dropped = local_map(local, x, params["router"].redistribute(mesh, [Replicate()] * mesh.ndim), *ws,
                                grads=[None, on_rows, w_grad, w_grad, w_grad],
                                out=[(x.placements, (b, s, d)), "replicate", "replicate"])
    return y, {"moe_aux": aux, "moe_drop_frac": dropped}
