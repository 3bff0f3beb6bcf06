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

With ``rules`` the expert products shard as the JAX package's do: the
expert dim over ``model`` where E divides it (expert parallelism), else the
slot dim (``resolve_moe_axes``). On DTensors the routing, the dispatch
scatter and the combine gather run on whole tensors, the same on every
rank: DTensor has no sharding rule for them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamDef, nrm
from repro_torch.parallel.sharding import ShardingRules, pin, replicated_like, shard_constraint, whole


def moe_defs(cfg: ModelConfig) -> dict:
    e, d, f = cfg.num_experts, cfg.d_model, cfg.ffn_dim
    return {
        "router": ParamDef((d, e), ("fsdp", None), nrm()),
        "gate": ParamDef((e, d, f), ("expert", "fsdp", None), nrm(fan_in_axis=1)),
        "up": ParamDef((e, d, f), ("expert", "fsdp", None), nrm(fan_in_axis=1)),
        "down": ParamDef((e, f, d), ("expert", None, "fsdp"), nrm(fan_in_axis=1)),
    }


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


def moe_apply(cfg: ModelConfig, params: dict, x: torch.Tensor, inference: bool = False,
              rules: Optional[ShardingRules] = None):
    """x (B, S, D) -> (y (B, S, D), {"moe_aux", "moe_drop_frac"}). S must be
    at most ``moe_group_size`` or a multiple of it (the JAX package asserts
    the same; neither pads).

    ``moe_aux`` is the GShard load-balance loss ``E * sum_e f_e * p_e``
    (``f_e`` the share of slots routed to e before the drop, ``p_e`` the
    mean router probability), per group and averaged; ``moe_drop_frac``
    the share of (token, slot) pairs dropped.
    """
    dt = x.dtype
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    g = min(cfg.moe_group_size, s)
    if s % g:
        raise ValueError(f"moe_apply: sequence {s} is not a multiple of the dispatch group {g}")
    ng = b * (s // g)
    # on DTensors the routing, the dispatch scatter and the combine gather
    # (sort, scatter_, cumsum, index_copy_, indexing: no DTensor sharding
    # rules) run on the whole tensors, replicated on every rank; the
    # experts' products run sharded
    xg = whole(x).reshape(ng, g, d)
    r = route(cfg, {"router": whole(params["router"])}, xg, inference)

    # each pair's row of the expert buffer (E, ng * C, D); a dropped pair
    # goes to a spare last row that nothing reads
    n_rows = e * ng * r.cap
    grp = torch.arange(ng, device=xg.device).view(ng, 1, 1)
    row = torch.where(r.keep, r.top_i * (ng * r.cap) + grp * r.cap + r.pos, n_rows).reshape(-1)
    tok = xg.reshape(ng * g, 1, d).expand(ng * g, k, d).reshape(-1, d)
    xe = xg.new_zeros((n_rows + 1, d)).index_copy_(0, row, tok)[:n_rows].view(e, ng * r.cap, d)
    # the expert dim takes ``model`` where E divides it, else the slots do
    ec_axes = ("expert", "moe_tp", None)
    xe = shard_constraint(replicated_like(xe, x), rules, ec_axes)
    h = F.silu(torch.bmm(xe, params["gate"].to(dt))) * torch.bmm(xe, params["up"].to(dt))
    h = shard_constraint(h, rules, ec_axes)
    ye = whole(shard_constraint(torch.bmm(h, params["down"].to(dt)), rules, ec_axes)).view(n_rows, d)
    # a dropped pair reads any row and weighs it by a gate of 0
    out = ye[row.clamp_max(n_rows - 1)].view(ng, g, k, d)
    gates = (r.top_p * r.keep).to(dt)
    y = replicated_like((out.float() * gates.float()[..., None]).sum(2).to(dt), x)

    # counts over a count as the JAX package takes them: times the fp32
    # reciprocal of the count, so the drop share is the same bits
    f_e = r.counts.float() * (1.0 / g)
    aux = e * (f_e * r.probs.mean(1)).sum(-1).mean()
    dropped = 1.0 - r.keep.float().sum() * (1.0 / r.keep.numel())
    # replicated DTensors on DTensor inputs, so that the loss's gradient
    # comes back into the whole tensors as plain tensors
    # y pinned: its gradient comes back replicated before the view into groups
    return pin(y.reshape(b, s, d)), {"moe_aux": replicated_like(aux, x), "moe_drop_frac": replicated_like(dropped, x)}
