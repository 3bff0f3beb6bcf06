"""Model assembly: embedding → layer loop → LM head.

Port of ``repro/models/model.py`` for every architecture of the JAX
package: stacks of attention blocks with a dense SwiGLU FFN (qwen3,
internlm2, llama3, llava, musicgen) or a mixture-of-experts FFN (moonshot,
mixtral: ``models/moe.py``), the xLSTM stack (mLSTM and sLSTM blocks, no
FFN), and the hybrid of Mamba-2 and attention blocks, each with a dense or
MoE FFN (jamba). The JAX package's ``lax.scan`` over block periods becomes
a Python loop over the periods' layers; parameters are a dict with a
``layers`` list, one dict per layer, in the JAX package's weight layouts
(``wq (D, H, hd)``, ``wo (H, hd, D)``, experts ``(E, D, F)``). A modality frontend
(llava's vision patches, musicgen's audio frames) is a linear projection
``frontend.proj`` of precomputed features, put before the token
embeddings when ``forward`` or ``prefill`` is given ``prefix_features``;
the decode step and the serving loop take tokens only, as the JAX
package's do.

The decode cache holds what the architecture has, each kind stacked over
its own layers with batch on dim 1, so a serving slot is one
``index_copy_`` on dim 1 of every tensor:

* attention: ``{"pos": (B,) int64, "k": (L, B, cap, KH, hd), "v": ...}``;
  under latent attention (MLA) ``{"pos", "c_kv": (L, B, cap, kv_lora_rank),
  "k_pe": (L, B, cap, qk_rope_head_dim)}``;
* xLSTM: ``{"pos", "mlstm": (L_m, B, H, hd, hd + 1) fp32, "slstm": {"h",
  "c", "n", "m"}: (L_s, B, d)}`` (``h`` in the compute dtype, the rest
  fp32, ``m`` starting at -1e30);
* Mamba-2: ``{"mamba": {"conv_x": (L_mb, B, W - 1, d_inner), "conv_b",
  "conv_c": (L_mb, B, W - 1, N), "ssm": (L_mb, B, H, N, P)}}``: the last
  W - 1 raw inputs of each causal conv in the compute dtype, the SSM state
  in fp32; beside the attention layers' ``k`` and ``v``.

``decode_step`` updates the cache in place; an inactive row keeps its
position, its KV slots and its recurrent state exactly as they were.

Three entry points mirror the workload kinds:
  forward()      — training forward (logits + aux metrics), activation
                   recomputation per ``RunConfig.remat``
  prefill()      — forward + cache construction
  decode_step()  — one token with cache
and ``lm_loss`` is the training loss on the forward's logits.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from repro_torch import spans
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm
from repro_torch.models.common import (
    ParamDef,
    build_params,
    build_shapes,
    build_specs,
    mlp_apply,
    mlp_defs,
    norm_def,
    nrm,
    param_count,
    rms_norm,
    softcap,
    trunc_nrm,
)
from repro_torch.parallel.sharding import (
    PartitionSpec,
    ShardingRules,
    gather_sequence,
    is_dtensor,
    local_map,
    local_range,
    partial_reduce,
    pin,
    placed_full,
    replicate,
    settle,
    shard_constraint,
    sharded_context,
    whole,
)

FRONTEND_FEATURE_DIM = {"audio_frames": 128, "vision_patches": 1152}
DEFAULT_PREFIX_LEN = 256


@functools.cache
def _kind_index(cfg: ModelConfig) -> tuple[tuple[str, int], ...]:
    """(kind, index among the layers of that kind) for every layer: where
    a layer's state sits in the cache."""
    seen: dict[str, int] = {}
    out = []
    for i in range(cfg.num_layers):
        kind = cfg.layer_kind(i)
        out.append((kind, seen.get(kind, 0)))
        seen[kind] = seen.get(kind, 0) + 1
    return tuple(out)


def _kind_counts(cfg: ModelConfig) -> dict[str, int]:
    """Number of layers of each kind."""
    return {kind: j + 1 for kind, j in _kind_index(cfg)}


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------


def _block_defs(cfg: ModelConfig, i: int) -> dict:
    kind = cfg.layer_kind(i)
    if kind == "mlstm":
        return {"mlstm": ssm.mlstm_defs(cfg)}
    if kind == "slstm":
        return {"slstm": ssm.slstm_defs(cfg)}
    mixer = ssm.mamba_defs(cfg) if kind == "mamba" else attn.attn_defs(cfg)
    d = {"norm": norm_def(cfg.d_model), kind: mixer}
    if cfg.layer_is_moe(i):
        d["ffn_norm"] = norm_def(cfg.d_model)
        d["moe"] = moe_lib.moe_defs(cfg)
    elif cfg.d_ff:
        d["ffn_norm"] = norm_def(cfg.d_model)
        d["ffn"] = mlp_defs(cfg.d_model, cfg.d_ff)
    return d


def model_defs(cfg: ModelConfig) -> dict:
    defs = {
        "embed": ParamDef((cfg.vocab_size, cfg.d_model), ("tp", "fsdp"), trunc_nrm(0.02)),
        "layers": [_block_defs(cfg, i) for i in range(cfg.num_layers)],
        "final_norm": norm_def(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((cfg.d_model, cfg.vocab_size), ("fsdp", "tp"), nrm())
    if cfg.frontend:
        defs["frontend"] = {"proj": ParamDef((FRONTEND_FEATURE_DIM[cfg.frontend], cfg.d_model), (None, "fsdp"), nrm())}
    return defs


def init_model(cfg: ModelConfig, gen: torch.Generator, dtype=torch.float32) -> dict:
    """Random weights from ``gen``, on ``gen``'s device. Serving may hold
    them in the compute dtype: that gives the values the JAX package's
    cast-at-use gives."""
    return build_params(model_defs(cfg), gen, gen.device, dtype)


def model_specs(cfg: ModelConfig, rules: Optional[ShardingRules]):
    """The PartitionSpec tree of :func:`init_model`'s params. ``layers[i]``
    gets the JAX package's spec of ``layers/b{i % period}`` without its
    leading (replicated) stack dim."""
    return build_specs(model_defs(cfg), rules)


def model_shapes(cfg: ModelConfig):
    """Allocation-free stand-ins of :func:`init_model`'s params: fp32
    tensors on the ``meta`` device (the dry-run)."""
    return build_shapes(model_defs(cfg))


def count_params_exact(cfg: ModelConfig) -> int:
    return param_count(model_defs(cfg))


def count_active_params_exact(cfg: ModelConfig) -> int:
    """Per-token active params (MoE experts scaled to experts_per_token)."""
    total = count_params_exact(cfg)
    for blk in model_defs(cfg)["layers"]:
        if "moe" in blk:
            experts = param_count([blk["moe"][w] for w in ("gate", "up", "down")])
            total -= experts - experts * cfg.experts_per_token // cfg.num_experts
    return total


# ---------------------------------------------------------------------------
# Blocks, embedding, head
# ---------------------------------------------------------------------------


def _compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def _ffn(cfg, blk, h, inference: bool, rules: Optional[ShardingRules] = None,
         moe_load: Optional[torch.Tensor] = None):
    """The block's FFN, dense or MoE, on the residual ``h``. Returns ``(h,
    aux)``: the MoE metrics, or ``{}`` where the block has no MoE."""
    if "moe" in blk:
        hn = rms_norm(h, blk["ffn_norm"], cfg.norm_eps)
        y, aux = moe_lib.moe_apply(cfg, blk["moe"], hn, inference=inference, rules=rules, load=moe_load)
        return h + y, aux
    if "ffn" in blk:
        hn = gather_sequence(rms_norm(h, blk["ffn_norm"], cfg.norm_eps), rules)
        h = h + pin(mlp_apply(blk["ffn"], hn, _compute_dtype(cfg)))
    return h, {}


def _embed(cfg, params, tokens, prefix_features=None, rules: Optional[ShardingRules] = None):
    """Token embeddings (B, S, D), after the projected ``prefix_features``
    (B, P, feature dim) where given: (B, P + S, D). A sharded table is
    gathered whole first: DTensor's rule for a vocab-sharded embedding
    cannot reduce it when the batch is sharded too."""
    dt = _compute_dtype(cfg)
    h = F.embedding(tokens, replicate(params["embed"].to(dt)))
    if prefix_features is not None:
        pf = prefix_features.to(dt) @ params["frontend"]["proj"].to(dt)
        h = torch.cat([pf, h], dim=1)
    return shard_constraint(h, rules, ("batch", "sp", None))


def _head(cfg, params, h, rules: Optional[ShardingRules] = None):
    dt = _compute_dtype(cfg)
    h = gather_sequence(rms_norm(h, params["final_norm"], cfg.norm_eps), rules)
    w = params["embed"].to(dt).T if cfg.tie_embeddings else params["lm_head"].to(dt)
    return shard_constraint(softcap(h @ w, cfg.logit_softcap), rules, ("batch", "sp", "tp"))


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


def _block_full(cfg, run, blk, kind, h, positions, rules=None):
    """One block over the whole sequence (no cache), training capacity.
    Returns ``(h, aux)``. Each mixer's and FFN's output is pinned
    (``parallel/sharding.py::pin``): on DTensors its gradient comes back
    from the sequence-sharded residual laid out as the output was, which
    the projection's backward can fold into rows."""
    aux = {}
    if kind == "mlstm":
        h = h + pin(ssm.mlstm_apply_full(cfg, blk["mlstm"], gather_sequence(h, rules), chunk=run.ssd_chunk))
    elif kind == "slstm":
        h = h + pin(ssm.slstm_apply_full(cfg, blk["slstm"], gather_sequence(h, rules)))
    else:
        hn = rms_norm(h, blk["norm"], cfg.norm_eps)
        if kind == "mamba":
            h = h + pin(ssm.mamba_apply_full(cfg, blk["mamba"], hn, chunk=run.ssd_chunk, rules=rules))
        else:
            h = h + pin(attn.attn_apply_full(cfg, run, blk["attn"], hn, positions, rules=rules))
        h, aux = _ffn(cfg, blk, h, inference=False, rules=rules)
    return shard_constraint(h, rules, ("batch", "sp", None)), aux


def _period(cfg, run, blocks, kinds, positions, rules, h):
    """One period of blocks, the JAX package's scan body. Returns ``(h,
    aux)``, the MoE metrics summed over the period's blocks."""
    sums = {}
    for blk, kind in zip(blocks, kinds):
        h, aux = _block_full(cfg, run, blk, kind, h, positions, rules)
        for key, v in aux.items():
            sums[key] = sums[key] + v if key in sums else v
    return h, sums


# "dots" keeps the outputs of the products with no batch dimension (the
# weight products: 2-D matmuls and linear layers) and recomputes the rest,
# batched products (attention scores, the experts' bmm) and the kernels
# included, as jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims
_DOTS_SAVED = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]


def _remat(run: RunConfig, fn, h):
    """``fn(h)`` under ``run.remat``, as the JAX package's ``_remat`` wraps
    its scan body: "none" keeps every activation for the backward; "full"
    keeps only ``h`` and reruns ``fn`` in the backward; "dots" keeps the
    weight products' outputs besides and reruns the rest."""
    if run.remat == "none":
        return fn(h)
    if run.remat == "full":
        return checkpoint(fn, h, use_reentrant=False)
    if run.remat == "dots":
        return checkpoint(fn, h, use_reentrant=False,
                          context_fn=functools.partial(create_selective_checkpoint_contexts, _DOTS_SAVED))
    raise ValueError(f"RunConfig.remat={run.remat!r}: expected 'none', 'dots' or 'full'")


def forward(cfg: ModelConfig, run: RunConfig, params: dict, tokens: torch.Tensor,
            prefix_features: Optional[torch.Tensor] = None, rules: Optional[ShardingRules] = None):
    """Training/eval forward. tokens: (B, S), after the frontend's
    ``prefix_features`` (B, P, feature dim) where given. Returns (logits
    (B, P + S, V), aux).

    The blocks run a period (``cfg.period`` layers, the JAX package's scan
    body) at a time, each period under ``run.remat`` (:func:`_remat`).
    ``aux`` holds the MoE metrics as the JAX package reports them: summed
    over the blocks of each period, then averaged over the periods; zeros
    for a stack without MoE.

    With ``rules``, params and tokens are DTensors (``launch/steps.py::
    distribute_tree``) and the activations are laid out at the JAX
    package's ``shard_constraint`` sites; without, those are the identity."""
    with sharded_context(rules):
        h = _embed(cfg, params, tokens, prefix_features, rules)
        positions = torch.arange(h.shape[1], device=h.device)[None, :]
        kinds = [kind for kind, _ in _kind_index(cfg)]
        p = cfg.period
        periods = []
        for start in range(0, cfg.num_layers, p):
            body = functools.partial(_period, cfg, run, params["layers"][start:start + p], kinds[start:start + p],
                                     positions, rules)
            h, sums = _remat(run, body, h)
            periods.append(sums)
        if periods[0]:
            aux = {key: torch.stack([sums[key] for sums in periods]).mean() for key in periods[0]}
        else:
            zero = torch.zeros((), device=h.device)
            aux = {"moe_aux": zero, "moe_drop_frac": zero}
        return _head(cfg, params, h, rules), aux


def prefill(cfg: ModelConfig, run: RunConfig, params: dict, tokens: torch.Tensor, max_len: int,
            prefix_features: Optional[torch.Tensor] = None, rules: Optional[ShardingRules] = None,
            moe_load: Optional[torch.Tensor] = None):
    """Forward + cache build, the frontend's ``prefix_features`` before the
    tokens where given (the cache then holds P + S positions). Returns
    (last-position logits (B, 1, V), cache). ``moe_load``, a (2,) int64
    tensor on the device, gains each dropless MoE layer's routed (token,
    slot) pairs and the most that one expert took (``models/moe.py``).

    With ``rules``, params and tokens are DTensors, the activations are
    laid out at the training forward's sites and the cache is built as
    DTensors laid out by :func:`cache_specs` (:func:`init_cache`); without,
    those are the identity."""
    with sharded_context(rules):
        h = _embed(cfg, params, tokens, prefix_features, rules)
        b, seq = h.shape[:2]
        positions = torch.arange(seq, device=h.device)[None, :]
        cache = init_cache(cfg, b, max_len, h.device, rules)
        cache["pos"].fill_(seq)
        for blk, (kind, j) in zip(params["layers"], _kind_index(cfg)):
            if kind == "mlstm":
                y, state = ssm.mlstm_apply_full(cfg, blk["mlstm"], gather_sequence(h, rules), chunk=run.ssd_chunk,
                                                return_state=True)
                cache["mlstm"][j].copy_(state)
                h = h + y
            elif kind == "slstm":
                y, state = ssm.slstm_apply_full(cfg, blk["slstm"], gather_sequence(h, rules), return_state=True)
                for key, t in state.items():
                    cache["slstm"][key][j].copy_(t)
                h = h + y
            elif kind == "mamba":
                hn = rms_norm(h, blk["norm"], cfg.norm_eps)
                y, state = ssm.mamba_apply_full(cfg, blk["mamba"], hn, chunk=run.ssd_chunk, return_state=True,
                                                rules=rules)
                for key, t in state.items():
                    cache["mamba"][key][j].copy_(t)
                h, _ = _ffn(cfg, blk, h + y, inference=True, rules=rules)
            else:
                hn = rms_norm(h, blk["norm"], cfg.norm_eps)
                span = spans.begin("attn.mla", device=True) if spans.on and cfg.kv_lora_rank else -1
                y, new = attn.attn_apply_full(cfg, run, blk["attn"], hn, positions, return_kv=True, rules=rules)
                if span >= 0:
                    spans.end(span)
                attn.attn_fill_cache(cfg, {name: cache[name][j] for name in new}, new)
                h, _ = _ffn(cfg, blk, h + y, inference=True, rules=rules, moe_load=moe_load)
            h = shard_constraint(h, rules, ("batch", "sp", None))
        return _head(cfg, params, gather_sequence(h, rules)[:, -1:], rules), cache


def _write_rows(dst: torch.Tensor, new: torch.Tensor, active: Optional[torch.Tensor]) -> None:
    """dst ← new in place, on the active rows (dim 0) only; the inactive
    rows keep their bits."""
    if active is not None:
        new = torch.where(active.view(-1, *(1,) * (new.dim() - 1)), new, dst)
    dst.copy_(new)


def decode_step(
    cfg: ModelConfig,
    run: RunConfig,
    params: dict,
    cache: dict,
    tokens: torch.Tensor,
    active: Optional[torch.Tensor] = None,
    rules: Optional[ShardingRules] = None,
):
    """One decode step. tokens: (B, 1). Returns (logits (B, 1, V), cache).

    ``cache["pos"]`` is a per-slot (B,) position vector, so rows of the
    batch may sit at different cache positions (continuous batching).
    ``active`` is an optional (B,) bool mask for ragged batches: inactive
    slots neither advance their position nor overwrite their KV slot or
    recurrent state (their logits are garbage the caller ignores). The
    JAX package's ``decode_step`` advances the mLSTM, sLSTM and Mamba
    state of inactive rows too (ROADMAP C5, C8); the port keeps them, so a
    parked session resumes from its own state. Under MoE every row is its own
    dispatch group at S = 1 (capacity one slot per expert), so rows never
    compete for experts. The cache is updated in place and returned.

    With ``rules``, params, tokens and the cache are DTensors (the cache
    laid out by :func:`cache_specs`, ``pos`` replicated): the embedding and
    the head are laid out as the reference's constraints say, each
    attention layer writes its own cache shards and runs K1 over them
    (``models/attention.py::attn_apply_step``), and the recurrent states
    are written back on active rows, shard by shard.
    """
    with sharded_context(rules):
        h = _embed(cfg, params, tokens, rules=rules)
        pos = cache["pos"]
        for blk, (kind, j) in zip(params["layers"], _kind_index(cfg)):
            if kind == "mlstm":
                y, state = ssm.mlstm_apply_step(cfg, blk["mlstm"], cache["mlstm"][j], h, rules)
                _write_rows(cache["mlstm"][j], state, active)
                h = h + y
            elif kind == "slstm":
                layer = {key: t[j] for key, t in cache["slstm"].items()}
                y, state = ssm.slstm_apply_step(cfg, blk["slstm"], layer, h, rules)
                for key, t in state.items():
                    _write_rows(layer[key], t, active)
                h = h + y
            elif kind == "mamba":
                hn = rms_norm(h, blk["norm"], cfg.norm_eps)
                layer = {key: t[j] for key, t in cache["mamba"].items()}
                y, state = ssm.mamba_apply_step(cfg, blk["mamba"], layer, hn, rules)
                for key, t in state.items():
                    _write_rows(layer[key], t, active)
                span = spans.begin("model.ffn") if spans.on else -1
                h, _ = _ffn(cfg, blk, h + y, inference=True, rules=rules)
                if span >= 0:
                    spans.end(span)
            else:
                hn = rms_norm(h, blk["norm"], cfg.norm_eps)
                layer_cache = {name: cache[name][j] for name in attn.attn_cache_axes(cfg)}
                span = spans.begin("model.attn") if spans.on else -1
                h = h + attn.attn_apply_step(cfg, run, blk["attn"], layer_cache, hn, pos, active, rules)
                if span >= 0:
                    span = spans.then(span, "model.ffn")
                h, _ = _ffn(cfg, blk, h, inference=True, rules=rules)
                if span >= 0:
                    spans.end(span)
        span = spans.begin("model.head") if spans.on else -1
        logits = _head(cfg, params, h, rules)
        if span >= 0:
            spans.end(span)
        if active is None:
            pos += 1
        else:
            pos += active.to(pos.dtype)
    return logits, cache


def _block_cache_axes(cfg: ModelConfig, kind: str) -> dict:
    """Logical axes of one layer's cache entries of ``kind``, keyed as the
    port's cache keys them."""
    if kind == "attn":
        return attn.attn_cache_axes(cfg)
    return {kind: getattr(ssm, f"{kind}_cache_axes")()}


def _block_cache_layout(cfg: ModelConfig, kind: str, batch: int, max_len: int) -> dict:
    """``(shape, dtype, fill)`` of one layer's cache entries of ``kind``,
    keyed as :func:`_block_cache_axes`."""
    if kind == "attn":
        return attn.attn_cache_layout(cfg, batch, max_len)
    return {kind: getattr(ssm, f"{kind}_cache_layout")(cfg, batch)}


def _spec_tree(layout, axes, rules):
    """Specs of a stacked cache subtree: each tensor (L, ...) gets a
    replicated layer dim before its per-layer axes."""
    if isinstance(layout, dict):
        return {k: _spec_tree(layout[k], axes[k], rules) for k in layout}
    if rules is None:
        return PartitionSpec()
    return rules.spec((None,) + tuple(axes), (0,) + tuple(layout[0][1:]))


def cache_specs(cfg: ModelConfig, rules: Optional[ShardingRules], batch: int, max_len: int) -> dict:
    """The PartitionSpec tree of :func:`init_cache`'s output. Each tensor
    stacked over the layers of its kind gets the JAX package's spec of
    that kind's per-layer cache (``layers/b{j}/<kind>``)."""
    layout = _cache_layout(cfg, batch, max_len)
    out = {"pos": PartitionSpec()}
    for kind in _kind_counts(cfg):
        axes = _block_cache_axes(cfg, kind)
        out.update(_spec_tree({k: layout[k] for k in axes}, axes, rules))
    return out


def _stacked(layout, n: int):
    """``layout`` with a leading dim of ``n`` layers on every shape."""
    if isinstance(layout, dict):
        return {k: _stacked(e, n) for k, e in layout.items()}
    shape, dtype, fill = layout
    return (n,) + tuple(shape), dtype, fill


def _cache_layout(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """``(shape, dtype, fill)`` of every cache tensor, in the cache's tree:
    each block's layout stacked over the layers of its kind (no tensor is
    made: the dry-run counts every tensor its step makes)."""
    counts = _kind_counts(cfg)
    out = {"pos": ((batch,), torch.long, 0)}
    for kind in ("attn", "mlstm", "slstm", "mamba"):
        if kind in counts:
            out.update(_stacked(_block_cache_layout(cfg, kind, batch, max_len), counts[kind]))
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device, rules: Optional[ShardingRules] = None) -> dict:
    """Zero-filled cache (decode-from-scratch, or a serving arena), with
    the parts the architecture has (the sLSTM stabiliser ``m`` at -1e30);
    ``max_len`` sizes the KV part only. With ``rules``, every tensor is a
    DTensor on ``rules.mesh`` laid out by :func:`cache_specs`, each rank
    making only its own shard."""
    specs = cache_specs(cfg, rules, batch, max_len) if rules is not None else None

    def make(entry, spec):
        shape, dtype, fill = entry
        if rules is not None:
            return placed_full(shape, fill, dtype, device, rules.mesh, spec)
        return torch.full(shape, fill, dtype=dtype, device=device)

    return {key: {k: make(e[k], specs and specs[key][k]) for k in e} if isinstance(e, dict)
            else make(e, specs and specs[key]) for key, e in _cache_layout(cfg, batch, max_len).items()}


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def lm_loss(cfg: ModelConfig, run: RunConfig, logits: torch.Tensor, labels: torch.Tensor,
            mask: Optional[torch.Tensor], aux: dict):
    """Causal-LM cross entropy + z-loss + MoE aux; labels aligned to
    logits. The cross entropy is taken from fp32 logits (logsumexp, gold
    logit gathered). Returns ``(total, metrics)`` with the reference's
    keys: ``loss``, ``ce``, ``z_loss`` and the forward's aux metrics.

    On DTensor logits each rank takes its own (batch, sequence, vocab)
    block (:func:`_sharded_lm_terms`) and no rank gathers the logits."""
    if is_dtensor(logits):
        ce, zl = _sharded_lm_terms(logits, labels, mask, run.z_loss)
    else:
        lf = logits.float()
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
        nll = lse - gold
        if mask is None:
            mask = torch.ones_like(nll)
        denom = torch.clamp(mask.sum(), min=1.0)
        ce = (nll * mask).sum() / denom
        zl = run.z_loss * ((lse**2) * mask).sum() / denom
    total = ce + zl + run.moe_aux_loss * aux.get("moe_aux", 0.0)
    metrics = {"loss": total, "ce": ce, "z_loss": zl, **aux}
    return total, metrics


class _RowLogStats(torch.autograd.Function):
    """(logsumexp, gold logit) in fp32 of each row of this rank's logits
    block ``(..., V_local)``, its columns ``v0``.. of the vocabulary. Where
    the mesh dims ``vocab`` split the vocabulary, the row max, the sum of
    exponentials and the gold logit are reduced over them (the
    vocab-parallel cross entropy). The backward stays on the block:
    ``softmax * d_lse + one_hot * d_gold``, with no fp32 copy of the block
    kept between the passes."""

    @staticmethod
    def forward(ctx, logits, labels, v0: int, mesh, vocab):
        lf = logits.float()
        col = labels - v0
        mine = (col >= 0) & (col < lf.shape[-1])
        col = col.clamp(0, lf.shape[-1] - 1)
        gold = torch.gather(lf, -1, col[..., None])[..., 0]
        if vocab:
            m = partial_reduce(lf.amax(-1), mesh, vocab, "max")
            lse = m + partial_reduce((lf - m[..., None]).exp_().sum(-1), mesh, vocab).log()
            gold = partial_reduce(torch.where(mine, gold, 0.0), mesh, vocab)
        else:
            lse = torch.logsumexp(lf, dim=-1)
        ctx.save_for_backward(logits, col, mine, lse)
        return lse, gold

    @staticmethod
    def backward(ctx, d_lse, d_gold):
        logits, col, mine, lse = ctx.saved_tensors
        grad = logits.to(torch.float32, copy=True).sub_(lse[..., None]).exp_().mul_(d_lse[..., None])
        grad.scatter_add_(-1, col[..., None], torch.where(mine, d_gold, 0.0)[..., None])
        return grad.to(logits.dtype), None, None, None, None


def _sharded_lm_terms(logits, labels, mask, z_loss: float):
    """``(ce, z-loss term)`` of DTensor logits (B, S, V), each a replicated
    scalar DTensor: each rank takes the logsumexp and the gold logit of its
    own block of rows and vocabulary (labels and mask, small, are made whole
    and cut to its rows), the masked sums over its rows, and the sums are
    reduced over the mesh dims that split the rows."""
    logits = settle(logits)
    mesh, pls = logits.device_mesh, logits.placements
    names = tuple(mesh.mesh_dim_names)
    rows = tuple(n for n, pl in zip(names, pls) if pl.is_shard() and pl.dim < 2)
    vocab = tuple(n for n, pl in zip(names, pls) if pl.is_shard(2))
    (b0, nb), (s0, ns), (v0, _) = (local_range(n, mesh, pls, dim) for dim, n in enumerate(logits.shape))
    lab = whole(labels)[b0:b0 + nb, s0:s0 + ns].long()
    msk = None if mask is None else whole(mask)[b0:b0 + nb, s0:s0 + ns]

    def terms(block):
        lse, gold = _RowLogStats.apply(block, lab, v0, mesh, vocab)
        m = torch.ones_like(lse) if msk is None else msk
        sums = partial_reduce(torch.stack([((lse - gold) * m).sum(), ((lse**2) * m).sum(), m.sum()]), mesh, rows)
        denom = torch.clamp(sums[2], min=1.0)
        return sums[0] / denom, z_loss * sums[1] / denom

    # a replicated mesh dim holds the same block on each of its ranks
    return local_map(terms, logits, out=["replicate", "replicate"])
