"""Grouped-query attention with RoPE, qk-norm, sliding window, KV caching.

Port of ``repro/models/attention.py``. Full-sequence implementations
(``RunConfig.attention_impl``):

* ``xla``      — plain softmax(QKᵀ)V; materialises the (Sq, Skv) scores.
* ``chunked``  — flash-style loops over q and kv chunks with a running max
                 and normaliser; never materialises the full score matrix.
* ``pallas``   — the K2 flash-attention kernel (``kernels/ops.py``): the
                 CUDA kernel on the card, its plain version on the CPU.

The decode step writes into a ring-buffer KV cache (capacity = sliding
window when set) and takes a per-slot position vector and an optional
active mask, so one call serves a continuous batch whose rows sit at
different cache positions. ``RunConfig.decode_attention_impl``: ``kernel``
is K1 flash-decode (CUDA on the card, plain on the CPU); ``einsum`` is the
masked-softmax reference path. The JAX package's ``*_interpret`` values
name its Pallas interpreter and are not accepted here.

With ``rules`` (``parallel/sharding.py``) the training path lays q, k, v
and the attention output out by heads over ``model`` where the head count
divides it, at the JAX package's ``shard_constraint`` sites; on plain
tensors, or without rules, those are the identity. The decode step with
rules takes a DTensor cache laid out by ``attn_cache_axes`` (its sequence
over ``model``) and writes each rank's own shard; K1 then runs over the
shards through ``parallel/flash_decode.py`` (the sequence sharded) or
through the wrapper's DTensor path (the sequence whole).
``pad_attention_heads_to``
pads the head count with zero heads (function-preserving) so that it
divides the mesh axis; it only helps sharding, so the port pads with
rules only.

**Multi-head latent attention** (MLA, DeepSeek-V2/V3; ``kv_lora_rank >
0``, the port's own: the JAX package has none) projects each token to a
latent ``c_kv`` of ``kv_lora_rank`` (RMS-normed) and one RoPE key ``k_pe``
of ``qk_rope_head_dim`` shared by the heads; the cache holds only those
two (``{"c_kv", "k_pe"}`` in place of ``k``/``v``). A prefill
(:func:`mla_apply_full`) expands the latent into each head's no-RoPE key
and value (``wkv_b``) and runs the full-sequence attention on q and k of
``qk_nope + qk_rope`` and v of ``v_head_dim``, all zero-padded to the
nearest width K2 takes (256 at Moonlight's 192 and 128) and the output cut
back; the scale stays that of the unpadded q·k. A decode step
(:func:`mla_apply_step`) absorbs instead: each head's no-RoPE query is
folded through ``wkv_b``'s key half onto the latent, the scores are taken
over the cached latent and RoPE keys
(``kernels/ops.py::latent_decode_attention``), and the weighted latent goes
through ``wkv_b``'s value half and ``wo``. No sharded path: with ``rules``
it raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.kernels import ops
from repro_torch.models.common import ParamDef, apply_rope, causal_mask, norm_def, nrm, rms_norm
from repro_torch.parallel.flash_decode import sharded_decode_attention
from repro_torch.parallel.sharding import (
    ShardingRules,
    from_local,
    gather_sequence,
    is_dtensor,
    local_map,
    local_range,
    pin,
    shard_constraint,
    whole,
)

NEG_INF = -1e30
_REPLICATE = Replicate()


def attn_defs(cfg: ModelConfig) -> dict:
    if cfg.kv_lora_rank:
        return mla_defs(cfg)
    hd = cfg.head_dim_
    defs = {
        "wq": ParamDef((cfg.d_model, cfg.num_heads, hd), ("fsdp", "tp", None), nrm()),
        "wk": ParamDef((cfg.d_model, cfg.num_kv_heads, hd), ("fsdp", "tp", None), nrm()),
        "wv": ParamDef((cfg.d_model, cfg.num_kv_heads, hd), ("fsdp", "tp", None), nrm()),
        "wo": ParamDef((cfg.num_heads, hd, cfg.d_model), ("tp", None, "fsdp"), nrm(fan_in_axis=2)),
    }
    if cfg.qk_norm:
        defs["q_norm"] = norm_def(hd)
        defs["k_norm"] = norm_def(hd)
    return defs


# ---------------------------------------------------------------------------
# Core attention math
# ---------------------------------------------------------------------------


def _split_gqa(q: torch.Tensor, num_kv: int) -> torch.Tensor:
    """(B, S, H, D) -> (B, S, KH, G, D)."""
    b, s, h, d = q.shape
    return q.reshape(b, s, num_kv, h // num_kv, d)


def _xla_attention(q, k, v, *, q_offset, window, scale):
    """Reference/naive path. q: (B,Sq,H,D); k,v: (B,Skv,KH,D)."""
    kh = k.shape[2]
    qg = _split_gqa(q, kh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    mask = causal_mask(q.shape[1], k.shape[1], q_offset, window, q.device)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(q.shape)


def _chunked_attention(q, k, v, *, q_offset, window, scale, q_chunk, kv_chunk):
    """Flash-style attention: loop q blocks × kv blocks, O(chunk²) memory."""
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    qc = min(q_chunk, sq)
    kc = min(kv_chunk, skv)
    dev = q.device
    outs = []
    for q0 in range(0, sq, qc):
        qi = _split_gqa(q[:, q0:q0 + qc], kh).float()  # (B,qc',KH,G,D)
        qp = torch.arange(q0, q0 + qi.shape[1], device=dev) + q_offset
        m = torch.full((b, kh, g, qi.shape[1]), NEG_INF, device=dev)
        l = torch.zeros((b, kh, g, qi.shape[1]), device=dev)
        acc = torch.zeros((b, kh, g, qi.shape[1], d), device=dev)
        for k0 in range(0, skv, kc):
            ki, vi = k[:, k0:k0 + kc].float(), v[:, k0:k0 + kc].float()
            kp = torch.arange(k0, k0 + ki.shape[1], device=dev)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qi, ki) * scale
            mask = kp[None, :] <= qp[:, None]
            if window:
                mask &= kp[None, :] > qp[:, None] - window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vi)
            m = m_new
        out = acc / l[..., None].clamp_min(1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, qi.shape[1], h, d))
    return torch.cat(outs, dim=1).to(q.dtype)


def _padded_heads(h: int, kh: int, multiple: int) -> tuple[int, int]:
    """(q heads, kv heads) after :func:`_pad_heads` pads ``h`` q heads over
    ``kh`` kv heads to a multiple of ``multiple``."""
    if h % multiple == 0:
        return h, kh
    if h == kh:  # MHA: q and kv heads padded together
        n = -(-h // multiple) * multiple
        return n, n
    g_pad = h // kh  # GQA: grow the per-kv group count until flat heads divide the axis
    while (kh * g_pad) % multiple:
        g_pad += 1
    return kh * g_pad, kh


def _pad_heads(q, k, v, multiple: int):
    """Pad head counts to a multiple (zero fake heads) so indivisible head
    counts still shard over the model axis. Function-preserving: padded q
    heads attend to zero-k/v fake kv heads (MHA) or ride as extra GQA
    groups; the caller slices their outputs away. Returns (q', k', v')."""
    b, sq, h, d = q.shape
    kh = k.shape[2]
    h_pad, kh_pad = _padded_heads(h, kh, multiple)
    if h_pad == h:
        return q, k, v
    if kh_pad != kh:  # MHA
        pad = (0, 0, 0, h_pad - h)
        return F.pad(q, pad), F.pad(k, pad), F.pad(v, pad)
    g = h // kh
    qg = F.pad(q.reshape(b, sq, kh, g, d), (0, 0, 0, h_pad // kh - g))
    return qg.reshape(b, sq, h_pad, d), k, v


def _unpad_heads(out, h_orig, kh_orig):
    b, sq, h_pad, d = out.shape
    if h_pad == h_orig:
        return out
    g = h_orig // kh_orig
    if g == 1:  # MHA path: flat head slice
        return out[:, :, :h_orig]
    g_pad = h_pad // kh_orig
    return out.reshape(b, sq, kh_orig, g_pad, d)[:, :, :, :g].reshape(b, sq, h_orig, d)


def _whole_heads(fn, shapes, rules, *ts):
    """``fn`` over the head dim of DTensors ``ts`` (B, S, H, D): the heads
    made whole first, ``fn`` run on each rank's own rows (``local_map``),
    its results of global ``shapes`` laid out as the inputs. DTensor
    lowers neither the split of the head dim into (KV heads, groups), which
    would cut a head-sharded dim, nor the pad of that 5-D view, which
    PyTorch 2.11's DTensor fails to redistribute. Plain tensors go to
    ``fn`` as they are."""
    if not is_dtensor(ts[0]):
        return fn(*ts)
    ts = [shard_constraint(t, rules, ("batch", None, None, None)) for t in ts]
    return local_map(fn, *ts, out=[(ts[0].placements, shape) for shape in shapes])


def multihead_attention(run: RunConfig, q, k, v, *, q_offset=0, window=0, rules: Optional[ShardingRules] = None):
    """Dispatch on the configured implementation. Shapes as in _xla_attention."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    kh_orig, h_orig = k.shape[2], q.shape[2]
    pad = bool(rules is not None and run.pad_attention_heads_to)
    if pad:
        h_pad, kh_pad = _padded_heads(h_orig, kh_orig, run.pad_attention_heads_to)
        if h_pad != h_orig:
            shapes = [(*q.shape[:2], h_pad, q.shape[3]), *((*t.shape[:2], kh_pad, t.shape[3]) for t in (k, v))]
            q, k, v = _whole_heads(lambda *ts: _pad_heads(*ts, run.pad_attention_heads_to), shapes, rules, q, k, v)
        # the padded head dim now divides the model axis: constrain again
        q = shard_constraint(q, rules, ("batch", None, "tp", None))
        k = shard_constraint(k, rules, ("batch", None, "tp", None))
        v = shard_constraint(v, rules, ("batch", None, "tp", None))
    impl = run.attention_impl
    if impl == "xla":
        out = _xla_attention(q, k, v, q_offset=q_offset, window=window, scale=scale)
    elif impl == "chunked":
        out = _chunked_attention(
            q, k, v, q_offset=q_offset, window=window, scale=scale,
            q_chunk=run.attention_chunk, kv_chunk=run.attention_chunk,
        )
    elif impl == "pallas":
        out = ops.flash_attention(q, k, v, q_offset=q_offset, window=window, softmax_scale=scale)
    else:
        raise ValueError(f"unknown attention_impl {impl!r} (the port has xla, chunked, pallas)")
    if pad and out.shape[2] != h_orig:
        out = _whole_heads(lambda o: _unpad_heads(o, h_orig, kh_orig), [(*out.shape[:2], h_orig, out.shape[3])],
                           rules, out)
    return out


# ---------------------------------------------------------------------------
# Block-level apply (projections + rope + attention [+ cache])
# ---------------------------------------------------------------------------


def _heads(cfg: ModelConfig, rules, t, n_heads: int):
    """The projection ``t`` (B, S, n_heads * hd) as (B, S, n_heads, hd).
    With rules, the flat dim is first laid out by whole heads over
    ``model`` (or replicated where n_heads does not divide it), so that no
    head is cut between ranks."""
    if rules is not None:
        t = shard_constraint(t, rules, ("batch", None, "tp" if n_heads % rules.tp_size == 0 else None))
    return t.view(*t.shape[:2], n_heads, cfg.head_dim_)


def _project_qkv(cfg: ModelConfig, params, x, positions, rules: Optional[ShardingRules] = None):
    dt = getattr(torch, cfg.compute_dtype)
    x = gather_sequence(x, rules)
    # einsum "bsd,dhk->bshk" as one matmul on the flattened head axis
    q = _heads(cfg, rules, x @ pin(params["wq"].to(dt).flatten(1)), cfg.num_heads)
    k = _heads(cfg, rules, x @ pin(params["wk"].to(dt).flatten(1)), cfg.num_kv_heads)
    v = _heads(cfg, rules, x @ pin(params["wv"].to(dt).flatten(1)), cfg.num_kv_heads)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = shard_constraint(q, rules, ("batch", None, "tp", None))
    k = shard_constraint(k, rules, ("batch", None, "tp", None))
    v = shard_constraint(v, rules, ("batch", None, "tp", None))
    return q, k, v


def _out_proj(cfg: ModelConfig, params, out):
    """einsum "bshk,hkd->bsd"."""
    dt = getattr(torch, cfg.compute_dtype)
    return out.flatten(2) @ pin(params["wo"].to(dt).flatten(0, 1))


def attn_apply_full(cfg: ModelConfig, run: RunConfig, params: dict, x, positions, return_kv: bool = False,
                    rules: Optional[ShardingRules] = None):
    """Training / prefill attention over the full sequence.

    x: (B, S, D) post-norm residual input; positions: (S,) or (B, S).
    With ``return_kv`` also the cache's entries of these positions,
    ``{"k", "v"}`` (``{"c_kv", "k_pe"}`` under MLA), for
    :func:`attn_fill_cache`.
    """
    if cfg.kv_lora_rank:
        return mla_apply_full(cfg, run, params, x, positions, return_kv, rules)
    q, k, v = _project_qkv(cfg, params, x, positions, rules)
    out = multihead_attention(run, q, k, v, q_offset=0, window=cfg.sliding_window, rules=rules)
    out = shard_constraint(out, rules, ("batch", None, "tp", None))
    y = _out_proj(cfg, params, out)
    if return_kv:
        return y, {"k": k, "v": v}
    return y


def cache_capacity(cfg: ModelConfig, max_len: int) -> int:
    return min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len


def attn_cache_layout(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """``(shape, dtype, fill)`` of one layer's ``k`` and ``v``: (B, cap, KH,
    hd) in the compute dtype, zero. Under MLA its ``c_kv`` (B, cap,
    kv_lora_rank) and ``k_pe`` (B, cap, qk_rope_head_dim)."""
    dt, cap = getattr(torch, cfg.compute_dtype), cache_capacity(cfg, max_len)
    if cfg.kv_lora_rank:
        return {"c_kv": ((batch, cap, cfg.kv_lora_rank), dt, 0), "k_pe": ((batch, cap, cfg.qk_rope_head_dim), dt, 0)}
    entry = ((batch, cap, cfg.num_kv_heads, cfg.head_dim_), dt, 0)
    return {"k": entry, "v": entry}


def attn_cache_axes(cfg: ModelConfig) -> dict:
    """Logical axes of one layer's ``k`` and ``v`` (B, cap, KH, hd): the
    cache sequence shards over ``model`` (sequence-sharded flash-decode,
    ``parallel/flash_decode.py``). Under MLA those of ``c_kv`` and
    ``k_pe``."""
    if cfg.kv_lora_rank:
        return {"c_kv": ("batch", "kv_seq", None), "k_pe": ("batch", "kv_seq", None)}
    return {
        "k": ("batch", "kv_seq", None, None),
        "v": ("batch", "kv_seq", None, None),
    }


def _ring_positions(s: int, cap: int, start: int, length: int):
    """For cache slots ``start .. start + length`` after a prefill of ``s``
    positions into a ring of ``cap``: the position each slot holds (the
    latest ``p < s`` with ``p % cap == slot``), or None where ``s < cap``."""
    if s < cap:
        return None
    slots = torch.arange(start, start + length)
    return (s - cap) + (slots - (s - cap)) % cap


def _local_rows_slots(t) -> tuple[int, int, int, int]:
    """(b0, nb, s0, ns): the batch rows and cache slots of a (B, cap, ...)
    tensor that this rank holds; the whole of a plain tensor."""
    if not is_dtensor(t):
        return 0, t.shape[0], 0, t.shape[1]
    mesh, pls = t.device_mesh, t.placements
    return (*local_range(t.shape[0], mesh, pls, 0), *local_range(t.shape[1], mesh, pls, 1))


def _local_rows(dst, t):
    """``t``'s rows as ``dst`` holds them: for a DTensor ``dst``, ``t`` laid
    out by ``dst``'s batch sharding with the rest whole, as a plain
    tensor; else ``t`` itself."""
    if not is_dtensor(dst):
        return t
    pls = [pl if pl.is_shard(0) else _REPLICATE for pl in dst.placements]
    return t.redistribute(dst.device_mesh, pls).to_local()


def attn_fill_cache(cfg: ModelConfig, cache: dict, new: dict) -> dict:
    """Write a prefill's cache entries ``new`` (each (B, S, ...): ``k`` and
    ``v``, or MLA's ``c_kv`` and ``k_pe``) into the fresh layer cache of the
    same keys, in place (ring-aware).

    A DTensor cache (laid out by ``attn_cache_axes``) is written shard by
    shard: each rank gathers the heads of its batch rows and copies the
    positions its sequence shard holds."""
    for name, t in new.items():
        dst = cache[name]
        cap, s = dst.shape[1], t.shape[1]
        rows = _local_rows(dst, t)
        local = dst.to_local() if is_dtensor(dst) else dst
        _, _, start, length = _local_rows_slots(dst)
        ring = _ring_positions(s, cap, start, length)
        if ring is not None:  # the trailing window: position p in slot p % cap
            local.copy_(rows[:, ring.to(rows.device)])
        elif start < s:
            n = min(s, start + length) - start
            local[:, :n].copy_(rows[:, start:start + n])
    return cache


def _write_step(dst, new, slot, active) -> None:
    """The decode step's write of ``new`` (B, KH, D) into the cache ``dst``
    (B, cap, KH, D) at each row's ``slot``, in place. Each rank writes, on
    its own batch rows, only where its sequence shard holds the row's slot
    (and the row is active); elsewhere it writes the slot's old value back,
    as the reference's elementwise select keeps every shard local. ``slot``
    and ``active`` are whole plain tensors; a plain ``dst`` is one shard."""
    b0, nb, s0, ns = _local_rows_slots(dst)
    new = _local_rows(dst, new)
    local = dst.to_local() if is_dtensor(dst) else dst
    at = slot[b0:b0 + nb] - s0
    own = (at >= 0) & (at < ns)
    if active is not None:
        own &= active[b0:b0 + nb]
    at = at.clamp(0, ns - 1)
    rows = torch.arange(nb, device=local.device)
    own = own.view(-1, *(1,) * (new.dim() - 1))
    local[rows, at] = torch.where(own, new.to(local.dtype), local[rows, at])


def _valid_mask(cfg: ModelConfig, like, slot, pos, active):
    """The (B, cap) valid mask of :func:`attn_apply_step`: per row, slots
    ``<= slot`` filled (full cache: monotone; ring: all once wrapped), none
    for a parked row. For a DTensor cache ``like`` it is a DTensor laid out
    as ``like``'s batch and sequence, each rank building only its piece."""
    b, cap = like.shape[:2]
    b0, nb, s0, ns = _local_rows_slots(like)
    idx = torch.arange(s0, s0 + ns, device=slot.device)
    valid = idx[None, :] <= slot[b0:b0 + nb, None]
    if cfg.sliding_window:
        valid |= pos[b0:b0 + nb, None] >= cap
    if active is not None:
        valid &= active[b0:b0 + nb, None]
    if not is_dtensor(like):
        return valid
    pls = [pl if pl.is_shard(0) or pl.is_shard(1) else _REPLICATE for pl in like.placements]
    return from_local(valid, like.device_mesh, pls, (b, cap))


def attn_apply_step(
    cfg: ModelConfig,
    run: RunConfig,
    params: dict,
    cache: dict,
    x,
    pos,
    active: Optional[torch.Tensor] = None,
    rules: Optional[ShardingRules] = None,
):
    """Single-token decode. x: (B, 1, D); pos: (B,) tokens so far *per
    slot*; active: optional (B,) bool. Writes the new K/V into ``cache`` in
    place and returns the attention block's output (B, 1, D).

    The JAX package writes with an elementwise select over the whole cache
    (``iota == slot``) and hands parked rows ``pos = -1``, which under a
    sliding window lands on the last ring slot (ROADMAP C4). Here the
    active rows are written in place at their slot; a parked row writes its
    slot's old value back, so it neither writes nor, having no valid key,
    attends.

    With ``rules`` and a DTensor cache, the step's k and v are laid out
    ``("batch", None, None, None)`` as the reference's constraint sites
    lay them, each rank writes its own shard (:func:`_write_step`), and
    the valid mask takes the cache's layout. K1 then runs over the
    sequence shards (``sharded_decode_attention``: K1's partials on each
    shard, three all-reduces) where the cache's sequence is sharded, or
    through ``ops.decode_attention``'s DTensor path where it is whole. The
    einsum path over a sharded sequence takes the jnp partials, which keep
    the reference's uniform spread over an all-invalid row (C3).
    """
    if cfg.kv_lora_rank:
        return mla_apply_step(cfg, params, cache, x, pos, active, rules)
    dt = getattr(torch, cfg.compute_dtype)
    cache_k, cache_v = cache["k"], cache["v"]
    sharded = rules is not None and is_dtensor(cache_k)
    q, k, v = _project_qkv(cfg, params, x, pos[:, None], rules)

    cap = cache_k.shape[1]
    act = active
    if sharded:
        pos = whole(pos)
        act = None if active is None else whole(active)
        k = shard_constraint(k, rules, ("batch", None, None, None))
        v = shard_constraint(v, rules, ("batch", None, None, None))
    slot = pos % cap if cfg.sliding_window else pos.clamp_max(cap - 1)
    _write_step(cache_k, k[:, 0], slot, act)
    _write_step(cache_v, v[:, 0], slot, act)
    valid = _valid_mask(cfg, cache_k, slot, pos, act)
    seq_axes = [name for name, pl in zip(cache_k.device_mesh.mesh_dim_names, cache_k.placements)
                if pl.is_shard(1)] if sharded else []

    scale = 1.0 / cfg.head_dim_**0.5
    impl = run.decode_attention_impl
    if impl not in ("kernel", "einsum"):
        raise ValueError(f"unknown decode_attention_impl {impl!r} (the port has einsum, kernel)")
    if seq_axes:
        mesh = cache_k.device_mesh
        batch_axes = tuple(name for name, pl in zip(mesh.mesh_dim_names, cache_k.placements) if pl.is_shard(0))
        out = sharded_decode_attention(q[:, 0], cache_k, cache_v, valid, mesh, axis=seq_axes[0],
                                       batch_axes=batch_axes, use_kernel=impl == "kernel")
        out = out[:, None].to(dt)
    elif impl == "kernel":
        out = ops.decode_attention(q[:, 0], cache_k, cache_v, valid, softmax_scale=scale)
        out = out[:, None].to(dt)  # (B, H, D) -> (B, 1, H, D)
    else:
        if sharded:  # the heads whole: the GQA split below cuts the head dim
            q = shard_constraint(q, rules, ("batch", None, None, None))
        qg = _split_gqa(q, cfg.num_kv_heads)  # (B,1,KH,G,D)
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), cache_k.float()) * scale
        scores = torch.where(valid[:, None, None, None, :], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhgqk,bkhd->bqhgd", probs, cache_v.float())
        out = out.reshape(q.shape).to(dt)
    return _out_proj(cfg, params, out)


# ---------------------------------------------------------------------------
# Multi-head latent attention (MLA)
# ---------------------------------------------------------------------------


def mla_defs(cfg: ModelConfig) -> dict:
    """MLA's weights: ``wq`` (D, H, nope + rope), ``wkv_a`` (D, R + rope):
    the latent and the shared RoPE key, ``kv_norm`` (R,), ``wkv_b`` (R, H,
    nope + v): each head's no-RoPE key then its value, ``wo`` (H, v, D)."""
    h, r = cfg.num_heads, cfg.kv_lora_rank
    nope, rope, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "wq": ParamDef((cfg.d_model, h, nope + rope), ("fsdp", "tp", None), nrm()),
        "wkv_a": ParamDef((cfg.d_model, r + rope), ("fsdp", None), nrm()),
        "kv_norm": norm_def(r),
        "wkv_b": ParamDef((r, h, nope + vd), (None, "tp", None), nrm()),
        "wo": ParamDef((h, vd, cfg.d_model), ("tp", None, "fsdp"), nrm(fan_in_axis=2)),
    }


def _mla_project(cfg: ModelConfig, params, x, positions):
    """x (B, S, D) → q_nope (B, S, H, nope), q_pe (B, S, H, rope) rotated,
    c_kv (B, S, R) normed, k_pe (B, S, rope) rotated."""
    dt = getattr(torch, cfg.compute_dtype)
    b, s, _ = x.shape
    nope, r = cfg.qk_nope_head_dim, cfg.kv_lora_rank
    q = (x @ params["wq"].to(dt).flatten(1)).view(b, s, cfg.num_heads, -1)
    q_pe = apply_rope(q[..., nope:], positions, cfg.rope_theta)
    kv = x @ params["wkv_a"].to(dt)
    c_kv = rms_norm(kv[..., :r], params["kv_norm"], cfg.norm_eps)
    k_pe = apply_rope(kv[..., None, r:], positions, cfg.rope_theta)[..., 0, :]
    return q[..., :nope], q_pe, c_kv, k_pe


def _mla_out(cfg: ModelConfig, params, out):
    """The heads' values (B, S, H, v) through ``wo``."""
    dt = getattr(torch, cfg.compute_dtype)
    return out.flatten(2) @ params["wo"].to(dt).flatten(0, 1)


K2_WIDTHS = (64, 128, 256)  # the head widths K2 is built for


def mla_apply_full(cfg: ModelConfig, run: RunConfig, params: dict, x, positions, return_kv: bool = False,
                   rules: Optional[ShardingRules] = None):
    """MLA over the full sequence, not absorbed: every head's key and value
    expanded from the latent. Returns y (B, S, D), and with ``return_kv``
    the cache's ``{"c_kv", "k_pe"}`` of these positions."""
    if rules is not None:
        raise NotImplementedError("multi-head latent attention has no sharded path")
    dt = getattr(torch, cfg.compute_dtype)
    b, s, _ = x.shape
    h, nope, vd = cfg.num_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    q_nope, q_pe, c_kv, k_pe = _mla_project(cfg, params, x, positions)
    kv = (c_kv @ params["wkv_b"].to(dt).flatten(1)).view(b, s, h, nope + vd)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([kv[..., :nope], k_pe[:, :, None].expand(b, s, h, -1)], dim=-1)
    # q, k and v zero-padded to one width K2 takes: the pad adds nothing to
    # q·k and gives output columns that are cut off
    qk = q.shape[-1]
    width = next(w for w in K2_WIDTHS if w >= max(qk, vd))
    q, k, v = (F.pad(t, (0, width - t.shape[-1])) for t in (q, k, kv[..., nope:]))
    scale = qk ** -0.5
    impl = run.attention_impl
    if impl == "pallas":
        out = ops.flash_attention(q, k, v, softmax_scale=scale)
    elif impl == "xla":
        out = _xla_attention(q, k, v, q_offset=0, window=0, scale=scale)
    elif impl == "chunked":
        out = _chunked_attention(q, k, v, q_offset=0, window=0, scale=scale, q_chunk=run.attention_chunk,
                                 kv_chunk=run.attention_chunk)
    else:
        raise ValueError(f"unknown attention_impl {impl!r} (the port has xla, chunked, pallas)")
    y = _mla_out(cfg, params, out[..., :vd])
    if return_kv:
        return y, {"c_kv": c_kv, "k_pe": k_pe}
    return y


def mla_apply_step(cfg: ModelConfig, params: dict, cache: dict, x, pos, active: Optional[torch.Tensor] = None,
                   rules: Optional[ShardingRules] = None):
    """One decode token of MLA, absorbed. x (B, 1, D); pos (B,); ``cache``
    the layer's ``{"c_kv" (B, cap, R), "k_pe" (B, cap, rope)}``, written in
    place at each active row's slot (a parked row writes its slot's old
    value back and attends to no key). Returns (B, 1, D)."""
    if rules is not None:
        raise NotImplementedError("multi-head latent attention has no sharded path")
    dt = getattr(torch, cfg.compute_dtype)
    nope = cfg.qk_nope_head_dim
    q_nope, q_pe, c_kv, k_pe = _mla_project(cfg, params, x, pos[:, None])
    cap = cache["c_kv"].shape[1]
    slot = pos.clamp_max(cap - 1)
    _write_step(cache["c_kv"], c_kv[:, 0], slot, active)
    _write_step(cache["k_pe"], k_pe[:, 0], slot, active)
    valid = _valid_mask(cfg, cache["c_kv"], slot, pos, active)
    wkv_b = params["wkv_b"].to(dt)  # (R, H, nope + v)
    # each head's query folded onto the latent: q_nope · W_k^T, (H, B, R)
    q_lat = torch.bmm(q_nope[:, 0].transpose(0, 1), wkv_b[..., :nope].permute(1, 2, 0)).transpose(0, 1)
    lat = ops.latent_decode_attention(q_lat, q_pe[:, 0], cache["c_kv"], cache["k_pe"], valid,
                                      softmax_scale=(nope + cfg.qk_rope_head_dim) ** -0.5)
    # the weighted latent through each head's value projection: (H, B, v)
    out = torch.bmm(lat.to(dt).transpose(0, 1), wkv_b[..., nope:].transpose(0, 1)).transpose(0, 1)
    return _mla_out(cfg, params, out[:, None])
