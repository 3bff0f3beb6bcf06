"""State-space and recurrent blocks: Mamba-2 (SSD), mLSTM, sLSTM.

Port of ``repro/models/ssm.py``. ``chunked_ssd`` is the shared chunked
scalar-decay linear recurrence; here it is a call to
``kernels/ops.py::ssm_scan`` (K3: the CUDA kernel on the card, its plain
version on the CPU). The Mamba-2 block feeds it per-head values, a decay
from ``dt`` and the B and C maps that every head shares; its decode step is
``ssd_step`` in plain PyTorch, as the JAX package computes it outside
Pallas. mLSTM folds the exponential input gate into ``b`` and appends a
ones column to the values, so the normaliser ``n`` rides along in the
state. sLSTM is sequential (scalar memory, exponential gating, a
stabiliser) and runs as a Python loop over time.

Decode-step functions take the layer's recurrent state and return the new
one; ``models/model.py::decode_step`` writes it back into the cache in
place, for active rows only.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import (
    ParamDef,
    const_init,
    norm_def,
    nrm,
    ones_init,
    rms_norm,
    uniform_init,
    zeros_init,
)
from repro_torch.parallel.sharding import (
    ShardingRules,
    elementwise,
    from_local,
    is_dtensor,
    gather_sequence,
    pin,
    settle,
    shard_constraint,
    split_heads,
)

DEFAULT_CHUNK = 256
MAMBA_HEAD_DIM = 128
M_INIT = -1e30  # sLSTM stabiliser state before the first step


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


# ---------------------------------------------------------------------------
# The shared chunked scalar-decay linear-recurrence primitive (SSD)
# ---------------------------------------------------------------------------


def chunked_ssd(x, loga, b, c, chunk: int = DEFAULT_CHUNK):
    """h_t = a_t·h_{t-1} + b_t ⊗ x_t ;  y_t = c_t · h_t, from h = 0.

    x (B, S, H, P), loga (B, S, H), b/c (B, S, H, N). Returns
    ``(y (B, S, H, P) in x's dtype, h_final (B, H, N, P) fp32)``.
    """
    return ops.ssm_scan(x, loga.float(), b, c, chunk)


def ssd_step(h, x_t, loga_t, b_t, c_t):
    """Single decode step. h: (B, H, N, P) fp32; x_t: (B, H, P); loga_t
    (B, H); b_t, c_t (B, H, N). Returns ``(y (B, H, P) in x_t's dtype, new h)``.

    On DTensors the step runs on each rank's rows and heads (every input
    laid out as the state's batch and heads): it is independent per
    (row, head), and DTensor cannot fold a head-sharded (B, H) into the
    product's batch (PyTorch 2.11)."""
    if is_dtensor(h):
        from torch.distributed.tensor import Replicate

        mesh = h.device_mesh
        pls = [pl if pl.is_shard(0) or pl.is_shard(1) else Replicate() for pl in h.placements]
        ins = [t.redistribute(mesh, pls) for t in (h, x_t, loga_t, b_t, c_t)]
        y, new = ssd_step(*(t.to_local() for t in ins))
        return from_local(y, mesh, pls, x_t.shape), from_local(new, mesh, pls, h.shape)
    a = torch.exp(loga_t.float())
    h = a[..., None, None] * h + b_t.float()[..., :, None] * x_t.float()[..., None, :]
    y = (c_t.float()[..., None, :] @ h)[..., 0, :]
    return y.to(x_t.dtype), h


# ---------------------------------------------------------------------------
# Mamba-2 block
# ---------------------------------------------------------------------------


def mamba_heads(cfg: ModelConfig) -> int:
    return max(1, cfg.d_inner // MAMBA_HEAD_DIM)


def mamba_defs(cfg: ModelConfig) -> dict:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.d_state
    h = mamba_heads(cfg)
    w = cfg.conv_width
    return {
        "wz": ParamDef((d, di), ("fsdp", "tp"), nrm()),
        "wx": ParamDef((d, di), ("fsdp", "tp"), nrm()),
        "wb": ParamDef((d, n), ("fsdp", None), nrm()),
        "wc": ParamDef((d, n), ("fsdp", None), nrm()),
        "wdt": ParamDef((d, h), ("fsdp", "tp"), nrm()),
        "dt_bias": ParamDef((h,), ("tp",), uniform_init(-4.0, -1.0)),
        "a_log": ParamDef((h,), ("tp",), uniform_init(0.0, 1.3)),  # A in [1, e^1.3]
        "d_skip": ParamDef((h,), ("tp",), ones_init),
        "conv_x": ParamDef((w, di), (None, "tp"), nrm(fan_in_axis=0)),
        "conv_b": ParamDef((w, n), (None, None), nrm(fan_in_axis=0)),
        "conv_c": ParamDef((w, n), (None, None), nrm(fan_in_axis=0)),
        "gate_norm": norm_def(di),
        "wo": ParamDef((di, d), ("tp", "fsdp"), nrm()),
    }


def _causal_conv(x, kernel, state=None):
    """Depthwise causal conv. x: (B, S, C); kernel: (W, C); state: the last
    W - 1 inputs before x, (B, W - 1, C), zeros when None. Returns ``(out,
    new state)``: the new state is the last W - 1 raw inputs, zero padding
    included for S < W - 1.

    The taps are summed as the reference sums them, left to right in x's
    dtype, each product rounded to it first (``F.conv1d`` would accumulate
    in fp32 and round once)."""
    w, s = kernel.shape[0], x.shape[1]
    if state is None:
        pad = torch.zeros((x.shape[0], w - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = xp[:, :s] * kernel[0]
    for i in range(1, w):
        out = out + xp[:, i:i + s] * kernel[i]
    return out, xp[:, s:]


def _mamba_project(cfg, params, x, conv_state=None):
    """The input projections and the causal convs, shared by the full pass
    and the step. Returns ``(z, xin, bmat, cmat, dt, loga, conv state)``:
    xin, bmat, cmat after the conv and SiLU in the compute dtype; ``dt =
    softplus(x W_dt + dt_bias)`` and the per-head log decay ``loga = dt ·
    (-exp(a_log))`` in fp32."""
    dt_ = _dtype(cfg)
    z = x @ params["wz"].to(dt_)
    state = {}
    conv = []
    for name, w in (("conv_x", "wx"), ("conv_b", "wb"), ("conv_c", "wc")):
        out, state[name] = _causal_conv(x @ params[w].to(dt_), params[name].to(dt_),
                                        None if conv_state is None else conv_state[name])
        conv.append(F.silu(out))
    dt_raw = x @ params["wdt"].to(dt_)
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())
    loga = dt * -torch.exp(params["a_log"].float())  # (B, S, H), <= 0
    return (z, *conv, dt, loga, state)


def _mamba_out(cfg, params, y, xh, z):
    """y + D·x per head, the gated RMSNorm, and the output projection; y
    and xh (B, S, H, P), z (B, S, d_inner)."""
    dt_ = _dtype(cfg)
    y = y + params["d_skip"].to(dt_)[:, None] * xh
    y = y.flatten(-2)
    y = rms_norm(y, params["gate_norm"], cfg.norm_eps) * F.silu(z)
    return y @ params["wo"].to(dt_)


def mamba_apply_full(cfg: ModelConfig, params, x, chunk=DEFAULT_CHUNK, return_state=False,
                     rules: Optional[ShardingRules] = None):
    """x: (B, S, D). With ``return_state`` also the decode cache the prompt
    leaves: ``{"conv_x", "conv_b", "conv_c"}`` (the last W - 1 raw inputs
    of each conv) and ``"ssm"``, the final state (B, H, N, P) fp32."""
    dt_ = _dtype(cfg)
    B, S, _ = x.shape
    H, P, N = mamba_heads(cfg), MAMBA_HEAD_DIM, cfg.d_state
    z, xin, bmat, cmat, dt, loga, state = _mamba_project(cfg, params, gather_sequence(x, rules))
    xh = shard_constraint(xin.view(B, S, H, P), rules, ("batch", None, "tp", None))
    bh = bmat[:, :, None, :] * dt[..., None]  # (B, S, H, N) fp32, rounded below as the reference rounds it
    ch = cmat[:, :, None, :].expand(B, S, H, N)
    y, state["ssm"] = chunked_ssd(xh, loga, bh.to(dt_), ch, chunk=chunk)
    out = _mamba_out(cfg, params, y, xh, z)
    return (out, state) if return_state else out


def mamba_cache_layout(cfg: ModelConfig, batch: int) -> dict:
    """``(shape, dtype, fill)`` of one layer's Mamba state: ``conv_x`` (B,
    W - 1, d_inner), ``conv_b``, ``conv_c`` (B, W - 1, N) in the compute
    dtype and ``ssm`` (B, H, N, P) fp32, all zero."""
    H, P, N = mamba_heads(cfg), MAMBA_HEAD_DIM, cfg.d_state
    lead, dt_ = (batch, cfg.conv_width - 1), _dtype(cfg)
    return {"conv_x": (lead + (cfg.d_inner,), dt_, 0), "conv_b": (lead + (N,), dt_, 0),
            "conv_c": (lead + (N,), dt_, 0), "ssm": ((batch, H, N, P), torch.float32, 0)}


def mamba_cache_axes() -> dict:
    """Logical axes of one layer's Mamba state, as
    :func:`mamba_cache_layout` lists it."""
    return {
        "conv_x": ("batch", None, "tp"),
        "conv_b": ("batch", None, None),
        "conv_c": ("batch", None, None),
        "ssm": ("batch", "tp", None, None),
    }


def mamba_apply_step(cfg: ModelConfig, params, state: dict, x, rules: Optional[ShardingRules] = None):
    """x: (B, 1, D); state as :func:`mamba_cache_axes` lists it. Returns (out, new
    state). ``rules`` as the reference's: nothing is constrained inside;
    the state may be DTensors laid out by :func:`mamba_cache_axes`."""
    B = x.shape[0]
    H, P, N = mamba_heads(cfg), MAMBA_HEAD_DIM, cfg.d_state
    z, xin, bmat, cmat, dt, loga, new = _mamba_project(cfg, params, x, state)
    xh = xin.view(B, H, P)
    bh = bmat[:, 0, None, :] * dt[:, 0, :, None]  # (B, H, N) fp32
    ch = cmat[:, 0, None, :].expand(B, H, N)
    y, new["ssm"] = ssd_step(state["ssm"], xh, loga[:, 0], bh, ch)
    return _mamba_out(cfg, params, y[:, None], xh[:, None], z), new


def _project_out(cfg, params, x, h):
    """The xLSTM projection sub-block after the mixer's inner residual ``h``;
    returns the block output without the outer residual."""
    dt = _dtype(cfg)
    hn = rms_norm(h, params["proj_norm"], cfg.norm_eps)
    g = F.silu(hn @ params["up_gate"].to(dt)) * (hn @ params["up"].to(dt))
    return (g @ params["down"].to(dt)) + (h - x)


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM matrix memory) — reuses chunked_ssd
# ---------------------------------------------------------------------------


def mlstm_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    H = cfg.num_heads
    hd = cfg.head_dim_
    di = H * hd
    return {
        "mixer_norm": norm_def(d),
        "wq": ParamDef((d, H, hd), ("fsdp", "tp", None), nrm()),
        "wk": ParamDef((d, H, hd), ("fsdp", "tp", None), nrm()),
        "wv": ParamDef((d, H, hd), ("fsdp", "tp", None), nrm()),
        "wi": ParamDef((d, H), ("fsdp", "tp"), nrm()),
        "wf": ParamDef((d, H), ("fsdp", "tp"), nrm()),
        "bi": ParamDef((H,), ("tp",), zeros_init),
        "bf": ParamDef((H,), ("tp",), const_init(3.0)),  # open forget gates
        "head_norm": norm_def(di),
        "wo": ParamDef((di, d), ("tp", "fsdp"), nrm()),
        # xLSTM projection sub-block (the arch has d_ff = 0)
        "up_gate": ParamDef((d, 2 * d), ("fsdp", "tp"), nrm()),
        "up": ParamDef((d, 2 * d), ("fsdp", "tp"), nrm()),
        "down": ParamDef((2 * d, d), ("tp", "fsdp"), nrm()),
        "proj_norm": norm_def(d),
    }


def _mlstm_qkv_gates(cfg, params, x):
    dt = _dtype(cfg)
    b, s, _ = x.shape
    H, hd = cfg.num_heads, cfg.head_dim_
    x = rms_norm(x, params["mixer_norm"], cfg.norm_eps)
    # einsum "bsd,dhk->bshk" as one matmul on the flattened head axis
    q = split_heads(x @ pin(params["wq"].to(dt).flatten(1)), H)
    k = split_heads(x @ pin(params["wk"].to(dt).flatten(1)), H)
    v = split_heads(x @ pin(params["wv"].to(dt).flatten(1)), H)
    k = k / (hd**0.5)
    i_raw = x @ params["wi"].to(dt) + params["bi"].to(dt)
    f_raw = x @ params["wf"].to(dt) + params["bf"].to(dt)
    loga = elementwise(F.logsigmoid, f_raw.float())  # (B, S, H)
    igate = torch.exp(torch.clamp(i_raw.float(), -10.0, 10.0))
    return q, k, v, loga, igate


def _mlstm_read(y_aug):
    """Split [values | normaliser] and normalise (xLSTM eq. with n-state)."""
    num, den = y_aug[..., :-1], y_aug[..., -1:]
    return num / den.abs().clamp_min(1.0)


def _mlstm_out(cfg, params, x, y_aug):
    dt = _dtype(cfg)
    b, s, _ = x.shape
    # pinned: the gradient comes back laid out as the merged heads were, so
    # that its view back into heads never splits a sharded dim
    y = pin(_mlstm_read(y_aug).reshape(b, s, cfg.num_heads * cfg.head_dim_))
    y = rms_norm(y, params["head_norm"], cfg.norm_eps)
    h = x + (y @ params["wo"].to(dt))  # inner residual (mixer)
    return _project_out(cfg, params, x, h)


def mlstm_apply_full(cfg: ModelConfig, params, x, chunk=DEFAULT_CHUNK, return_state=False):
    """x: (B, S, D). With ``return_state`` also the final matrix memory
    ``(B, H, hd, hd + 1)`` fp32 (the prefill cache)."""
    dt = _dtype(cfg)
    q, k, v, loga, igate = _mlstm_qkv_gates(cfg, params, x)
    ones = torch.ones((*v.shape[:-1], 1), dtype=dt, device=x.device)
    v_aug = torch.cat([v, ones], dim=-1)  # (B, S, H, hd + 1)
    b = k * igate[..., None]  # bf16 × fp32 → fp32, as in the JAX package
    y_aug, state = chunked_ssd(v_aug, loga, b, q, chunk=chunk)
    out = _mlstm_out(cfg, params, x, y_aug)
    return (out, state) if return_state else out


def mlstm_cache_layout(cfg: ModelConfig, batch: int) -> tuple:
    """``(shape, dtype, fill)`` of one layer's mLSTM memory: (B, H, hd,
    hd + 1) fp32, zero."""
    return (batch, cfg.num_heads, cfg.head_dim_, cfg.head_dim_ + 1), torch.float32, 0


def mlstm_cache_axes() -> tuple:
    """Logical axes of one layer's mLSTM memory (B, H, hd, hd + 1); the JAX
    package keeps it under ``{"state": ...}``, the port's cache holds the
    tensor itself."""
    return ("batch", "tp", None, None)


def mlstm_apply_step(cfg: ModelConfig, params, state, x, rules: Optional[ShardingRules] = None):
    """x: (B, 1, D); state (B, H, hd, hd + 1) fp32. Returns (out, new
    state). ``rules`` as the reference's: nothing is constrained inside;
    the state may be a DTensor laid out by :func:`mlstm_cache_axes`."""
    dt = _dtype(cfg)
    q, k, v, loga, igate = _mlstm_qkv_gates(cfg, params, x)  # S = 1
    ones = torch.ones((*v.shape[:1], v.shape[2], 1), dtype=dt, device=x.device)
    v_aug = torch.cat([v[:, 0], ones], dim=-1)
    b = (k * igate[..., None])[:, 0]
    # state layout (B, H, N = hd, P = hd + 1) matches ssd_step directly
    y_aug, state = ssd_step(state, v_aug, loga[:, 0], b, q[:, 0])
    return _mlstm_out(cfg, params, x, y_aug[:, None]), state


# ---------------------------------------------------------------------------
# sLSTM block (scalar memory, exponential gating, stabilised) — sequential
# ---------------------------------------------------------------------------

SLSTM_GATES = ("i", "f", "z", "o")


def slstm_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    H = cfg.num_heads
    dh = d // H

    def gate():
        return ParamDef((d, d), ("fsdp", "tp"), nrm())

    def rec():
        return ParamDef((H, dh, dh), ("tp", None, None), nrm(fan_in_axis=1))

    def bias(v=0.0):
        return ParamDef((d,), ("tp",), const_init(v))

    return {
        "mixer_norm": norm_def(d),
        "wi": gate(), "wf": gate(), "wz": gate(), "wo": gate(),
        "ri": rec(), "rf": rec(), "rz": rec(), "ro": rec(),
        "bi": bias(), "bf": bias(3.0), "bz": bias(), "bo": bias(),
        "out_norm": norm_def(d),
        "w_out": ParamDef((d, d), ("tp", "fsdp"), nrm()),
        "up_gate": ParamDef((d, 2 * d), ("fsdp", "tp"), nrm()),
        "up": ParamDef((d, 2 * d), ("fsdp", "tp"), nrm()),
        "down": ParamDef((2 * d, d), ("tp", "fsdp"), nrm()),
        "proj_norm": norm_def(d),
    }


def _slstm_recurrent(params, dtype):
    """The four recurrent maps side by side, (H, dh, 4·dh), and the four
    biases, (4, d): one ``bmm`` per step gives the four einsums
    ``bhk,hkj->bhj`` of the reference (each output is the same dot over k)."""
    r = torch.cat([params[f"r{g}"].to(dtype) for g in SLSTM_GATES], dim=-1)
    bias = torch.stack([params[f"b{g}"].to(dtype) for g in SLSTM_GATES])
    return r, bias


def _slstm_cell(cfg, rec, bias, carry, xg):
    """carry: (h, c, n, m) each (B, d); xg: the step's W·x, (B, 4, d) in the
    gate order i, f, z, o. Returns the new carry."""
    h, c, n, m = carry
    B, d = h.shape
    H = cfg.num_heads
    dh = d // H
    r = torch.bmm(split_heads(h, H).transpose(0, 1), rec)  # (H, B, 4·dh)
    # pinned: the gradient of the merged heads comes back laid out as r,
    # so that its view back into heads never splits a sharded dim
    r = pin(r.view(H, B, 4, dh).permute(1, 2, 0, 3).reshape(B, 4, d))
    pre = xg + r + bias  # each gate: x + rec + bias, in h's dtype
    it, ft = pre[:, 0].float(), pre[:, 1].float()
    zt = torch.tanh(pre[:, 2])
    ot = torch.sigmoid(pre[:, 3])
    logf = elementwise(F.logsigmoid, ft)
    m_new = torch.maximum(logf + m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(logf + m - m_new)
    c_new = f_p * c + i_p * zt.float()
    n_new = f_p * n + i_p
    h_new = (ot.float() * c_new / n_new.clamp_min(1.0)).to(h.dtype)
    return h_new, c_new, n_new, m_new


def slstm_scan(cfg, rec, bias, carry, xg):
    """The time loop: ``(the h of every step, the last carry)`` from
    ``carry`` over the steps of ``xg`` (B, S, 4, d).

    Every sLSTM block's full pass calls it once, through this module's
    global, with all S steps, and uses only its two results: a stand-in
    of this signature that returns S h's of the right shape may replace it
    (``launch/dryrun.py::slstm_steps`` runs the first few steps and
    repeats the last h; ``tests/test_torch_dryrun.py`` holds the count)."""
    hs = []
    for t in range(xg.shape[1]):
        carry = _slstm_cell(cfg, rec, bias, carry, xg[:, t])
        hs.append(carry[0])
    return hs, carry


def _slstm_gates_in(cfg, params, x):
    """rms_norm(x) @ W for the four gates, stacked as (B, S, 4, d)."""
    dt = _dtype(cfg)
    xn = rms_norm(x, params["mixer_norm"], cfg.norm_eps)
    return settle(torch.stack([xn @ params[f"w{g}"].to(dt) for g in SLSTM_GATES], dim=2))


def _slstm_out(cfg, params, x, y):
    dt = _dtype(cfg)
    y = rms_norm(y, params["out_norm"], cfg.norm_eps)
    h = x + (y @ params["w_out"].to(dt))
    return _project_out(cfg, params, x, h)


def slstm_cache_layout(cfg: ModelConfig, batch: int) -> dict:
    """``(shape, dtype, fill)`` of one layer's sLSTM carry ``{"h", "c",
    "n", "m"}``, each (B, d): h in the compute dtype, the rest fp32, all
    zero but m at -1e30 (the reference's initial carry)."""
    row, f32 = (batch, cfg.d_model), torch.float32
    return {"h": (row, _dtype(cfg), 0), "c": (row, f32, 0), "n": (row, f32, 0), "m": (row, f32, M_INIT)}


def slstm_init_cache(cfg: ModelConfig, batch: int, device) -> dict:
    """The initial carry of :func:`slstm_cache_layout`."""
    return {k: torch.full(shape, fill, dtype=dtype, device=device)
            for k, (shape, dtype, fill) in slstm_cache_layout(cfg, batch).items()}


def slstm_cache_axes() -> dict:
    """Logical axes of one layer's sLSTM carry, each (B, d); the JAX
    package's tuple ``(h, c, n, m)`` is the port's dict."""
    ax = ("batch", "tp")
    return {"h": ax, "c": ax, "n": ax, "m": ax}


def slstm_apply_full(cfg: ModelConfig, params, x, return_state=False):
    """x: (B, S, D), from the initial carry. With ``return_state`` also the
    final carry as ``{"h", "c", "n", "m"}``."""
    B, S, _ = x.shape
    xg = _slstm_gates_in(cfg, params, x)
    rec, bias = _slstm_recurrent(params, xg.dtype)
    init = slstm_init_cache(cfg, B, x.device)
    hs, carry = slstm_scan(cfg, rec, bias, tuple(init[k] for k in ("h", "c", "n", "m")), xg)
    out = _slstm_out(cfg, params, x, torch.stack(hs, dim=1))
    if return_state:
        return out, dict(zip(("h", "c", "n", "m"), carry))
    return out


def slstm_apply_step(cfg: ModelConfig, params, state: dict, x, rules: Optional[ShardingRules] = None):
    """x: (B, 1, D); state ``{"h", "c", "n", "m"}``. Returns (out, new
    state). ``rules`` as the reference's: nothing is constrained inside;
    the state may be DTensors laid out by :func:`slstm_cache_axes`."""
    xg = _slstm_gates_in(cfg, params, x)
    rec, bias = _slstm_recurrent(params, xg.dtype)
    carry = _slstm_cell(cfg, rec, bias, tuple(state[k] for k in ("h", "c", "n", "m")), xg[:, 0])
    return _slstm_out(cfg, params, x, carry[0][:, None]), dict(zip(("h", "c", "n", "m"), carry))
