"""Recurrent blocks of the xLSTM stack: mLSTM and sLSTM.

Port of the xLSTM part of ``repro/models/ssm.py`` (the Mamba-2 block waits
for the jamba slice, which also needs MoE). ``chunked_ssd`` is the shared
chunked scalar-decay linear recurrence; here it is a call to
``kernels/ops.py::ssm_scan`` (K3: the CUDA kernel on the card, its plain
version on the CPU). mLSTM folds the exponential input gate into ``b`` and
appends a ones column to the values, so the normaliser ``n`` rides along
in the state. sLSTM is sequential (scalar memory, exponential gating, a
stabiliser) and runs as a Python loop over time.

Decode-step functions take the layer's recurrent state and return the new
one; ``models/model.py::decode_step`` writes it back into the cache in
place, for active rows only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import ParamDef, const_init, norm_def, nrm, rms_norm, zeros_init

DEFAULT_CHUNK = 256
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
    (B, H); b_t, c_t (B, H, N). Returns ``(y (B, H, P) in x_t's dtype, new h)``."""
    a = torch.exp(loga_t.float())
    h = a[..., None, None] * h + b_t.float()[..., :, None] * x_t.float()[..., None, :]
    y = (c_t.float()[..., None, :] @ h)[..., 0, :]
    return y.to(x_t.dtype), h


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
        "wq": ParamDef((d, H, hd), nrm()),
        "wk": ParamDef((d, H, hd), nrm()),
        "wv": ParamDef((d, H, hd), nrm()),
        "wi": ParamDef((d, H), nrm()),
        "wf": ParamDef((d, H), nrm()),
        "bi": ParamDef((H,), zeros_init),
        "bf": ParamDef((H,), const_init(3.0)),  # open forget gates
        "head_norm": norm_def(di),
        "wo": ParamDef((di, d), nrm()),
        # xLSTM projection sub-block (the arch has d_ff = 0)
        "up_gate": ParamDef((d, 2 * d), nrm()),
        "up": ParamDef((d, 2 * d), nrm()),
        "down": ParamDef((2 * d, d), nrm()),
        "proj_norm": norm_def(d),
    }


def _mlstm_qkv_gates(cfg, params, x):
    dt = _dtype(cfg)
    b, s, _ = x.shape
    H, hd = cfg.num_heads, cfg.head_dim_
    x = rms_norm(x, params["mixer_norm"], cfg.norm_eps)
    # einsum "bsd,dhk->bshk" as one matmul on the flattened head axis
    q = (x @ params["wq"].to(dt).flatten(1)).view(b, s, H, hd)
    k = (x @ params["wk"].to(dt).flatten(1)).view(b, s, H, hd)
    v = (x @ params["wv"].to(dt).flatten(1)).view(b, s, H, hd)
    k = k / (hd**0.5)
    i_raw = x @ params["wi"].to(dt) + params["bi"].to(dt)
    f_raw = x @ params["wf"].to(dt) + params["bf"].to(dt)
    loga = F.logsigmoid(f_raw.float())  # (B, S, H)
    igate = torch.exp(torch.clamp(i_raw.float(), -10.0, 10.0))
    return q, k, v, loga, igate


def _mlstm_read(y_aug):
    """Split [values | normaliser] and normalise (xLSTM eq. with n-state)."""
    num, den = y_aug[..., :-1], y_aug[..., -1:]
    return num / den.abs().clamp_min(1.0)


def _mlstm_out(cfg, params, x, y_aug):
    dt = _dtype(cfg)
    b, s, _ = x.shape
    y = _mlstm_read(y_aug).reshape(b, s, cfg.num_heads * cfg.head_dim_)
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


def mlstm_init_cache(cfg: ModelConfig, batch: int, device) -> torch.Tensor:
    H, hd = cfg.num_heads, cfg.head_dim_
    return torch.zeros((batch, H, hd, hd + 1), dtype=torch.float32, device=device)


def mlstm_apply_step(cfg: ModelConfig, params, state, x):
    """x: (B, 1, D); state (B, H, hd, hd + 1) fp32. Returns (out, new state)."""
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
        return ParamDef((d, d), nrm())

    def rec():
        return ParamDef((H, dh, dh), nrm(fan_in_axis=1))

    def bias(v=0.0):
        return ParamDef((d,), const_init(v))

    return {
        "mixer_norm": norm_def(d),
        "wi": gate(), "wf": gate(), "wz": gate(), "wo": gate(),
        "ri": rec(), "rf": rec(), "rz": rec(), "ro": rec(),
        "bi": bias(), "bf": bias(3.0), "bz": bias(), "bo": bias(),
        "out_norm": norm_def(d),
        "w_out": ParamDef((d, d), nrm()),
        "up_gate": ParamDef((d, 2 * d), nrm()),
        "up": ParamDef((d, 2 * d), nrm()),
        "down": ParamDef((2 * d, d), nrm()),
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
    r = torch.bmm(h.view(B, H, dh).transpose(0, 1), rec)  # (H, B, 4·dh)
    r = r.view(H, B, 4, dh).permute(1, 2, 0, 3).reshape(B, 4, d)
    pre = xg + r + bias  # each gate: x + rec + bias, in h's dtype
    it, ft = pre[:, 0].float(), pre[:, 1].float()
    zt = torch.tanh(pre[:, 2])
    ot = torch.sigmoid(pre[:, 3])
    logf = F.logsigmoid(ft)
    m_new = torch.maximum(logf + m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(logf + m - m_new)
    c_new = f_p * c + i_p * zt.float()
    n_new = f_p * n + i_p
    h_new = (ot.float() * c_new / n_new.clamp_min(1.0)).to(h.dtype)
    return h_new, c_new, n_new, m_new


def _slstm_gates_in(cfg, params, x):
    """rms_norm(x) @ W for the four gates, stacked as (B, S, 4, d)."""
    dt = _dtype(cfg)
    xn = rms_norm(x, params["mixer_norm"], cfg.norm_eps)
    return torch.stack([xn @ params[f"w{g}"].to(dt) for g in SLSTM_GATES], dim=2)


def _slstm_out(cfg, params, x, y):
    dt = _dtype(cfg)
    y = rms_norm(y, params["out_norm"], cfg.norm_eps)
    h = x + (y @ params["w_out"].to(dt))
    return _project_out(cfg, params, x, h)


def slstm_init_cache(cfg: ModelConfig, batch: int, device) -> dict:
    """``{"h", "c", "n", "m"}`` each (B, d): h in the compute dtype, the
    rest fp32, m at -1e30 (the reference's initial carry)."""
    d = cfg.d_model
    z32 = torch.zeros((batch, d), dtype=torch.float32, device=device)
    return {"h": torch.zeros((batch, d), dtype=_dtype(cfg), device=device),
            "c": z32, "n": z32.clone(), "m": torch.full_like(z32, M_INIT)}


def slstm_apply_full(cfg: ModelConfig, params, x, return_state=False):
    """x: (B, S, D), from the initial carry. With ``return_state`` also the
    final carry as ``{"h", "c", "n", "m"}``."""
    B, S, _ = x.shape
    xg = _slstm_gates_in(cfg, params, x)
    rec, bias = _slstm_recurrent(params, xg.dtype)
    init = slstm_init_cache(cfg, B, x.device)
    carry = tuple(init[k] for k in ("h", "c", "n", "m"))
    hs = []
    for t in range(S):
        carry = _slstm_cell(cfg, rec, bias, carry, xg[:, t])
        hs.append(carry[0])
    out = _slstm_out(cfg, params, x, torch.stack(hs, dim=1))
    if return_state:
        return out, dict(zip(("h", "c", "n", "m"), carry))
    return out


def slstm_apply_step(cfg: ModelConfig, params, state: dict, x):
    """x: (B, 1, D); state ``{"h", "c", "n", "m"}``. Returns (out, new state)."""
    xg = _slstm_gates_in(cfg, params, x)
    rec, bias = _slstm_recurrent(params, xg.dtype)
    carry = _slstm_cell(cfg, rec, bias, tuple(state[k] for k in ("h", "c", "n", "m")), xg[:, 0])
    return _slstm_out(cfg, params, x, carry[0][:, None]), dict(zip(("h", "c", "n", "m"), carry))
