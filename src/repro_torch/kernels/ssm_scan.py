"""K3, the chunked SSD scan (mLSTM and Mamba-2 prefill).

The CUDA kernel is ``csrc/ssm_scan.cu``; it replaces the Pallas kernel
``repro/kernels/ssm_scan.py::_ssd_kernel``. Beside it,
:func:`ssm_scan_plain` computes the same function in plain PyTorch: the
CPU tests run it, and ``chip_smoke.py`` holds the kernel against it on the
card. Callers go through ``kernels/ops.py::ssm_scan``, which takes the
model layout and uses :func:`fold` and :func:`unfold` below.

Contract of both, on the kernel's folded layout: x ``(BH, S, P)``, loga
``(BH, S)`` fp32, b and c ``(BH, S, N)``; the recurrence

    h_t = exp(loga_t) · h_{t-1} + b_t ⊗ x_t ;   y_t = c_t · h_t

from ``h_0 = 0``, evaluated in chunks of ``L = min(chunk, S)`` steps, with
``S % L == 0`` (the Pallas kernel asserts the same). Per chunk:
``cum = cumsum(loga)``, ``y = (C Bᵀ ∘ exp(cum_t − cum_s) ∘ tril) X +
(C · exp(cum)) h``, then ``h ← exp(cum_L) h + (B · exp(cum_L − cum))ᵀ X``.
All arithmetic in fp32 whatever the input types (x and c may be bf16, b
fp32 or bf16); y comes back in x's dtype, the final h in fp32.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build


def fold(x, loga, b, c, chunk: int):
    """Model layout ``x (B, S, H, P)``, ``loga (B, S, H)``, ``b``/``c
    (B, S, H, N)`` → the folded layout, with S padded to a multiple of
    ``L = min(chunk, S)`` by identity steps (``loga = 0``, ``b = x = 0``:
    the state passes through unchanged), as ``models/ssm.py::chunked_ssd``
    of the JAX package pads."""
    B, S, H, P = x.shape
    pad = (-S) % min(chunk, S)
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
        loga = F.pad(loga, (0, 0, 0, pad))
    sp = S + pad

    def f(t):  # contiguous: at B = 1 the reshape alone is a strided view
        return t.transpose(1, 2).reshape(B * H, sp, *t.shape[3:]).contiguous()

    return f(x), f(loga), f(b), f(c)


def unfold(y, h, batch: int, seq: int):
    """Folded ``y (BH, S', P)``, ``h (BH, N, P)`` → ``(B, S, H, P)`` (the
    padding cut off) and ``(B, H, N, P)``."""
    bh, sp, p = y.shape
    heads = bh // batch
    y = y.reshape(batch, heads, sp, p).transpose(1, 2)[:, :seq]
    return y, h.reshape(batch, heads, h.shape[1], p)


def _chunk_len(s: int, chunk: int) -> int:
    L = min(chunk, s)
    if s % L:
        raise ValueError(f"ssm_scan: sequence {s} is not a multiple of the chunk {L}; "
                         "pad it first (kernels/ssm_scan.py::fold)")
    return L


def ssm_scan_plain(x, loga, b, c, chunk: int):
    """The chunked algorithm of the JAX package's ``chunked_ssd`` step by
    step, on the folded layout. Returns ``(y (BH, S, P) in x.dtype,
    h (BH, N, P) fp32)``."""
    bh, s, p = x.shape
    n = b.shape[-1]
    L = _chunk_len(s, chunk)
    k = s // L
    xk = x.reshape(bh, k, L, p).float()
    bk = b.reshape(bh, k, L, n).float()
    ck = c.reshape(bh, k, L, n).float()
    cum = torch.cumsum(loga.reshape(bh, k, L).float(), dim=2)  # inclusive
    total = cum[:, :, -1]

    # intra-chunk quadratic term, decay-weighted and causal; the exponent is
    # clamped at 0 as in the reference (the masked side would overflow)
    cb = ck @ bk.transpose(-1, -2)  # (bh, k, L, L): c_t · b_s
    decay = torch.exp(torch.clamp_max(cum[..., :, None] - cum[..., None, :], 0.0))
    mask = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    y = torch.where(mask, cb * decay, 0.0) @ xk

    # per-chunk end states
    sdecay = torch.exp(total[..., None] - cum)  # (bh, k, L)
    s_k = (bk * sdecay[..., None]).transpose(-1, -2) @ xk  # (bh, k, n, p)

    # inter-chunk sequential pass over the chunks
    h = torch.zeros((bh, n, p), dtype=torch.float32, device=x.device)
    y_inter = []
    for i in range(k):
        y_inter.append((ck[:, i] @ h) * torch.exp(cum[:, i])[..., None])
        h = torch.exp(total[:, i])[:, None, None] * h + s_k[:, i]
    y = y + torch.stack(y_inter, dim=1)
    return y.reshape(bh, s, p).to(x.dtype), h


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
MAX_CHUNK = 1024  # the kernel's block prefix sum holds 4 values per thread


@functools.cache
def _entry():
    fn = _build.load("ssm_scan").k3_ssm_scan
    fn.argtypes = [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def ssm_scan_cuda(x, loga, b, c, chunk: int):
    """Launch the CUDA kernel. Same arguments and results as the plain
    version. x and c share float32 or bfloat16, b is either, loga is
    float32; every tensor contiguous. Checks what the kernel takes and
    raises on anything else."""
    bh, s, p = x.shape
    n = b.shape[-1]
    if not (x.is_cuda and all(t.device == x.device for t in (loga, b, c))):
        raise ValueError("ssm_scan_cuda: x, loga, b, c must be on the same CUDA device")
    if x.dtype not in _DTYPE_CODE or c.dtype != x.dtype or b.dtype not in _DTYPE_CODE:
        raise TypeError(f"ssm_scan_cuda: x and c must share float32 or bfloat16 and b be either, got "
                        f"{x.dtype}, {c.dtype}, {b.dtype}")
    if loga.dtype != torch.float32:
        raise TypeError(f"ssm_scan_cuda: loga must be float32, got {loga.dtype}")
    if loga.shape != (bh, s) or b.shape != (bh, s, n) or c.shape != b.shape:
        raise ValueError(f"ssm_scan_cuda: shapes x {tuple(x.shape)}, loga {tuple(loga.shape)}, "
                         f"b {tuple(b.shape)}, c {tuple(c.shape)} do not agree")
    if not all(t.is_contiguous() for t in (x, loga, b, c)):
        raise ValueError("ssm_scan_cuda: x, loga, b, c must be contiguous")
    L = _chunk_len(s, chunk)
    if L > MAX_CHUNK or bh > 65535 or s // L > 65535:
        raise ValueError(f"ssm_scan_cuda: chunk {L} (at most {MAX_CHUNK}), rows {bh} or chunks "
                         f"{s // L} (at most 65535) out of range")
    y =torch.empty_like(x)
    h = torch.empty((bh, n, p), dtype=torch.float32, device=x.device)
    wt = torch.empty((bh, s // L, L, L), dtype=torch.float32, device=x.device)  # scratch: the intra-chunk weights
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _entry()(
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[b.dtype], x.data_ptr(), loga.data_ptr(), b.data_ptr(),
        c.data_ptr(), y.data_ptr(), h.data_ptr(), wt.data_ptr(), bh, s, p, n, L, stream,
    )
    _build.check(err, "ssm_scan kernel")
    return y, h
