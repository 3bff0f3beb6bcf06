"""K3, the chunked SSD scan (mLSTM and Mamba-2 prefill).

The CUDA kernel is ``csrc/ssm_scan.cu``; it replaces the Pallas kernel
``repro/kernels/ssm_scan.py::_ssd_kernel``. Beside it,
:func:`ssm_scan_plain` computes the same function in plain PyTorch: the
CPU tests run it, and ``chip_smoke.py`` holds the kernel against it on the
card. Callers go through ``kernels/ops.py::ssm_scan``, which takes the
model layout and uses :func:`fold` and :func:`unfold` below. The kernel
is a forward; its gradient is :func:`ssm_scan_ref_vjp`, the plain
version differentiated under recompute.

Contract of both, on the kernel's folded layout: x ``(BH, S, P)``, loga
``(BH, S)`` fp32, b and c ``(BH, S, N)``; the recurrence

    h_t = exp(loga_t) · h_{t-1} + b_t ⊗ x_t ;   y_t = c_t · h_t

from ``h_0 = 0``, evaluated in chunks of ``L = min(chunk, S)`` steps, with
``S % L == 0`` (the Pallas kernel asserts the same). Per chunk:
``cum = cumsum(loga)``, ``y = (C Bᵀ ∘ exp(cum_t − cum_s) ∘ tril) X +
(C · exp(cum)) h``, then ``h ← exp(cum_L) h + (B · exp(cum_L − cum))ᵀ X``.
x and c may be bf16 or fp32, b either; y comes back in x's dtype, the
final h in fp32.

Precision: every product is taken to about 2⁻²¹ of its size and every sum
in fp32 (fp64 where x and c are fp32). The kernel computes its products on
TF32 tensor cores: it writes each fp32 operand ``a`` as ``hi + lo``, both
TF32 (``hi`` is ``a`` rounded to TF32, ``lo`` is ``a − hi`` rounded, so
``|a − hi − lo| ≤ 2⁻²² |a|``), and takes ``hi·b + lo·b`` where the other
operand is bf16 (exact in TF32). On the fp32 path (both operands fp32)
it writes each as three TF32 parts, whose sum is exact, and keeps every
product of parts above 2⁻³³ of the whole. One TF32 pass alone (2⁻¹¹)
would miss the limits the kernel is held to. The plain version sums in
its inputs' promoted type, at least fp32: fp32 for bf16 and fp32 inputs
(the port's path on the CPU), fp64 for fp64 inputs.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build


ALIGN = 8  # the kernel copies rows in 16-byte pieces: P and N are padded to multiples of 8


def fold(x, loga, b, c, chunk: int):
    """Model layout ``x (B, S, H, P)``, ``loga (B, S, H)``, ``b``/``c
    (B, S, H, N)`` → the folded layout, with S padded to a multiple of
    ``L = min(chunk, S)`` by identity steps (``loga = 0``, ``b = x = 0``:
    the state passes through unchanged), as ``models/ssm.py::chunked_ssd``
    of the JAX package pads, and P and N padded to multiples of ``ALIGN``
    by zero columns: zero columns of x give zero columns of y and h, zero
    columns of b and c zero rows of h, and neither changes the rest.
    :func:`unfold` cuts them off again."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    pad = (-S) % min(chunk, S)
    pp, pn = (-P) % ALIGN, (-N) % ALIGN
    if pad or pp:
        x = F.pad(x, (0, pp, 0, 0, 0, pad))
    if pad or pn:
        b = F.pad(b, (0, pn, 0, 0, 0, pad))
        c = F.pad(c, (0, pn, 0, 0, 0, pad))
    if pad:
        loga = F.pad(loga, (0, 0, 0, pad))
    sp = S + pad

    def f(t):  # contiguous: at B = 1 the reshape alone is a strided view
        return t.transpose(1, 2).reshape(B * H, sp, *t.shape[3:]).contiguous()

    return f(x), f(loga), f(b), f(c)


def unfold(y, h, batch: int, seq: int, p: int, n: int):
    """Folded ``y (BH, S', P')``, ``h (BH, N', P')`` → ``(B, S, H, P)`` and
    ``(B, H, N, P)``, the padding of :func:`fold` cut off."""
    bh, sp, pp = y.shape
    heads = bh // batch
    y = y.reshape(batch, heads, sp, pp).transpose(1, 2)[:, :seq, :, :p]
    return y, h.reshape(batch, heads, h.shape[1], pp)[:, :, :n, :p]


def _chunk_len(s: int, chunk: int) -> int:
    L = min(chunk, s)
    if s % L:
        raise ValueError(f"ssm_scan: sequence {s} is not a multiple of the chunk {L}; "
                         "pad it first (kernels/ssm_scan.py::fold)")
    return L


def ssm_scan_plain(x, loga, b, c, chunk: int):
    """The chunked algorithm of the JAX package's ``chunked_ssd`` step by
    step, on the folded layout. Returns ``(y (BH, S, P) in x.dtype,
    h (BH, N, P))``, every sum and h in the inputs' promoted type, at least
    fp32: fp32 for bf16 and fp32 inputs, as the JAX package sums; fp64 for
    fp64 inputs, which the checks on the card hand it to hold the kernel
    against an exact result (summed in fp32, at input gates near e^10, it is
    itself up to 5e-5 of an element's scale from that result, beyond the
    kernel's 1e-5: ``scripts/k3_precision.py``).
    """
    bh, s, p = x.shape
    n = b.shape[-1]
    L = _chunk_len(s, chunk)
    k = s // L
    acc = functools.reduce(torch.promote_types, (x.dtype, loga.dtype, b.dtype, c.dtype), torch.float32)
    xk = x.reshape(bh, k, L, p).to(acc)
    bk = b.reshape(bh, k, L, n).to(acc)
    ck = c.reshape(bh, k, L, n).to(acc)
    cum = torch.cumsum(loga.reshape(bh, k, L).to(acc), dim=2)  # inclusive
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
    h = torch.zeros((bh, n, p), dtype=acc, device=x.device)
    y_inter = []
    for i in range(k):
        y_inter.append((ck[:, i] @ h) * torch.exp(cum[:, i])[..., None])
        h = torch.exp(total[:, i])[:, None, None] * h + s_k[:, i]
    y = y + torch.stack(y_inter, dim=1)
    return y.reshape(bh, s, p).to(x.dtype), h


def ssm_scan_ref_vjp(x, loga, b, c, gy, gh, chunk: int):
    """``(dx, dloga, db, dc)`` of :func:`ssm_scan_plain` at the folded
    inputs for the cotangents ``gy`` of y and ``gh`` of the final h (one of
    them may be ``None``, for zero), in the inputs' dtypes: the function
    recomputed under autograd, as the JAX package differentiates its jnp
    ``chunked_ssd`` (``repro/models/ssm.py``), which has no backward kernel
    either. The
    clamped decay exponent of the plain version keeps the masked side of
    the intra-chunk term out of the backward (inf · 0 would give NaN).
    Plain PyTorch on every device."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (x, loga, b, c)]
        pairs = [(out, g) for out, g in zip(ssm_scan_plain(*ins, chunk), (gy, gh)) if g is not None]
        outs, grads = zip(*pairs)
        return torch.autograd.grad(outs, ins, grads, allow_unused=True, materialize_grads=True)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
MAX_CHUNK = 1024  # the kernel keeps a chunk's cumulative log-decay in shared memory
_TILE = 64  # the kernel's t and s tile: W is kept per chunk at L rounded up to it


@functools.cache
def _entry():
    fn = _build.load("ssm_scan").k3_ssm_scan
    fn.argtypes = [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def ssm_scan_cuda(x, loga, b, c, chunk: int):
    """Launch the CUDA kernel. Same arguments and results as the plain
    version, on :func:`fold`'s output: x and c share float32 or bfloat16, b
    is either, loga is float32; every tensor contiguous, P and N multiples
    of ``ALIGN``. Checks what the kernel takes and raises on anything else.
    Allocates its outputs and scratch with ``torch.empty``, so a call can be
    captured in a CUDA graph."""
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
    if p % ALIGN or n % ALIGN:
        raise ValueError(f"ssm_scan_cuda: P {p} and N {n} must be multiples of {ALIGN}; pad them first "
                         "(kernels/ssm_scan.py::fold)")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (x, loga, b, c)):
        raise ValueError("ssm_scan_cuda: x, loga, b, c must be contiguous and 16-byte aligned")
    L = _chunk_len(s, chunk)
    k = s // L
    if L > MAX_CHUNK or bh * k > 65535:
        raise ValueError(f"ssm_scan_cuda: chunk {L} (at most {MAX_CHUNK}) or rows x chunks {bh * k} "
                         "(at most 65535) out of range")
    y = torch.empty_like(x)
    h = torch.empty((bh, n, p), dtype=torch.float32, device=x.device)
    lp = -(-L // _TILE) * _TILE
    # scratch: the state entering each chunk after the first, and the
    # intra-chunk weights W
    hs = torch.empty((bh, k - 1, n, p), dtype=torch.float32, device=x.device)
    w = torch.empty((bh, k, lp, lp), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):  # the kernel launches on, and opts in on, the current device
        err = _entry()(
            _DTYPE_CODE[x.dtype], _DTYPE_CODE[b.dtype], x.data_ptr(), loga.data_ptr(), b.data_ptr(),
            c.data_ptr(), y.data_ptr(), h.data_ptr(), hs.data_ptr(), w.data_ptr(), bh, s, p, n, L,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(err, "ssm_scan kernel")
    return y, h
