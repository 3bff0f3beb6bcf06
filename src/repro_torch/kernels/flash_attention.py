"""K2, causal flash-attention forward (prefill).

The CUDA kernel is ``csrc/flash_attention.cu``; it replaces the Pallas
kernel ``repro/kernels/flash_attention.py::_flash_kernel``. Beside it,
:func:`flash_attention_plain` computes the same function in plain PyTorch:
the CPU tests run it, and ``chip_smoke.py`` holds the kernel against it on
the card. Callers go through ``kernels/ops.py::flash_attention``.

Contract of both: q ``(B, Sq, H, D)``; k, v ``(B, Sk, KH, D)``; query row
``i`` sits at position ``i + q_offset`` and sees keys ``kpos <= qpos`` (and
``kpos > qpos - window`` when ``window > 0``). fp32 softmax with masked
probabilities written as exact zeros; output in q's dtype.

The kernel is a forward. Its gradient, as in the JAX package
(``repro/kernels/ops.py::_flash_bwd_rule``, the VJP of
``repro/kernels/ref.py::flash_attention_ref``), is taken under recompute:
:func:`flash_attention_ref_vjp` rebuilds :func:`flash_attention_plain`
from the saved q, k, v and differentiates it with autograd. The plain
version is the reference's function (fp32 scores, ``NEG_INF`` mask,
softmax) with fully masked rows written as zeros, as the kernel writes
them, so the backward differentiates the function the forward computes.
That is plain PyTorch on the card too, as the reference computes its
backward outside any Pallas kernel. ``kernels/ops.py`` wires the two into
one ``torch.autograd.Function``.

On the card bf16 runs on the tensor cores (``wgmma`` on 64 x 64 tiles
copied in by 16-byte ``cp.async``), so q, k and v must be 16-byte aligned
with strides of whole 8-value chunks; fp32, which only the tests use, runs
on the CUDA cores.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30


def flash_attention_plain(q, k, v, *, q_offset: int = 0, window: int = 0, scale: float):
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    qg = q.reshape(b, sq, kh, g, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    out = acc / l.clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def flash_attention_ref_vjp(q, k, v, g, *, q_offset: int = 0, window: int = 0, scale: float):
    """``(dq, dk, dv)`` of :func:`flash_attention_plain` at ``q, k, v`` for
    the output cotangent ``g``, in the inputs' dtypes: the function
    recomputed under autograd (its O(Sq·Sk) fp32 scores are rebuilt here
    and freed on return), as ``repro/kernels/ops.py::_flash_bwd_rule``
    takes ``jax.vjp`` of the reference's oracle. Plain PyTorch on every
    device: the reference has no backward kernel."""
    with torch.enable_grad():
        qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
        out = flash_attention_plain(qr, kr, vr, q_offset=q_offset, window=window, scale=scale)
        return torch.autograd.grad(out, (qr, kr, vr), g)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


@functools.cache
def _entry():
    fn = _build.load("flash_attention").k2_flash_attention
    fn.argtypes = [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                   _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                   _I, _I, ctypes.c_float, _P]
    fn.restype = _I
    return fn


def flash_attention_cuda(q, k, v, *, q_offset: int = 0, window: int = 0, scale: float):
    """Launch the CUDA kernel. Same arguments and result as the plain
    version. Checks what the kernel takes and raises on anything else."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_cuda: q, k, v must be on the same CUDA device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_cuda: q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != (b, sk, kh, d) or v.shape != k.shape or h % kh:
        raise ValueError(f"flash_attention_cuda: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if d not in (64, 128, 256):
        raise ValueError(f"flash_attention_cuda: head_dim {d} is not 64, 128 or 256")
    if not (q.stride(3) == 1 and k.stride(3) == 1 and v.stride(3) == 1):
        raise ValueError("flash_attention_cuda: q, k, v must be contiguous along head_dim")
    if q.dtype == torch.float32 and b * h > 65535:
        raise ValueError(f"flash_attention_cuda: batch * heads {b * h} exceeds the fp32 grid")
    if q.dtype == torch.bfloat16:  # the tensor-core body copies 16-byte chunks of 8 values
        if any(t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]) for t in (q, k, v)):
            raise ValueError("flash_attention_cuda: bf16 q, k, v must be 16-byte aligned with "
                             "strides that are multiples of 8 elements")
        if -(-sq // 64) > 65535:
            raise ValueError(f"flash_attention_cuda: {sq} query rows exceed the grid")
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):  # the kernel launches on, and opts in on, the current device
        err = _entry()(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, sq, sk, h, kh, d,
            q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2), out.stride(0), out.stride(1), out.stride(2),
            q_offset, window, scale, stream,
        )
    _build.check(err, "flash_attention kernel")
    return out
