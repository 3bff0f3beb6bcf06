"""K1, flash-decode: one query token against the KV arena.

The CUDA kernel is ``csrc/decode_attention.cu``; it replaces the Pallas
kernel ``repro/kernels/decode_attention.py::_decode_kernel``. Beside it,
:func:`decode_attention_plain` computes the same function in plain PyTorch:
the CPU tests run it, and ``chip_smoke.py`` holds the kernel against it on
the card. Callers go through ``kernels/ops.py::decode_attention``.

Contract of both: q ``(B, H, D)``; k, v ``(B, S, KH, D)`` in the model's
layout; valid ``(B, S)``. Softmax in fp32; masked probabilities are exact
zeros, so a row with no valid key gives ``out = 0`` and ``l = 0``.
``normalize=False`` returns the unnormalised partials ``(acc, m, l)``.
This differs from the masked-softmax ``einsum`` path, which spreads an
all-invalid row uniformly.

The kernel cuts S into splits of :data:`SPLIT_KEYS` keys, one block each,
and combines their partials in split order (:func:`split_plan`). The split
length depends on S alone, never on the batch or the card, so a row's
result is the same bits whatever batch it is decoded in.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
SPLIT_KEYS = 256  # keys per block of the CUDA kernel (kSplit in the source)


def split_plan(seq_len: int) -> tuple[int, int]:
    """``(keys per split, number of splits)`` for a cache of ``seq_len``
    keys; the last split may be short."""
    if seq_len <= 0:
        raise ValueError(f"split_plan: seq_len {seq_len} must be positive")
    return SPLIT_KEYS, -(-seq_len // SPLIT_KEYS)


def scratch_shape(batch: int, heads: int, head_dim: int, seq_len: int) -> tuple[int, int, int, int]:
    """Shape of the fp32 scratch the wrapper hands the kernel: one partial
    ``(acc (head_dim), m, l)`` per (row, q head, split)."""
    return batch, heads, split_plan(seq_len)[1], head_dim + 2


def decode_attention_plain(q, k, v, valid, *, scale: float, normalize: bool = True):
    """Returns fp32 ``(out (B, H, D), m (B, H), l (B, H))``."""
    b, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    qg = q.reshape(b, kh, g, d).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k.float()) * scale
    ok = valid.bool()[:, None, None, :]
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(ok, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    if normalize:
        acc = acc / l.clamp_min(1e-30)[..., None]
    return acc.reshape(b, h, d), m.reshape(b, h), l.reshape(b, h)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


@functools.cache
def _entry():
    fn = _build.load("decode_attention").k1_decode_attention
    fn.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                   _L, _L, _L, _L, _L, _L, _I, _I, ctypes.c_float, _I, _P]
    fn.restype = _I
    return fn


def decode_attention_cuda(q, k, v, valid, *, scale: float, normalize: bool = True):
    """Launch the CUDA kernel. Same arguments and results as the plain
    version; ``valid`` must be int32. Checks what the kernel takes and
    raises on anything else."""
    b, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    if not (q.is_cuda and k.device == q.device and v.device == q.device and valid.device == q.device):
        raise ValueError("decode_attention_cuda: every tensor must be on the same CUDA device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention_cuda: q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if valid.dtype != torch.int32:
        raise TypeError(f"decode_attention_cuda: valid must be int32, got {valid.dtype}")
    if k.shape != (b, s, kh, d) or v.shape != k.shape or valid.shape != (b, s) or h % kh:
        raise ValueError(f"decode_attention_cuda: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, valid {tuple(valid.shape)} do not agree")
    if d not in (64, 128, 256):
        raise ValueError(f"decode_attention_cuda: head_dim {d} is not 64, 128 or 256")
    if not (q.is_contiguous() and valid.is_contiguous() and k.stride(3) == 1 and v.stride(3) == 1):
        raise ValueError("decode_attention_cuda: q and valid must be contiguous, k and v "
                         "contiguous along head_dim")
    vec = 16 // k.element_size()  # the kernel reads k and v in 16-byte vectors
    if any(t.data_ptr() % 16 or any(st % vec for st in t.stride()[:3]) for t in (k, v)):
        raise ValueError("decode_attention_cuda: k and v must be 16-byte aligned with strides that "
                         f"are multiples of {vec} elements")
    split_keys, n_split = split_plan(s)
    part = torch.empty(scratch_shape(b, h, d, s), dtype=torch.float32, device=q.device)
    out = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, h), dtype=torch.float32, device=q.device)
    l = torch.empty((b, h), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry()(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
        part.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(), b, s, h, kh, d,
        k.stride(0), k.stride(1), k.stride(2), v.stride(0), v.stride(1), v.stride(2),
        split_keys, n_split, scale, int(normalize), stream,
    )
    _build.check(err, "decode_attention kernel")
    return out, m, l
