"""Model-layout wrappers around the Hopper kernels.

  flash_attention(q, k, v, ...)     — (B, Sq, H, D) × (B, Sk, KH, D) → (B, Sq, H, D)   (K2)
  decode_attention(q, k, v, valid)  — (B, H, D) one token vs the (B, S, KH, D) cache  (K1)
  combine_decode_partials(...)      — logsumexp combine of K1 partials from shards
  ssm_scan(x, loga, b, c, chunk)    — chunked SSD scan, (B, S, H, P) → y, final h (K3)

A wrapper runs its kernel's plain PyTorch version for tensors on the CPU
(the tests) and launches the CUDA kernel for tensors on the card, raising
if the kernel does not take them; there is no fallback from one to the
other. K2 and K3 are differentiable on both devices: each is a
``torch.autograd.Function`` whose forward is the kernel (its plain
version on the CPU) and whose backward recomputes the plain version under
autograd, as the JAX package differentiates its oracles; no backward
launches a kernel. ``LAUNCHES`` counts kernel launches per wrapper
(forward launches only, and a forward recomputed by activation
checkpointing launches again), so a run can show that its main path went
through the kernels. K1 and K2 read the tensors in the model's layout
through strides; ``ssm_scan`` folds batch and heads into the kernel's
row axis (a copy), as the JAX package's wrapper does.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention import decode_attention_cuda, decode_attention_plain
from repro_torch.kernels.flash_attention import (
    flash_attention_cuda,
    flash_attention_plain,
    flash_attention_ref_vjp,
)
from repro_torch.kernels.ssm_scan import fold, ssm_scan_cuda, ssm_scan_plain, ssm_scan_ref_vjp, unfold

LAUNCHES = {"decode_attention": 0, "flash_attention": 0, "ssm_scan": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class _FlashAttention(torch.autograd.Function):
    """K2's forward; the backward is the VJP of its plain version under
    recompute (``flash_attention_ref_vjp``), as the JAX package's
    ``custom_vjp`` pairs the kernel with its oracle's VJP. Only the forward
    launches the kernel and counts."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset: int, window: int, scale: float):
        if q.device.type == "cpu":
            out = flash_attention_plain(q, k, v, q_offset=q_offset, window=window, scale=scale)
        else:
            out = flash_attention_cuda(q, k, v, q_offset=q_offset, window=window, scale=scale)
            LAUNCHES["flash_attention"] += 1
        ctx.save_for_backward(q, k, v)
        ctx.args = (q_offset, window, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        q_offset, window, scale = ctx.args
        dq, dk, dv = flash_attention_ref_vjp(q, k, v, g, q_offset=q_offset, window=window, scale=scale)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_offset: int = 0,
    window: int = 0,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal attention; q (B, Sq, H, D), k/v (B, Sk, KH, D). Differentiable
    on both devices: the forward is K2 (its plain version on the CPU), the
    backward recomputes the plain version under autograd."""
    scale = softmax_scale if softmax_scale is not None else 1.0 / q.shape[-1] ** 0.5
    return _FlashAttention.apply(q, k, v, q_offset, window, scale)


def decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid: torch.Tensor,
    softmax_scale: Optional[float] = None,
    return_partials: bool = False,
):
    """One-token attention; q (B, H, D), k/v (B, S, KH, D), valid (B, S).

    Returns the output in q's dtype, or with ``return_partials`` the fp32
    partials ``(acc (B, H, D), m (B, H), l (B, H))``.
    """
    scale = softmax_scale if softmax_scale is not None else 1.0 / q.shape[-1] ** 0.5
    normalize = not return_partials
    if q.device.type == "cpu":
        out, m, l = decode_attention_plain(q, k, v, valid, scale=scale, normalize=normalize)
    else:
        if valid.dtype == torch.bool:
            valid = valid.to(torch.int32)
        out, m, l = decode_attention_cuda(q, k, v, valid, scale=scale, normalize=normalize)
        LAUNCHES["decode_attention"] += 1
    if return_partials:
        return out, m, l
    return out.to(q.dtype)


def combine_decode_partials(outs, ms, ls):
    """logsumexp-combine flash-decode partials from sequence shards.

    outs: list of (B, H, D) unnormalised; ms/ls: (B, H).
    """
    m_g = torch.stack(ms).amax(dim=0)
    num = 0.0
    den = 0.0
    for o, m, l in zip(outs, ms, ls):
        w = torch.exp(m - m_g)
        num = num + o * w[..., None]
        den = den + l * w
    return num / den.clamp_min(1e-30)[..., None]


class _SsmScan(torch.autograd.Function):
    """K3's forward on the folded layout; the backward is the VJP of its
    plain version under recompute (``ssm_scan_ref_vjp``) from the saved
    folded inputs. ``fold`` and ``unfold`` stay outside, so their padding
    and layout changes carry their own gradients. The final state's
    cotangent is ``None`` when nothing reads it (training), and counts as
    zero. Only the forward launches the kernel and counts."""

    @staticmethod
    def forward(ctx, x, loga, b, c, chunk: int):
        if x.device.type == "cpu":
            y, h = ssm_scan_plain(x, loga, b, c, chunk)
        else:
            y, h = ssm_scan_cuda(x, loga, b, c, chunk)
            LAUNCHES["ssm_scan"] += 1
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, loga, b, c)
        ctx.chunk = chunk
        return y, h

    @staticmethod
    def backward(ctx, gy, gh):
        return (*ssm_scan_ref_vjp(*ctx.saved_tensors, gy, gh, ctx.chunk), None)


def ssm_scan(x, loga, b, c, chunk: int = 256):
    """Chunked SSD scan from a zero state; x (B, S, H, P), loga (B, S, H)
    fp32, b/c (B, S, H, N). Any S: it is padded to a multiple of
    ``min(chunk, S)`` with identity steps (and P and N to multiples of 8
    with zero columns, cut off again). Returns ``(y (B, S, H, P) in
    x's dtype, h (B, H, N, P) fp32)``. Differentiable on both devices:
    the forward is K3 (its plain version on the CPU), the backward
    recomputes the plain version under autograd."""
    batch, seq = x.shape[:2]
    p, n = x.shape[-1], b.shape[-1]
    y, h = _SsmScan.apply(*fold(x, loga, b, c, chunk), chunk)
    return unfold(y, h, batch, seq, p, n)
