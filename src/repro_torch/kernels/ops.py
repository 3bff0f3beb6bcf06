"""Model-layout wrappers around the Hopper kernels.

  flash_attention(q, k, v, ...)     — (B, Sq, H, D) × (B, Sk, KH, D) → (B, Sq, H, D)   (K2)
  decode_attention(q, k, v, valid)  — (B, H, D) one token vs the (B, S, KH, D) cache  (K1)
  combine_decode_partials(...)      — logsumexp combine of K1 partials from shards
  latent_decode_attention(...)      — one token of absorbed MLA vs the latent cache
                                      (plain torch on both devices, no kernel yet)
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

On DTensors (``torch.distributed.tensor``, the sharded train step) each
wrapper runs on every rank's local shard, the same code on both devices:
the batch dim and the head dim keep their sharding, every other dim is
made whole first, and the call runs on ``to_local()`` views. Where q's
heads are split over a mesh dim that k's and v's do not divide
(``KH % tp != 0``), k and v are replicated over it and each rank slices
the kv heads its q heads read; their gradients then sum over that mesh
dim (``Partial``).

Each kernel is also a ``torch.library.custom_op`` (``repro_torch::
decode_attention``, ``flash_attention``, ``ssm_scan``): the op runs the
CPU/CUDA choice above, its ``register_fake`` gives the output shapes, and
``torch.utils.flop_counter`` holds a FLOP formula for the work the kernel
does. A fake tensor (``FakeTensorMode``) or a ``meta`` tensor that reaches
a wrapper therefore launches nothing and runs no plain version: the op's
fake gives its outputs, and the dry-run (``launch/dryrun.py``) counts the
kernels' FLOPs from the formulas.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.decode_attention import decode_attention_cuda, decode_attention_plain
from repro_torch.kernels.flash_attention import (
    flash_attention_cuda,
    flash_attention_plain,
    flash_attention_ref_vjp,
)
from repro_torch.kernels.ssm_scan import fold, ssm_scan_cuda, ssm_scan_plain, ssm_scan_ref_vjp, unfold
from repro_torch.parallel.sharding import from_local, shard_index

LAUNCHES = {"decode_attention": 0, "flash_attention": 0, "ssm_scan": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# The kernels as custom ops: the device choice, the fake, the FLOP formula
# ---------------------------------------------------------------------------


@torch.library.custom_op("repro_torch::decode_attention", mutates_args=(),
                         schema="(Tensor q, Tensor k, Tensor v, Tensor valid, float scale, bool normalize) "
                                "-> (Tensor, Tensor, Tensor)")
def _decode_op(q, k, v, valid, scale, normalize):
    """K1: fp32 ``(out, m, l)``, the plain version on the CPU, else the kernel."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, valid, scale=scale, normalize=normalize)
    if valid.dtype == torch.bool:
        valid = valid.to(torch.int32)
    res = decode_attention_cuda(q, k, v, valid, scale=scale, normalize=normalize)
    LAUNCHES["decode_attention"] += 1
    return res


@_decode_op.register_fake
def _(q, k, v, valid, scale, normalize):
    b, h, d = q.shape
    return (q.new_empty((b, h, d), dtype=torch.float32), q.new_empty((b, h), dtype=torch.float32),
            q.new_empty((b, h), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.decode_attention)
def _decode_flops(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
    """Scores and weighted values over every key of the cache: the kernel
    reads each key and masks the invalid ones (4·D per q head and key)."""
    b, h, d = q_shape
    return 4 * b * h * k_shape[1] * d


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         schema="(Tensor q, Tensor k, Tensor v, int q_offset, int window, float scale) -> Tensor")
def _flash_op(q, k, v, q_offset, window, scale):
    """K2's forward in q's dtype, the plain version on the CPU, else the kernel."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, q_offset=q_offset, window=window, scale=scale)
    out = flash_attention_cuda(q, k, v, q_offset=q_offset, window=window, scale=scale)
    LAUNCHES["flash_attention"] += 1
    return out


@_flash_op.register_fake
def _(q, k, v, q_offset, window, scale):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


def attended_pairs(sq: int, sk: int, q_offset: int = 0, window: int = 0) -> int:
    """The (query, key) pairs a causal row set attends to: query ``i`` at
    position ``i + q_offset`` sees keys ``max(0, p - window + 1) .. min(p,
    sk - 1)``."""
    p = np.arange(sq, dtype=np.int64) + q_offset
    hi = np.minimum(p, sk - 1)
    lo = np.maximum(0, p - window + 1) if window else np.zeros_like(p)
    return int(np.clip(hi - lo + 1, 0, None).sum())


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flops(q_shape, k_shape, v_shape, q_offset, window, *args, out_shape=None, **kwargs) -> int:
    """Scores and weighted values over the pairs the mask keeps (4·D per
    q head and pair; the kernel skips the tiles the mask empties)."""
    b, sq, h, d = q_shape
    return 4 * b * h * d * attended_pairs(sq, k_shape[1], q_offset, window)


@torch.library.custom_op("repro_torch::ssm_scan", mutates_args=(),
                         schema="(Tensor x, Tensor loga, Tensor b, Tensor c, int chunk) -> (Tensor, Tensor)")
def _scan_op(x, loga, b, c, chunk):
    """K3 on the folded layout: ``(y, final h)``, the plain version on the
    CPU, else the kernel."""
    if x.device.type == "cpu":
        return ssm_scan_plain(x, loga, b, c, chunk)
    res = ssm_scan_cuda(x, loga, b, c, chunk)
    LAUNCHES["ssm_scan"] += 1
    return res


@_scan_op.register_fake
def _(x, loga, b, c, chunk):
    bh, s, p = x.shape
    return torch.empty_like(x), x.new_empty((bh, b.shape[-1], p), dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.ssm_scan)
def _scan_flops(x_shape, loga_shape, b_shape, c_shape, chunk, *args, out_shape=None, **kwargs) -> int:
    """Per chunk of L steps: C Bᵀ (2·L²·N), its decay-masked product with
    X (2·L²·P), the carried state's read (2·L·N·P) and update (2·L·N·P)."""
    bh, s, p = x_shape
    n = b_shape[-1]
    L = min(chunk, s)
    return bh * s * (2 * L * (n + p) + 4 * n * p)


class _FlashAttention(torch.autograd.Function):
    """K2's forward; the backward is the VJP of its plain version under
    recompute (``flash_attention_ref_vjp``), as the JAX package's
    ``custom_vjp`` pairs the kernel with its oracle's VJP. Only the forward
    launches the kernel and counts."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset: int, window: int, scale: float):
        out = _flash_op(q, k, v, q_offset, window, scale)
        ctx.save_for_backward(q, k, v)
        ctx.args = (q_offset, window, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        q_offset, window, scale = ctx.args
        dq, dk, dv = flash_attention_ref_vjp(q, k, v, g, q_offset=q_offset, window=window, scale=scale)
        # contiguous, as the inputs were: on DTensors the gradient goes on
        # through views of the projections, which a transposed local
        # gradient cannot take
        return dq.contiguous(), dk.contiguous(), dv.contiguous(), None, None, None


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
    if isinstance(q, DTensor):
        return _on_local_heads(lambda ql, kl, vl: (_FlashAttention.apply(ql, kl, vl, q_offset, window, scale),),
                               q, (k, v), q_head_dim=2)[0]
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
    if isinstance(q, DTensor):
        def local(ql, kl, vl, vall):
            return decode_attention(ql, kl, vl, vall, scale, return_partials=True)

        out, m, l = _on_local_heads(local, q, (k, v), q_head_dim=1, batch_only=(valid,))
        return (out, m, l) if return_partials else (out / l.clamp_min(1e-30)[..., None]).to(q.dtype)
    out, m, l = _decode_op(q, k, v, valid, scale, not return_partials)
    if return_partials:
        return out, m, l
    return out.to(q.dtype)


NEG_INF = -1e30


def _bmm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` batched, products of the inputs' dtype summed and returned
    in fp32: cuBLAS's fp32 output on the card, the inputs widened (exactly)
    on the CPU, which has no such output."""
    if a.dtype == torch.float32 or a.device.type == "cpu":
        return torch.bmm(a.float(), b.float())
    return torch.bmm(a, b, out_dtype=torch.float32)


def latent_decode_attention(q_lat, q_pe, c_kv, k_pe, valid, softmax_scale: float) -> torch.Tensor:
    """One query token of absorbed multi-head latent attention against the
    latent cache. q_lat (B, H, R): each head's no-RoPE query folded through
    its key projection onto the latent; q_pe (B, H, P): its RoPE part;
    c_kv (B, S, R), k_pe (B, S, P): the cache's latent and shared RoPE key;
    valid (B, S). Returns the fp32 softmax-weighted latent (B, H, R).

    Contract as K1's: scores summed in fp32, softmax in fp32 over the valid
    keys, masked probabilities exact zeros, so a row with no valid key gives
    0. Plain cuBLAS ``bmm`` calls and elementwise passes on both devices
    (the probabilities rounded to the cache's dtype for the read-out, as K2
    rounds them): no host sync and no shape that depends on the data, so a
    captured decode step replays it."""
    s = (_bmm32(q_lat, c_kv.transpose(1, 2)) + _bmm32(q_pe, k_pe.transpose(1, 2))) * softmax_scale
    ok = valid.bool()[:, None, :]
    s = torch.where(ok, s, NEG_INF)
    p = torch.where(ok, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    out = _bmm32(p.to(c_kv.dtype), c_kv)
    return out / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)


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
        y, h = _scan_op(x, loga, b, c, chunk)
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
    if isinstance(x, DTensor):
        return _ssm_scan_local(x, loga, b, c, chunk)
    batch, seq = x.shape[:2]
    p, n = x.shape[-1], b.shape[-1]
    y, h = _SsmScan.apply(*fold(x, loga, b, c, chunk), chunk)
    return unfold(y, h, batch, seq, p, n)


# ---------------------------------------------------------------------------
# DTensor inputs: the wrappers above on each rank's local shard
# ---------------------------------------------------------------------------


def _keep(placements, dims) -> list:
    """``placements`` with every placement but ``Shard(d)`` for d in
    ``dims`` made ``Replicate()`` (a ``Partial`` is reduced)."""
    return [pl if isinstance(pl, Shard) and pl.dim in dims else Replicate() for pl in placements]


def _to(x: DTensor, placements) -> DTensor:
    return x if tuple(x.placements) == tuple(placements) else x.redistribute(x.device_mesh, placements)


def _on_local_heads(fn, q: DTensor, kv, q_head_dim: int, batch_only=()):
    """``fn(q_local, *kv_local, *batch_only_local)`` for attention on
    DTensors; q ``(B, ..., H, D)`` with its heads on ``q_head_dim``, each
    of ``kv`` ``(B, S, KH, D)``, each of ``batch_only`` ``(B, ...)``. Every
    output of ``fn`` is laid out as q with its trailing dims after the
    heads dropped or kept (``(B, H, D)`` or ``(B, H)``)."""
    mesh = q.device_mesh
    qpl = _keep(q.placements, (0, q_head_dim))
    h, kh = q.shape[q_head_dim], kv[0].shape[2]
    _, n = shard_index(mesh, qpl, q_head_dim)
    if h % n:  # unevenly split heads: run them whole
        qpl = _keep(qpl, (0,))
        n = 1
    kv_split = n > 1 and kh % n == 0  # the kv heads split as q's do
    kvpl = [Shard(2) if isinstance(pl, Shard) and pl.dim == q_head_dim and kv_split
            else (Shard(0) if pl == Shard(0) else Replicate()) for pl in qpl]
    q = _to(q, qpl)
    ql = q.to_local()
    if n > 1 and not kv_split:
        # each rank reads the kv heads of its own q heads; the gradients of
        # the replicated k and v sum over the mesh dims that split q's heads
        idx, _ = shard_index(mesh, qpl, q_head_dim)
        g, hl = h // kh, h // n
        if hl % g and g % hl:
            raise ValueError(f"DTensor attention: {hl} local q heads of {h} do not pair with {kh} kv heads")
        k0, k1 = idx * hl // g, (idx * hl + hl - 1) // g + 1
        gradpl = [Partial() if isinstance(pl, Shard) and pl.dim == q_head_dim else kvpl[i]
                  for i, pl in enumerate(qpl)]
        kvl = [_to(t, kvpl).to_local(grad_placements=gradpl)[:, :, k0:k1] for t in kv]
    else:
        kvl = [_to(t, kvpl).to_local() for t in kv]
    bpl = [Shard(0) if pl == Shard(0) else Replicate() for pl in qpl]
    other = [_to(t, bpl).to_local() for t in batch_only]
    outs = fn(ql, *kvl, *other)
    res = []
    for o in outs:
        opl = [pl if not (isinstance(pl, Shard) and pl.dim >= o.dim()) else Replicate() for pl in qpl]
        shape = tuple(q.shape[:q_head_dim + 1]) + tuple(o.shape[q_head_dim + 1:])
        # contiguous, as its global stride says: DTensor views the local shard
        res.append(from_local(o.contiguous(), mesh, opl, shape))
    return res


def _ssm_scan_local(x: DTensor, loga, b, c, chunk: int):
    """:func:`ssm_scan` on DTensors: batch (dim 0) and heads (dim 2) keep
    their sharding, the scan runs on each rank's local rows and heads."""
    mesh = x.device_mesh
    pl = _keep(x.placements, (0, 2))
    _, n = shard_index(mesh, pl, 2)
    if x.shape[2] % n:
        pl = _keep(pl, (0,))
    locs = [_to(t, pl).to_local() for t in (x, loga, b, c)]
    y, h = ssm_scan(*locs, chunk)
    hpl = [Shard(1) if p == Shard(2) else p for p in pl]  # h (B, H, N, P)
    B, S, H, P = x.shape
    hshape = (B, H, b.shape[-1], P)
    return from_local(y.contiguous(), mesh, pl, x.shape), from_local(h, mesh, hpl, hshape)
