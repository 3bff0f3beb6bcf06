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

On DTensors (``torch.distributed.tensor``, the sharded train step) each
wrapper runs on every rank's local shard, the same code on both devices:
the batch dim and the head dim keep their sharding, every other dim is
made whole first, and the call runs on ``to_local()`` views. Where q's
heads are split over a mesh dim that k's and v's do not divide
(``KH % tp != 0``), k and v are replicated over it and each rank slices
the kv heads its q heads read; their gradients then sum over that mesh
dim (``Partial``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

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


def _shard_index(mesh, placements, dim: int) -> tuple[int, int]:
    """(this rank's shard index along tensor dim ``dim``, number of
    shards): the mesh dims that split it, in mesh-dim order."""
    coord = mesh.get_coordinate()
    idx, n = 0, 1
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            idx, n = idx * mesh.size(i) + coord[i], n * mesh.size(i)
    return idx, n


def _on_local_heads(fn, q: DTensor, kv, q_head_dim: int, batch_only=()):
    """``fn(q_local, *kv_local, *batch_only_local)`` for attention on
    DTensors; q ``(B, ..., H, D)`` with its heads on ``q_head_dim``, each
    of ``kv`` ``(B, S, KH, D)``, each of ``batch_only`` ``(B, ...)``. Every
    output of ``fn`` is laid out as q with its trailing dims after the
    heads dropped or kept (``(B, H, D)`` or ``(B, H)``)."""
    mesh = q.device_mesh
    qpl = _keep(q.placements, (0, q_head_dim))
    h, kh = q.shape[q_head_dim], kv[0].shape[2]
    _, n = _shard_index(mesh, qpl, q_head_dim)
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
        idx, _ = _shard_index(mesh, qpl, q_head_dim)
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
        res.append(DTensor.from_local(o.contiguous(), mesh, opl, run_check=False, shape=torch.Size(shape),
                                      stride=_contiguous_stride(shape)))
    return res


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for s in reversed(shape):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def _ssm_scan_local(x: DTensor, loga, b, c, chunk: int):
    """:func:`ssm_scan` on DTensors: batch (dim 0) and heads (dim 2) keep
    their sharding, the scan runs on each rank's local rows and heads."""
    mesh = x.device_mesh
    pl = _keep(x.placements, (0, 2))
    _, n = _shard_index(mesh, pl, 2)
    if x.shape[2] % n:
        pl = _keep(pl, (0,))
    locs = [_to(t, pl).to_local() for t in (x, loga, b, c)]
    y, h = ssm_scan(*locs, chunk)
    hpl = [Shard(1) if p == Shard(2) else p for p in pl]  # h (B, H, N, P)
    B, S, H, P = x.shape
    hshape = (B, H, b.shape[-1], P)
    y = DTensor.from_local(y.contiguous(), mesh, pl, run_check=False, shape=x.shape, stride=_contiguous_stride(x.shape))
    h = DTensor.from_local(h, mesh, hpl, run_check=False, shape=torch.Size(hshape), stride=_contiguous_stride(hshape))
    return y, h
