"""Cross-device flash-decode: the KV cache sharded by sequence over ``model``.

Port of ``repro/parallel/flash_decode.py``. Each rank runs K1
(``kernels/ops.py::decode_attention`` with ``return_partials``: the CUDA
kernel on the card, its plain version on the CPU) over its local slice of
the cache, giving unnormalised partials ``(acc, m, l)``; the combine is a
logsumexp reduction over the ``axis`` group: an all-reduce MAX of the
running max, then SUMs of the rescaled numerator and denominator, three
small collectives of (B, H[, D]) instead of gathering the cache.
``ops.combine_decode_partials`` is the same combine in one process.

A row with no valid key gives exact zeros on the kernel path (K1's
contract: ``m = -1e30``, ``l = 0``, and a shard without a valid key weighs
nothing in the combine). ``use_kernel=False`` computes the JAX package's
jnp partials, which do not zero masked probabilities: an all-invalid row
spreads uniformly over the whole sequence there, as the reference's
``decode_attention_ref`` does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.kernels import ops
from repro_torch.parallel.sharding import from_local


def _placed(t: torch.Tensor, mesh, placements):
    """``t`` as a DTensor laid out as ``placements`` (a plain tensor is the
    same whole tensor on every rank)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(t, DTensor):
        return t if tuple(t.placements) == tuple(placements) else t.redistribute(mesh, placements)
    return distribute_tensor(t, mesh, placements)


def _jnp_partials(q, k, v, valid):
    """The reference's partials without the kernel: masked scores at -1e30,
    probabilities not zeroed."""
    b, h, d = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, kh, h // kh, d).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k.float()) / (d**0.5)
    s = torch.where(valid.bool()[:, None, None, :], s, -1e30)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    out = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    return out.reshape(b, h, d), m.reshape(b, h), p.sum(-1).reshape(b, h)


def sharded_decode_attention(
    q: torch.Tensor,  # (B, H, D), replicated over ``axis``
    k: torch.Tensor,  # (B, S, KH, D), S sharded over ``axis``
    v: torch.Tensor,
    valid: torch.Tensor,  # (B, S) bool
    mesh,
    axis: str = "model",
    batch_axes: Optional[tuple[str, ...]] = ("data",),
    use_kernel: bool = True,
):
    """Exact attention over a sequence-sharded KV cache. Inputs are
    DTensors on ``mesh`` (redistributed to the layout above where they
    differ) or plain whole tensors, the same on every rank. The batch is
    sharded over ``batch_axes`` when every one of them is in the mesh.
    Returns a DTensor (B, H, D) in q's dtype, replicated over ``axis``."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    bdims = batch_axes if batch_axes and all(a in names for a in batch_axes) else ()
    n = mesh.size(names.index(axis))
    seq = k.shape[1]
    if seq % n:
        raise ValueError(f"sharded_decode_attention: sequence {seq} does not divide over {n} {axis!r} shards")

    def layout(seq_dim: Optional[int]):
        return [Shard(0) if a in bdims else (Shard(seq_dim) if a == axis and seq_dim is not None else Replicate())
                for a in names]

    ql = _placed(q, mesh, layout(None)).to_local()
    kl, vl = (_placed(t, mesh, layout(1)).to_local() for t in (k, v))
    validl = _placed(valid, mesh, layout(1)).to_local()
    if use_kernel:
        out, m, l = ops.decode_attention(ql, kl, vl, validl, return_partials=True)
    else:
        out, m, l = _jnp_partials(ql, kl, vl, validl)
    # logsumexp combine across the sequence shards
    group = mesh.get_group(axis)
    m_g = m.clone()
    dist.all_reduce(m_g, op=dist.ReduceOp.MAX, group=group)
    w = torch.exp(m - m_g)
    num = out * w[..., None]
    den = l * w
    dist.all_reduce(num, op=dist.ReduceOp.SUM, group=group)
    dist.all_reduce(den, op=dist.ReduceOp.SUM, group=group)
    res = (num / den.clamp_min(1e-30)[..., None]).to(q.dtype)
    return from_local(res, mesh, layout(None), q.shape)
