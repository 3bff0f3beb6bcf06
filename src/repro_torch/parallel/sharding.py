"""Logical-axis sharding rules for the (pod, data, model) mesh.

Port of ``repro/parallel/sharding.py``. Every parameter and activation axis
of the model carries a *logical* axis name (``ParamDef.axes``); this module
maps logical names to physical mesh axes. The mapping adapts to the mesh
(single-pod ``(data, model)``, multi-pod ``(pod, data, model)``), and with
no rules every constraint is the identity, as the JAX package's are off-mesh.

Logical axes
------------
``batch``    data-parallel batch → all DP axes ("pod","data")
``fsdp``     parameter shard axis for ZeRO-3 → all DP axes (or None w/o FSDP)
``tp``       tensor-parallel → "model"
``sp``       sequence-parallel activations → "model"
``expert``   MoE expert-parallel → "model" when divisible, else None
``kv_seq``   decode KV-cache sequence shards → "model" (flash-decode)
``null``     explicit replication

A spec is a :class:`PartitionSpec`, one entry per tensor dim: ``None``, one
mesh axis name, or a tuple of several. On ``torch.distributed.tensor`` it
becomes one placement per mesh dim (:func:`placements`): ``Shard(dim)`` for
the tensor dim that uses the mesh dim, else ``Replicate()``. A tensor dim
split over two mesh dims is split in mesh-dim order, so such an entry must
name its axes in the mesh's order (JAX splits major to minor in the entry's
order; the two agree only then, and :func:`placements` asserts it).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import torch


class PartitionSpec(tuple):
    """A tuple of per-dim mesh axes, written as the JAX package's
    ``PartitionSpec`` iterates: an entry naming one mesh axis is the bare
    name, ``("data",)`` becomes ``"data"``."""

    def __new__(cls, *entries):
        norm = []
        for e in entries:
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                e = e[0] if len(e) == 1 else (e or None)
            norm.append(e)
        return super().__new__(cls, norm)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class Axes:
    """Physical mesh-axis names, in order."""

    names: tuple[str, ...]

    @property
    def dp(self) -> tuple[str, ...]:
        return tuple(a for a in self.names if a in ("pod", "data"))

    @property
    def has_model(self) -> bool:
        return "model" in self.names


@dataclass(frozen=True)
class ShardingRules:
    """Logical→physical mapping, derived from the mesh + run flags. ``mesh``
    is the ``DeviceMesh`` the rules came from (:func:`rules_from_mesh`), or
    None; it takes no part in equality."""

    mesh_axes: tuple[str, ...]
    mesh_shape: tuple[int, ...]
    fsdp: bool = True
    sequence_parallel: bool = True
    mesh: Any = field(default=None, compare=False, repr=False)

    # ------------------------------------------------------------------
    def axis_size(self, name: str) -> int:
        if name not in self.mesh_axes:
            return 1
        return self.mesh_shape[self.mesh_axes.index(name)]

    @property
    def dp_axes(self) -> tuple[str, ...]:
        return tuple(a for a in self.mesh_axes if a in ("pod", "data"))

    @property
    def dp_size(self) -> int:
        s = 1
        for a in self.dp_axes:
            s *= self.axis_size(a)
        return s

    @property
    def tp_size(self) -> int:
        return self.axis_size("model")

    # ------------------------------------------------------------------
    def resolve(self, logical: Optional[str], dim_size: Optional[int] = None):
        """Map one logical axis name to a physical axis (or None). A dim of
        size 1 is never split: where the JAX package names a mesh axis of
        one device for it (which splits nothing), the port replicates, since
        DTensor refuses to fold a sharded dim of size 1 into a view (a
        prompt of batch 1, a decode step's one token on a (1, 1) mesh)."""
        if logical is None or logical == "null" or dim_size == 1:
            return None
        if logical == "batch":
            if not self.dp_axes:
                return None
            if dim_size is not None and dim_size % self.dp_size != 0:
                return None  # e.g. global_batch=1 long-context decode
            return self.dp_axes
        if logical == "fsdp":
            if not self.fsdp or not self.dp_axes:
                return None
            if dim_size is not None and dim_size % self.dp_size != 0:
                return None  # indivisible → replicate rather than crash
            return self.dp_axes
        if logical in ("tp", "sp", "expert", "kv_seq", "moe_tp"):
            if logical == "sp" and not self.sequence_parallel:
                return None
            if "model" not in self.mesh_axes:
                return None
            if dim_size is not None and dim_size % self.tp_size != 0:
                return None
            return "model"
        raise ValueError(f"unknown logical axis {logical!r}")

    def spec(self, logical_axes: Sequence[Optional[str]], shape: Optional[Sequence[int]] = None) -> PartitionSpec:
        """A PartitionSpec from per-dimension logical names.

        With ``shape``, a logical axis whose physical axis size does not
        divide the dimension is dropped (replicated): Mixtral's 8 experts on
        a 16-way model axis replicate the expert dim and shard in-expert."""
        phys = []
        for i, name in enumerate(logical_axes):
            dim = None if shape is None else shape[i]
            phys.append(self.resolve(name, dim))
        # a mesh axis shards at most one dim: the first use wins
        used: set[str] = set()
        out = []
        for p in phys:
            axes = (p,) if isinstance(p, str) else tuple(p or ())
            if any(a in used for a in axes):
                out.append(None)
                continue
            used.update(axes)
            out.append(p)
        return PartitionSpec(*out)


def rules_from_mesh(mesh, fsdp: bool = True, sequence_parallel: bool = True) -> ShardingRules:
    """The rules of a ``torch.distributed.device_mesh.DeviceMesh`` with named dims."""
    return ShardingRules(
        mesh_axes=tuple(mesh.mesh_dim_names),
        mesh_shape=tuple(mesh.shape),
        fsdp=fsdp,
        sequence_parallel=sequence_parallel,
        mesh=mesh,
    )


def logical_spec(rules: Optional[ShardingRules], logical_axes, shape=None) -> PartitionSpec:
    if rules is None:
        return PartitionSpec()
    return rules.spec(logical_axes, shape)


def spec_placements(mesh, spec: PartitionSpec) -> list:
    """One ``Shard(dim)`` or ``Replicate()`` per dim of ``mesh`` for ``spec``."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        idx = [names.index(a) for a in axes]
        # DTensor splits a dim over several mesh dims in mesh-dim order
        assert idx == sorted(idx), f"spec entry {entry!r} is not in the mesh's axis order {names}"
        for i in idx:
            out[i] = Shard(dim)
    return out


def placements(mesh, rules: ShardingRules, logical_axes, shape) -> list:
    """The placements of a tensor of ``shape`` with ``logical_axes`` on
    ``mesh``: the JAX package's ``named_sharding`` on DTensor."""
    return spec_placements(mesh, rules.spec(logical_axes, shape))


def sharded_context(rules: Optional[ShardingRules]):
    """Inside a sharded step (``rules`` given), plain tensors made there
    (positions, masks, the schedule's scalars) count as replicated
    DTensors; without rules, nothing changes."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    # implicit_replication() clears the flag on exit, so it is entered only
    # by the outermost of nested sharded contexts
    if rules is None or getattr(DTensor._op_dispatcher, "_allow_implicit_replication", False):
        return contextlib.nullcontext()
    return implicit_replication()


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def shard_constraint(x, rules: Optional[ShardingRules], logical_axes):
    """Lay ``x`` out as ``logical_axes`` say: ``redistribute`` for a
    DTensor, the identity for a plain tensor or without rules. As JAX's
    constraint binds the cotangent too, the gradient leaves the site laid
    out as ``x`` came in."""
    if rules is None or not isinstance(x, torch.Tensor) or not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, placements(x.device_mesh, rules, logical_axes, tuple(x.shape)))


def gather_sequence(x, rules: Optional[ShardingRules]):
    """``x`` (B, S, ...) laid out with only its batch sharded: the input of
    a projection. The sequence-parallel layout (``("batch", "sp", None)``,
    between blocks) cannot enter ``x @ W`` on DTensor as it stands: the
    matmul folds (B, S) into rows, a view that DTensor (PyTorch 2.11)
    refuses across a sharded S."""
    return shard_constraint(x, rules, ("batch",) + (None,) * (x.dim() - 1))


def split_heads(x, n_heads: int):
    """``x`` (..., n_heads * hd) viewed as (..., n_heads, hd). On a DTensor
    whose last dim is cut into more pieces than divide ``n_heads`` (xlstm's
    4 heads on a 16-way ``model`` axis), that dim is made whole first: no
    head is cut between ranks."""
    if is_dtensor(x):
        last = x.dim() - 1
        _, n = shard_index(x.device_mesh, x.placements, last)
        if n_heads % n:
            from torch.distributed.tensor import Replicate

            x = x.redistribute(x.device_mesh, [Replicate() if pl.is_shard(last) else pl for pl in x.placements])
    return x.view(*x.shape[:-1], n_heads, x.shape[-1] // n_heads)


def pin(x):
    """``x`` unchanged; on a DTensor, its gradient is laid out as ``x``
    before it flows on. Put after a view whose backward view DTensor can
    split only from ``x``'s layout (a flattened weight's heads)."""
    if not isinstance(x, torch.Tensor) or not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, x.placements)


def elementwise(fn, x):
    """``fn(x)`` for an elementwise ``fn``, on each rank's own shard where
    ``x`` is a DTensor (laid out as ``x``; a partial sum is reduced first):
    for elementwise ops that DTensor has no sharding rule for, such as
    ``log_sigmoid``'s forward and backward."""
    if not isinstance(x, torch.Tensor) or not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import DTensor

    x = settle(x)
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, x.placements, run_check=False, shape=x.shape,
                              stride=x.stride())


def settle(x):
    """``x`` with its partial sums reduced (a DTensor's ``Partial``
    placements made ``Replicate``): before an elementwise op with a tensor
    laid out otherwise, which PyTorch 2.11's DTensor would meet by turning
    that tensor partial, a redistribution it does not have."""
    if not isinstance(x, torch.Tensor) or not is_dtensor(x) or not any(pl.is_partial() for pl in x.placements):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [Replicate() if pl.is_partial() else pl for pl in x.placements])


def replicate(x):
    """``x`` replicated over its mesh where it is a DTensor, else ``x``: the
    layout change around an op that DTensor has no sharding rule for."""
    if not isinstance(x, torch.Tensor) or not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def whole(x):
    """The whole of ``x`` as a plain tensor on every rank (``x`` itself
    where it is plain): for ops with no DTensor sharding rule."""
    return replicate(x).to_local() if isinstance(x, torch.Tensor) and is_dtensor(x) else x


def shard_index(mesh, placements, dim: int) -> tuple[int, int]:
    """(this rank's shard index along tensor dim ``dim``, number of
    shards): the mesh dims whose placement is ``Shard(dim)``, in mesh-dim
    order."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    idx, n = 0, 1
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            idx, n = idx * mesh.size(i) + coord[i], n * mesh.size(i)
    return idx, n


def local_range(size: int, mesh, placements, dim: int) -> tuple[int, int]:
    """(start, length) of this rank's piece of a tensor dim of ``size``
    laid out by ``placements``: ``torch.chunk``'s cut, as DTensor's."""
    idx, n = shard_index(mesh, placements, dim)
    step = -(-size // n)
    start = min(idx * step, size)
    return start, min(step, size - start)


def from_local(local: torch.Tensor, mesh, placements, shape):
    """``local`` as this rank's shard of a DTensor of global ``shape``,
    contiguous, with no communication."""
    from torch.distributed.tensor import DTensor

    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=torch.Size(shape),
                              stride=tuple(reversed(stride)))


class _AllReduce(torch.autograd.Function):
    """``t`` reduced by ``op`` over the groups of the mesh dims ``dims``, in
    turn. The gradient passes unchanged: every rank holds the reduced value
    and, after it, the whole of its gradient (the replicated convention of
    DTensor's own redistributions), which is each rank's term's gradient."""

    @staticmethod
    def forward(ctx, t, mesh, dims, op):
        from torch.distributed import _functional_collectives as funcol

        for dim in dims:
            t = funcol.all_reduce(t, op, (mesh, dim))
            t = t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t
        return t

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None, None


def partial_reduce(t: torch.Tensor, mesh, dims: Sequence[str], op: str = "sum") -> torch.Tensor:
    """The plain tensor ``t``, each rank's term of a sum (``op`` "sum"), a
    mean ("mean", of equal terms' counts) or a max ("max", no gradient) over
    the mesh dims named ``dims``, reduced: every rank of those dims gets the
    result. The gradient of each rank's term is the result's gradient
    (times 1/n for a mean of n terms)."""
    idx = [tuple(mesh.mesh_dim_names).index(name) for name in dims]
    if not idx:
        return t
    out = _AllReduce.apply(t, mesh, idx, "max" if op == "max" else "sum")
    if op == "mean":
        n = 1
        for i in idx:
            n *= mesh.size(i)
        out = out / n
    return out


def local_map(fn, *args, out, grads=None):
    """``fn`` on each rank's own shards, with no communication in or out.
    Each DTensor of ``args`` is passed as its local tensor (``to_local``),
    its gradient laid out as the DTensor or as ``grads[i]`` where that is
    given (``Partial`` over the mesh dims where each rank uses a replicated
    argument for its own rows only: its gradient there is a term of the
    whole); any other argument as it is. ``out`` states each of ``fn``'s
    results: ``(placements, global shape)`` makes it a DTensor of this
    rank's shard (``from_local``, contiguous), ``"replicate"`` a DTensor
    replicated on the mesh (a scalar ``fn`` reduced with
    :func:`partial_reduce`). DTensor lowers no op of ``fn``: no view of a
    sharded dim, which PyTorch 2.11's DTensor refuses, can arise."""
    from torch.distributed.tensor import Replicate

    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    grads = grads or [None] * len(args)
    local = [a.to_local(grad_placements=g) if is_dtensor(a) else a for a, g in zip(args, grads)]
    res = fn(*local)
    single = not isinstance(res, tuple)
    res = (res,) if single else res
    assert len(res) == len(out), f"local_map: {len(res)} results, {len(out)} layouts"
    placed = tuple(
        from_local(r, mesh, [Replicate()] * mesh.ndim, r.shape) if spec == "replicate"
        else from_local(r, mesh, spec[0], spec[1]) for r, spec in zip(res, out))
    return placed[0] if single else placed


def gather_over(t: torch.Tensor, mesh, name: str, dim: int, size: int) -> torch.Tensor:
    """The plain tensor ``t``, this rank's piece along ``dim`` (as
    :func:`split_over` cuts it) of a tensor of length ``size`` there that
    every rank of mesh dim ``name`` needs whole: the whole, all-gathered
    over that dim. Its gradient, whole and the same on every rank of the
    dim, comes back as this rank's piece."""
    from torch.distributed.tensor import Replicate, Shard

    sub = mesh[name]
    shape = list(t.shape)
    shape[dim] = size
    return from_local(t, sub, [Shard(dim)], shape).redistribute(sub, [Replicate()]).to_local()


def split_over(t: torch.Tensor, mesh, name: str, dim: int) -> torch.Tensor:
    """This rank's piece along ``dim`` over mesh dim ``name`` (as
    ``torch.chunk`` cuts it) of the plain tensor ``t``, which every rank of
    that dim holds whole and the same; no communication. The pieces'
    gradients are gathered: ``t``'s gradient comes back whole and the same
    on every rank of the dim."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    sub = mesh[name]
    return DTensor.from_local(t, sub, [Replicate()], run_check=False).redistribute(sub, [Shard(dim)]).to_local()


def placed_full(shape, fill: float, dtype, device, mesh, spec: PartitionSpec):
    """A DTensor of ``shape`` laid out by ``spec`` whose every element is
    ``fill``: each rank makes only its own piece (no communication, and no
    whole tensor anywhere), as the cache and the dry-run's stand-ins are
    made."""
    pls = spec_placements(mesh, spec)
    local = [local_range(n, mesh, pls, d)[1] for d, n in enumerate(shape)]
    return from_local(torch.full(local, fill, dtype=dtype, device=device), mesh, pls, shape)
