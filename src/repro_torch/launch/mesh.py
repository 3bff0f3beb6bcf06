"""Mesh construction on ``torch.distributed.device_mesh``, and the ranks.

Port of ``repro/launch/mesh.py``. Each function builds a ``DeviceMesh``
with ``init_device_mesh`` over the ranks of the default process group
(``torch.distributed.init_process_group`` comes first; it needs the
address, world size and rank from the caller). The device is ``"cuda"``
unless the caller asks for ``"cpu"`` (the gloo tests): without a card a
CUDA mesh raises, never turns into a CPU one, except over a fake process
group (``launch/dryrun.py``), whose CUDA devices hold fake tensors only
and need no card. The JAX package's
``TPU_PERF_FLAGS`` are XLA flags for a TPU and stay there.

A JAX process sees every device of its host; a PyTorch process drives one
card. :func:`spawn_ranks` starts one process per rank with
``torch.multiprocessing``, and :func:`init_rank` joins each to the group:
under NCCL, rank r binds card r (``torch.cuda.set_device``) before
``init_process_group`` and before any mesh, or every rank lands on card 0
and NCCL refuses the duplicate GPU. Under NCCL both raise where the host
has fewer cards than ranks: nothing carries on with fewer ranks or on the
CPU.
"""

from __future__ import annotations

from datetime import timedelta

import torch

DEFAULT_AXES = {1: ("model",), 2: ("data", "model"), 3: ("pod", "data", "model")}


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...] | None = None, device: str = "cuda"):
    """A mesh of ``shape`` named ``axes`` (by rank: ``("model",)``,
    ``("data", "model")``, ``("pod", "data", "model")`` when None)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = tuple(int(s) for s in shape)
    if axes is None:
        axes = DEFAULT_AXES[len(shape)]
    if len(axes) != len(shape):
        raise ValueError(f"make_mesh: {len(shape)} dims {shape} but axes {axes}")
    if device == "cuda" and not torch.cuda.is_available() and _backend() != "fake":
        raise RuntimeError("make_mesh: no CUDA device; pass device='cpu' for a CPU (gloo) mesh")
    return init_device_mesh(device, shape, mesh_dim_names=tuple(axes))


def _backend() -> str | None:
    import torch.distributed as dist

    return dist.get_backend() if dist.is_initialized() else None


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """The production mesh: 16×16 per pod, 2 pods multi-pod."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"), device)
    return make_mesh((16, 16), ("data", "model"), device)


def parse_mesh_arg(arg: str, device: str = "cuda"):
    """'16x16' → single-pod-style mesh; '2x16x16' → multi-pod-style."""
    return make_mesh(tuple(int(x) for x in arg.lower().split("x")), device=device)


def require_cards(n: int) -> None:
    """Raise unless this host has at least ``n`` CUDA devices."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise RuntimeError(f"{n} NCCL ranks need {n} CUDA devices, one a rank; this host has {have}")


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_rank(rank: int, world_size: int, init_method: str, backend: str = "nccl", timeout_s: float = 300.0) -> None:
    """Join the default process group as ``rank`` of ``world_size``. Under
    NCCL the rank binds card ``rank`` first, and the group is given it as
    its ``device_id``; gloo ranks stay on the CPU."""
    import torch.distributed as dist

    kwargs = {}
    if backend == "nccl":
        require_cards(world_size)
        torch.cuda.set_device(rank)
        kwargs["device_id"] = torch.device("cuda", rank)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                            timeout=timedelta(seconds=timeout_s), **kwargs)


def _rank_entry(rank: int, fn, world_size: int, init_method: str, backend: str, timeout_s: float, args) -> None:
    import torch.distributed as dist

    init_rank(rank, world_size, init_method, backend, timeout_s)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world_size: int, args=(), backend: str = "nccl", init_method: str | None = None,
                timeout_s: float = 300.0) -> None:
    """Run ``fn(rank, *args)`` in ``world_size`` processes, each joined to
    one process group (:func:`init_rank`; rendezvous at ``init_method``, a
    ``file://`` path or, by default, a free TCP port on localhost), and
    wait for all of them. ``fn`` must be picklable (a module-level
    function). A rank that raises ends the others, and this raises."""
    import torch.multiprocessing as mp

    if backend == "nccl":
        require_cards(world_size)
    init_method = init_method or f"tcp://localhost:{free_port()}"
    mp.spawn(_rank_entry, args=(fn, world_size, init_method, backend, timeout_s, tuple(args)), nprocs=world_size,
             join=True)
