"""Mesh construction on ``torch.distributed.device_mesh``.

Port of ``repro/launch/mesh.py``. Each function builds a ``DeviceMesh``
with ``init_device_mesh`` over the ranks of the default process group
(``torch.distributed.init_process_group`` comes first; it needs the
address, world size and rank from the caller). The device is ``"cuda"``
unless the caller asks for ``"cpu"`` (the gloo tests): without a card a
CUDA mesh raises, never turns into a CPU one, except over a fake process
group (``launch/dryrun.py``), whose CUDA devices hold fake tensors only
and need no card. The JAX package's
``TPU_PERF_FLAGS`` are XLA flags for a TPU and stay there.
"""

from __future__ import annotations

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
