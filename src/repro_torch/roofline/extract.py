"""Roofline terms of one (arch × shape × mesh) cell, counted on fake tensors.

Port of ``repro/roofline/extract.py``. The reference reads XLA's
``cost_analysis()``, ``memory_analysis()`` and the partitioned HLO text of
a compiled step. PyTorch compiles nothing here, so the port counts one
eager run of the step (``launch/dryrun.py``) on ``meta`` tensors (shapes
and dtypes, no memory and no values) over a fake process group, with
DTensor parameters, optimizer state, cache and inputs laid out by the
sharding rules:

  * **FLOPs per device**: :class:`StepCounter` sees every op one device
    runs on its local shards and sums ``torch.utils.flop_counter``'s
    formulas (matmuls, batched matmuls, and the kernels K1, K2, K3, whose
    formulas ``kernels/ops.py`` registers). ``FlopCounterMode`` itself
    counts an op on DTensors once, at its global shape (2·1024·4096·8192
    for a ``(1024, 4096) @ (4096, 8192)`` sharded over a (8, 8) mesh), so
    the counter lets DTensor lower each op first (it returns
    ``NotImplemented`` for DTensor arguments) and counts the local ops:
    the numbers are per device, not global.
  * **Collective bytes per class**, per device: the payload of each
    collective the device issues (functional collectives, DTensor's
    all-to-all, ``torch.distributed``'s in-place ones), the result's bytes,
    except that a reduce-scatter or an all-reduce counts its operand (as
    the reference counts a reduce-scatter's operand).
  * **Bytes accessed, unfused**: each local op's tensor inputs and outputs
    (views and allocations move nothing and are skipped): the pessimistic
    side of the reference's bracket. :func:`analytic_hbm_bytes` is the
    optimistic side, as in the reference.
  * **Peak bytes per device**: ``torch.distributed._tools.mem_tracker.
    MemTracker`` over the same run, the arguments' local shards counted
    from the start.

DTensor derives each op's output metadata by running the op once more on
global-shape tensors under a ``FakeTensorMode``. The step's own tensors
are ``meta`` tensors under no fake mode, so the counter and the memory
tracker skip every op that runs under a fake mode: that work is no
device's.

The eager run sees every iteration of every loop, so, unlike the
reference's probes, nothing is counted once per scan body: no layer, chunk
or microbatch is missing, and :func:`slstm_correction_flops` (which adds
the sLSTM time steps the reference's probes count once) is *not* added to
counted FLOPs. It is kept for the reference's analytic check.
:func:`extrapolate_probes` is kept too, for another reason: the sLSTM
time loop at S = 4096 or 32768 runs tens of thousands of small ops per
block under DTensor dispatch, minutes per cell. The dry-run therefore runs
an xLSTM cell twice with each sLSTM loop cut to 1 and to 2 real steps (the
rest of the loop hands the carry on unchanged, so every shape stays) and
extrapolates linearly to S steps: every step costs the same, so the
extrapolation is exact for FLOPs, bytes and collectives, and an estimate
for the peak. The reference's 1- and 2-period depth probes are not needed:
an eager run counts every layer, and depth is not what costs time.

MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE) for training and 2·N·D
for inference, N excluding the embedding gather (the lm_head matmul IS
included; for tied embeddings the table is counted once, as the head).

The roofline terms read the H100's nameplate peaks
(``configs/hadoop_cluster.py``): they are predictions derived from the
data sheet, never measurements.
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.configs.hadoop_cluster import H100_HBM_BPS, H100_NVLINK_BPS, H100_PEAK_FLOPS_BF16

_COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# op → (class, whose bytes are the payload: the result "out" or the operand "in")
_COLLECTIVE_OPS = {
    "_c10d_functional.all_gather_into_tensor": ("all-gather", "out"),
    "_c10d_functional.all_gather_into_tensor_coalesced": ("all-gather", "out"),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", "in"),
    "_c10d_functional.reduce_scatter_tensor_coalesced": ("reduce-scatter", "in"),
    "_c10d_functional.all_reduce": ("all-reduce", "in"),
    "_c10d_functional.all_reduce_": ("all-reduce", "in"),
    "_c10d_functional.all_reduce_coalesced": ("all-reduce", "in"),
    "_c10d_functional.all_to_all_single": ("all-to-all", "in"),
    "_c10d_functional_autograd.all_to_all_single": ("all-to-all", "in"),
    "_dtensor.shard_dim_alltoall": ("all-to-all", "in"),
    "_c10d_functional.broadcast": ("broadcast", "in"),
    "c10d.allreduce_": ("all-reduce", "in"),
    "c10d.allgather_": ("all-gather", "in"),
    "c10d._allgather_base_": ("all-gather", "out"),
    "c10d.reduce_scatter_": ("reduce-scatter", "in"),
    "c10d._reduce_scatter_base_": ("reduce-scatter", "in"),
    "c10d.alltoall_base_": ("all-to-all", "in"),
    "c10d.broadcast_": ("broadcast", "in"),
}
# ops that move no bytes of their own
_NO_TRAFFIC = {
    "_c10d_functional.wait_tensor", "aten.empty", "aten.empty_strided", "aten.empty_like", "aten.new_empty",
    "aten.new_empty_strided", "aten.detach", "aten.lift_fresh", "aten.alias", "prim.device", "aten._local_scalar_dense",
}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor))


def _is_view(func) -> bool:
    """The op returns a view of an input (an alias that it does not write)."""
    return any(r.alias_info is not None and not r.alias_info.is_write for r in func._schema.returns)


def _in_fake_mode() -> bool:
    """A ``FakeTensorMode`` is active: DTensor's metadata run."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    return any(isinstance(m, FakeTensorMode) for m in _get_current_dispatch_mode_stack())


class StepCounter(TorchDispatchMode):
    """FLOPs, unfused bytes and collective payload bytes of the ops one
    device runs, per device (see the module docstring)."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives: dict[str, float] = dict.fromkeys(_COLLECTIVES, 0.0)
        self.counts: dict[str, int] = dict.fromkeys(_COLLECTIVES, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor lowers it to local ops, which come back here
        kwargs = kwargs or {}
        own = not _in_fake_mode()
        out = func(*args, **kwargs)
        if own:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = str(func._overloadpacket)
        if name in _COLLECTIVE_OPS:
            cls, side = _COLLECTIVE_OPS[name]
            payload = _nbytes(out if side == "out" else args[0])
            self.collectives[cls] = self.collectives.get(cls, 0.0) + payload
            self.counts[cls] = self.counts.get(cls, 0) + 1
            return
        if func._overloadpacket in flop_registry:
            self.flops += flop_registry[func._overloadpacket](*args, **kwargs, out_val=out)
        if name not in _NO_TRAFFIC and not _is_view(func):
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)


def _mem_tracker():
    """``MemTracker``, its bookkeeping skipped for DTensor's metadata run
    (whichever PyTorch release it comes from)."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class LocalMemTracker(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if _in_fake_mode():
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return LocalMemTracker()


def count_step(fn, args) -> dict:
    """Run ``fn(*args)`` once on its ``meta`` DTensor arguments and
    return its per-device ``flops``, ``bytes``, ``collectives`` (payload
    bytes per class), ``n_collectives`` and ``peak_bytes`` (the arguments'
    local shards included)."""
    from repro_torch.models.common import tree_leaves

    mem, counter = _mem_tracker(), StepCounter()
    mem.track_external(*tree_leaves(args))
    with mem, counter:
        fn(*args)
    peak = max(v["Total"] for v in mem.get_tracker_snapshot("peak").values())
    return {"flops": float(counter.flops), "bytes": float(counter.bytes), "collectives": dict(counter.collectives),
            "n_collectives": dict(counter.counts), "peak_bytes": float(peak)}


def _iter_defs(tree, path=()):
    from repro_torch.models.common import is_def

    if is_def(tree):
        yield path, tree
        return
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        yield from _iter_defs(v, path + (k,))


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6·N_active·D (2·N_active·D for inference), N excluding the embedding gather."""
    from repro_torch.models.model import model_defs

    n = 0
    for path, leaf in _iter_defs(model_defs(cfg)):
        if path[0] == "embed" and not cfg.tie_embeddings:
            continue
        size = math.prod(leaf.shape)
        if "moe" in path and path[-1] in ("gate", "up", "down"):
            size = size * cfg.experts_per_token // cfg.num_experts
        n += size
    d = shape.tokens_per_step
    mult = 6.0 if shape.kind == "train" else 2.0  # fwd-only for inference
    return mult * n * d


# a device sends a collective's payload over its NVLink ports at most at
# half the nameplate figure, which counts both directions
LINK_BPS = H100_NVLINK_BPS / 2


def roofline_terms(hlo_flops: float, hlo_bytes: float, coll_bytes_per_dev: float, n_devices: int) -> dict[str, float]:
    """The three terms, in seconds, from per-device FLOPs and bytes over the
    H100's nameplate peaks: ``H100_PEAK_FLOPS_BF16`` (dense bf16),
    ``H100_HBM_BPS``, and for collectives :data:`LINK_BPS`:
    ``H100_NVLINK_BPS`` is 900e9 bytes/s summed over both directions of a
    card's NVLink ports, so a device sends (or receives) its payload at
    450e9 bytes/s at most. That is the rate inside one 8-card host; a mesh
    wider than a host crosses slower links, so the term is a lower bound.
    Predictions derived from the data sheet, not measurements."""
    return {
        "t_compute": hlo_flops / H100_PEAK_FLOPS_BF16,
        "t_memory": hlo_bytes / H100_HBM_BPS,
        "t_collective": coll_bytes_per_dev / LINK_BPS,
    }


def extrapolate_probes(probe_costs: list[dict], num_periods: int) -> dict:
    """cost(P) = c2 + (P−2)·(c2 − c1) from two probes one unit apart.

    The reference probes 1 and 2 block periods; the port's dry-run probes
    1 and 2 real steps of each sLSTM time loop (``num_periods`` = the
    sequence length). The constant term cancels, the per-unit delta scales
    linearly."""
    c1, c2 = probe_costs
    out = {}
    for key in ("flops", "bytes"):
        out[key] = max(0.0, c2[key] + (num_periods - 2) * (c2[key] - c1[key]))
    out["collectives"] = {}
    for k in c2["collectives"]:
        v1, v2 = c1["collectives"].get(k, 0.0), c2["collectives"][k]
        out["collectives"][k] = max(0.0, v2 + (num_periods - 2) * (v2 - v1))
    return out


def slstm_correction_flops(cfg: ModelConfig, shape: ShapeConfig, n_dev: int) -> float:
    """The reference's analytic sLSTM term: its probes count the time-step
    scan's recurrent R·h matmuls once per layer, and it adds the missing
    (S−1)/S: 4 gates × 2·B·H·dh² flops per step per layer. The port's
    eager count sees every step, so this is not added to counted FLOPs."""
    if cfg.ssm_kind != "xlstm" or not cfg.slstm_every or shape.kind == "decode":
        return 0.0
    n_slstm = sum(1 for i in range(cfg.num_layers) if cfg.layer_kind(i) == "slstm")
    dh = cfg.d_model // cfg.num_heads
    per_step = 4 * 2 * shape.global_batch * cfg.num_heads * dh * dh
    mult = 3.0 if shape.kind == "train" else 1.0  # bwd ≈ 2× fwd
    return mult * n_slstm * (shape.seq_len - 1) * per_step / n_dev


def analytic_hbm_bytes(cfg: ModelConfig, shape: ShapeConfig, n_dev: int, tp: int = 16) -> dict:
    """Credible per-device HBM traffic model (lower bound, kernelized attn).

    The counted bytes sum every op's operands and outputs with no fusion:
    structurally pessimistic against fused kernels. This analytic model
    bounds the real traffic from below; the record reports both (counted =
    pessimistic, analytic = optimistic), so the memory term is a bracket,
    not a point.

    weights: each device streams its TP slice of every (FSDP-gathered) layer,
    once per pass (fwd / remat-fwd / bwd≈2). optimizer: read+write p,m,ν.
    activations: α residual-sized tensors per layer. decode: weights + the
    full KV cache/state scan per token batch.
    """
    from repro_torch.models.model import count_params_exact

    n = count_params_exact(cfg)
    dp = max(1, n_dev // tp)
    d, L = cfg.d_model, cfg.num_layers
    out: dict[str, float] = {}

    if shape.kind == "train":
        weight_stream = 4 * (2 * n / tp)  # fwd + remat + bwd(dx, dW reads)
        opt_bytes = n / n_dev * (4 * 6)  # p,m,v read+write fp32
        tokens_dev = shape.tokens_per_step / dp
        alpha = 30.0  # fwd ~10 intermediates, remat refwd ~10, bwd ~10
        act = alpha * L * tokens_dev * d * 2 / max(1, cfg.period) * cfg.period
        out["bytes"] = weight_stream + opt_bytes + act
    elif shape.kind == "prefill":
        weight_stream = 2 * n / tp
        tokens_dev = shape.tokens_per_step / dp
        act = 10.0 * L * tokens_dev * d * 2
        out["bytes"] = weight_stream + act
    else:  # decode: weights + cache scan dominate
        weight_stream = 2 * n / tp
        cache = 0.0
        s_eff = min(shape.seq_len, cfg.sliding_window or shape.seq_len)
        n_attn = sum(1 for i in range(cfg.num_layers) if cfg.layer_kind(i) == "attn")
        kv = 2 * s_eff * cfg.num_kv_heads * cfg.head_dim_ * 2  # k+v bf16
        batch_dev = max(1, shape.global_batch // dp)
        cache += n_attn * kv * batch_dev / tp  # cache seq-sharded over model
        out["bytes"] = weight_stream + cache
    out["t_memory_analytic"] = out["bytes"] / H100_HBM_BPS
    return out


def analyze_counts(cfg: ModelConfig, shape: ShapeConfig, mesh, counts: dict) -> dict[str, Any]:
    """The record of one cell from :func:`count_step`'s per-device counts
    (extrapolated where the cell was probed): the reference's fields, with
    ``hlo_*`` naming the counted values."""
    n_dev = mesh.size()
    flops, byts = counts["flops"], counts["bytes"]
    colls = {k: v for k, v in counts["collectives"].items()}
    coll_total = sum(colls.values())
    rec: dict[str, Any] = {
        "n_devices": n_dev,
        "counted_per": "device",
        "hlo_flops_per_dev": flops,
        "hlo_bytes_per_dev": byts,
        "collectives": colls,
        "n_collectives": counts.get("n_collectives", {}),
        "collective_bytes_per_dev": coll_total,
        "peak_bytes_per_dev": counts["peak_bytes"],
    }
    terms = roofline_terms(flops, byts, coll_total, n_dev)
    rec.update(terms)
    rec["dominant"] = max(terms, key=terms.get).replace("t_", "")
    rec["terms_from"] = "H100 SXM nameplate peaks (data sheet), predicted, not measured"

    mf = model_flops(cfg, shape)
    rec["model_flops_total"] = mf
    rec["model_flops_per_dev"] = mf / n_dev
    rec["useful_flop_ratio"] = (mf / n_dev) / flops if flops > 0 else -1.0
    t_bound = max(terms.values())
    if t_bound > 0:
        rec["roofline_fraction"] = (mf / n_dev / t_bound) / H100_PEAK_FLOPS_BF16
    tp = mesh.size(list(mesh.mesh_dim_names).index("model")) if "model" in mesh.mesh_dim_names else 1
    ana = analytic_hbm_bytes(cfg, shape, n_dev, tp)
    rec["hlo_bytes_analytic_per_dev"] = ana["bytes"]
    rec["t_memory_analytic"] = ana["t_memory_analytic"]
    t_bound_opt = max(terms["t_compute"], ana["t_memory_analytic"], terms["t_collective"])
    if t_bound_opt > 0:
        rec["roofline_fraction_optimistic"] = (mf / n_dev / t_bound_opt) / H100_PEAK_FLOPS_BF16
    rec["slstm_correction_flops_not_added"] = slstm_correction_flops(cfg, shape, n_dev)
    return rec
