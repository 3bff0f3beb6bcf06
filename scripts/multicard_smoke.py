#!/usr/bin/env python3
"""Bring the port's distribution layer up on four cards of one host.

Run from the repository root on a host with four NVIDIA H100s:

    python3 scripts/multicard_smoke.py --out chiprun_out/multicard.json

One NCCL rank a card (``launch/mesh.py::spawn_ranks``: rank r binds card r
before ``init_process_group``). It refuses outright, exiting 1, on a host
with fewer than 4 cards. Each check is ``chip_smoke.check``: a failed one
raises in its rank, which ends every rank, and the script exits non-zero.

Before the ranks start, the parent builds the kernels once, starts the
dry-run's count of the same steps (``--count``, a process of its own over
a fake process group of 4 ranks, host only) and runs the one-card
references of the models no card holds beside a shard (``--reference``):
qwen3-1.7b's and the moonshot-v1-16b-a3b cut's unsharded train steps, and
moonshot-v1-16b-a3b's unsharded serve at full width (56.1 GB of bf16
weights), each in a process of its own on a card of its own, all at once.
Then the 4 ranks run, in order:

(a) K1 across cards: qwen3-1.7b's attention layout at decode_32k's length
    (``chip_smoke.DIST_DECODE``, bf16), the cache's sequence over the
    4-way ``model`` axis of a (1, 4) mesh, one K1 launch a rank and the
    MAX/SUM all-reduces of ``parallel/flash_decode.py``; a row with no
    valid key and a row valid in shard 0 only. Against one K1 call over the
    whole cache and the plain version (``BF16_TOL``, ``ATTN_SCALED_TOL``),
    the all-invalid row exact zeros; timed by CUDA events over 20 calls,
    beside one K1 call on one card and each rank's own K1 call (CUDA-graph
    replays), and, at the end of the run, by replaying a CUDA graph of the
    sharded call where NCCL's calls can be captured.
(b) ``pipeline_apply`` of 4 qwen3-1.7b blocks at full width, one a stage,
    over 4 microbatches of (2, 1024) (``DIST_PIPE``) on a (4, 1) ("pod",
    "data") mesh, against the 4 blocks one after another on one card; ms,
    and each stage's idle share from ``torch.profiler`` beside the
    arithmetic bubble (P - 1) / (M + P - 1).
(c) qwen3-1.7b's sharded train step at full width on a (2, 2) ("data",
    "model") mesh, FSDP and sequence parallelism, 2 x 1024 tokens, 1 +
    ``DIST_TRAIN_STEPS`` steps: losses within ``DIST_LOSS_RTOL`` of the
    one-card step's, the peak per card no higher than the one-card
    step's; ms per step, NCCL's share of a step's device time
    (``chip_smoke.step_device_ms``); a ``DIST_CUT_LAYERS``-layer fp32 cut
    whose updated params match the one-card step's to ``DIST_CUT_TOL``.
(d) moonshot-v1-16b-a3b cut to ``MOE_TRAIN_LAYERS`` layers, trained the
    same way on (2, 2): each data rank routes its own groups, each
    ``model`` rank runs its experts.
(e) The sharded serve on a (1, 4) mesh, the cache's sequence over
    ``model``: qwen3-1.7b at full width, phase 21's 8 prompts of 128-1024
    (``SERVE_LENS``) prefilled alone into caches of ``SERVE_MAX_LEN``,
    stacked, ``SERVE_STEPS`` greedy steps, against the unsharded serve on
    the same weights on one card (bf16: the largest logit gap and the first
    step at which any stream parts); a ``SERVE_CUT_LAYERS``-layer fp32 cut
    (streams identical, logits within ``SERVE_CUT_TOL``); moonshot-v1-16b-
    a3b at full width with the experts over ``model`` against its one-card
    serve. ms per prefill and decode step, peak per card, NCCL's share, K1
    and K2 launches.
(f) The dry-run against the mesh: each step of (c), (d) and (e) counted by
    ``roofline/extract.py`` on ``meta`` tensors over a fake group of 4 ranks
    at the run's own mesh and shapes, its peak per device, collective bytes
    per device and predicted t_collective printed beside the measured peak
    and NCCL time (a gap over 2x in the peak is reported, not checked).

Every figure goes to ``--out`` (JSON); the last line of the output is a JSON
summary. ``chip_smoke.py`` stays the one-card driver. The functions here
take a :class:`Plan`: ``tests/test_torch_multicard.py`` runs the same rank
code on 4 gloo CPU ranks at a narrow 2-layer cut with the plain kernels.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import chip_smoke as C  # noqa: E402  (check, the timers, the limits and shapes of phases 20-21)

WORLD = 4
# moonshot-v1-16b-a3b's prompts: a MoE prompt longer than its dispatch group
# (512) must be a multiple of it
MOE_SERVE_LENS, MOE_SERVE_STEPS = (128, 256, 384, 512, 512, 1024, 1024, 1024), 16
TIMED_CALLS = 20  # K1 across cards: CUDA events over this many calls
PEAK_GAP = 2.0  # counted against measured peak: a wider gap is a fault to explain (ROADMAP C)
REFERENCES = ("train", "moe_train", "moe_serve")  # the one-card runs, each a process on a card of its own


@dataclasses.dataclass(frozen=True)
class Plan:
    """What the run does and at what size: the defaults are the cards' run,
    :func:`rehearsal_plan` the gloo rehearsal's."""

    backend: str = "nccl"
    device: str = "cuda"
    dense: str = "qwen3-1.7b"
    moe: str = "moonshot-v1-16b-a3b"
    overrides: tuple = ()  # ((arch, {field: value}), ...): the rehearsal's cut
    decode: tuple = C.DIST_DECODE
    pipe: tuple = C.DIST_PIPE
    train_seq: tuple = C.DIST_TRAIN_SEQ
    train_steps: int = C.DIST_TRAIN_STEPS
    cut_layers: int = C.DIST_CUT_LAYERS
    moe_train_layers: int = C.MOE_TRAIN_LAYERS
    serve_lens: tuple = C.SERVE_LENS
    serve_max_len: int = C.SERVE_MAX_LEN
    serve_steps: int = C.SERVE_STEPS
    serve_cut_layers: int = C.SERVE_CUT_LAYERS
    moe_serve_lens: tuple = MOE_SERVE_LENS
    moe_serve_steps: int = MOE_SERVE_STEPS
    profiled: int = C.SERVE_PROFILED

    def config(self, arch: str, **changes):
        from repro_torch.configs import get_config

        cfg = get_config(arch)
        return dataclasses.replace(cfg, **{**dict(self.overrides).get(arch, {}), **changes})

    @property
    def cuda(self) -> bool:
        return self.device == "cuda"


def rehearsal_plan() -> Plan:
    """The gloo CPU rehearsal's plan (``tests/test_torch_multicard.py``):
    qwen3-1.7b and moonshot-v1-16b-a3b cut to 2 narrow layers, every shape
    cut to a few rows, no device time. The MoE cut computes in fp32: at
    width 64 in bf16 the router's inputs, summed in another order across
    ranks, flip routings, and the first step's loss moved by 3e-3 (6.19413
    against 6.21234 on one process); in fp32 they agree to 1e-6."""
    dense = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256)
    moe = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16, d_ff=64, moe_d_ff=64,
               vocab_size=256, num_experts=4, experts_per_token=2, moe_group_size=16, compute_dtype="float32")
    return Plan(backend="gloo", device="cpu", overrides=(("qwen3-1.7b", dense), ("moonshot-v1-16b-a3b", moe)),
                decode=(4, 64, 4, 2, 16), pipe=(4, 1, 16), train_seq=(2, 16), cut_layers=1, moe_train_layers=2,
                serve_lens=(8, 12, 16, 4), serve_max_len=32, serve_steps=4, serve_cut_layers=1,
                moe_serve_lens=(8, 16, 16, 4), moe_serve_steps=3, profiled=0)


TRAIN_RUN = dict(remat="none", attention_impl="pallas", z_loss=0.0)
SERVE_RUN = dict(remat="none", attention_impl="pallas", decode_attention_impl="kernel")


# ---------------------------------------------------------------------------
# helpers on either device (the rehearsal runs them on the CPU)
# ---------------------------------------------------------------------------


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reset_peak(dev) -> None:
    free(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def peak_gib(dev):
    return torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None


def free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()


def host_ms(fn, dev, n: int = 3) -> list:
    """Host-clock ms of ``n`` synchronised calls of ``fn``, after one."""
    fn()
    out = []
    for _ in range(n):
        sync(dev)
        t0 = time.perf_counter()
        fn()
        sync(dev)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def device_ms(fn, dev, n: int = 1):
    """``chip_smoke.step_device_ms`` on a card (``torch.profiler``); None on
    the CPU, where the profiler records no device time."""
    return C.step_device_ms(fn, n) if dev.type == "cuda" else None


def device_split(dv):
    """A step's device time (``chip_smoke.step_device_ms``) split: NCCL's
    share of it, and the time and share of the profiled wall in every
    other kernel, copy and fill (an NCCL kernel runs from its launch to the
    last rank's arrival, so its time holds the waits for the other ranks'
    hosts, and kernels on NCCL's streams overlap the compute stream's)."""
    if not dv or not dv["device_ms"]:
        return None
    compute = dv["device_ms"] - dv["nccl_ms"]
    return {"nccl_share": dv["nccl_ms"] / dv["device_ms"], "compute_ms": compute,
            "compute_share_of_wall": compute / dv["wall_ms_profiled"]}


def shares(splits) -> str:
    return ", ".join("not measured" if d is None else
                     f"NCCL {d['nccl_share']:.3f} of device time, other kernels {d['compute_ms']:.2f} ms = "
                     f"{d['compute_share_of_wall']:.3f} of the wall" for d in splits)


def place(tree, specs, mesh):
    """``tree``'s tensors (the same whole tensor on every rank) as DTensors
    laid out by their PartitionSpecs, each rank keeping a copy of its own
    shard, with no communication; each whole tensor is dropped from
    ``tree`` as soon as it is placed (a shard along dim 0 would otherwise
    be a view that keeps the whole tensor alive)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.parallel.sharding import from_local, spec_placements

    def one(t, spec):
        pl = spec_placements(mesh, spec)
        d = distribute_tensor(t, mesh, pl, src_data_rank=None)
        return from_local(d.to_local().clone(), mesh, pl, tuple(d.shape))

    if isinstance(tree, torch.Tensor):
        return one(tree, specs)
    keys = list(tree) if isinstance(tree, dict) else range(len(tree))
    for k in keys:
        tree[k] = place(tree[k], specs[k], mesh)
    return tree


def counted_plain(plan: Plan):
    """On the CPU the wrappers run the plain versions, which count no
    launch: there each plain call of K1 or K2 through ``kernels/ops.py``
    counts as the launch it stands for, so that the rehearsal's launch
    checks hold the same paths as the cards'. On a card, nothing."""
    import contextlib

    from repro_torch.kernels import ops

    stack = contextlib.ExitStack()
    if plan.cuda:
        return stack
    for name, key in (("decode_attention_plain", "decode_attention"), ("flash_attention_plain", "flash_attention")):
        def counting(*a, _real=getattr(ops, name), _key=key, **kw):
            ops.LAUNCHES[_key] += 1
            return _real(*a, **kw)

        stack.enter_context(mock.patch.object(ops, name, counting))
    return stack


_MESHES: dict = {}


def mesh_of(plan: Plan, shape: tuple, axes: tuple = ("data", "model")):
    """The mesh of ``shape`` named ``axes``, made once a process (each mesh
    makes a communicator per dim)."""
    from repro_torch.launch.mesh import make_mesh

    key = (tuple(shape), tuple(axes))
    if key not in _MESHES:
        _MESHES[key] = make_mesh(shape, axes, device=plan.device)
    return _MESHES[key]


def full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def gather(obj) -> list:
    """``obj`` of every rank, in rank order."""
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def say(rank: int, *a) -> None:
    if rank == 0:
        print(*a, flush=True)


# ---------------------------------------------------------------------------
# the steps, shared by the one-card references and the ranks
# ---------------------------------------------------------------------------


def train_batches(vocab: int, plan: Plan) -> list:
    rng = np.random.default_rng(20)
    b, s = plan.train_seq
    return [{"tokens": rng.integers(0, vocab, (b, s)), "labels": rng.integers(0, vocab, (b, s)),
             "mask": np.ones((b, s), np.float32)} for _ in range(1 + plan.train_steps)]


def train_run(cfg, dev, data: list, steps: int, mesh=None, profile: bool = False):
    """``steps`` train steps of ``cfg`` from seeded fp32 weights, sharded by
    the rules of ``mesh`` where given (params and AdamW state placed by
    ``model_specs``/``opt_state_specs``). Returns the params and the losses,
    host ms, (K2 launches, DTensor-path calls) per step, the peak GiB and,
    with ``profile``, one more step's device time."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import rules_from_mesh

    run = RunConfig(**TRAIN_RUN)
    params = M.init_model(cfg, torch.Generator(device=dev).manual_seed(0))
    opt = adamw.init_opt_state(params)
    rules = None
    if mesh is not None:
        rules = rules_from_mesh(mesh)
        specs = M.model_specs(cfg, rules)
        params, opt = place(params, specs, mesh), place(opt, adamw.opt_state_specs(specs), mesh)
    step_fn = make_train_step(cfg, run, rules)
    reset_peak(dev)
    rec = {"losses": [], "ms": [], "k2_and_dtensor_calls": []}
    local, real, shapes, real_op = [], ops._on_local_heads, set(), ops._flash_op

    def spy(*a, **kw):
        local.append(1)
        return real(*a, **kw)

    def op_spy(q, k, *a):  # the shapes K2 runs at, on this rank
        shapes.add((tuple(q.shape), tuple(k.shape)))
        return real_op(q, k, *a)

    with mock.patch.object(ops, "_on_local_heads", spy), mock.patch.object(ops, "_flash_op", op_spy):
        for i in range(steps):
            ops.reset_launches()
            local.clear()
            sync(dev)
            t0 = time.perf_counter()
            params, opt, metrics = step_fn(params, opt, data[i])
            loss = float(metrics["loss"])
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
            rec["losses"].append(loss)
            rec["k2_and_dtensor_calls"].append((ops.LAUNCHES["flash_attention"], len(local)))
    rec["peak_gib"] = peak_gib(dev)
    rec["k2_shapes"] = sorted(shapes)
    if profile:
        rec["device"] = device_ms(lambda: step_fn(params, opt, data[0]), dev)
    return params, rec


def serve_run(cfg, params, dev, lens, steps: int, max_len: int, mesh=None, profiled: int = 0) -> dict:
    """Phase 21's serve: each prompt (``SyntheticCorpus``, seed 0) prefilled
    alone into a cache of ``max_len``, the caches stacked, ``steps`` greedy
    decode steps; sharded by the rules of ``mesh`` where given (``params``
    placed by ``model_specs``, the cache by ``cache_specs``, its sequence
    over ``model``). Returns the logits and tokens of every step, ms per
    prefill and step, (launches, DTensor-path calls) per prefill (K2) and
    step (K1), the peak GiB, and ``profiled`` more steps' device time."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.dataset import SyntheticCorpus
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import attention as A
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import rules_from_mesh

    run = RunConfig(**SERVE_RUN)
    rules = rules_from_mesh(mesh) if mesh is not None else None
    if rules is not None:
        params = place(params, M.model_specs(cfg, rules), mesh)
    corpus = SyntheticCorpus(cfg.vocab_size, max(lens), seed=0)
    prompts = [torch.as_tensor(corpus.grain_tokens(i, 1)[:, :n], device=dev) for i, n in enumerate(lens)]
    prefill, step = make_prefill_step(cfg, run, rules, max_len), make_serve_step(cfg, run, rules)
    local, sharded = [], []
    real_local, real_sharded = ops._on_local_heads, A.sharded_decode_attention

    def spy_local(*a, **kw):
        local.append(1)
        return real_local(*a, **kw)

    def spy_sharded(*a, **kw):
        sharded.append(1)
        return real_sharded(*a, **kw)

    reset_peak(dev)
    rec = {"prefill": [], "steps": [], "prefill_ms": [], "ms": []}
    logits, caches = [], []
    with mock.patch.object(ops, "_on_local_heads", spy_local), \
            mock.patch.object(A, "sharded_decode_attention", spy_sharded):
        for p in prompts:
            ops.reset_launches()
            local.clear()
            sync(dev)
            t0 = time.perf_counter()
            lg, cache = prefill(params, {"tokens": p})
            sync(dev)
            rec["prefill_ms"].append((time.perf_counter() - t0) * 1e3)
            logits.append(full(lg).float())
            caches.append(cache)
            rec["prefill"].append((ops.LAUNCHES["flash_attention"], len(local)))
        cache = C.stack_caches(caches) if len(caches) > 1 else caches[0]
        del caches
        out_logits, tokens = [torch.cat(logits)], []
        for _ in range(steps):
            tok = out_logits[-1].argmax(-1)
            tokens.append(tok)
            ops.reset_launches()
            sharded.clear()
            sync(dev)
            t0 = time.perf_counter()
            lg, cache = step(params, cache, {"tokens": tok})
            sync(dev)
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
            out_logits.append(full(lg).float())
            rec["steps"].append((ops.LAUNCHES["decode_attention"], len(sharded)))
        rec["peak_gib"] = peak_gib(dev)
        if profiled:
            tok = out_logits[-1].argmax(-1)
            rec["device"] = device_ms(lambda: step(params, cache, {"tokens": tok}), dev, profiled)
    rec["logits"], rec["tokens"] = out_logits, tokens
    return rec


def compare(a: dict, b: dict) -> dict:
    """The first step at which any greedy stream parts (None: never), and
    the logits' largest gap up to and including it."""
    part = next((i for i, (x, y) in enumerate(zip(a["tokens"], b["tokens"])) if not torch.equal(x.cpu(), y.cpu())),
                None)
    upto = len(a["logits"]) if part is None else part + 1
    gap = max(float((x.cpu() - y.cpu()).abs().max()) for x, y in zip(a["logits"][:upto], b["logits"][:upto]))
    top = max(float(x.abs().max()) for x in a["logits"][:upto])
    return {"parts_at_step": part, "max_abs_gap": gap, "max_abs_logit": top, "steps": len(a["tokens"])}


def summary(rec: dict) -> dict:
    """A run's figures without its logits and tokens."""
    return {k: v for k, v in rec.items() if k not in ("logits", "tokens")}


# ---------------------------------------------------------------------------
# the one-card references (``--reference``), each in a process of its own
# ---------------------------------------------------------------------------


def reference(name: str, plan: Plan, work: Path) -> None:
    """One unsharded run on this process's card (or the CPU), its record
    saved to ``work/ref_<name>.pt``."""
    dev = torch.device(plan.device)
    from repro_torch.models import model as M

    if plan.cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    with counted_plain(plan):
        if name in ("train", "moe_train"):
            cfg = plan.config(plan.dense) if name == "train" else plan.config(plan.moe, num_layers=plan.moe_train_layers)
            rec = train_run(cfg, dev, train_batches(cfg.vocab_size, plan), 1 + plan.train_steps)[1]
        else:
            cfg = plan.config(plan.moe)
            params = M.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dtype=torch.bfloat16)
            rec = serve_run(cfg, params, dev, plan.moe_serve_lens, plan.moe_serve_steps, plan.serve_max_len)
            rec["logits"] = [t.to(torch.bfloat16).cpu() for t in rec["logits"]]
            rec["tokens"] = [t.cpu() for t in rec["tokens"]]
    rec["wall_s"] = time.perf_counter() - t0
    rec["device_name"] = torch.cuda.get_device_name(dev) if plan.cuda else "cpu"
    torch.save(rec, work / f"ref_{name}.pt")
    print(f"one-card reference {name} on {rec['device_name']}: {json.dumps(summary(rec), default=str)}", flush=True)


# ---------------------------------------------------------------------------
# (f) the dry-run's count of the same steps (``--count``), host only
# ---------------------------------------------------------------------------


def count_cells(plan: Plan, out: Path) -> None:
    """Each step of (c), (d) and (e) counted on ``meta`` tensors over a fake
    process group of WORLD ranks, at the run's mesh, shapes and dtypes
    (fp32 params and AdamW state for training, bf16 weights for serving);
    the records (``roofline/extract.py::analyze_counts``) to ``out``."""
    os.environ["REPRO_DRYRUN_DEVICES"] = str(WORLD)
    from repro_torch.configs import input_shardings, input_specs
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import cache_shapes, make_prefill_step, make_serve_step, make_train_step
    from repro_torch.models import model as M
    from repro_torch.models.common import tree_map
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import rules_from_mesh
    from repro_torch.roofline.extract import analyze_counts, count_step

    b, s = plan.train_seq
    cells = {
        "train": (plan.config(plan.dense), "train", (2, 2)),
        "train_moe": (plan.config(plan.moe, num_layers=plan.moe_train_layers), "train", (2, 2)),
        "serve_prefill": (plan.config(plan.dense), "prefill", (1, 4)),
        "serve_decode": (plan.config(plan.dense), "decode", (1, 4)),
        "serve_moe_prefill": (plan.config(plan.moe), "prefill", (1, 4)),
        "serve_moe_decode": (plan.config(plan.moe), "decode", (1, 4)),
    }
    res = {}
    for name, (cfg, kind, mesh_shape) in cells.items():
        t0 = time.perf_counter()
        mesh = dryrun.fake_mesh(mesh_shape)
        if kind == "train":
            run = RunConfig(**TRAIN_RUN)
            rules = rules_from_mesh(mesh, fsdp=run.fsdp, sequence_parallel=run.sequence_parallel)
            shape = ShapeConfig(f"multicard_{name}", "train", s, b)
            pspecs = M.model_specs(cfg, rules)
            pshapes = M.model_shapes(cfg)
            fn = make_train_step(cfg, run, rules)
            args = (pshapes, adamw.opt_state_shapes(pshapes), input_specs(cfg, shape))
            specs = (pspecs, adamw.opt_state_specs(pspecs), input_shardings(cfg, shape, rules))
        else:
            run = RunConfig(**SERVE_RUN)
            rules = rules_from_mesh(mesh)
            pspecs = M.model_specs(cfg, rules)
            weights = tree_map(lambda t: torch.empty(t.shape, dtype=torch.bfloat16, device="meta"), M.model_shapes(cfg))
            lens = plan.moe_serve_lens if cfg.num_experts else plan.serve_lens
            if kind == "prefill":
                shape = ShapeConfig(f"multicard_{name}", "prefill", max(lens), 1)
                fn = make_prefill_step(cfg, run, rules, plan.serve_max_len)
                args, specs = (weights, input_specs(cfg, shape)), (pspecs, input_shardings(cfg, shape, rules))
            else:
                shape = ShapeConfig(f"multicard_{name}", "decode", plan.serve_max_len, len(lens))
                fn = make_serve_step(cfg, run, rules)
                args = (weights, cache_shapes(cfg, shape), input_specs(cfg, shape))
                specs = (pspecs, M.cache_specs(cfg, rules, shape.global_batch, shape.seq_len),
                         input_shardings(cfg, shape, rules))
        counts = count_step(fn, dryrun._placed(args, specs, mesh))
        rec = analyze_counts(cfg, shape, mesh, counts)
        rec.update(mesh=list(mesh_shape), count_s=time.perf_counter() - t0)
        res[name] = rec
        print(f"counted {name} on {mesh_shape}: peak {rec['peak_bytes_per_dev'] / 2**30:.3f} GiB a device, "
              f"collectives {rec['collective_bytes_per_dev'] / 1e6:.3f} MB a device, t_collective "
              f"{rec['t_collective']:.4e} s (predicted), {rec['count_s']:.1f} s", flush=True)
    out.write_text(json.dumps(res, indent=1, default=str))


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def decode_phase(rank: int, plan: Plan, dev) -> dict:
    """(a) K1 over the cache's sequence on a (1, 4) mesh, against one call."""
    import torch.nn.functional as F
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_plain
    from repro_torch.parallel.flash_decode import sharded_decode_attention

    B, S, H, KH, D = plan.decode
    step = S // WORLD
    gen = torch.Generator(device=dev).manual_seed(20)  # the inputs of chip_smoke's phase 20
    q = torch.randn((B, H, D), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((B, S, KH, D), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((B, S, KH, D), generator=gen, device=dev).to(torch.bfloat16)
    valid_b = torch.rand((B, S), generator=gen, device=dev) > 0.2
    valid_b[B - 2, step:] = False  # valid keys in shard 0 only: three shards empty
    valid_b[B - 1] = False  # no valid key
    valid = valid_b.to(torch.int32)
    scale = D**-0.5
    mesh = mesh_of(plan, (1, WORLD))
    seq_pl, q_pl = [Shard(0), Shard(1)], [Shard(0), Replicate()]
    qd = distribute_tensor(q, mesh, q_pl, src_data_rank=None)
    kd, vd, validd = (distribute_tensor(t, mesh, seq_pl, src_data_rank=None) for t in (k, v, valid_b))

    def sharded():
        return sharded_decode_attention(qd, kd, vd, validd, mesh)

    def whole():  # one K1 call over the whole cache, its fp32 output
        acc, _, l = ops.decode_attention(q, k, v, valid, scale, return_partials=True)
        return acc / l.clamp_min(1e-30)[..., None]

    ops.reset_launches()
    got = full(sharded())
    sync(dev)
    launches = ops.LAUNCHES["decode_attention"]
    one, plain = whole(), decode_attention_plain(q, k, v, valid, scale=scale)[0]
    g = got.float()
    errs = {"vs_one_call": float((g - one).abs().max()), "vs_plain": float((g - plain).abs().max()),
            "scaled_vs_one_call": C.scaled_err(g, one), "scaled_vs_plain": C.scaled_err(g, plain),
            "past_bf16_rounding": float(((g - one).abs() - one.abs() * 2**-8).max()),
            "one_call_vs_plain": float((one - plain).abs().max())}
    rec = {"errors": errs, "launches_per_rank": gather(launches), "shape": [B, S, H, KH, D]}
    if plan.cuda:  # which cards reach each other's memory directly (P2P over NVLink or PCIe)
        n = torch.cuda.device_count()
        rec["peer_access"] = [[i == j or torch.cuda.can_device_access_peer(i, j) for j in range(n)] for i in range(n)]
        say(rank, f"(a) peer access between the {n} cards: {rec['peer_access']}")
    say(rank, f"(a) K1 across {WORLD} cards, q {tuple(q.shape)}, k/v {tuple(k.shape)} bf16, {step} keys a card: "
              f"max abs err vs one K1 call {errs['vs_one_call']:.3e}, vs plain {errs['vs_plain']:.3e} "
              f"(tol {C.BF16_TOL}); scaled {errs['scaled_vs_one_call']:.3e}, {errs['scaled_vs_plain']:.3e} (tol "
              f"{C.ATTN_SCALED_TOL[torch.bfloat16]:.0e}, bf16 output); {errs['past_bf16_rounding']:.3e} past the "
              f"rounding to bf16 (tol {C.FP32_TOL}); K1 launches per rank {rec['launches_per_rank']}")
    for key in ("vs_one_call", "vs_plain", "one_call_vs_plain"):
        C.check(errs[key] < C.BF16_TOL, f"(a) K1 across cards: {key} {errs}")
    for key in ("scaled_vs_one_call", "scaled_vs_plain"):
        C.check(errs[key] <= C.ATTN_SCALED_TOL[torch.bfloat16], f"(a) K1 across cards: {key} {errs}")
    C.check(errs["past_bf16_rounding"] <= C.FP32_TOL, f"(a) K1 across cards past the bf16 rounding: {errs}")
    C.check(bool((got[B - 1] == 0).all() and (one[B - 1] == 0).all()), "(a) the all-invalid row is exact zeros")
    C.check(rec["launches_per_rank"] == [1] * WORLD, f"(a) one K1 launch a rank: {rec['launches_per_rank']}")
    if plan.cuda:
        ql, kl, vl, vall = (t.to_local() for t in (qd, kd, vd, validd))
        vall = vall.to(torch.int32)
        local = C.k1_bound(ql, kl, vall)
        whole_bound = C.k1_bound(q, k, valid)
        mask = valid_b[:, None, None, :]
        t = {"ms_events": C.timed_ms(sharded, TIMED_CALLS), "timing": f"CUDA events over {TIMED_CALLS} calls",
             "one_call_ms": C.graph_ms(whole),
             "local_call_ms": C.graph_ms(lambda: ops.decode_attention(ql, kl, vl, vall, scale, return_partials=True)),
             "plain_ms": C.timed_ms(lambda: decode_attention_plain(q, k, v, valid, scale=scale)),
             "library_ms": C.graph_ms(lambda: F.scaled_dot_product_attention(
                 q[:, :, None], k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask, enable_gqa=True)),
             "bound_ms": max(gather(local["bound_ms"])), "bound_by": local["bound_by"],
             "one_card_bound_ms": whole_bound["bound_ms"]}
        t["local_call_ms_per_rank"] = gather(t["local_call_ms"])
        rec["times"] = t
        say(rank, f"(a) K1 across cards: {t['ms_events']:.5f} ms a call ({t['timing']}); one K1 call over {S} keys "
                  f"on one card {t['one_call_ms']:.5f} ms (CUDA graph); each rank's own K1 call "
                  + ", ".join(f"{x:.5f}" for x in t["local_call_ms_per_rank"]) + f" ms (CUDA graph); bound per card "
                  f"{t['bound_ms']:.5f} ms by {t['bound_by']} (one card {t['one_card_bound_ms']:.5f}); plain "
                  f"{t['plain_ms']:.4f} ms; SDPA over the whole cache {t['library_ms']:.5f} ms")
    return rec


def graph_decode_phase(rank: int, plan: Plan, dev) -> dict:
    """(a) again at the end of the run: the sharded call replayed from a CUDA
    graph, NCCL's all-reduces captured in it. Where capture fails, every
    rank reports why (the events' figure of (a) stands)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.parallel.flash_decode import sharded_decode_attention

    B, S, H, KH, D = plan.decode
    gen = torch.Generator(device=dev).manual_seed(20)
    q = torch.randn((B, H, D), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((B, S, KH, D), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((B, S, KH, D), generator=gen, device=dev).to(torch.bfloat16)
    valid_b = torch.rand((B, S), generator=gen, device=dev) > 0.2
    mesh = mesh_of(plan, (1, WORLD))
    qd = distribute_tensor(q, mesh, [Shard(0), Replicate()], src_data_rank=None)
    kd, vd, validd = (distribute_tensor(t, mesh, [Shard(0), Shard(1)], src_data_rank=None) for t in (k, v, valid_b))
    try:
        ms = C.graph_ms(lambda: sharded_decode_attention(qd, kd, vd, validd, mesh))
        rec = {"ms_graph": ms, "timing": "CUDA graph of 20 calls, replayed 5 times"}
    except Exception as e:  # noqa: BLE001 — reported beside the events' figure
        rec = {"ms_graph": None, "graph_error": f"{type(e).__name__}: {e}"[:500]}
    rec["per_rank"] = gather(rec.get("ms_graph"))
    say(rank, "(a) K1 across cards replayed from a CUDA graph: "
        + (f"{rec['ms_graph']:.5f} ms a call (per rank " + ", ".join(f"{x:.5f}" for x in rec["per_rank"]) + ")"
           if rec.get("ms_graph") is not None else f"not captured: {rec.get('graph_error')}"))
    return rec


def pipeline_phase(rank: int, plan: Plan, dev) -> dict:
    """(b) GPipe of WORLD qwen3 blocks, one a stage, on a (4, 1) mesh."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models.common import tree_map
    from repro_torch.parallel.pipeline import bubble_fraction, pipeline_apply

    cfg = plan.config(plan.dense)
    run = RunConfig(**TRAIN_RUN)
    blocks = M.init_model(dataclasses.replace(cfg, num_layers=WORLD), torch.Generator(device=dev).manual_seed(0),
                          dtype=torch.bfloat16)["layers"]
    stacked = tree_map(lambda *ts: torch.stack(ts), *blocks)
    Mb, Bp, Sp = plan.pipe
    gen = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn((Mb, Bp, Sp, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
    positions = torch.arange(Sp, device=dev)[None, :]

    def block(p, h):
        return M._block_full(cfg, run, p, "attn", h, positions)[0]

    def sequential():
        outs = []
        for i in range(Mb):
            h = x[i]
            for p in blocks:
                h = block(p, h)
            outs.append(h)
        return torch.stack(outs)

    pmesh = mesh_of(plan, (WORLD, 1), ("pod", "data"))
    with torch.no_grad():
        ops.reset_launches()
        piped = pipeline_apply(block, stacked, x, pmesh, stage_axis="pod")
        sync(dev)
        k2 = ops.LAUNCHES["flash_attention"]
        seq = sequential()
        err = float((piped.float() - seq.float()).abs().max())
        top = float(seq.float().abs().max())
        rec = {"max_abs_err": err, "max_abs_out": top, "k2_launches_per_rank": gather(k2),
               "bubble": bubble_fraction(WORLD, Mb), "microbatches": Mb, "microbatch": [Bp, Sp]}
        say(rank, f"(b) pipeline_apply of {WORLD} qwen3 blocks, one a card, {Mb} microbatches of {(Bp, Sp)}: max abs "
                  f"err vs the blocks in turn on one card {err:.3e} (largest |out| {top:.3f}); K2 launches per rank "
                  f"{rec['k2_launches_per_rank']}")
        C.check(err <= 1e-2 * top, f"(b) pipeline vs sequential: {err} at largest {top}")
        C.check(rec["k2_launches_per_rank"] == [Mb] * WORLD, f"(b) K2 launches {rec['k2_launches_per_rank']}")
        rec["ms"] = host_ms(lambda: pipeline_apply(block, stacked, x, pmesh, stage_axis="pod"), dev)
        rec["sequential_ms"] = host_ms(sequential, dev)
        dv = device_ms(lambda: pipeline_apply(block, stacked, x, pmesh, stage_axis="pod"), dev)
    if dv is not None:
        busy = dv["device_ms"] - dv["nccl_ms"]
        dv["idle_share"] = 1 - busy / dv["wall_ms_profiled"]
    rec["stages"] = gather(dv)
    if plan.cuda:
        say(rank, f"(b) pipeline: {np.median(rec['ms']):.2f} ms a call (host clock, median of "
                  + ", ".join(f"{t:.2f}" for t in rec["ms"]) + f"), the {WORLD} blocks in turn on one card "
                  f"{np.median(rec['sequential_ms']):.2f} ms; each stage's idle share (torch.profiler: 1 - its "
                  "kernels' time but NCCL's over the call's wall) "
                  + ", ".join(f"{s['idle_share']:.3f}" for s in rec["stages"])
                  + f", NCCL ms per stage " + ", ".join(f"{s['nccl_ms']:.3f}" for s in rec["stages"])
                  + f"; arithmetic bubble (P-1)/(M+P-1) = {rec['bubble']:.4f}")
    return rec


def train_phase(rank: int, plan: Plan, dev, work: Path, moe: bool) -> dict:
    """(c) qwen3's (or (d) the moonshot cut's) sharded train step on (2, 2)
    against the one-card step of its reference process."""
    from repro_torch.models.common import tree_leaves

    tag = "(d)" if moe else "(c)"
    cfg = plan.config(plan.moe, num_layers=plan.moe_train_layers) if moe else plan.config(plan.dense)
    name = f"{cfg.name} cut to {cfg.num_layers} layers" if moe else cfg.name
    ref = torch.load(work / f"ref_{'moe_train' if moe else 'train'}.pt", weights_only=False)
    mesh = mesh_of(plan, (2, 2))
    data = train_batches(cfg.vocab_size, plan)
    params, rec = train_run(cfg, dev, data, 1 + plan.train_steps, mesh, profile=True)
    del params
    free(dev)
    L = cfg.num_layers
    rec["peak_gib_per_rank"] = gather(rec["peak_gib"])
    rec["device_per_rank"] = gather(rec.get("device"))
    rec["split_per_rank"] = [device_split(d) for d in rec["device_per_rank"]]
    out = {"sharded": rec, "one_card": ref}
    say(rank, f"{tag} {name} train step on (2, 2), {plan.train_seq[0]} x {plan.train_seq[1]} tokens: losses "
              + ", ".join(f"{x:.5f}" for x in rec["losses"]) + " against one card's "
              + ", ".join(f"{x:.5f}" for x in ref["losses"]) + "; ms per step "
              + ", ".join(f"{x:.1f}" for x in rec["ms"]) + " against " + ", ".join(f"{x:.1f}" for x in ref["ms"])
              + f" (first incl. warm-up); peak per card {rec['peak_gib_per_rank']} GiB against one card's "
              f"{ref['peak_gib']}; a profiled step's device time per rank: {shares(rec['split_per_rank'])}; "
              f"(K2 launches, DTensor-path calls) per step {rec['k2_and_dtensor_calls']}; K2's local q "
              f"{rec['k2_shapes']}")
    for a, b in zip(ref["losses"], rec["losses"]):
        C.check(np.isfinite(b) and abs(a - b) <= C.DIST_LOSS_RTOL * abs(a),
                f"{tag} {name} losses across cards {rec['losses']} vs one card {ref['losses']}")
    C.check(all(kk == (L, L) for kk in rec["k2_and_dtensor_calls"]),
            f"{tag} every K2 launch through the DTensor path: {rec['k2_and_dtensor_calls']}")
    if plan.cuda:
        C.check(max(rec["peak_gib_per_rank"]) <= ref["peak_gib"] + C.DIST_PEAK_SLACK_GIB,
                f"{tag} peak per card {rec['peak_gib_per_rank']} GiB over one card's {ref['peak_gib']:.2f}")
    if plan.cuda and not moe:
        out["k2_local"] = k2_times(rank, dev, *rec["k2_shapes"][0])
    if not moe:
        cut = dataclasses.replace(cfg, num_layers=plan.cut_layers, compute_dtype="float32")
        cdata = train_batches(cut.vocab_size, plan)
        p_one = train_run(cut, dev, cdata, 1)[0]
        p_shard = train_run(cut, dev, cdata, 1, mesh)[0]
        err = max(float((a - full(b)).abs().max()) for a, b in zip(tree_leaves(p_one), tree_leaves(p_shard)))
        out["cut_fp32_max_param_err"] = err
        say(rank, f"(c) {cfg.name} cut to {plan.cut_layers} layers, fp32, one step on (2, 2): params against one "
                  f"card's, max abs err {err:.3e} (tol {C.DIST_CUT_TOL})")
        C.check(err < C.DIST_CUT_TOL, f"(c) fp32 cut across cards vs one card: params {err}")
        del p_one, p_shard
        free(dev)
    return out


def k2_times(rank: int, dev, q_shape, kv_shape) -> dict:
    """K2 (causal, bf16) at the local shape a rank of (c) runs it at: its
    data rank's rows and its ``model`` rank's heads. Against its plain
    version; timed by CUDA-graph replay beside the plain version and SDPA,
    with its bound (bytes: q, k, v read and the output written once;
    operations: 4·D per (q head, visited key))."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain

    gen = torch.Generator(device=dev).manual_seed(24)
    q = torch.randn(q_shape, generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(kv_shape, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    b, sq, h, d = q.shape
    scale = d**-0.5
    got, exp = flash_attention_cuda(q, k, v, scale=scale), flash_attention_plain(q, k, v, scale=scale)
    err = float((got.float() - exp.float()).abs().max())
    C.check(err < C.BF16_TOL and C.scaled_err(got, exp) <= C.ATTN_SCALED_TOL[torch.bfloat16],
            f"(c) K2 at the local shape {q_shape} vs plain: {err}")
    t_b = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() / C.HBM_BYTES_PER_S * 1e3
    t_o = 4 * b * h * d * C.window_pairs(sq, 0) / C.BF16_FLOPS * 1e3
    rec = {"q": list(q_shape), "kv": list(kv_shape), "max_abs_err": err,
           "ms": C.graph_ms(lambda: flash_attention_cuda(q, k, v, scale=scale)),
           "plain_ms": C.timed_ms(lambda: flash_attention_plain(q, k, v, scale=scale)),
           "library_ms": C.graph_ms(lambda: F.scaled_dot_product_attention(
               q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True, enable_gqa=True)),
           "bound_ms": max(t_b, t_o), "bound_by": "bytes" if t_b >= t_o else "operations"}
    say(rank, f"(c) K2 at the local shape q {q_shape}, k/v {kv_shape}: {rec['ms']:.5f} ms (CUDA graph), bound "
              f"{rec['bound_ms']:.5f} ms by {rec['bound_by']}, plain {rec['plain_ms']:.4f} ms, SDPA "
              f"{rec['library_ms']:.5f} ms, max abs err {err:.3e}")
    return rec


def serve_phase(rank: int, plan: Plan, dev, work: Path) -> dict:
    """(e) the sharded serve on (1, 4) against one card."""
    from repro_torch.models import model as M

    mesh = mesh_of(plan, (1, WORLD))
    cfg = plan.config(plan.dense)
    L = cfg.num_layers
    out = {}

    def weights(c, dtype=torch.bfloat16):
        return M.init_model(c, torch.Generator(device=dev).manual_seed(0), dtype=dtype)

    def report(key: str, name: str, sh: dict, one: dict, layers: int) -> dict:
        cmp = compare(sh, one)
        r = {"compare": cmp, "sharded": summary(sh), "one_card": summary(one),
             "peak_gib_per_rank": gather(sh["peak_gib"]), "device_per_rank": gather(sh.get("device"))}
        r["split_per_rank"] = [device_split(d) for d in r["device_per_rank"]]
        say(rank, f"(e) {name} serve on (1, {WORLD}), {len(sh['prefill'])} prompts, {cmp['steps']} decode steps: "
                  f"largest logit gap vs one card {cmp['max_abs_gap']:.4e} (largest |logit| {cmp['max_abs_logit']:.3f}),"
                  f" streams part at step {cmp['parts_at_step']}; ms per decode step median "
                  f"{np.median(sh['ms']):.2f} against one card's {np.median(one['ms']):.2f}; ms per prefill "
                  + ", ".join(f"{x:.1f}" for x in sh["prefill_ms"]) + " against "
                  + ", ".join(f"{x:.1f}" for x in one["prefill_ms"]) + f"; peak per card {r['peak_gib_per_rank']} "
                  f"GiB against one card's {one['peak_gib']}; a profiled decode step's device time per rank: "
                  f"{shares(r['split_per_rank'])}; (K2, DTensor path) per prefill {sh['prefill'][0]}, (K1, "
                  f"sharded_decode_attention) per step {sh['steps'][0]}")
        C.check(all(bool(torch.isfinite(x).all()) for x in sh["logits"]), f"(e) {name}: finite logits")
        C.check(all(kk == (layers, layers) for kk in sh["prefill"]) and all(kk == (layers, layers) for kk in sh["steps"]),
                f"(e) {name}: {layers} K2 a prefill and {layers} K1 a step, each through the DTensor path: "
                f"{sh['prefill']}, {sh['steps']}")
        C.check(all(kk == (layers, 0) for kk in one["prefill"]) and all(kk == (layers, 0) for kk in one["steps"]),
                f"(e) {name} on one card: {layers} K2 a prefill and {layers} K1 a step: {one['prefill']}, {one['steps']}")
        return r

    args = (dev, plan.serve_lens, plan.serve_steps, plan.serve_max_len)
    one = serve_run(cfg, weights(cfg), *args)
    free(dev)
    sh = serve_run(cfg, weights(cfg), *args, mesh=mesh, profiled=plan.profiled)
    free(dev)
    out["dense"] = report("dense", cfg.name, sh, one, L)
    del one, sh
    free(dev)

    cut = dataclasses.replace(cfg, num_layers=plan.serve_cut_layers, compute_dtype="float32")
    one = serve_run(cut, weights(cut, torch.float32), *args)
    sh = serve_run(cut, weights(cut, torch.float32), *args, mesh=mesh)
    ccmp = compare(sh, one)
    out["dense_cut_fp32"] = ccmp
    say(rank, f"(e) {cfg.name} cut to {plan.serve_cut_layers} layers, fp32, on (1, {WORLD}) against one card: streams "
              f"part at step {ccmp['parts_at_step']} of {ccmp['steps']}, logits' largest gap {ccmp['max_abs_gap']:.3e} "
              f"(tol {C.SERVE_CUT_TOL})")
    C.check(ccmp["parts_at_step"] is None and ccmp["max_abs_gap"] < C.SERVE_CUT_TOL,
            f"(e) fp32 cut across cards vs one card: {ccmp}")
    del one, sh
    free(dev)

    mcfg = plan.config(plan.moe)
    ref = torch.load(work / "ref_moe_serve.pt", weights_only=False)
    sh = serve_run(mcfg, weights(mcfg), dev, plan.moe_serve_lens, plan.moe_serve_steps, plan.serve_max_len, mesh=mesh,
                   profiled=plan.profiled)
    out["moe"] = report("moe", mcfg.name, sh, ref, mcfg.num_layers)
    out["moe"]["one_card_device_name"] = ref["device_name"]
    del sh
    free(dev)
    return out


def rank_main(rank: int, plan: Plan, work: str) -> None:
    """Every phase on this rank; rank 0 writes the record to
    ``work/ranks.json`` after each phase."""
    work = Path(work)
    dev = torch.device(plan.device, rank) if plan.cuda else torch.device("cpu")
    if plan.cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    rec = {"phase_s": {}}
    phases = (("decode", lambda: decode_phase(rank, plan, dev)),
              ("pipeline", lambda: pipeline_phase(rank, plan, dev)),
              ("train", lambda: train_phase(rank, plan, dev, work, moe=False)),
              ("train_moe", lambda: train_phase(rank, plan, dev, work, moe=True)),
              ("serve", lambda: serve_phase(rank, plan, dev, work)))
    if plan.cuda:
        phases += (("decode_graph", lambda: graph_decode_phase(rank, plan, dev)),)
    for name, fn in phases:
        t0 = time.perf_counter()
        with counted_plain(plan):
            rec[name] = fn()
        free(dev)
        rec["phase_s"][name] = time.perf_counter() - t0
        say(rank, f"phase {name}: {rec['phase_s'][name]:.1f} s")
        if rank == 0:
            (work / "ranks.json").write_text(json.dumps(rec, indent=1, default=str))


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------


def _child(args: list, env: dict) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, str(Path(__file__).resolve()), *args], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def run(plan: Plan, work: Path, timeout_s: float = 900.0) -> dict:
    """The whole run: the count and the references in processes of their
    own, then the ranks; returns the record (the references', the ranks'
    and the counts' figures and the dry-run's comparison)."""
    from repro_torch.launch.mesh import spawn_ranks

    work.mkdir(parents=True, exist_ok=True)
    (work / "plan.pkl").write_bytes(pickle.dumps(plan))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    counter = _child(["--count", str(work)], env)
    refs = {name: _child(["--reference", name, str(work)],
                         dict(env, CUDA_VISIBLE_DEVICES=str(i)) if plan.cuda else env)
            for i, name in enumerate(REFERENCES)}
    try:
        t0 = time.perf_counter()
        for name, proc in refs.items():
            text, _ = proc.communicate(timeout=timeout_s)
            print(text.rstrip(), flush=True)
            C.check(proc.returncode == 0, f"the one-card reference {name} exited {proc.returncode}")
        record = {"references_s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        spawn_ranks(rank_main, WORLD, args=(plan, str(work)), backend=plan.backend,
                    init_method=f"file://{work.resolve()}/rendezvous-{os.getpid()}", timeout_s=300)
        record["ranks_s"] = time.perf_counter() - t0
        record["ranks"] = json.loads((work / "ranks.json").read_text())
        text, _ = counter.communicate(timeout=timeout_s)
        print(text.rstrip(), flush=True)
        C.check(counter.returncode == 0, f"the dry-run's count exited {counter.returncode}")
    finally:  # no process outlives the run
        for proc in (counter, *refs.values()):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    record["counts"] = json.loads((work / "counts.json").read_text())
    record["dryrun_vs_measured"] = dryrun_vs_measured(record)
    return record


def dryrun_vs_measured(record: dict) -> dict:
    """(f) Each counted step beside what the ranks measured: the peak per
    card (the largest rank's) and NCCL's device ms a step (the largest
    rank's)."""
    ranks, counts = record["ranks"], record["counts"]
    measured = {
        "train": ranks["train"]["sharded"], "train_moe": ranks["train_moe"]["sharded"],
        "serve_prefill": ranks["serve"]["dense"], "serve_decode": ranks["serve"]["dense"],
        "serve_moe_prefill": ranks["serve"]["moe"], "serve_moe_decode": ranks["serve"]["moe"],
    }
    out = {}
    for name, c in counts.items():
        m = measured[name]
        peak = max(m["peak_gib_per_rank"]) if m["peak_gib_per_rank"][0] is not None else None
        nccl = [d["nccl_ms"] for d in m["device_per_rank"] if d] or [None]
        counted = c["peak_bytes_per_dev"] / 2**30
        row = {"counted_peak_gib": counted, "measured_peak_gib": peak,
               "peak_ratio": None if not peak else max(counted / peak, peak / counted),
               "counted_collective_bytes_per_dev": c["collective_bytes_per_dev"],
               "collectives": c["collectives"], "predicted_t_collective_s": c["t_collective"],
               "measured_nccl_ms": max(nccl) if nccl[0] is not None else None,
               "measured_on": "the step the peak covers (a serve: its prefills and decode steps together)"}
        row["gap_over_2x"] = bool(row["peak_ratio"] and row["peak_ratio"] > PEAK_GAP)
        out[name] = row
        print(f"(f) {name}: counted peak {counted:.3f} GiB a device against measured "
              + (f"{peak:.3f}" if peak is not None else "not measured")
              + f" ({'a gap over 2x: a fault to explain' if row['gap_over_2x'] else 'within 2x'}); counted "
              f"collectives {c['collective_bytes_per_dev'] / 1e6:.3f} MB a device, predicted t_collective "
              f"{c['t_collective'] * 1e3:.4f} ms against NCCL's measured "
              + (f"{row['measured_nccl_ms']:.4f} ms" if row["measured_nccl_ms"] is not None else "not measured"),
              flush=True)
    return out


def card_lines() -> dict:
    """``nvidia-smi``'s name and power limit of every card, and the host's
    links: ``nvidia-smi topo -m``, and ``nvidia-smi nvlink --status`` beside
    it (a sandboxed host may refuse the first)."""
    def smi(*args) -> str:
        r = subprocess.run(["nvidia-smi", *args], capture_output=True, text=True)
        return (r.stdout + r.stderr).rstrip()

    return {"cards": smi("--query-gpu=name,power.limit", "--format=csv,noheader").splitlines(),
            "topology": smi("topo", "-m"), "nvlink": smi("nvlink", "--status"), "host_cpu": C.host_cpu()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write every figure to this JSON file")
    ap.add_argument("--work", default=str(ROOT / "results" / "multicard"), help="scratch for the processes' records")
    ap.add_argument("--reference", nargs=2, metavar=("NAME", "WORK"), help=argparse.SUPPRESS)
    ap.add_argument("--count", metavar="WORK", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.reference:
        name, work = args.reference
        reference(name, pickle.loads((Path(work) / "plan.pkl").read_bytes()), Path(work))
        return 0
    if args.count:
        count_cells(pickle.loads((Path(args.count) / "plan.pkl").read_bytes()), Path(args.count) / "counts.json")
        return 0
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < WORLD:
        print(f"multicard_smoke: needs {WORLD} CUDA devices, one NCCL rank a card; this host has {have}",
              file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    cards = card_lines()
    print("\n".join(cards["cards"]))
    print(cards["topology"])
    print(cards["nvlink"][:3000])
    print(f"host: {cards['host_cpu']}", flush=True)
    from repro_torch.kernels import _build

    built = _build.build()
    print("built " + ", ".join(f"{k} {v['seconds']:.1f} s" for k, v in built.items()), flush=True)
    record = {"cards": cards, "torch": torch.__version__, "cuda": torch.version.cuda,
              **run(Plan(), Path(args.work))}
    record["wall_s"] = time.perf_counter() - t0
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1, default=str))
    r = record["ranks"]
    print(cards["cards"][0])
    print(json.dumps({"ok": True, "world": WORLD, "cards": cards["cards"], "wall_s": round(record["wall_s"], 1),
                      "k1_across_cards_ms": r["decode"].get("times", {}).get("ms_events"),
                      "k1_across_cards_graph_ms": r.get("decode_graph", {}).get("ms_graph"),
                      "train_ms": r["train"]["sharded"]["ms"], "serve_step_ms_median":
                          float(np.median(r["serve"]["dense"]["sharded"]["ms"]))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
