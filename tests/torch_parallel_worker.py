"""Ranks of the multi-rank runs of ``tests/test_torch_parallel.py``.

``python tests/torch_parallel_worker.py OUT_DIR [gloo|nccl]`` starts the
backend's ranks with ``torch.multiprocessing`` (``launch/mesh.py::
spawn_ranks``, a ``file://`` rendezvous in OUT_DIR, so that concurrent
test workers never race for a port): 8 gloo ranks on the CPU (the
default), or 4 NCCL ranks, one a card (it raises on a host with fewer).
``BACKENDS`` gives each backend's meshes: ``main`` (gloo (2, 4), NCCL
(2, 2)), ``pipe`` ((4, 2), (4, 1)), ``serve`` and ``moe`` ((2, 4), (1, 4):
the cache's sequence and the experts over a 4-way model axis). On them,
in order: ``sharded_decode_attention`` on ``main``, both paths; the K1
wrapper on head-sharded DTensors; ``pipeline_apply`` on ``pipe``
("pod", "data"); one sharded ``make_train_step`` of internlm2-1.8b cut to
2 layers (weights from OUT_DIR/train_in.pt); the forward loss with rules
of moonshot-v1-16b-a3b-smoke, xlstm-1.3b-smoke and internlm2-1.8b-smoke
with 6 q heads padded to 8; the sharded serve steps on ``serve``
(``serve``): internlm2 cut to 2 layers (prefill of 4 prompts, 6 greedy
decode steps) on the kernel path, with a row parked, over a
sliding-window ring that wraps, and on the einsum path with a row parked
from the start (no valid key), and the ``-smoke`` configs of xlstm, jamba
and moonshot with a row parked; the sharded ``lm_loss`` on ``main`` with
the sequence over ``model`` and with the vocabulary over it (``loss``),
and moonshot-v1-16b-a3b-smoke's ``moe_apply`` with rules on ``moe``, each
data rank routing its own groups (``moe``: training, inference, and 6
experts that the 4-way model axis does not divide). On the cards the
attention configs take heads of 64 (:func:`on_device`: K1 and K2 take
head_dim 64, 128 or 256) and every kernel runs; on the CPU their plain
versions. Rank 0 writes every result, as CPU tensors, to
OUT_DIR/results.pt; the test compares them with the JAX package (gloo)
and with the port in one process (both backends). Imports no JAX.
"""

import os
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

# backend -> (ranks, device, meshes)
BACKENDS = {
    "gloo": (8, "cpu", {"main": (2, 4), "pipe": (4, 2), "serve": (2, 4), "moe": (2, 4)}),
    "nccl": (4, "cuda", {"main": (2, 2), "pipe": (4, 1), "serve": (1, 4), "moe": (1, 4)}),
}
KERNEL_HEAD_DIM = 64  # the attention configs' heads on the cards
DECODE_SHAPE = (4, 256, 8, 2, 64)  # B, S, H, KH, D, as tests/test_distributed.py
PIPE_SHAPE = (4, 6, 2, 8)  # P, M, B, D, as tests/test_pipeline.py
TRAIN_BATCH = (8, 32)
# forward with rules: arch (":pad6" = 6 q heads over 2 kv heads, padded to 8
# for the 4-way model axis): sequence length
FWD_ARCHS = {"moonshot-v1-16b-a3b-smoke": 16, "xlstm-1.3b-smoke": 8, "internlm2-1.8b-smoke:pad6": 16}
# the serve cases: name -> (arch or "cut" for the train-step cut, sliding
# window, decode path, the step from which row 1 is parked (None: never;
# 0: from the first decode step)); 4 prompts of 12 tokens, a cache of 24
# (the window's ring: 8), SERVE_STEPS greedy decode steps
SERVE_CASES = {
    "cut": ("cut", 0, "kernel", None),
    "cut/parked": ("cut", 0, "kernel", 2),
    "cut/window": ("cut", 8, "kernel", None),
    "cut/einsum": ("cut", 0, "einsum", 0),
    "xlstm-1.3b-smoke": ("xlstm-1.3b-smoke", 0, "kernel", 2),
    "jamba-1.5-large-398b-smoke": ("jamba-1.5-large-398b-smoke", 0, "kernel", 2),
    "moonshot-v1-16b-a3b-smoke": ("moonshot-v1-16b-a3b-smoke", 0, "kernel", 2),
}
SERVE_PROMPT, SERVE_MAX_LEN, SERVE_STEPS = (4, 12), 24, 6
# the sharded loss: logits (B, S, V) laid out ("batch", "sp", "tp"), so the
# sequence over model with sequence parallelism and the vocabulary without
LOSS_SHAPE = (8, 16, 64)
# the sharded MoE of moonshot-v1-16b-a3b-smoke in fp32, dispatch groups of
# 64: case -> (inference, x's (B, S), config overrides). "train/e6": 6
# experts, which the 4-way model axis does not divide, so each rank takes
# its slots (3 groups a data rank, 11 slots an expert: 33 rows, cut
# unevenly), at a capacity factor that drops pairs
MOE_CASES = {"train": (False, (8, 128), {}), "inference": (True, (8, 128), {}),
             "train/e6": (False, (6, 64), {"num_experts": 6, "moe_capacity_factor": 0.5})}


def on_device(cfg, device: str):
    """``cfg`` as it runs on ``device``: on a card an attention config's
    heads are KERNEL_HEAD_DIM wide (the smoke configs' 16 are below what
    K1 and K2 take)."""
    import dataclasses

    if device == "cpu" or not any(cfg.layer_kind(i) == "attn" for i in range(cfg.num_layers)):
        return cfg
    return dataclasses.replace(cfg, head_dim=KERNEL_HEAD_DIM)


def to_device(tree, device):
    """Every tensor of a tree (dicts, lists, tuples) moved to ``device``;
    other leaves as they are."""
    from repro_torch.models.common import tree_map

    return tree_map(lambda t: t.to(device) if isinstance(t, torch.Tensor) else t, tree)


def decode_inputs(case: str):
    """q, k, v, valid for a decode case, from a numpy seed. ``edge``: row 0
    has no valid key, row 3 has valid keys in the first quarter of the
    sequence only (the first shard of 2 or 4)."""
    B, S, H, KH, D = DECODE_SHAPE
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KH, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KH, D)).astype(np.float32)
    valid = rng.random((B, S)) > 0.2
    if case == "edge":
        valid[0] = False
        valid[3, S // 4:] = False
    return q, k, v, valid


def pipe_inputs():
    P, M, B, D = PIPE_SHAPE
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((P, D, D)) * 0.3).astype(np.float32)
    x = rng.standard_normal((M, B, D)).astype(np.float32)
    return w, x


def train_batch():
    rng = np.random.default_rng(1)
    shape = TRAIN_BATCH
    return {"tokens": rng.integers(0, 64, shape), "labels": rng.integers(0, 64, shape),
            "mask": np.ones(shape, np.float32)}


def train_setup(device: str = "cpu"):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig

    cfg = get_config("internlm2-1.8b").reduced(num_layers=2, d_model=64, vocab_size=64,
                                               param_dtype="float32", compute_dtype="float32")
    return on_device(cfg, device), RunConfig(remat="none", attention_impl="pallas", z_loss=0.0)


def port_train_start(device: str = "cpu") -> dict:
    """The train-step cut's weights (seeded, on the CPU) and AdamW state as
    it runs on ``device``, from the port alone (where the JAX package is
    missing: on the cards)."""
    from repro_torch.models import model as M
    from repro_torch.optim import adamw

    params = M.init_model(train_setup(device)[0], torch.Generator().manual_seed(0))
    return {"params": params, "opt": adamw.init_opt_state(params)}


def loss_inputs():
    """fp32 logits, labels in every one of the 4 vocab shards, and a mask
    with two positions masked out."""
    B, S, V = LOSS_SHAPE
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((B, S, V)) * 3).astype(np.float32)
    labels = rng.integers(0, V, (B, S))
    labels[0, :4] = [3, 17, 40, 63]
    mask = np.ones((B, S), np.float32)
    mask[1, 5] = mask[6, S - 1] = 0.0
    return logits, labels, mask


def moe_setup(case: str):
    """``(cfg, params, x, w)`` of a MoE case: the first layer's MoE weights
    of a seeded fp32 model, x, and the weights ``w`` of the test loss
    ``(y * w).sum() + moe_aux``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    _, shape, over = MOE_CASES[case]
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b-smoke"), param_dtype="float32",
                              compute_dtype="float32", **over)
    params = M.init_model(cfg, torch.Generator().manual_seed(0))["layers"][0]["moe"]
    rng = np.random.default_rng(6)
    x, w = (torch.from_numpy(rng.standard_normal((*shape, cfg.d_model)).astype(np.float32)) for _ in range(2))
    return cfg, params, x, w


def moe_run(case: str, params, x, w, rules=None) -> dict:
    """``moe_apply`` of a MoE case (with ``rules`` on DTensors ``params``
    and ``x``): y, the metrics, the gradients of x and of every weight
    (plain tensors), and the routing each call of ``route`` made."""
    from unittest import mock

    from repro_torch.models import moe
    from repro_torch.models.common import tree_leaves, tree_unflatten
    from repro_torch.parallel.sharding import sharded_context

    cfg, _, _, _ = moe_setup(case)
    seen, real = [], moe.route

    def spy(*a, **k):
        r = real(*a, **k)
        seen.append(r)
        return r

    live = [t.detach().requires_grad_() for t in [x, *tree_leaves(params)]]
    with mock.patch.object(moe, "route", spy), torch.enable_grad(), sharded_context(rules):
        y, aux = moe.moe_apply(cfg, tree_unflatten(params, live[1:]), live[0], MOE_CASES[case][0], rules)
        grads = torch.autograd.grad((y * w).sum() + aux["moe_aux"], live)
    return {"y": _full(y.detach()), "aux": {k: _full(v.detach()).item() for k, v in aux.items()},
            "grads": [_full(g) for g in grads],
            "routing": [(r.top_i.cpu(), r.pos.cpu(), r.keep.cpu(), r.cap) for r in seen]}


def fwd_setup(arch: str, device: str = "cpu"):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import model as M

    name, _, pad = arch.partition(":")
    heads = {"num_heads": 6, "num_kv_heads": 2} if pad else {}
    cfg = on_device(get_config(name).reduced(param_dtype="float32", compute_dtype="float32", **heads), device)
    params = to_device(M.init_model(cfg, torch.Generator().manual_seed(0)), device)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (8, FWD_ARCHS[arch]))
    run = RunConfig(remat="none", attention_impl="pallas", ssd_chunk=8, pad_attention_heads_to=4 if pad else 0)
    return cfg, run, params, tokens


def fwd_loss(cfg, run, params, tokens, rules=None):
    """The forward's LM loss of ``tokens`` against themselves shifted."""
    from repro_torch.launch.steps import _to_device
    from repro_torch.models import model as M
    from repro_torch.models.common import tree_leaves
    from repro_torch.parallel.sharding import sharded_context

    b = _to_device({"tokens": tokens}, tree_leaves(params)[0].device, rules)
    with sharded_context(rules):
        logits, aux = M.forward(cfg, run, params, b["tokens"], rules=rules)
        loss = M.lm_loss(cfg, run, logits[:, :-1], b["tokens"][:, 1:], None, aux)[0]
    return loss.full_tensor() if hasattr(loss, "full_tensor") else loss


def serve_setup(case: str, params=None, device: str = "cpu"):
    """``(cfg, run, params, prompts, active per decode step)`` of a serve
    case, the params on ``device``; the cut uses ``params`` (the train-step
    cut's weights), the smoke configs fp32 weights from a seeded
    generator."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import model as M

    arch, window, impl, parked = SERVE_CASES[case]
    if arch == "cut":
        cfg = dataclasses.replace(train_setup(device)[0], sliding_window=window)
    else:
        cfg = on_device(dataclasses.replace(get_config(arch), param_dtype="float32", compute_dtype="float32"), device)
        params = M.init_model(cfg, torch.Generator().manual_seed(0))
    params = to_device(params, device)
    run = RunConfig(attention_impl="pallas", decode_attention_impl=impl, ssd_chunk=8)
    prompts = np.random.default_rng(4).integers(0, cfg.vocab_size, SERVE_PROMPT)
    b = SERVE_PROMPT[0]
    active = [None if parked is None or i < parked else np.arange(b) != 1 for i in range(SERVE_STEPS)]
    return cfg, run, params, prompts, active


def serve(cfg, run, params, prompts, active, rules=None) -> dict:
    """Prefill ``prompts`` and decode SERVE_STEPS greedy steps (tokens each
    row's argmax), ``active[i]`` the mask of step i. Returns the logits and
    tokens of every step and the whole cache (plain tensors) after the
    prefill and after each step."""
    from repro_torch.launch.steps import _to_device, make_prefill_step, make_serve_step
    from repro_torch.models import model as M
    from repro_torch.models.common import tree_leaves

    device = tree_leaves(params)[0].device
    logits, cache = make_prefill_step(cfg, run, rules, SERVE_MAX_LEN)(params, {"tokens": prompts})
    out = {"logits": [_full(logits)], "tokens": [], "caches": [_full(cache)]}
    step = make_serve_step(cfg, run, rules)
    for i, act in enumerate(active):
        tok = out["logits"][-1].argmax(-1)
        out["tokens"].append(tok)
        if act is None:
            logits, cache = step(params, cache, {"tokens": tok.numpy()})
        else:  # the serve step takes tokens only, as the reference's: a parked row goes through decode_step
            b = _to_device({"tokens": tok.numpy()}, device, rules)
            logits, cache = M.decode_step(cfg, run, params, cache, b["tokens"], active=torch.as_tensor(act, device=device),
                                          rules=rules)
        out["logits"].append(_full(logits))
        out["caches"].append(_full(cache))
    return out


def _layout(placements) -> list:
    """Each placement as the tensor dim it shards, or "R" (replicated)."""
    return [p.dim if p.is_shard() else "R" for p in placements]


def _full(tree):
    """A tree's tensors whole (DTensors gathered) and on the CPU."""
    from repro_torch.models.common import tree_map

    return tree_map(lambda t: (t.full_tensor() if hasattr(t, "full_tensor") else t).cpu(), tree)


def rank_main(rank: int, out: str, backend: str = "gloo"):
    world, device, meshes = BACKENDS[backend]
    torch.set_num_threads(1)
    if device == "cuda":  # the one-process references are held to these bits: no TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh, parse_mesh_arg
    from repro_torch.launch.steps import distribute_tree, make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.parallel.flash_decode import sharded_decode_attention
    from repro_torch.parallel.pipeline import pipeline_apply
    from repro_torch.parallel.sharding import rules_from_mesh, sharded_context

    res = {"backend": backend, "world": world, "meshes": meshes}
    mesh = make_mesh(meshes["main"], device=device)
    res["mesh"] = (tuple(mesh.mesh_dim_names), tuple(mesh.shape),
                   tuple(parse_mesh_arg("x".join(map(str, meshes["main"])), device=device).mesh_dim_names))
    for case in ("random", "edge"):
        q, k, v, valid = (torch.from_numpy(a) for a in decode_inputs(case))
        for use_kernel in (True, False):
            o = sharded_decode_attention(q, k, v, valid, mesh, use_kernel=use_kernel)
            res[f"decode/{case}/{use_kernel}"] = (_full(o), _layout(o.placements))
    try:
        sharded_decode_attention(q, k[:, :255], v[:, :255], valid[:, :255], mesh)
        res["decode/indivisible"] = "no error"
    except ValueError as e:
        res["decode/indivisible"] = str(e)

    # the K1 wrapper on DTensors: q's heads over model, k and v replicated
    # over it (2 kv heads, each rank slicing its own) or split with q's (8)
    rules = rules_from_mesh(mesh)
    q, k, v, valid = (torch.from_numpy(a) for a in decode_inputs("edge"))
    for kh in (2, 8):
        kk, vv = (t[:, :, :1].expand(-1, -1, kh, -1).contiguous() + torch.arange(kh)[:, None] * 0.1
                  for t in (k, v))
        args = [distribute_tree(t, rules.spec(axes, t.shape), mesh) for t, axes in (
            (q, ("batch", "tp", None)), (kk, ("batch", None, "tp", None)), (vv, ("batch", None, "tp", None)),
            (valid, ("batch", None)))]
        o = ops.decode_attention(*args)
        res[f"decode_wrapper/{kh}"] = (_full(o), _layout(o.placements), (q, kk, vv, valid))

    pmesh = make_mesh(meshes["pipe"], ("pod", "data"), device=device)
    w, x = (torch.from_numpy(a).to(device) for a in pipe_inputs())
    res["pipeline"] = _full(pipeline_apply(lambda wi, h: torch.tanh(h @ wi), w, x, pmesh, stage_axis="pod"))

    cfg, run = train_setup(device)
    start = torch.load(Path(out) / "train_in.pt")
    specs = M.model_specs(cfg, rules)
    params = distribute_tree(start["params"], specs, mesh)
    opt = distribute_tree(start["opt"], adamw.opt_state_specs(specs), mesh)
    params, opt, metrics = make_train_step(cfg, run, rules)(params, opt, train_batch())
    res["train"] = {"params": _full(params), "mu": _full(opt["mu"]),
                    "metrics": {k: v.item() for k, v in metrics.items()},
                    "placements": _layout(params["layers"][0]["attn"]["wq"].placements)}

    for arch in FWD_ARCHS:
        fcfg, frun, fparams, tokens = fwd_setup(arch, device)
        dparams = distribute_tree(fparams, M.model_specs(fcfg, rules), mesh)
        res[f"forward/{arch}"] = fwd_loss(fcfg, frun, dparams, tokens, rules).item()

    from unittest import mock

    from repro_torch.models import attention as A

    calls = []

    def spy(*a, **k):  # K1 over the sequence shards: count the calls
        calls.append(k.get("use_kernel", True))
        return sharded_decode_attention(*a, **k)

    cut_params = torch.load(Path(out) / "train_in.pt")["params"]  # the train step updated start's in place
    smesh = make_mesh(meshes["serve"], device=device)
    srules = rules_from_mesh(smesh)
    for case in SERVE_CASES:
        cfg, run, sparams, prompts, active = serve_setup(case, cut_params, device)
        dparams = distribute_tree(sparams, M.model_specs(cfg, srules), smesh)
        calls.clear()
        with mock.patch.object(A, "sharded_decode_attention", spy):
            got = serve(cfg, run, dparams, prompts, active, srules)
        got["sharded_decode_calls"] = list(calls)
        cache = M.init_cache(cfg, SERVE_PROMPT[0], SERVE_MAX_LEN, device, srules)
        got["placements"] = {k: _layout(t.placements) for k, t in cache.items() if not isinstance(t, dict)}
        res[f"serve/{case}"] = got

    from repro_torch.configs.base import RunConfig
    from repro_torch.models import moe
    from repro_torch.models.common import build_specs

    logits, labels, mask = (torch.from_numpy(a).to(device) for a in loss_inputs())
    for sp in (True, False):
        lrules = rules_from_mesh(mesh, sequence_parallel=sp)
        dl = distribute_tree(logits, lrules.spec(("batch", "sp", "tp"), logits.shape), mesh).requires_grad_()
        dlab, dmask = (distribute_tree(t, lrules.spec(("batch", None), t.shape), mesh) for t in (labels, mask))
        with sharded_context(lrules):
            total, metrics = M.lm_loss(cfg, RunConfig(), dl, dlab, dmask, {})
            (grad,) = torch.autograd.grad(total, [dl])
        res[f"loss/sp={sp}"] = {"metrics": {k: _full(v).item() for k, v in metrics.items()},
                                "grad": _full(grad), "layout": _layout(dl.placements)}

    mmesh = make_mesh(meshes["moe"], device=device)
    mrules = rules_from_mesh(mmesh)
    for case in MOE_CASES:
        mcfg, mparams, x, w = (to_device(t, device) for t in moe_setup(case))
        dparams = distribute_tree(mparams, build_specs(moe.moe_defs(mcfg), mrules), mmesh)
        got = moe_run(case, dparams, distribute_tree(x, mrules.spec(("batch", "sp", None), x.shape), mmesh), w,
                      mrules)
        # every rank's own routing, with its (data, model) coordinate
        ranks = [None] * world
        dist.all_gather_object(ranks, (tuple(mmesh.get_coordinate()), got.pop("routing")))
        got["routing"] = ranks
        got["expert_layout"] = _layout(dparams["gate"].placements)
        res[f"moe/{case}"] = got

    if rank == 0:
        torch.save(res, Path(out) / "results.pt")
    dist.barrier()


def main(out: str, backend: str = "gloo") -> None:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.launch.mesh import spawn_ranks

    out = str(Path(out).resolve())  # a file:// rendezvous needs an absolute path
    spawn_ranks(rank_main, BACKENDS[backend][0], args=(out, backend), backend=backend,
                init_method=f"file://{out}/rendezvous", timeout_s=120 if backend == "gloo" else 300)


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    main(*sys.argv[1:3])
