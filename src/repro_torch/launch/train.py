"""End-to-end trainer (the framework's `main`).

Port of ``repro/launch/train.py``. Runs the heterogeneity-aware stack on
one device: capacity-proportional accumulation across logical pods,
weighted (optionally int8-compressed) cross-pod combine, heartbeats,
redundant checkpoints, failure injection + elastic recovery. Every arch
of the port trains. On the card (``--device cuda``, the default) every
attention layer's forward is K2 and every mLSTM and Mamba scan K3, each
with the reference's recompute backward (``kernels/ops.py``); on the CPU
the same autograd functions run the kernels' plain versions. A frontend
arch (musicgen, llava) trains on 8 prefix features before each
microbatch's tokens. ``RunConfig.remat`` is "none", as in the reference's
trainer (``make_grad_step`` also takes "dots" and "full").

Examples
--------
# a smoke-size model for a few steps on the CPU:
PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b-smoke \\
    --device cpu --steps 20 --batch 4 --seq 64

# xlstm-1.3b at full width, or a MoE stack cut to 3 layers, on the card:
PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-1.3b \\
    --steps 3 --batch 2 --seq 1024 --microbatches 3 --pods 1.0,0.5
PYTHONPATH=src python -m repro_torch.launch.train --arch moonshot-v1-16b-a3b \\
    --layers 3 --steps 3 --batch 2 --seq 1024 --microbatches 3

# heterogeneous 4-pod run with a mid-run failure, on the card:
PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b-smoke \\
    --steps 60 --pods 1.0,1.0,0.5,0.25 --kill-pod 2 --kill-at 30 --compress
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.core.coordinator import HetCoordinator, PodRuntime
from repro_torch.data.dataset import batch_iterator
from repro_torch.launch.elastic import ElasticController
from repro_torch.launch.steps import make_grad_step
from repro_torch.models import model as M
from repro_torch.models.common import tree_leaves
from repro_torch.optim import adamw


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b-smoke")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8, help="microbatch (per grain)")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=8, help="grains per global step")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--d-model", type=int, default=0, help="override width (smoke)")
    ap.add_argument("--layers", type=int, default=0, help="override depth (smoke)")
    ap.add_argument("--pods", default="1.0", help="comma speeds, e.g. 1.0,0.5")
    ap.add_argument("--no-het-schedule", action="store_true")
    ap.add_argument("--compress", action="store_true", help="int8+EF cross-pod combine")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--ckpt-redundancy", default="replicate", choices=["replicate", "stripe"])
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--kill-pod", type=int, default=-1)
    ap.add_argument("--kill-at", type=int, default=-1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (their plain versions)")
    return ap


def build_model(args):
    cfg = get_config(args.arch)
    over = {}
    if args.d_model:
        over.update(d_model=args.d_model, head_dim=max(args.d_model // max(cfg.num_heads, 1), 8))
    if args.layers:
        over.update(num_layers=args.layers)
    if over:
        cfg = dataclasses.replace(cfg, **over)
    cfg.validate()
    run = RunConfig(
        learning_rate=args.lr,
        total_steps=args.steps,
        warmup_steps=max(args.steps // 20, 5),
        remat="none",
        attention_impl="pallas",
        attention_chunk=max(64, min(1024, args.seq)),
        ssd_chunk=min(256, args.seq),
        het_schedule=not args.no_het_schedule,
        grad_compression="int8_ef" if args.compress else "none",
    )
    return cfg, run


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train --device cuda: no CUDA device is available; "
                           "pass --device cpu to run the plain path on the CPU")
    cfg, run = build_model(args)
    gen = torch.Generator(device=device).manual_seed(args.seed)

    params = M.init_model(cfg, gen)
    opt_state = adamw.init_opt_state(params, getattr(torch, run.optimizer_dtype))
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M layers={cfg.num_layers} d={cfg.d_model} device={device}")

    grad_fn = make_grad_step(cfg, run)

    def update_fn(p, o, g):
        return adamw.adamw_update(run, p, g, o)

    speeds = [float(s) for s in args.pods.split(",")]
    pods = [PodRuntime(f"pod{i}", s) for i, s in enumerate(speeds)]
    coord = HetCoordinator(
        grad_fn=grad_fn,
        update_fn=update_fn,
        pods=pods,
        total_microbatches=args.microbatches,
        grain_tokens=args.batch * args.seq,
        compress=args.compress,
        het_schedule=run.het_schedule,
    )

    def template():
        return {"params": params, "opt_state": opt_state, "step": torch.zeros((), dtype=torch.int32, device=device)}

    ckpt = None
    if args.ckpt_dir:
        ckpt = CheckpointManager(
            args.ckpt_dir, num_nodes=max(4, len(pods)),
            redundancy=args.ckpt_redundancy, async_save=True,
        )
        elastic = ElasticController(coord, checkpoints=ckpt)
        if args.restore and ckpt.steps():
            state, info = ckpt.restore(ckpt.steps()[-1], template())
            params, opt_state = state["params"], state["opt_state"]
            print(f"restored from step {info['step']}")
        elastic.set_restore_template(template())  # the live state: it holds no other copy
    else:
        elastic = ElasticController(coord)

    batches = batch_iterator(cfg, args.seq, args.batch, seed=args.seed,
                             frontend_prefix=8 if cfg.frontend else 0)
    history = []
    t0 = time.time()
    start_step = int(opt_state["step"])
    for step in range(start_step, args.steps):
        if args.kill_at == step and args.kill_pod >= 0:
            # the pod's heartbeats stop; after the timeout it is pronounced dead
            coord.monitor.pronounce(f"pod{args.kill_pod}", coord._vtime)
            params, opt_state, restored = elastic.maybe_restore(params, opt_state)
            if restored:
                step = int(opt_state["step"])
                print(f"[elastic] pod{args.kill_pod} dead → restored step {step}, "
                      f"{len(coord.alive_pods())} pods remain")
        params, opt_state, rep = coord.step(params, opt_state, batches)
        history.append({"step": step, **rep.metrics,
                        "virtual_s": rep.virtual_step_s, "homo_s": rep.homo_virtual_s,
                        "schedule": list(rep.schedule.microbatches)})
        if step % args.log_every == 0 or step == args.steps - 1:
            m = rep.metrics
            print(f"step {step:5d} loss={m.get('loss', float('nan')):.4f} "
                  f"grad_norm={m.get('grad_norm', 0):.2f} sched={rep.schedule.microbatches} "
                  f"het={rep.virtual_step_s:.2f}s homo={rep.homo_virtual_s:.2f}s")
        if ckpt is not None and step > 0 and step % args.ckpt_every == 0:
            ckpt.save(step, {"params": params, "opt_state": opt_state, "step": opt_state["step"]})
    if ckpt is not None:
        ckpt.wait()
        ckpt.save(args.steps, {"params": params, "opt_state": opt_state, "step": opt_state["step"]})
        ckpt.wait()

    wall = time.time() - t0
    out = {
        "arch": cfg.name,
        "device": str(device),
        "params_m": n_params / 1e6,
        "steps": len(history),
        "first_loss": history[0]["loss"] if history else None,
        "last_loss": history[-1]["loss"] if history else None,
        "wall_s": wall,
        "history": history,
        "elastic_events": [vars(e) for e in elastic.events],
    }
    if args.metrics_out:
        Path(args.metrics_out).write_text(json.dumps(out, indent=2, default=str))
    print(f"done: loss {out['first_loss']:.4f} → {out['last_loss']:.4f} in {wall:.1f}s")
    return out


if __name__ == "__main__":
    main()
