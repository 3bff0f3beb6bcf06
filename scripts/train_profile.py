"""Where a training microbatch and an update spend the card's time.

Builds the model as ``repro_torch.launch.train.main`` builds it (fp32
master weights from a seeded generator, bf16 compute, K2 forward and the
reference's recompute backward in every attention layer), runs warm-up
grad steps and one update, then traces one grad microbatch and one AdamW
update with ``torch.profiler`` and prints the device time by kernel,
summed over calls, the share of the traced wall in device kernels, and
the device-side span of the recompute backwards (each
``flash_attention_ref_vjp`` call marked with ``record_function``).

Run on a machine with an NVIDIA GPU, from the repository root:

    python3 scripts/train_profile.py [--arch qwen3-1.7b] [--batch 2] [--seq 1024]
        [--top 30] [--out train_profile.json]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
MARK = "flash_attention_ref_vjp"  # the recompute backward's marked range


def profile(fn, label: str, top: int) -> dict:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    attr = "device_time_total" if hasattr(events[0], "device_time_total") else "cuda_time_total"
    on_device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    # record_function also leaves a device-side annotation of each marked
    # range: its span, not a kernel, so it is kept out of the kernel sums
    spans = [e for e in on_device if e.key == MARK]
    kernels = [e for e in on_device if e.key != MARK]
    total_ms = sum(getattr(e, attr) for e in kernels) / 1e3
    rows = sorted(({"name": e.key, "calls": e.count, "ms": getattr(e, attr) / 1e3} for e in kernels),
                  key=lambda r: -r["ms"])
    span_ms = sum(getattr(e, attr) for e in spans) / 1e3
    out = {"label": label, "wall_ms": wall_ms, "kernel_ms": total_ms, "kernel_share_of_wall": total_ms / wall_ms,
           "recompute_backward_span_ms": span_ms, "recompute_backward_calls": spans[0].count if spans else 0,
           "top": rows[:top]}
    print(f"{label}: wall {wall_ms:.2f} ms (under the profiler), device kernels {total_ms:.2f} ms "
          f"({total_ms / wall_ms:.1%} of the wall); the {out['recompute_backward_calls']} recompute backwards span "
          f"{span_ms:.2f} ms on the device")
    for r in rows[:top]:
        print(f"  {r['ms']:9.3f} ms  {r['calls']:5d}  {r['ms'] / total_ms:6.1%}  {r['name'][:110]}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_profile: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.dataset import batch_iterator
    from repro_torch.kernels import _build, ops
    from repro_torch.launch.steps import make_grad_step
    from repro_torch.models import model as M
    from repro_torch.optim import adamw

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    cfg = get_config(args.arch)
    run = RunConfig(remat="none", attention_impl="pallas", total_steps=100, warmup_steps=5)
    params = M.init_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    opt = adamw.init_opt_state(params)
    grad_step = make_grad_step(cfg, run)
    batches = batch_iterator(cfg, args.seq, args.batch, seed=0)
    for _ in range(2):  # warm-up: cuBLAS, the kernels' first launches, the allocator
        grads, _ = grad_step(params, next(batches))
    adamw.adamw_update(run, params, grads, opt)
    del grads
    vjp = ops.flash_attention_ref_vjp

    def marked(*a, **k):
        with torch.profiler.record_function(MARK):
            return vjp(*a, **k)

    batch = next(batches)
    held = {}

    def microbatch():
        held["grads"], _ = grad_step(params, batch)

    with mock.patch.object(ops, "flash_attention_ref_vjp", marked):
        out = {"card": card, "arch": cfg.name, "batch": args.batch, "seq": args.seq,
               "microbatch": profile(microbatch, f"grad microbatch {args.batch} x {args.seq} ({cfg.name})",
                                     args.top)}
    out["update"] = profile(lambda: adamw.adamw_update(run, params, held["grads"], opt), "AdamW update", args.top)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    print(f"peak {out['peak_bytes'] / 2**30:.2f} GiB ({card})")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
