#!/usr/bin/env python3
"""Where the sharded train step's extra device memory goes.

Runs qwen3-1.7b at full width, one microbatch of 2 x 1024 tokens, through
``make_grad_step`` and ``adamw.adamw_update``, unsharded and then sharded on
a one-rank NCCL (1, 1) mesh (``chip_smoke.py`` phase 20's setup), and
prints for each: the memory held before the step (params and AdamW
state), the peak of the grad step, the memory held after it (plus the
gradients), and the peak of the update, in GiB. Needs one GPU:
``python3 scripts/dist_memory_probe.py`` from the repository root.
"""

from __future__ import annotations

import json
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

GIB = 2**30


def main() -> int:
    if not torch.cuda.is_available():
        print("dist_memory_probe: no CUDA device", file=sys.stderr)
        return 1
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import distribute_tree, make_grad_step
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import rules_from_mesh, sharded_context

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    mesh = make_mesh((1, 1))
    rules = rules_from_mesh(mesh)
    cfg = get_config("qwen3-1.7b")
    run = RunConfig(remat="none", attention_impl="pallas", z_loss=0.0)
    rng = np.random.default_rng(20)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 1024)), "labels": rng.integers(0, cfg.vocab_size, (2, 1024)),
             "mask": np.ones((2, 1024), np.float32)}
    out = {"card": card}
    for name, r in (("unsharded", None), ("sharded", rules)):
        params = M.init_model(cfg, torch.Generator(device="cuda").manual_seed(0))
        opt = adamw.init_opt_state(params)
        if r is not None:
            specs = M.model_specs(cfg, r)
            params = distribute_tree(params, specs, mesh)
            opt = distribute_tree(opt, adamw.opt_state_specs(specs), mesh)
        grad_step = make_grad_step(cfg, run, r)
        grad_step(params, batch)  # warm-up
        torch.cuda.synchronize()
        rec = {"held_before": torch.cuda.memory_allocated() / GIB}
        torch.cuda.reset_peak_memory_stats()
        grads, _ = grad_step(params, batch)
        torch.cuda.synchronize()
        rec["grad_step_peak"] = torch.cuda.max_memory_allocated() / GIB
        rec["held_with_grads"] = torch.cuda.memory_allocated() / GIB
        torch.cuda.reset_peak_memory_stats()
        with sharded_context(r):
            adamw.adamw_update(run, params, grads, opt)
        torch.cuda.synchronize()
        rec["update_peak"] = torch.cuda.max_memory_allocated() / GIB
        out[name] = rec
        print(f"{name}: " + ", ".join(f"{k} {v:.2f} GiB" for k, v in rec.items()) + f" ({card})", flush=True)
        del params, opt, grads
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
