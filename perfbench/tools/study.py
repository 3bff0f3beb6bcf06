"""The readings a cell's limits are set from, taken on the card at the
cell's own size, in one process.

    python3 perfbench/tools/study.py --workload <name> --seeds <a,b,...> \\
        --seconds <s> [--control <n>] [--faults <n>] --out <file.jsonl>

For each seed it runs the cell (weights, traffic, warm-up and a short window
at the cell's own load, as ``run.py`` does) and reads the numbers that
may be compared: a served cell's widest and mean gap, a training cell's
loss, gradient and change gaps. On the first ``--control`` seeds it reads
the control beside them: the reference computed with float8 products put in
the program's place (served: the widest and mean gap of the tokens the
control puts first at the served positions, ``control_gap`` and
``control_mean_gap``; training: the control's steps against the float32
reference's).
On the first ``--faults`` seeds of a training cell it plants half a batch
left out in the program and reads that too. One JSON line per reading.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchlib import host  # noqa: E402

host.pin_caches()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--faults", type=int, default=0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()

    import torch

    from benchlib import judge, program, serve, spec, traffic, train

    cell = spec.resolve(args.workload)
    cell.device, cell.seconds, cell.trace, cell.clock = "cuda", args.seconds, False, host.seconds_since_start
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)

    def write(rec):
        rec["card"] = torch.cuda.get_device_name(0)
        line = json.dumps(rec)
        print(line, flush=True)
        with open(out, "a") as f:
            f.write(line + "\n")

    seeds = [int(s) for s in args.seeds.split(",")]
    for i, seed in enumerate(seeds):
        cell.seed = seed
        t = time.perf_counter()
        if cell.mix["kind"] == "train":
            data = train.run(cell, cell.ref, {})
            got = data["finish"]()
            write({"seed": seed, "kind": "program", **got, "wall_s": time.perf_counter() - t})
            d = cell.ref.dims(cell.cfg)
            mix = cell.mix

            def batches(j, seed=seed):
                return traffic.microbatch(mix, seed, j, d.V, "cuda")["tokens"]

            if i < args.control:
                gc.collect()
                torch.cuda.empty_cache()
                refs = {}
                for quant in (None, "fp8"):
                    start = cell.ref.make_params(cell.cfg, seed, "cuda", torch.float32)
                    refs[quant] = cell.ref.train(cell.cfg, start, batches, mix["optimizer"], mix["check_steps"],
                                                 mix["microbatches"], quant=quant)
                    del start
                    gc.collect()
                    torch.cuda.empty_cache()
                write({"seed": seed, "kind": "control", **judge.train_gaps(refs["fp8"], refs[None])})
            if i < args.faults:
                make = program.trainer

                def half(*a, **k):
                    coord, opt_state = make(*a, **k)
                    grad = coord.grad_fn
                    coord.grad_fn = lambda p, b: grad(p, {key: v[: v.shape[0] // 2] for key, v in b.items()})
                    return coord, opt_state

                program.trainer = half
                try:
                    data = train.run(cell, cell.ref, {})
                    write({"seed": seed, "kind": "fault_half_batch", **data["finish"]()})
                finally:
                    program.trainer = make
        else:
            data = serve.run(cell, cell.ref, {})
            if i < args.control:
                # the judge of run.py, with the control read on the same sample
                orig = judge.serve_gaps
                judge.serve_gaps = lambda *a, **k: orig(*a, **{**k, "control": True})
                try:
                    got = data["finish"]()
                finally:
                    judge.serve_gaps = orig
            else:
                got = data["finish"]()
            write({"seed": seed, "kind": "program", **got, "attempted": data["attempted"],
                   "failed": data["failed"], "wall_s": time.perf_counter() - t})
        del data  # its judge holds the seed's weights
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
