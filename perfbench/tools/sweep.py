"""Find an open-loop cell's knee once: run its traffic at each offered rate
for a window, in one process, and read the tails and the backlog.

    python3 perfbench/tools/sweep.py --workload <name> --seed <n> \\
        --seconds <s> --rates 1.5,2,2.5,3 --out <file.jsonl>

A rate the system sustains drains its window's requests in a few seconds;
past the knee the queue grows through the window and the drain grows with
it. One JSON line a rate: requests, TTFT and queue-wait p90, ITL p99, the
drain's seconds, the requests still waiting at the window's close, and the
widest served gap.
"""

from __future__ import annotations

import argparse
import copy
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
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()

    import torch

    from benchlib import serve, spec

    base = spec.resolve(args.workload)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    for rate in (float(r) for r in args.rates.split(",")):
        cell = copy.copy(base)
        cell.mix = dict(copy.deepcopy(base.mix), rate_per_s=rate)
        cell.seed, cell.seconds, cell.trace, cell.device = args.seed, args.seconds, False, "cuda"
        cell.clock = host.seconds_since_start
        t = time.perf_counter()
        data = serve.run(cell, cell.ref, {})
        data["setup_s"] = 0.0
        reqs = [r for r in data["requests"] if r["arrival"] < args.seconds]
        waiting = sum(1 for r in reqs if r["submitted"] > data["t_close"] or r["first_token"] < 0)
        rec = {"rate": rate, "requests": len(reqs), "failed": data["failed"],
               "waiting_at_close": waiting, "drain_s": max(0.0, data["t_end"] - data["t_close"]),
               **{m: spec.reader(m)(data) for m in ("ttft_p90_ms", "itl_p99_ms", "queue_wait_p90_ms.docqa")},
               "prefill_s": sum(p["seconds"] for p in data["prefills"]),
               "memory_peak_gib": data["memory_peak_bytes"] / 2**30}
        rec.update(data["finish"]())
        rec["wall_s"] = time.perf_counter() - t
        rec["card"] = torch.cuda.get_device_name(0)
        line = json.dumps(rec)
        print(line, flush=True)
        with open(out, "a") as f:
            f.write(line + "\n")
        del data
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
