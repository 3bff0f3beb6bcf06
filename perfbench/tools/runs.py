"""Run cells of the benchmark one after another, each in its own process
as the check runs them, and summarise them.

    python3 perfbench/tools/runs.py --out chiprun_out/<dir> \\
        --run <workload>:<seed>:<seconds>:<trace> [--run ...]

Each run's standard output and error go to ``<dir>/<i>-<workload>-<seed>-<trace>.{out,err}``;
one line per run (exit code, wall seconds, ``correct``, metrics, checks and
the set-up phases) goes to ``<dir>/summary.jsonl`` and to standard output.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--run", action="append", default=[])
    ap.add_argument("--timeout", type=float, default=1300)
    args = ap.parse_args()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for i, spec in enumerate(args.run):
        wl, seed, secs, trace = spec.split(":")
        tag = f"{i:02d}-{wl}-{seed}-{trace}"
        t = time.perf_counter()
        try:
            p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", wl, "--seed", seed,
                                "--seconds", secs, "--trace", trace], capture_output=True, text=True,
                               timeout=args.timeout)
            rc, so, se = p.returncode, p.stdout, p.stderr
        except subprocess.TimeoutExpired as e:
            rc, so, se = 124, e.stdout or "", e.stderr or ""
            so, se = (x.decode() if isinstance(x, bytes) else x for x in (so, se))
        wall = time.perf_counter() - t
        (out / f"{tag}.out").write_text(so)
        (out / f"{tag}.err").write_text(se)
        line = {"run": tag, "rc": rc, "wall_s": round(wall, 2)}
        for raw in so.splitlines():
            try:
                obj = json.loads(raw)
            except ValueError:
                continue
            if isinstance(obj, dict):
                line.update({k: v for k, v in obj.items() if k != "breakdown"})
        if rc != 0:
            line["stderr_tail"] = se[-1500:]
        text = json.dumps(line)
        print(text, flush=True)
        with open(out / "summary.jsonl", "a") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
