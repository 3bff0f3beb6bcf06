"""The spread of a cell's two sets of runs, and the bound it gives.

    python3 perfbench/tools/spread.py <summary.jsonl> [...]

Reads ``tools/runs.py`` summaries in which a cell's runs come as two sets
of the same seeds (the first run of a seed is in the first set). For each
end-to-end metric of each cell: each set's median and its spread (the
distance between the first and third quartiles, as
``statistics.quantiles(values, n=4)`` gives them, over the median), the
wider spread, five times it as the bound it suggests (at least 1 %, at
most 25 %), and the tightness reading (the mean of the two sets' spreads,
each set's run farthest from its median left out).
"""

from __future__ import annotations

import json
import statistics
import sys
from collections import defaultdict


def spread(v):
    q1, med, q3 = statistics.quantiles(v, n=4)
    return (q3 - q1) / med


def trimmed(v):
    med = statistics.median(v)
    far = max(range(len(v)), key=lambda i: abs(v[i] - med))
    return [x for i, x in enumerate(v) if i != far]


def main() -> None:
    runs = defaultdict(list)
    for path in sys.argv[1:]:
        for line in open(path):
            r = json.loads(line)
            if r.get("rc") == 0 and "metrics" in r and "breakdown" not in r:
                wl, seed, trace = r["run"].split("-", 1)[1].rsplit("-", 2)
                if trace == "0":
                    runs[wl].append((seed, r))
    for wl, rs in runs.items():
        sets = [[], []]
        seen = set()
        for seed, r in rs:
            sets[seed in seen].append(r)
            seen.add(seed)
        ok = sum(bool(r["correct"]) for _, r in rs)
        print(f"== {wl}: {len(sets[0])} + {len(sets[1])} runs, correct {ok}/{len(rs)}")
        for m in sets[0][0]["metrics"]:
            vals = [[r["metrics"][m]["value"] for r in s] for s in sets if len(s) >= 3]
            if not vals:
                continue
            sp = [spread(v) for v in vals]
            tight = statistics.mean(spread(trimmed(v)) for v in vals) if all(len(v) >= 4 for v in vals) else None
            print(f"  {m}: medians {[round(statistics.median(v), 4) for v in vals]} spreads "
                  f"{[round(s, 4) for s in sp]} bound {min(0.25, max(0.01, 5 * max(sp))):.4f} "
                  f"tight {tight if tight is None else round(tight, 4)} values {vals}")


if __name__ == "__main__":
    main()
