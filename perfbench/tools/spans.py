"""Run one cell traced, as ``run.py --trace 1`` does (the program's own
spans on over its window, ``benchlib/program_spans.py``), and print more of
what its spans hold than the cell's metrics.

    python3 perfbench/tools/spans.py --workload <name> --seed <n> --seconds <s>

It prints what ``run.py`` prints, the result line last, and before that one
more line, ``{"program_spans": {...}}``:

* ``decode_issue_ms``, ``decode_readback_ms``: the medians of
  ``serve.decode.issue`` and ``serve.decode.readback`` over the window's
  decode steps outside the profiled slice; ``admit_stall_p99_ms``: the 99th
  percentile, over the window's ticks outside the slice in which a slot was
  decoding, of the tick's time in ``serve.admit``; ``accum_share``: the
  share of the steps' time in ``train.accumulate`` and ``train.combine``
  by their CUDA events;
* ``by_name``: for each span name, over the window outside the slice, the
  count, the median and the total of its host time, and of its device
  time where it has CUDA events;
* ``idle_gaps``: the slice's ten longest idle gaps named ``<harness span>
  <program span> <host call>``; ``idle_by_span``: the slice's idle seconds
  by the program span around each gap;
* ``window_tick_ms``, ``slice_tick_ms`` (serving) and ``train_tok_s``
  (training): the traced run's pace.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchlib import host  # noqa: E402


def readings(data: dict, phases: dict) -> dict:
    """The ``program_spans`` line of a finished traced run (this module's
    docstring lists its keys)."""
    from benchlib import program_spans as ps
    from benchlib import spec
    from benchlib.stats import percentile

    by_name: dict[str, dict] = {}
    for s in data.get("spans") or ():
        if ps.outside(data, s):
            d = by_name.setdefault(s.name, {"host": [], "device": []})
            d["host"].append((s.end_ns - s.start_ns) / 1e6)
            if s.device_s is not None:
                d["device"].append(1e3 * s.device_s)
    out = {
        "spans": len(data.get("spans") or ()),
        "decode_issue_ms": ps.decode_ms(data, "serve.decode.issue"),
        "decode_readback_ms": ps.decode_ms(data, "serve.decode.readback"),
        "admit_stall_p99_ms": ps.admit_stall_p99_ms(data),
        "accum_share": ps.accum_share(data),
        "by_name": {name: {"n": len(d["host"]), "host_ms_median": percentile(d["host"], 50),
                           "host_s_total": sum(d["host"]) / 1e3,
                           **({"device_ms_median": percentile(d["device"], 50),
                               "device_s_total": sum(d["device"]) / 1e3} if d["device"] else {})}
                    for name, d in by_name.items()},
    }
    s = data.get("slice") or {}
    out["idle_gaps"], out["idle_by_span"] = s.get("program_idle_gaps"), s.get("idle_by_span")
    for key in ("window_tick_ms", "slice_tick_ms"):
        if key in phases:
            out[key] = phases[key]
    if data.get("steps"):
        out["train_tok_s"] = spec.reader("train_tok_s")(data)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", required=True)
    ap.add_argument("--seconds", required=True)
    args = ap.parse_args(argv)
    host.pin_caches()  # before torch is imported
    from benchlib import program_spans, spec

    traced = program_spans.traced

    def noting(drive, cell, ref, phases):
        data = traced(drive, cell, ref, phases)
        host.note("program_spans", readings(data, phases))
        return data

    program_spans.traced = noting
    spec.load_module(host.BENCH_DIR / "run.py").main(["--workload", args.workload, "--seed", args.seed,
                                                      "--seconds", args.seconds, "--trace", "1"])


if __name__ == "__main__":
    main()
