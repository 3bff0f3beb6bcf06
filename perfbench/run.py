"""Run one cell of the benchmark once, on the card of this machine.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

It makes the cell's weights and traffic from ``--seed``, builds and warms
the program (``src/repro_torch``), measures for ``--seconds`` seconds,
checks what the timed path produced against the plain reference, and
prints one JSON line last: ``correct``, ``attempted``, ``failed``, the
cell's end-to-end metrics (``--trace 0``) or its per-layer metrics
(``--trace 1``: the program's own spans recorded over the window, with the
profiled slice's ``busy_s``, ``window_s`` and ``breakdown``), ``device``
and, last, ``checks``: each compared number with its limit. Set-up phases
and counts go on earlier lines. It exits non-zero with no result where
there is no card, too few cards, a forbidden module (JAX or the JAX
package) loaded, or no program to run.
"""

from __future__ import annotations

import argparse
import math
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from benchlib import host  # noqa: E402


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _finite(x: float) -> float:
    if not math.isfinite(x):
        raise ValueError(f"metric is not finite: {x}")
    return x


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    host.pin_caches()  # before torch is imported
    phases = {"start_s": host.seconds_since_start()}

    t = time.perf_counter()
    import torch

    phases["import_torch_s"] = time.perf_counter() - t
    from benchlib import program_spans, serve, spec, train

    cell = spec.resolve(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        host.fail(f"{args.workload} needs {cell.chips} CUDA device(s); this machine has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    t = time.perf_counter()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    phases["cuda_init_s"] = time.perf_counter() - t
    t = time.perf_counter()
    try:
        from benchlib import program

        program.load()
        from repro_torch.kernels import _build
    except ImportError as e:
        host.fail(f"the program under test (src/repro_torch) cannot be imported: {e}")
    phases["import_program_s"] = time.perf_counter() - t
    t = time.perf_counter()
    _build.build(("decode_attention", "flash_attention"))
    phases["build_s"] = time.perf_counter() - t
    host.note("card", _power_limit())

    cell.seed, cell.seconds, cell.trace, cell.device = args.seed, args.seconds, bool(args.trace), "cuda"
    cell.clock = host.seconds_since_start
    drive = train.run if cell.mix["kind"] == "train" else serve.run
    data = program_spans.traced(drive, cell, cell.ref, phases)
    data["setup_s"] = phases["setup_s"]
    host.note("phases", phases)
    report(cell, data, torch.cuda.get_device_name(0))


def report(cell, data: dict, kind: str) -> None:
    """Read the cell's metrics from a finished window's ``data``, run the
    judge, and print the result line; with no line, and a non-zero exit,
    where a forbidden module is loaded once all of that has run."""
    from benchlib import judge, spec

    metrics = {}
    for m in cell.per_layer if cell.trace else cell.end_to_end:
        v = spec.reader(m["name"])(data)
        if v is not None:
            metrics[m["name"]] = {"value": _finite(float(v)), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": int(data["memory_peak_bytes"])}
    result = {"attempted": data["attempted"], "failed": data["failed"], "metrics": metrics, "device": device}
    if cell.trace:
        s = data["slice"]
        device["busy_s"], device["window_s"] = s["busy_s"], s["window_s"]
        # the longest idle gaps named by the program's spans where it recorded them
        gaps = s.get("program_idle_gaps", s["idle_gaps"])
        result["breakdown"] = {"device_ops": s["device_ops"], "idle_gaps": gaps}

    t = time.perf_counter()
    got = data["finish"]()
    host.note("judge", {**got, "seconds": time.perf_counter() - t})
    correct, checks = judge.verdict(cell.mix["check"]["limits"], got)
    bad = host.forbidden_modules()
    if bad:
        host.fail(f"forbidden modules loaded after the window: {bad}", 3)
    host.emit({"correct": correct, **result}, checks)


if __name__ == "__main__":
    main()
