"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. The configuration's file is the entry's ``file`` in ``configs``; its
``reference`` key names its plain reference, ``configs/<reference>.py``,
which states the file's contract with the program (``program_sizes``,
``leaf_paths``) and its own CPU-sized cut (``tiny_cut``).
The mix is ``traffic/<traffic>.json``. Each metric is read by
``metrics/<metric name>.py``, whose ``read(data)`` returns the number or
``None`` where the run held nothing to read. A cell reports the metrics
that list it under ``workloads``, and those without the key that are
end-to-end metrics or move one that the cell reports.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

from .host import BENCH_DIR, ROOT


def load_module(path: Path):
    """The module in ``path``, loaded once (a file's name may hold dots)."""
    name = "perfbench_" + path.stem.replace(".", "_").replace("-", "_")
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


@dataclass
class Cell:
    name: str
    cfg: dict
    mix: dict
    ref: object
    chips: int
    end_to_end: list
    per_layer: list
    seed: int = 0
    seconds: float = 0.0
    trace: bool = False
    device: str = "cuda"
    clock: Callable[[], float] = field(default=lambda: 0.0)


def _applies(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def resolve(name: str, bench: dict | None = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration, mix, reference and metrics."""
    bench = bench or benchmark(root)
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(wl)}")
    w = wl[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = json.loads((root / conf["file"]).read_text())
    mix = json.loads((BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text())
    ref = load_module(BENCH_DIR / "configs" / f"{cfg['reference']}.py")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"] if _applies(m, name, names)]
    return Cell(name, cfg, mix, ref, w["chips"], e2e, per)


def reader(metric: str):
    return load_module(BENCH_DIR / "metrics" / f"{metric}.py").read
