"""Process plumbing of one benchmark run: the clock since the process
started, the cache directories inside the checkout, the device check, the
check for forbidden modules, and the printing of the result.

Nothing here imports torch at module level: ``pin_caches`` has to run
before torch is imported.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]  # the checkout: perfbench/benchlib/host.py
BENCH_DIR = ROOT / "perfbench"
CACHE_DIR = ROOT / "build"  # the program's kernels build into build/kernels
# top-level module names that may not be loaded in the process that prints
# the result: JAX, its libraries, and the JAX package this port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

_IMPORTED_AT = time.perf_counter()


def seconds_since_start() -> float:
    """Seconds since this process started, from the kernel's start time of
    the process (``/proc/self/stat``); where that cannot be read, since this
    module was imported."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])  # field 22 of stat(5), counted after the command name
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        since = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        if since >= 0:
            return since
    except (OSError, ValueError, IndexError):
        pass
    return time.perf_counter() - _IMPORTED_AT


def pin_caches() -> None:
    """Point every build and kernel cache at a fixed directory inside the
    checkout, so that only the first run of a checkout builds. Called
    before torch is imported."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(CACHE_DIR / sub)
    sys.path.insert(0, str(ROOT / "src"))


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among ``names`` (the loaded modules by
    default), compared whole: ``repro_torch`` is not ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def fail(message: str, code: int = 2) -> None:
    """End the run with ``code`` and no result line."""
    print(f"perfbench: {message}", file=sys.stderr, flush=True)
    sys.exit(code)


def note(key: str, value) -> None:
    """An earlier line of standard output: one phase or count, as JSON."""
    print(json.dumps({key: value}), flush=True)


def emit(result: dict, checks: dict) -> None:
    """Each compared number beside its limit as the last lines of standard
    error, then the result as the last line of standard output, with the
    checks under the key that comes last."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps({**result, "checks": checks}), flush=True)
