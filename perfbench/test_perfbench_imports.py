"""Nothing the benchmark runs loads JAX or the JAX package ``repro``:
compared by whole top-level module name (``repro_torch`` is the program
and is allowed), both in the harness's sources and in a process that runs
a cell."""

from __future__ import annotations

import ast
import subprocess
import sys
import textwrap

from benchlib import host


def test_no_source_of_the_benchmark_imports_a_forbidden_module():
    for path in host.BENCH_DIR.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in host.FORBIDDEN, (path, name)


def test_a_run_loads_no_forbidden_module():
    """A tiny serving run and a tiny training run on the CPU, through the
    harness, every metric reader and the reference loaded, in a fresh
    process."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(host.BENCH_DIR)!r})
        from benchlib import host
        host.pin_caches()
        import torch
        from conftest import tiny
        from benchlib import serve, spec, train
        for m in spec.benchmark()["end_to_end"] + spec.benchmark()["per_layer"]:
            spec.reader(m["name"])
        for name, drive in (("qwen3-1.7b.docqa", serve.run), ("qwen3-1.7b.train", train.run)):
            c = tiny(name, seconds=0.5)
            drive(c, c.ref, {{}})["finish"]()
        assert "repro_torch" in sys.modules
        print("FORBIDDEN", host.forbidden_modules())
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         cwd=str(host.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout, out.stdout[-2000:]


def test_forbidden_names_are_compared_whole():
    assert host.forbidden_modules(["repro_torch", "repro_torch.models", "jaxtyping", "numpy"]) == []
    assert host.forbidden_modules(["repro.core", "jax.numpy", "flax", "torch"]) == ["flax", "jax", "repro"]
