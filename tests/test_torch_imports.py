"""The PyTorch port stands alone: importing ``repro_torch`` and every one
of its modules pulls in no JAX, and no port file (nor ``chip_smoke.py``, nor
the golden hashes it reads) imports JAX or the JAX package ``repro``."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def test_import_port_leaves_jax_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 37, mods\n"
        "assert {'repro_torch.core.router', 'repro_torch.core.autoscale', 'repro_torch.launch.fleet'} <= set(mods)\n"
        "sim = {'repro_torch.core.' + m for m in ('topology', 'capacity', 'placement', 'replication', 'heartbeat',\n"
        "       'scheduler', 'simulator', 'workload', 'namespace', 'tuning')}\n"
        "sim |= {'repro_torch.configs.hadoop_cluster', 'repro_torch.data.sampler'}\n"
        "assert sim <= set(mods), sorted(sim - set(mods))\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


_FORBIDDEN = re.compile(r"^\s*(import\s+jax|from\s+jax|import\s+repro(\.|\s|$)|from\s+repro(\.|\s))", re.M)


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")) + ["chip_smoke.py", "tests/torch_sim_golden.py"],
)
def test_port_source_imports_no_jax(path):
    src = (ROOT / path).read_text()
    assert not _FORBIDDEN.search(src), f"{path} imports JAX or the JAX package"


def test_simulator_imports_leave_jax_out():
    code = (
        "import sys\n"
        "import repro_torch.core, repro_torch.core.workload, repro_torch.data.sampler\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
