"""The PyTorch port stands alone: importing ``repro_torch`` and every one
of its modules pulls in no JAX, and no port file (nor ``chip_smoke.py``, nor
the golden hashes it reads) imports JAX or the JAX package ``repro``;
``repro_torch.launch.dryrun`` alone imports neither."""

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
        "assert len(mods) >= 63, mods\n"
        "assert {'repro_torch.core.router', 'repro_torch.core.autoscale', 'repro_torch.launch.fleet'} <= set(mods)\n"
        "last = {'repro_torch.configs.' + m for m in ('jamba_1_5_large_398b', 'llava_next_34b', 'musicgen_medium')}\n"
        "assert last <= set(mods), sorted(last - set(mods))\n"
        "from repro_torch.configs import ARCH_IDS, get_config\n"
        "assert len(ARCH_IDS) == 10 and all(get_config(a).name == a for a in ARCH_IDS)\n"
        "sim = {'repro_torch.core.' + m for m in ('topology', 'capacity', 'placement', 'replication', 'heartbeat',\n"
        "       'scheduler', 'simulator', 'workload', 'namespace', 'tuning')}\n"
        "sim |= {'repro_torch.configs.hadoop_cluster', 'repro_torch.data.sampler'}\n"
        "assert sim <= set(mods), sorted(sim - set(mods))\n"
        "train = {'repro_torch.' + m for m in ('optim', 'optim.adamw', 'optim.compression', 'checkpoint',\n"
        "         'checkpoint.checkpoint', 'core.coordinator', 'launch.steps', 'launch.train', 'launch.elastic')}\n"
        "assert train <= set(mods), sorted(train - set(mods))\n"
        "dist = {'repro_torch.' + m for m in ('parallel', 'parallel.sharding', 'parallel.flash_decode',\n"
        "        'parallel.pipeline', 'launch.mesh')}\n"
        "assert dist <= set(mods), sorted(dist - set(mods))\n"
        "dry = {'repro_torch.' + m for m in ('roofline', 'roofline.extract', 'launch.dryrun')}\n"
        "assert dry <= set(mods), sorted(dry - set(mods))\n"
        "from repro_torch.roofline import analyze_counts, count_step, roofline_terms\n"
        "from repro_torch.launch.dryrun import main, run_cell\n"
        "from repro_torch.launch.steps import cell_artifacts, make_prefill_step, make_serve_step\n"
        "from repro_torch.configs import all_cells, input_shardings, input_specs, prefix_len\n"
        "from repro_torch.parallel import Axes, ShardingRules, logical_spec, shard_constraint\n"
        "from repro_torch.parallel.flash_decode import sharded_decode_attention\n"
        "from repro_torch.parallel.pipeline import bubble_fraction, pipeline_apply\n"
        "from repro_torch.launch.mesh import make_mesh, make_production_mesh, parse_mesh_arg\n"
        "from repro_torch.models.model import lm_loss\n"
        "from repro_torch.data.dataset import BlockDataset, batch_iterator\n"
        "from repro_torch.bridge import opt_state_from_jax\n"
        "from repro_torch.core import HetCoordinator, PodRuntime, StepReport\n"
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


def test_dryrun_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import repro_torch.launch.dryrun\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


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
