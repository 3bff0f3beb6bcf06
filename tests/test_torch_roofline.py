"""The port's roofline model (``repro_torch/roofline/extract.py``) against
the JAX package's (``repro/roofline/extract.py``).

``model_flops`` equals the reference's on all 33 cells and on every arch's
``-smoke`` config at every shape; ``slstm_correction_flops``,
``extrapolate_probes`` and the bytes of ``analytic_hbm_bytes`` equal the
reference's; the roofline terms read the H100's nameplate peaks. The
per-device counter runs on ``meta`` DTensors over a fake 8-rank process
group in a subprocess (the group is global to a process): a sharded matmul
is counted at its local shape, an all-gather by its result's bytes, a
reduce-scatter and an all-reduce by their operand's, and DTensor's own
metadata run is not counted. JAX is imported under ``try``: the card's
machine has none.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.configs import ARCH_IDS, SHAPES, all_cells, get_config, shape_applicable
from repro_torch.configs.hadoop_cluster import H100_HBM_BPS, H100_NVLINK_BPS, H100_PEAK_FLOPS_BF16
from repro_torch.roofline import extract as X

try:
    from repro.configs import all_cells as jax_all_cells
    from repro.configs import get_config as jax_get_config
    from repro.roofline import extract as JX
except ImportError:  # the card's machine has no JAX
    JX = None

ROOT = Path(__file__).resolve().parents[1]
SMOKE_CELLS = [(a + "-smoke", s) for a in ARCH_IDS for s in SHAPES if shape_applicable(get_config(a), SHAPES[s])]


def _needs_jax():
    if JX is None:
        pytest.skip("JAX is not installed: the reference side of this test is missing")


def test_all_cells_are_the_reference_cells():
    assert len(all_cells()) == 33
    _needs_jax()
    assert sorted(all_cells()) == sorted(jax_all_cells())  # the registries list the archs in another order


@pytest.mark.parametrize("arch,shape", all_cells() + SMOKE_CELLS)
def test_model_flops_equal_reference(arch, shape):
    _needs_jax()
    assert X.model_flops(get_config(arch), SHAPES[shape]) == JX.model_flops(jax_get_config(arch), SHAPES[shape])


@pytest.mark.parametrize("arch,shape", all_cells() + SMOKE_CELLS)
def test_analytic_hbm_bytes_equal_reference(arch, shape):
    """The bytes of the optimistic bracket, on the production mesh and on
    the smoke cells' (2, 4); the times differ by design (H100 against the
    reference's TPU rate)."""
    _needs_jax()
    for n_dev, tp in ((256, 16), (8, 4)):
        got = X.analytic_hbm_bytes(get_config(arch), SHAPES[shape], n_dev, tp)
        exp = JX.analytic_hbm_bytes(jax_get_config(arch), SHAPES[shape], n_dev, tp)
        assert got["bytes"] == exp["bytes"]
        assert got["t_memory_analytic"] == got["bytes"] / H100_HBM_BPS


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "xlstm-1.3b-smoke", "llama3-405b", "jamba-1.5-large-398b"])
def test_slstm_correction_equals_reference(arch):
    """Twin of ``tests/test_perf_levers.py::test_slstm_analytic_flop_correction_positive``,
    and equal to the reference's at every shape and device count."""
    cfg = get_config(arch)
    corr = X.slstm_correction_flops(cfg, SHAPES["train_4k"], 256)
    assert (corr > 0) == arch.startswith("xlstm")
    assert X.slstm_correction_flops(cfg, SHAPES["decode_32k"], 256) == 0.0
    _needs_jax()
    for shape in SHAPES.values():
        for n_dev in (1, 8, 256):
            assert X.slstm_correction_flops(cfg, shape, n_dev) == JX.slstm_correction_flops(
                jax_get_config(arch), shape, n_dev)


def test_extrapolate_probes_equals_reference():
    rng = np.random.default_rng(0)

    def probe():
        return {"flops": float(rng.random() * 1e12), "bytes": float(rng.random() * 1e9),
                "collectives": {"all-gather": float(rng.random() * 1e6), "all-reduce": float(rng.random() * 1e6)}}

    for n in (1, 2, 7, 4096):
        c = [probe(), probe()]
        got = X.extrapolate_probes(c, n)
        if JX is not None:
            assert got == JX.extrapolate_probes(c, n)
        assert got["flops"] == max(0.0, c[1]["flops"] + (n - 2) * (c[1]["flops"] - c[0]["flops"]))


def test_roofline_terms_read_the_h100_peaks():
    terms = X.roofline_terms(2e15, 3e12, 9e11, 256)
    assert terms["t_compute"] == 2e15 / H100_PEAK_FLOPS_BF16
    assert terms["t_memory"] == 3e12 / H100_HBM_BPS
    assert terms["t_collective"] == 9e11 / (H100_NVLINK_BPS / 2)  # one direction of the NVLink ports


_COUNTER = r"""
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch.parallel.sharding import from_local
from repro_torch.roofline.extract import count_step

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = init_device_mesh("cuda", (2, 4), mesh_dim_names=("data", "model"))


def placed(shape, placements):
    local = list(shape)
    for i, pl in enumerate(placements):
        if pl.is_shard():
            local[pl.dim] //= mesh.size(i)
    return from_local(torch.empty(local, device="meta"), mesh, placements, shape)


a = placed((1024, 4096), [Shard(0), Replicate()])
b = placed((4096, 8192), [Replicate(), Shard(1)])
mm = count_step(lambda x, y: x @ y, (a, b))
print("mm", mm["flops"], mm["bytes"], mm["peak_bytes"], sum(mm["collectives"].values()))
x = placed((64, 32), [Replicate(), Shard(0)])
ag = count_step(lambda t: t.redistribute(mesh, [Replicate(), Replicate()]), (x,))
print("ag", ag["collectives"]["all-gather"], ag["n_collectives"]["all-gather"])
p = from_local(torch.empty((64, 32), device="meta"), mesh, [Replicate(), Partial()], (64, 32))
rs = count_step(lambda t: t.redistribute(mesh, [Replicate(), Shard(0)]), (p,))
print("rs", rs["collectives"]["reduce-scatter"], rs["n_collectives"]["reduce-scatter"])
ar = count_step(lambda t: t.redistribute(mesh, [Replicate(), Replicate()]), (p,))
print("ar", ar["collectives"]["all-reduce"], ar["n_collectives"]["all-reduce"])
"""


def test_counter_on_a_fake_group():
    """A (1024, 4096) @ (4096, 8192) with the rows over ``data`` (2) and
    the columns over ``model`` (4) is 2·512·4096·2048 FLOPs on each device
    (``FlopCounterMode`` would count the global 2·1024·4096·8192 once); its
    bytes are the local operands and result, its peak those plus nothing
    of DTensor's global-shape metadata run. Gathering (64, 32) fp32 from 4
    row shards moves the 8192-byte result; reduce-scattering and
    all-reducing a partial (64, 32) move the 8192-byte operand."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _COUNTER], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    got = {line.split()[0]: [float(v) for v in line.split()[1:]] for line in out.stdout.splitlines()}
    local = 512 * 4096 * 4 + 4096 * 2048 * 4 + 512 * 2048 * 4
    assert got["mm"] == [2 * 512 * 4096 * 2048, local, local, 0.0]
    assert got["ag"] == [64 * 32 * 4, 1]
    assert got["rs"] == [64 * 32 * 4, 1]
    assert got["ar"] == [64 * 32 * 4, 1]
