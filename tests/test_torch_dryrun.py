"""The port's dry-run (``python -m repro_torch.launch.dryrun``) end to end.

Twin of ``tests/test_distributed.py::test_dryrun_cli_smoke_cell``: the CLI
counts ``qwen3-1.7b-smoke`` at ``train_4k``, ``prefill_32k`` and
``decode_32k`` on a (2, 4) mesh of a fake 8-rank process group, imports
no JAX, writes nothing outside ``--out``, and each record carries the
reference's asserted fields, a peak per device no less than the local
shards of params, optimizer state and cache, and the three roofline terms.
An ``xlstm-1.3b-smoke`` training cell shows that the sLSTM time loop is
counted once per step (the reference's analytic correction is not added
on top), and the qwen3 prefill cell's counted FLOPs are held against the
reference's ``hlo_flops_per_dev`` for the same cell (its dry-run run here
with its mesh's axes made ``Auto``, which jax 0.9's ``make_mesh`` no
longer defaults to). Two cells widened where the loss and the MoE
dispatch cost memory (a vocabulary of 32768; MoE at d_model 512 with 8
experts) hold the port's peak per device to at most twice the
reference's ``memory_analysis()`` peak. Every run is a subprocess: the
fake process group is global to a process.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import RunConfig
from repro_torch.models import model as M
from repro_torch.models.common import tree_leaves
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import ShardingRules
from repro_torch.roofline.extract import slstm_correction_flops

try:
    import jax  # noqa: F401
except ImportError:  # the card's machine has no JAX
    jax = None

ROOT = Path(__file__).resolve().parents[1]
MESH = (2, 4)
QWEN_SHAPES = ("train_4k", "prefill_32k", "decode_32k")

_RUN = (
    "import sys\n"
    "from repro_torch.launch import dryrun\n"
    "dryrun.main(sys.argv[1:])\n"
    "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'repro' "
    "or m.startswith('repro.'))\n"
    "assert not bad, bad\n"
)


def _run(args, tmp: Path, timeout: int = 240):
    """The CLI in a subprocess whose working directory, HOME and TMPDIR are
    empty directories under ``tmp``."""
    dirs = {name: tmp / name for name in ("cwd", "home", "tmp")}
    for d in dirs.values():
        d.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), HOME=str(dirs["home"]), TMPDIR=str(dirs["tmp"]),
               OMP_NUM_THREADS="1")
    env.pop("REPRO_DRYRUN_DEVICES", None)
    out = subprocess.run([sys.executable, "-c", _RUN, *args], env=env, cwd=dirs["cwd"], capture_output=True,
                         text=True, timeout=timeout)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    return dirs


def _record(out: Path, arch: str, shape: str) -> dict:
    return json.loads((out / f"{arch}__{shape}__2x4.json").read_text())


@pytest.fixture(scope="module")
def qwen(tmp_path_factory):
    """The three qwen3-1.7b-smoke cells in one run of the CLI."""
    tmp = tmp_path_factory.mktemp("dryrun")
    results = ROOT / "results" / "dryrun_torch"
    before = sorted(results.rglob("*")) if results.exists() else None
    cells = [a for s in QWEN_SHAPES for a in ("--cell", f"qwen3-1.7b-smoke:{s}")]
    dirs = _run([*cells, "--mesh", "2x4", "--out", str(tmp / "out"), "--attention-chunk", "512"], tmp)
    after = sorted(results.rglob("*")) if results.exists() else None
    written = sorted(p.relative_to(tmp) for p in tmp.rglob("*") if p.is_file())
    return tmp / "out", {"results_dir": (before, after), "written": written, "dirs": dirs}


def test_cli_smoke_cell(qwen):
    """The asserts of ``tests/test_distributed.py:117-124`` on the port's record."""
    out, _ = qwen
    rec = _record(out, "qwen3-1.7b-smoke", "train_4k")
    assert rec["ok"]
    assert rec["hlo_flops_per_dev"] > 0
    assert rec["t_compute"] > 0 and rec["t_memory"] > 0
    assert rec["dominant"] in ("compute", "memory", "collective")
    assert 0 < rec["useful_flop_ratio"] < 2.0
    assert rec["peak_bytes_per_dev"] > 0 and rec["n_devices"] == 8


def test_cli_writes_only_its_out_dir_and_imports_no_jax(qwen):
    """The run imported no JAX (asserted inside it) and wrote its three
    records under ``--out`` and nothing else: not in its working
    directory, HOME or TMPDIR, nor in the repo's ``results/``."""
    _, info = qwen
    assert info["written"] == sorted(Path("out") / f"qwen3-1.7b-smoke__{s}__2x4.json" for s in QWEN_SHAPES)
    before, after = info["results_dir"]
    assert before == after


def _local_bytes(tree, specs) -> int:
    """Bytes of this rank's shards of ``tree`` laid out by ``specs`` on the
    (2, 4) ("data", "model") mesh."""
    sizes = dict(zip(("data", "model"), MESH))
    total = 0
    for t, spec in zip(tree_leaves(tree), tree_leaves(specs, is_leaf=lambda x: isinstance(x, tuple))):
        n = t.numel()
        for entry in spec:
            for axis in ((entry,) if isinstance(entry, str) else tuple(entry or ())):
                n //= sizes[axis]
        total += n * t.element_size()
    return total


@pytest.mark.parametrize("shape", QWEN_SHAPES)
def test_peak_covers_the_local_shards(qwen, shape):
    """Each record: ok, the three terms and a dominant one, and a peak no
    less than the local shards of the step's arguments (params, AdamW
    state for training, the cache for decode); the model FLOPs are the
    reference's definition (``tests/test_torch_roofline.py``)."""
    out, _ = qwen
    rec = _record(out, "qwen3-1.7b-smoke", shape)
    assert rec["ok"] and rec["dominant"] in ("compute", "memory", "collective")
    assert min(rec["t_compute"], rec["t_memory"]) > 0 and rec["model_flops_total"] > 0
    cfg, sh = get_config("qwen3-1.7b-smoke"), SHAPES[shape]
    rules = ShardingRules(mesh_axes=("data", "model"), mesh_shape=MESH)
    pspecs = M.model_specs(cfg, rules)
    held = _local_bytes(M.model_shapes(cfg), pspecs)
    if sh.kind == "train":
        held += _local_bytes(adamw.opt_state_shapes(M.model_shapes(cfg)), adamw.opt_state_specs(pspecs))
    if sh.kind == "decode":
        held += _local_bytes(M.init_cache(cfg, sh.global_batch, sh.seq_len, "meta"),
                             M.cache_specs(cfg, rules, sh.global_batch, sh.seq_len))
        assert rec["collective_bytes_per_dev"] > 0  # the sequence-sharded decode combines across ranks
    assert rec["peak_bytes_per_dev"] >= held > 0


def test_xlstm_counts_each_slstm_step_once(tmp_path):
    """xlstm-1.3b-smoke at train_4k, no remat: the two probes (1 and 2 real
    steps of each sLSTM loop) differ by exactly the reference's analytic
    per-step term (the recurrent R·h products, forward and backward), and
    the record's FLOPs are the probe extrapolated to S steps: every step
    counted once, the reference's correction not added on top."""
    _run(["--cell", "xlstm-1.3b-smoke:train_4k", "--mesh", "2x4", "--out", str(tmp_path / "out"), "--remat",
          "none"], tmp_path)
    rec = _record(tmp_path / "out", "xlstm-1.3b-smoke", "train_4k")
    assert rec["ok"] and rec["probe_steps"] == [1, 2]
    c1, c2 = (p["flops"] for p in rec["probe_costs"])
    s = SHAPES["train_4k"].seq_len
    per_step = slstm_correction_flops(get_config("xlstm-1.3b-smoke"), SHAPES["train_4k"], 8) / (s - 1)
    assert c2 - c1 == per_step
    assert rec["hlo_flops_per_dev"] == c1 + (s - 1) * (c2 - c1)
    assert rec["slstm_correction_flops_not_added"] == per_step * (s - 1)


_REFERENCE = (
    "import sys\n"
    "import jax\n"
    "from jax.sharding import AxisType\n"
    "make = jax.make_mesh\n"
    "jax.make_mesh = lambda shape, axes, **kw: make(shape, axes, axis_types=(AxisType.Auto,) * len(axes))\n"
    "from repro.launch import dryrun\n"
    "sys.argv = ['dryrun'] + sys.argv[1:]\n"
    "dryrun.main()\n"
)


def test_counted_flops_against_the_reference(qwen, tmp_path):
    """qwen3-1.7b-smoke at prefill_32k: the port's counted FLOPs per device
    over the reference's ``hlo_flops_per_dev``. The band, 0.35 to 0.6:
    attention over 32768 positions is most of this cell's work at
    d_model 64, and the reference's chunked attention (chunks of 512)
    computes every (query, key) block, the masked half above the diagonal
    included, where K2's formula counts the attended pairs, half of them;
    XLA's cost analysis also counts the elementwise work (exponentials,
    norms, RoPE, masks) that the port's counter leaves out. The model
    FLOPs of both are equal."""
    if jax is None:
        pytest.skip("JAX is not installed: the reference side of this test is missing")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_DRYRUN_DEVICES="8", JAX_PLATFORMS="cpu")
    ref = subprocess.run([sys.executable, "-c", _REFERENCE, "--cell", "qwen3-1.7b-smoke:prefill_32k", "--mesh", "2x4",
                          "--out", str(tmp_path), "--attention-chunk", "512"], env=env, capture_output=True, text=True,
                         timeout=240)
    assert ref.returncode == 0, ref.stdout[-2000:] + ref.stderr[-2000:]
    exp = _record(tmp_path, "qwen3-1.7b-smoke", "prefill_32k")
    got = _record(qwen[0], "qwen3-1.7b-smoke", "prefill_32k")
    assert got["model_flops_total"] == exp["model_flops_total"]
    ratio = got["hlo_flops_per_dev"] / exp["hlo_flops_per_dev"]
    assert 0.35 < ratio < 0.6, ratio
    assert math.isclose(got["model_flops_per_dev"], exp["model_flops_per_dev"])


def test_run_config_defaults_take_the_kernel_paths():
    """The CLI's run config: K2 for prefill and training, K1 for decode,
    the reference's other defaults."""
    from repro_torch.launch import dryrun

    run = dryrun.build_run(dryrun.parse_args([]), "qwen3-1.7b")
    assert (run.attention_impl, run.decode_attention_impl, run.remat, run.fsdp) == ("pallas", "kernel", "full", True)
    assert isinstance(run, RunConfig)


# Cells widened where a sharded step's memory goes: the loss over a larger
# vocabulary, and the MoE dispatch at a wider model with more experts.
# Each package runs them at its CLI's defaults (the port's: K2, remat
# "full"; the reference's: chunked attention of 1024, remat "full").
PARITY_CELLS = {
    "qwen3-1.7b-smoke:train_4k": {"vocab_size": 32768},
    "moonshot-v1-16b-a3b-smoke:prefill_32k": {"d_model": 512, "moe_d_ff": 512, "num_experts": 8,
                                              "experts_per_token": 2},
}
# the same cells unmodified: their peaks before each rank computed its own
# loss and routed its own groups (GiB, rounded up: this counter on the
# tree before that change)
UNMODIFIED_PEAK_GIB = {"qwen3-1.7b-smoke:train_4k": 32.6614, "moonshot-v1-16b-a3b-smoke:prefill_32k": 2.6982}

_PORT_CELLS = (
    "import json, sys\n"
    "from pathlib import Path\n"
    "from repro_torch.launch import dryrun\n"
    "cells, out = json.loads(sys.argv[1]), Path(sys.argv[2])\n"
    "mesh = dryrun.fake_mesh((2, 4))\n"
    "for cell, over, tag in cells:\n"
    "    arch, shape = cell.split(':')\n"
    "    rec = dryrun.run_cell(arch, shape, mesh, dryrun.build_run(dryrun.parse_args([]), arch), tag, out, "
    "cfg_overrides=over)\n"
    "    assert rec['ok'], rec.get('traceback')\n"
)
_REFERENCE_CELLS = (
    "import json, sys, types\n"
    "from pathlib import Path\n"
    "import jax\n"
    "from jax.sharding import AxisType\n"
    "make = jax.make_mesh\n"
    "jax.make_mesh = lambda shape, axes, **kw: make(shape, axes, axis_types=(AxisType.Auto,) * len(axes))\n"
    "from repro.launch import dryrun\n"
    "from repro.launch.mesh import parse_mesh_arg\n"
    "cells, out = json.loads(sys.argv[1]), Path(sys.argv[2])\n"
    "# the CLI's defaults (src/repro/launch/dryrun.py, main)\n"
    "args = types.SimpleNamespace(no_fsdp=False, no_sp=False, remat='full', attention_impl='chunked', "
    "attention_chunk=1024, grad_accum=1, pad_heads=0, opt_dtype='float32')\n"
    "mesh = parse_mesh_arg('2x4')\n"
    "for cell, over, tag in cells:\n"
    "    arch, shape = cell.split(':')\n"
    "    rec = dryrun.run_cell(arch, shape, mesh, dryrun.build_run(args, arch), tag, out, probes=False, "
    "cfg_overrides=over)\n"
    "    assert rec['ok'], rec.get('traceback')\n"
)


@pytest.fixture(scope="module")
def peaks(tmp_path_factory):
    """Both packages' records of the widened cells (and the port's of the
    unmodified ones): ``{cell: (port, reference or None)}``, the
    unmodified port records under ``"unmodified"``."""
    tmp = tmp_path_factory.mktemp("peaks")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               REPRO_DRYRUN_DEVICES="8")
    widened = [(cell, over, "over") for cell, over in PARITY_CELLS.items()]
    cells = widened + [(cell, None, "2x4") for cell in UNMODIFIED_PEAK_GIB]
    ref = None
    if jax is not None:  # the reference's compiles run while the port counts
        proc = subprocess.Popen([sys.executable, "-c", _REFERENCE_CELLS, json.dumps(widened), str(tmp / "ref")],
                                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        res = subprocess.run([sys.executable, "-c", _PORT_CELLS, json.dumps(cells), str(tmp / "port")], env=env,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
        if jax is not None:
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, out[-2000:] + err[-3000:]
            ref = {cell: json.loads((tmp / "ref" / f"{cell.replace(':', '__')}__over.json").read_text())
                   for cell in PARITY_CELLS}
    finally:
        if jax is not None and proc.poll() is None:
            proc.kill()
            proc.wait()

    def port(cell, tag):
        return json.loads((tmp / "port" / f"{cell.replace(':', '__')}__{tag}.json").read_text())

    return {"over": {cell: port(cell, "over") for cell in PARITY_CELLS},
            "unmodified": {cell: port(cell, "2x4") for cell in UNMODIFIED_PEAK_GIB}, "ref": ref}


@pytest.mark.parametrize("cell", list(PARITY_CELLS))
def test_peak_per_device_within_twice_the_reference(peaks, cell):
    """The port's peak per device at most twice the reference's: each rank
    takes the loss on its own rows and routes its own groups, as the
    reference's compiled step does. Before, the loss gathered the global
    fp32 logits on every rank (320.10 against 48.14 GiB) and the routing
    ran on the whole tokens (20.25 against 6.45 GiB). The factor 2 leaves
    room for what an eager step holds that XLA's fusion does not (fp32
    copies of a block, unfused temporaries)."""
    if jax is None:
        pytest.skip("JAX is not installed: the reference side of this test is missing")
    got, exp = peaks["over"][cell], peaks["ref"][cell]
    assert got["ok"] and exp["ok"]
    assert got["peak_bytes_per_dev"] <= 2 * exp["peak_bytes_per_dev"], (got["peak_bytes_per_dev"] / 2**30,
                                                                         exp["peak_bytes_per_dev"] / 2**30)


@pytest.mark.parametrize("cell", list(UNMODIFIED_PEAK_GIB))
def test_unmodified_smoke_peak_no_higher(peaks, cell):
    """The unmodified cells' peaks are no higher than before the change."""
    rec = peaks["unmodified"][cell]
    assert rec["ok"] and rec["peak_bytes_per_dev"] / 2**30 <= UNMODIFIED_PEAK_GIB[cell]
