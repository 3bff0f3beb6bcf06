"""Multi-pod dry-run: count every (arch × shape × mesh) cell on fake tensors.

Port of ``repro/launch/dryrun.py``. It proves the distribution config is
coherent without hardware: for each cell it runs the step of
``launch/steps.py::cell_artifacts`` once, eagerly, on ``meta`` tensors
(shapes and dtypes, no memory, no values) laid out as DTensors on a
``"cuda"`` device mesh, the production mesh, over a fake process group,
and counts with ``roofline/extract.py``:

  * FLOPs and unfused bytes per device (the local ops of one rank,
    the kernels K1, K2, K3 by the formulas ``kernels/ops.py`` registers);
  * collective payload bytes per class (all-gather, all-reduce,
    reduce-scatter, all-to-all, ...);
  * the peak bytes per device (``MemTracker``; fits-in-HBM proof);

and writes the roofline terms against the H100's nameplate peaks
(predicted, never measured) to ``results/dryrun_torch/<arch>__<shape>__
<mesh>.json``. Nothing is allocated on a card and nothing is computed: a
``meta`` tensor that reaches a kernel's wrapper takes the same path a CUDA
tensor takes, to the kernel's custom op, whose fake gives its outputs, so
it launches nothing and runs no plain version, and the kernels' FLOPs are
counted. Like the reference's, it is a host tool; it imports no JAX.

Why ``meta`` and not fake CUDA tensors (``FakeTensorMode``): both take the
kernel paths, but a PyTorch built without CUDA aborts the process when
autograd records an op on a (fake) CUDA tensor (it has no CUDA device
guard), and under ``FakeTensorMode`` DTensor finds no sharding strategy
for decomposed ops such as ``log_sigmoid_forward`` (sLSTM), which it
shards on ``meta`` tensors. ``meta`` counts the same ops on a machine with
a card and on one without.

The reference's ``REPRO_DRYRUN_DEVICES`` is the world size of the fake
group (by default the mesh's size). Parameters are fp32, as the
reference's; the attention runs the kernel paths (``--attention-impl
pallas`` by default, K1 for decode). xLSTM cells run their sLSTM time
loops cut to 1 and 2 real steps and extrapolate to the sequence length
(see ``roofline/extract.py``); ``--no-probes`` runs every step.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-405b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # every cell, single-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --cell qwen3-1.7b-smoke:train_4k --mesh 2x4 --out DIR
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from pathlib import Path
from unittest import mock

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro_torch.configs.base import RunConfig
from repro_torch.launch.mesh import DEFAULT_AXES, make_mesh
from repro_torch.launch.steps import cell_artifacts
from repro_torch.models import ssm
from repro_torch.models.common import tree_map
from repro_torch.parallel.sharding import placed_full
from repro_torch.roofline.extract import analyze_counts, count_step, extrapolate_probes

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
DEVICE = "meta"  # the stand-ins' device; the mesh is a CUDA mesh


def fake_mesh(shape: tuple[int, ...]):
    """A ``DeviceMesh`` of ``shape`` on ``"cuda"`` over a fake process group
    of ``REPRO_DRYRUN_DEVICES`` ranks (by default the mesh's size); this
    process is rank 0. The group exchanges nothing."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    n = math.prod(shape)
    world = int(os.environ.get("REPRO_DRYRUN_DEVICES", n))
    if world < n:
        raise SystemExit(f"dryrun: mesh {shape} needs {n} devices, REPRO_DRYRUN_DEVICES={world}")
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    if world == n:
        return make_mesh(shape, device="cuda")
    return DeviceMesh("cuda", torch.arange(n).view(shape), mesh_dim_names=DEFAULT_AXES[len(shape)])


@contextlib.contextmanager
def slstm_steps(limit: int | None):
    """Run only the first ``limit`` steps of each sLSTM time loop
    (``models/ssm.py::slstm_scan``, whose docstring states the contract a
    stand-in keeps); the later steps repeat the last h, detached, so every
    shape stays and the cost of a repeat cancels in the extrapolation.
    ``None``: every step."""
    if limit is None:
        yield
        return
    real = ssm.slstm_scan

    def scan(cfg, rec, bias, carry, xg):
        hs, carry = real(cfg, rec, bias, carry, xg[:, :limit])
        return hs + [carry[0].detach()] * (xg.shape[1] - len(hs)), carry

    with mock.patch.object(ssm, "slstm_scan", scan):
        yield


def _placed(args, specs, mesh):
    """Each stand-in as a ``meta`` DTensor on ``mesh``, laid out by its
    spec: this rank's shard only."""
    return tree_map(lambda t, spec: placed_full(t.shape, 0, t.dtype, DEVICE, mesh, spec), args, specs)


def count_cell(cfg, run: RunConfig, shape, mesh, probes: bool = True) -> dict:
    """Per-device counts of one cell: one eager run of its step on ``meta``
    tensors, or, for a cell with an sLSTM time loop and ``probes``, two
    runs with the loop cut to 1 and 2 steps, extrapolated to the sequence
    length."""
    art = cell_artifacts(cfg, run, shape, mesh)

    def once(limit=None):
        with slstm_steps(limit):
            return count_step(art["fn"], _placed(art["args"], art["in_shardings"], mesh))

    loops = shape.kind != "decode" and any(cfg.layer_kind(i) == "slstm" for i in range(cfg.num_layers))
    if not (probes and loops):
        return once()
    c1, c2 = once(1), once(2)
    steps = shape.seq_len

    def line(a, b):
        return max(0.0, b + (steps - 2) * (b - a))

    ext = extrapolate_probes([c1, c2], steps)
    return {**ext, "peak_bytes": line(c1["peak_bytes"], c2["peak_bytes"]),
            "n_collectives": {k: int(line(c1["n_collectives"].get(k, 0), v)) for k, v in c2["n_collectives"].items()},
            "probe_costs": [c1, c2], "probe_steps": [1, 2]}


def run_cell(arch: str, shape_name: str, mesh, run: RunConfig, tag: str, out_dir: Path, probes: bool = True,
             cfg_overrides: dict | None = None) -> dict:
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": tag,
        "mesh_shape": list(mesh.shape),
        "device": f"{DEVICE} tensors on a cuda mesh, fake process group",
        "torch": torch.__version__,
        "run": {
            "fsdp": run.fsdp,
            "sequence_parallel": run.sequence_parallel,
            "remat": run.remat,
            "attention_impl": run.attention_impl,
            "decode_attention_impl": run.decode_attention_impl,
            "attention_chunk": run.attention_chunk,
            "grad_accum_steps": run.grad_accum_steps,
            "pad_attention_heads_to": run.pad_attention_heads_to,
            "optimizer_dtype": run.optimizer_dtype,
        },
    }
    t0 = time.time()
    try:
        counts = count_cell(cfg, run, shape, mesh, probes)
        rec.update(analyze_counts(cfg, shape, mesh, counts))
        for key in ("probe_costs", "probe_steps"):
            if key in counts:
                rec[key] = counts[key]
        rec["ok"] = True
        rec["count_s"] = round(time.time() - t0, 2)
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.time() - t0, 2)

    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"{arch}__{shape_name}__{tag}.json"
    out.write_text(json.dumps(rec, indent=2, default=str))
    status = "OK " if rec.get("ok") else "FAIL"
    print(f"[{status}] {arch:24s} {shape_name:12s} {tag:10s} {rec['total_s']:8.1f}s", flush=True)
    if not rec.get("ok"):
        print("      " + rec["error"], flush=True)
    return rec


def build_run(args, arch: str) -> RunConfig:
    return RunConfig(
        fsdp=not args.no_fsdp,
        sequence_parallel=not args.no_sp,
        remat=args.remat,
        attention_impl=args.attention_impl,
        decode_attention_impl="kernel",
        attention_chunk=args.attention_chunk,
        grad_accum_steps=args.grad_accum,
        pad_attention_heads_to=args.pad_heads,
        optimizer_dtype=args.opt_dtype,
    )


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None, help="arch id (repeatable)")
    ap.add_argument("--cell", action="append", default=None, help="explicit arch:shape cell (repeatable)")
    ap.add_argument("--shape", action="append", default=None, choices=list(SHAPES), help="shape (repeatable)")
    ap.add_argument("--all", action="store_true", help="all applicable cells")
    ap.add_argument("--multi-pod", action="store_true", help="2×16×16 mesh instead of 16×16")
    ap.add_argument("--mesh", default=None, help="override mesh, e.g. 2x4 / 2x2x4")
    ap.add_argument("--remat", default="full", choices=["none", "dots", "full"])
    ap.add_argument("--attention-impl", default="pallas", choices=["xla", "chunked", "pallas"],
                    help="pallas: K2, the path on the card")
    ap.add_argument("--attention-chunk", type=int, default=1024)
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-sp", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--pad-heads", type=int, default=0)
    ap.add_argument("--opt-dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--moe-group", type=int, default=0, help="override cfg.moe_group_size")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    ap.add_argument("--tag", default=None, help="override result-file mesh tag")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-probes", action="store_true", help="run every step of the sLSTM time loops")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)

    if args.mesh:
        shape = tuple(int(x) for x in args.mesh.lower().split("x"))
        tag = args.tag or args.mesh
    else:
        shape = (2, 16, 16) if args.multi_pod else (16, 16)
        tag = args.tag or ("multipod" if args.multi_pod else "singlepod")
    mesh = fake_mesh(shape)

    archs = args.arch or list(ARCH_IDS)
    shapes = args.shape or list(SHAPES)
    out_dir = Path(args.out)

    if args.cell:
        cells = [tuple(c.split(":", 1)) for c in args.cell]
    else:
        cells = []
        for arch in archs:
            cfg = get_config(arch)
            for sh in shapes:
                if not shape_applicable(cfg, SHAPES[sh]):
                    print(f"[SKIP] {arch:24s} {sh:12s} (full attention: long-context n/a)")
                    continue
                cells.append((arch, sh))

    n_ok = 0
    for arch, sh in cells:
        if args.skip_existing and (out_dir / f"{arch}__{sh}__{tag}.json").exists():
            prev = json.loads((out_dir / f"{arch}__{sh}__{tag}.json").read_text())
            if prev.get("ok"):
                n_ok += 1
                print(f"[SKIP-OK] {arch:24s} {sh:12s} (cached)")
                continue
        over = {"moe_group_size": args.moe_group} if args.moe_group else None
        rec = run_cell(arch, sh, mesh, build_run(args, arch), tag, out_dir, probes=not args.no_probes,
                       cfg_overrides=over)
        n_ok += bool(rec.get("ok"))
    print(f"\n{n_ok}/{len(cells)} cells counted OK on mesh {tag} {tuple(mesh.shape)}")
    if n_ok < len(cells):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
