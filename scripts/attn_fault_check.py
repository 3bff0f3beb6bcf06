#!/usr/bin/env python3
"""Do the K1 and K2 checks of ``chip_smoke.py`` refuse a kernel that drops
a few keys? A check of the checks, on the card.

It copies ``src/`` and ``chip_smoke.py`` into a temporary directory and
plants three faults in the copy's CUDA sources:

- K1 (``decode_attention.cu``) ignores the last 32 keys of any sequence of
  2048 keys or more (a split tail);
- K2's bf16 tensor-core kernel and its fp32 kernel (``flash_attention.cu``)
  skip the last key tile of any query tile that sees more than 16 tiles.

Then, for the repository and for the copy, each in a process of its own
(each builds its kernels), it prints the absolute and the scaled error
(``chip_smoke.scaled_err``: each element against |plain| + the largest
|plain| of its row) against the plain versions at jamba's shapes with every
key valid (K1: q (8, 64, 128) over a ring of 4129; K2: a causal prefill of
4096 at G = 8), bf16 and fp32, and runs ``chip_smoke.groupings`` with its
checks recorded instead of raised (timings skipped). It exits 0 only if the
repository passes every check and the faulty copy fails at least one check
of every kernel it changed on a scaled limit, and it reports whether the
faulty K1 in bf16 stays under the absolute limit at the ring shape (the
case the scaled limit exists for).

The repository itself is never modified. Run from the repository root on a
machine with an H100: ``python3 scripts/attn_fault_check.py``.
"""

from __future__ import annotations

import contextlib
import io
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FAULTS = {
    "decode_attention.cu": [("ok[u] = in && valid_b[t] != 0;",
                             "ok[u] = in && valid_b[t] != 0 && !(S >= 2048 && t >= S - 32);")],
    "flash_attention.cu": [
        ("const int ntiles = kend > kstart ? (kend - kstart + BK - 1) / BK : 0;",
         "const int ntiles_all = kend > kstart ? (kend - kstart + BK - 1) / BK : 0;\n"
         "  const int ntiles = ntiles_all > 16 ? ntiles_all - 1 : ntiles_all;"),
        ("for (int k0 = kstart; k0 < kend; k0 += kBlockK32) {",
         "for (int k0 = kstart; k0 < (kend - kstart > 16 * kBlockK32 ? kend - kBlockK32 : kend); "
         "k0 += kBlockK32) {"),
    ],
}


def probe(root: str) -> dict:
    """The errors and failed checks of the tree at ``root`` (run in a
    process of its own, so that its kernels are built from its sources)."""
    sys.path[:0] = [root, root + "/src"]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import decode_attention_cuda, decode_attention_plain
    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain

    assert cs.__file__.startswith(root), cs.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def errs(kernel, what, dtype, got, exp):
        return {"kernel": kernel, "shape": what, "dtype": str(dtype),
                "abs": float((got.float() - exp.float()).abs().max()), "scaled": cs.scaled_err(got, exp),
                "mean_abs_out": float(exp.float().abs().mean())}

    out = {"cases": []}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = rnd(8, 64, 128, dtype=dtype), rnd(8, 4129, 8, 128, dtype=dtype), rnd(8, 4129, 8, 128, dtype=dtype)
        valid = torch.ones(8, 4129, dtype=torch.int32, device=dev)
        out["cases"].append(errs("K1", "q (8,64,128), k/v (8,4129,8,128), every key valid", dtype,
                                 decode_attention_cuda(q, k, v, valid, scale=128**-0.5)[0],
                                 decode_attention_plain(q, k, v, valid, scale=128**-0.5)[0]))
        q, k, v = rnd(1, 4096, 64, 128, dtype=dtype), rnd(1, 4096, 8, 128, dtype=dtype), rnd(1, 4096, 8, 128, dtype=dtype)
        exp = torch.cat([flash_attention_plain(q[:, i:i + 1024], k[:, :i + 1024], v[:, :i + 1024], q_offset=i,
                                               scale=128**-0.5) for i in range(0, 4096, 1024)], dim=1)
        out["cases"].append(errs("K2", "q (1,4096,64,128), k/v (1,4096,8,128), causal", dtype,
                                 flash_attention_cuda(q, k, v, scale=128**-0.5), exp))
        del q, k, v, exp
    fails = []
    cs.check = lambda ok, what: ok or fails.append(what)
    cs.graph_ms = lambda *a, **kw: 0.0
    cs.timed_ms = lambda *a, **kw: 0.0
    with contextlib.redirect_stdout(io.StringIO()):
        cs.groupings(rnd, gen, "")
    out["groupings_fails"] = fails
    out["tol"] = {"abs": {"bf16": cs.BF16_TOL, "fp32": cs.FP32_TOL},
                  "scaled": {str(k): v for k, v in cs.ATTN_SCALED_TOL.items()}}
    return out


def run(root: Path) -> dict:
    res = subprocess.run([sys.executable, __file__, "--probe", str(root)], capture_output=True, text=True)
    if res.returncode:
        sys.stderr.write(res.stdout + res.stderr)
        raise SystemExit(f"attn_fault_check: the probe of {root} failed")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("attn_fault_check: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    results = {"repository": run(ROOT)}
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(ROOT / "src", Path(tmp) / "src", ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(ROOT / "chip_smoke.py", tmp)
        for name, edits in FAULTS.items():
            path = Path(tmp) / "src" / "repro_torch" / "csrc" / name
            text = path.read_text()
            for old, new in edits:
                assert text.count(old) == 1, (name, old)
                text = text.replace(old, new)
            path.write_text(text)
        results["planted faults"] = run(Path(tmp))
    for label, r in results.items():
        for c in r["cases"]:
            print(f"{label}: {c['kernel']} {c['dtype']} at {c['shape']}: abs err {c['abs']:.3e}, scaled err "
                  f"{c['scaled']:.3e}, mean |out| {c['mean_abs_out']:.3e} ({card})")
        print(f"{label}: {len(r['groupings_fails'])} checks of chip_smoke.groupings failed",
              *r["groupings_fails"], sep="\n  ")
    faulty = results["planted faults"]
    ring = next(c for c in faulty["cases"] if c["kernel"] == "K1" and c["dtype"] == "torch.bfloat16")
    print(f"the faulty K1 at the ring shape, bf16: abs err {ring['abs']:.3e}, "
          f"{'under' if ring['abs'] < faulty['tol']['abs']['bf16'] else 'over'} the absolute limit "
          f"{faulty['tol']['abs']['bf16']}; scaled err {ring['scaled']:.3e}")
    caught = {kernel: any(f.startswith(f"{kernel} vs plain") and "scaled err" in f for f in faulty["groupings_fails"])
              for kernel in ("K1", "K2")}
    ok = not results["repository"]["groupings_fails"] and all(caught.values())
    print(json.dumps({"ok": ok, "scaled check caught": caught, "card": card}))
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--probe":
        print(json.dumps(probe(sys.argv[2])))
        sys.exit(0)
    sys.exit(main())
