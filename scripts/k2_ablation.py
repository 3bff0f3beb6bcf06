#!/usr/bin/env python3
"""Where K2's time goes on the card, without a profiler: timing-only variants.

Builds copies of ``src/repro_torch/csrc/flash_attention.cu`` with one part of
the bf16 tile loop taken out (their results are wrong by design and never
checked), and times each against the unchanged kernel by CUDA-graph replay:

- ``no_exp``:  P = S - m instead of exp2(S - m) (no MUFU work);
- ``no_pv``:   the P V wgmma skipped (V is still copied in);
- ``no_qk``:   the Q Kᵀ wgmma skipped (K is still copied in);
- ``no_load``: only the first three kv tiles are copied in (later tiles
  reuse their shared memory).

Shapes: the qwen3 prefill (B 1, Sq = Sk = 1024), a throughput shape (B 8,
Sq = Sk = 2048) and 64 query rows against 1024 keys (16 blocks of equal
work, one per SM). H 16, KH 8, D 128, bf16. Run from the repository root on
a machine with an H100 and the CUDA toolkit: ``python3 scripts/k2_ablation.py``.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from chip_smoke import graph_ms  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

VARIANTS = {
    "kernel": [],
    "no_exp": [("exp2f(s[4 * nt + e] - m_new)", "(s[4 * nt + e] - m_new)")],
    "no_pv": [("      wgmma_rs<D>(o, a,", "      if (kk < 0) wgmma_rs<D>(o, a,")],
    "no_qk": [("      wgmma_ss<BK>(acc,", "      if (kd < 0) wgmma_ss<BK>(acc,")],
    "no_load": [("if (j + 2 < ntiles) load_kv(", "if (j + 2 < ntiles && j < 1) load_kv(")],
}
SHAPES = [(1, 1024, 0), (8, 2048, 0), (1, 64, 960)]  # (B, Sq, q_offset); Sk = Sq + q_offset


def build_variants(out_dir: Path) -> dict:
    src = (ROOT / "src/repro_torch/csrc/flash_attention.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: the kernel no longer contains {old!r}")
            text = text.replace(old, new)
        (out_dir / f"{name}.cu").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"), str(out_dir / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    return {name: out_dir / f"{name}.so" for name in VARIANTS}


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_ablation: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    libs = build_variants(_build.BUILD_DIR / "k2_ablation")
    gen = torch.Generator(device="cuda").manual_seed(0)
    H, KH, D = 16, 8, 128

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    data = {sh: (rnd(sh[0], sh[1], H, D), rnd(sh[0], sh[1] + sh[2], KH, D), rnd(sh[0], sh[1] + sh[2], KH, D))
            for sh in SHAPES}
    entry = fa._entry
    argtypes = entry().argtypes
    try:
        for name, lib in libs.items():
            fn = ctypes.CDLL(str(lib)).k2_flash_attention
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            fa._entry = lambda fn=fn: fn
            cells = []
            for (b, sq, off), (q, k, v) in data.items():
                ms = graph_ms(lambda: fa.flash_attention_cuda(q, k, v, q_offset=off, scale=D**-0.5))
                cells.append(f"B {b}, Sq {sq}, Sk {sq + off}: {ms:.5f} ms")
            print(f"{name}: " + "; ".join(cells) + f" ({card})", flush=True)
    finally:
        fa._entry = entry
    return 0


if __name__ == "__main__":
    sys.exit(main())
