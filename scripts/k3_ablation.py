#!/usr/bin/env python3
"""Where K3's time goes on the card, without ncu: timing-only variants.

Builds copies of ``src/repro_torch/csrc/ssm_scan.cu`` with one part of the
inner loop taken out (their results are wrong by design and never checked)
and times each against the unchanged kernel, per pass (``torch.profiler``
device time of ``pass_states_weights`` and ``pass_outputs``) and as a whole
call (a CUDA graph of 20 calls, replayed):

- ``no_split``: the fp32 operands are not rounded to TF32 parts (the
  subtractions stay);
- ``no_mma``:   every ``mma.sync`` replaced by one fp32 addition that keeps
  its operands alive (the fragment loads and splits stay);
- ``no_load``:  only the stages that first fill the ring are copied in
  (later stages reuse their shared memory);
- ``no_frag``:  the fragments are zeros instead of shared-memory loads (the
  splits and ``mma.sync`` stay);
- ``no_tiles``: no tile products at all (the copies, barriers, scans and
  stores stay): the skeleton of both passes;
- ``no_scan``:  the chunk's cumulative log-decay is its log-decay (no
  log-step scan and its barriers).

Shape: one mLSTM prefill of xlstm-1.3b (folded x (4, 1024, 520) bf16, b
fp32, c bf16, N = 512, chunk 256). Run from the repository root on a
machine with an H100 and the CUDA toolkit: ``python3 scripts/k3_ablation.py``.
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
import torch.nn.functional as F  # noqa: E402

from chip_smoke import graph_ms  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ssm_scan as k3  # noqa: E402

VARIANTS = {
    "kernel": [],
    "no_split": [("      p[i] = to_tf32(a);", "      p[i] = __float_as_uint(a);")],
    "no_mma": [("            mma_tf32(sum[mi][ni], fa4, fb2);",
                "            sum[mi][ni][0] += __uint_as_float(fa4[0] ^ fa4[1] ^ fa4[2] ^ fa4[3] ^ fb2[0] ^ fb2[1]);"),
               ("            mma_tf32(acc[mi][ni], fa4, fb2);",
                "            acc[mi][ni][0] += __uint_as_float(fa4[0] ^ fa4[1] ^ fa4[2] ^ fa4[3] ^ fb2[0] ^ fb2[1]);")],
    "no_load": [("      if (i < steps) {\n        unsigned char* st", "      if (i < steps && i < kStages) {\n        unsigned char* st"),
                ("    if (i < steps) {\n      unsigned char* st", "    if (i < steps && i < kStages) {\n      unsigned char* st"),
                ("    if (i < steps1) {\n      stage_tile", "    if (i < steps1 && i < kStages) {\n      stage_tile"),
                ("    } else if (i < steps) {", "    } else if (i < steps && i - steps1 < kStages) {")],
    "no_frag": [("    fa(kk, va);\n    fb(kk, vb);",
                 "    for (int i = 0; i < 8; ++i) va[i / 4][i % 4] = vb[i / 2][i % 2] = 0.f;")],
    "no_tiles": [("  for (int kk = 0; kk < kStep; kk += 8) {", "  for (int kk = 0; kk < 0; kk += 8) {")],
    "no_scan": [("  for (int off = 1; off < kThreads; off <<= 1) {", "  for (int off = kThreads; off < kThreads; off <<= 1) {")],
}
PASSES = ("pass_states_weights", "pass_outputs")


def build_variants(out_dir: Path) -> dict:
    src = (ROOT / "src/repro_torch/csrc/ssm_scan.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: the kernel holds {old!r} {text.count(old)} times, not once")
            text = text.replace(old, new)
        (out_dir / f"{name}.cu").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"), str(out_dir / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    return {name: out_dir / f"{name}.so" for name in VARIANTS}


def pass_us(fn, iters: int = 10) -> dict:
    """Mean device time of each pass over ``iters`` calls, from the profiler."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(PASSES, 0.0)
    for e in prof.key_averages():
        for p in PASSES:
            if p in e.key:
                out[p] += e.device_time_total / iters
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_ablation: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    libs = build_variants(_build.BUILD_DIR / "k3_ablation")
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, S, H, P, N = 1, 1024, 4, 513, 512

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    gate = torch.exp(rnd(B, S, H, 1).clamp(-10, 10))
    f = k3.fold(rnd(B, S, H, P).to(torch.bfloat16), F.logsigmoid(3 + rnd(B, S, H)),
                rnd(B, S, H, N) / N**0.5 * gate, rnd(B, S, H, N).to(torch.bfloat16), 256)
    entry = k3._entry
    argtypes = entry().argtypes
    try:
        for name, lib in libs.items():
            fn = ctypes.CDLL(str(lib)).k3_ssm_scan
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            k3._entry = lambda fn=fn: fn
            call = lambda: k3.ssm_scan_cuda(*f, 256)  # noqa: E731
            us = pass_us(call)
            print(f"{name}: call {graph_ms(call):.5f} ms (graph); " +
                  ", ".join(f"{p} {v:.2f} us" for p, v in us.items()) + f" ({card})", flush=True)
    finally:
        k3._entry = entry
    return 0


if __name__ == "__main__":
    sys.exit(main())
