#!/usr/bin/env python3
"""Where K3 should form its intra-chunk weights W, timed on the card.

K3 (``src/repro_torch/csrc/ssm_scan.cu``) forms W = C B^T o decay o tril
once, in weights blocks of its first launch, into a 4 MB scratch that the
output blocks read. ``scripts/k3_w_in_block.cu`` forms W inside each output
block instead (the states blocks alone in the first launch), which repeats
the C B^T work and its copies for every 64 columns of P but drops the
scratch. This script builds that probe twice (launch bounds asking for 2
and 3 blocks an SM), checks that its y and h equal the kernel's bit for
bit, and times both in one process: the whole call by replaying a CUDA
graph of 20 calls, each pass by ``torch.profiler``.

Shape: one mLSTM prefill of xlstm-1.3b (folded x (4, 1024, 520) bf16, b
fp32, c bf16, N = 512, chunk 256), as ``scripts/k3_ablation.py``. Run from
the repository root on a machine with an H100 and the CUDA toolkit:
``python3 scripts/k3_w_placement.py``.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from chip_smoke import graph_ms  # noqa: E402
from k3_ablation import pass_us  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ssm_scan as k3  # noqa: E402

MIN_BLOCKS = (2, 3)


def build(out_dir: Path) -> dict:
    """One library per launch bound, built in parallel; each exports the
    kernel's entry point and the probe's. Prints ptxas's registers and
    spills for the probe's output pass."""
    out_dir.mkdir(parents=True, exist_ok=True)
    src = ROOT / "scripts" / "k3_w_in_block.cu"
    procs = {}
    for mb in MIN_BLOCKS:
        out = out_dir / f"w_in_block_{mb}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-DK3W_MIN_BLOCKS={mb}", "-o", str(out), str(src)]
        procs[mb] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for mb, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for K3W_MIN_BLOCKS={mb}:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and "pass_outputs_wblock" in line:
                usage = " ".join(ln.strip() for ln in lines[i + 1:i + 4] if re.search(r"registers|spill", ln))
                print(f"ptxas, probe output pass, {mb} blocks an SM: {usage}", flush=True)
        libs[mb] = out
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_w_placement: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    libs = build(_build.BUILD_DIR / "k3_w_placement")
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, S, H, P, N = 1, 1024, 4, 513, 512

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    gate = torch.exp(rnd(B, S, H, 1).clamp(-10, 10))
    f = k3.fold(rnd(B, S, H, P).to(torch.bfloat16), F.logsigmoid(3 + rnd(B, S, H)),
                rnd(B, S, H, N) / N**0.5 * gate, rnd(B, S, H, N).to(torch.bfloat16), 256)
    entry = k3._entry
    argtypes = entry().argtypes
    call = lambda: k3.ssm_scan_cuda(*f, 256)  # noqa: E731
    y0, h0 = call()
    ok = True
    try:
        # the kernel, each probe, the kernel again: a drift of the card's
        # clock between readings shows as two kernel readings that differ
        order = [("kernel", entry())] + [
            (f"w_in_block ({mb} blocks an SM)", getattr(ctypes.CDLL(str(lib)), "k3_ssm_scan_w_in_block"))
            for mb, lib in libs.items()] + [("kernel", entry())]
        for name, fn in order:
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            k3._entry = lambda fn=fn: fn
            y, h = call()
            torch.cuda.synchronize()
            same = torch.equal(y, y0) and torch.equal(h, h0)
            ok &= same
            us = pass_us(call)
            print(f"{name}: call {graph_ms(call):.5f} ms (graph); " +
                  ", ".join(f"{p} {v:.2f} us" for p, v in us.items()) +
                  f"; y and h equal the kernel's bit for bit: {same} ({card})", flush=True)
    finally:
        k3._entry = entry
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
