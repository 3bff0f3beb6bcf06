#!/usr/bin/env python3
"""How far K3 and the plain chunked algorithm summed in fp32 each land from
the exact result, on the card.

At the shape of one xlstm-1.3b mLSTM prefill (folded x (4, 1024, 513), N =
512, chunk 256) with mLSTM-like inputs (b = k exp(input gate), the gate's
log ~ N(0, sd^2) clamped at +-10; sd 1 is what the model's random weights
give, sd 3 reaches e^10), for x and c in bf16 and in fp32 and three seeds,
it prints each element's error against its own scale (|exact| + the
largest |exact| of its row, as ``chip_smoke.py`` takes it) for

- ``kernel``: K3 (``ssm_scan_cuda``);
- ``fp32``:   ``ssm_scan_plain`` on the inputs as they are, which it sums
  in fp32 (cuBLAS, TF32 off);

where "exact" is ``ssm_scan_plain`` on the same inputs widened to fp64,
which it sums in fp64. Run from the repository root on a
machine with an H100: ``python3 scripts/k3_precision.py``.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels.ssm_scan import fold, ssm_scan_cuda, ssm_scan_plain  # noqa: E402


def scaled_err(a, exact):
    a, exact = a.double(), exact.double()
    scale = exact.abs() + exact.abs().amax(dim=-1, keepdim=True)
    return float(((a - exact).abs() / scale.clamp_min(1e-300)).max())


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_precision: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    B, S, H, P, N, L = 1, 1024, 4, 513, 512, 256
    for dtype in (torch.bfloat16, torch.float32):
        for sd in (1.0, 3.0):
            for seed in range(3):
                gen = torch.Generator(device="cuda").manual_seed(seed)

                def rnd(*shape):
                    return torch.randn(*shape, generator=gen, device="cuda")

                x = rnd(B, S, H, P).to(dtype)
                x[..., -1] = 1
                c = rnd(B, S, H, N).to(dtype)
                gate = torch.exp((sd * rnd(B, S, H, 1)).clamp(-10, 10))
                b = rnd(B, S, H, N) / N**0.5 * gate
                loga = F.logsigmoid(3 + rnd(B, S, H))
                f = fold(x, loga, b, c, L)
                y, h = ssm_scan_cuda(*f, L)
                ye, he = ssm_scan_plain(*(t.double() for t in f), L)
                y32, h32 = ssm_scan_plain(*f, L)
                ye = ye.to(dtype)  # y is compared where it is rounded to x's type
                print(f"{str(dtype)[6:]} gate sd {sd:g} seed {seed}: kernel y {scaled_err(y, ye):.3e} "
                      f"h {scaled_err(h, he):.3e}; fp32 y {scaled_err(y32, ye):.3e} "
                      f"h {scaled_err(h32, he):.3e} ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
