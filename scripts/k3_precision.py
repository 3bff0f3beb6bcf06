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
which it sums in fp64.

Then, at ``chip_smoke.py``'s "loga ~ -5" case (x (4, 512, 65), N = 64,
loga = -5 + 0.1 noise, gate sd 1) over 20 seeds, it prints the same two
errors beside each element's condition: the magnitude of the terms its
sum adds (``ssm_scan_plain`` in fp64 on |x|, |b|, |c|) over its scale. At
a decay of e^-5 a step, an output row is nearly the one product c_t . b_t
times x_t, so where that product cancels the row's scale falls far below
the terms the kernel sums. It also prints the error over the terms'
magnitude, which arithmetic that rounds in fp32 keeps near 2^-24 or below.
Last, the same at the Mamba-2 layout of jamba-1.5-large-398b (128 heads of
P = 128, N = 64, c shared by the heads, a 4096-token prompt, 10 seeds),
whose decay reaches e^-11 a step.

Run from the repository root on a machine with an H100:
``python3 scripts/k3_precision.py``.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from chip_smoke import mamba_scan_inputs  # noqa: E402
from repro_torch.kernels.ssm_scan import fold, ssm_scan_cuda, ssm_scan_plain  # noqa: E402


def scaled_err(a, exact):
    a, exact = a.double(), exact.double()
    scale = exact.abs() + exact.abs().amax(dim=-1, keepdim=True)
    return float(((a - exact).abs() / scale.clamp_min(1e-300)).max())


def neg5(card: str) -> None:
    """chip_smoke.py's "loga ~ -5" case over 20 seeds (see the module's
    docstring)."""
    B, S, H, P, N, L = 1, 512, 4, 65, 64, 256
    for dtype in (torch.bfloat16, torch.float32):
        for seed in range(20):
            gen = torch.Generator(device="cuda").manual_seed(seed)

            def rnd(*shape):
                return torch.randn(*shape, generator=gen, device="cuda")

            x = rnd(B, S, H, P).to(dtype)
            x[..., -1] = 1
            c = rnd(B, S, H, N).to(dtype)
            b = rnd(B, S, H, N) / N**0.5 * torch.exp(rnd(B, S, H, 1).clamp(-10, 10))
            loga = -5 + 0.1 * rnd(B, S, H)
            f = fold(x, loga, b, c, L)
            y, _ = ssm_scan_cuda(*f, L)
            y32, _ = ssm_scan_plain(*f, L)
            ye, _ = ssm_scan_plain(*(t.double() for t in f), L)
            terms, _ = ssm_scan_plain(f[0].double().abs(), f[1].double(), f[2].double().abs(),
                                      f[3].double().abs(), L)
            scale = ye.abs() + ye.abs().amax(dim=-1, keepdim=True)
            ye = ye.to(dtype).double()
            e, e32 = (y.double() - ye).abs(), (y32.double() - ye).abs()
            at = int((e / scale.clamp_min(1e-300)).argmax())
            print(f"loga ~ -5 {str(dtype)[6:]} seed {seed}: kernel y {float((e / scale).max()):.3e}, fp32 y "
                  f"{float((e32 / scale).max()):.3e} of the scale; at the kernel's worst element the terms are "
                  f"{float(terms.flatten()[at] / scale.flatten()[at]):.1f} x its scale; over the terms: kernel "
                  f"{float((e / terms.clamp_min(1e-300)).max()):.3e}, fp32 {float((e32 / terms.clamp_min(1e-300)).max()):.3e}; "
                  f"largest terms / scale {float((terms / scale).max()):.1f} ({card})", flush=True)


def mamba(card: str) -> None:
    """K3 at jamba's Mamba-2 layout over 10 seeds (see the module's
    docstring): x (1, 4096, 128, 128), b and c (1, 4096, 128, 64) as
    ``chip_smoke.mamba_scan_inputs`` builds them (c the same for every
    head, loga down to about -11 a step); the same errors as ``neg5``."""
    S, L = 4096, 256
    for dtype in (torch.bfloat16, torch.float32):
        for seed in range(10):
            f = fold(*mamba_scan_inputs(torch.Generator(device="cuda").manual_seed(seed), 1, S, dtype), L)
            y, _ = ssm_scan_cuda(*f, L)
            y32, _ = ssm_scan_plain(*f, L)
            ye, _ = ssm_scan_plain(*(t.double() for t in f), L)
            terms, _ = ssm_scan_plain(f[0].double().abs(), f[1].double(), f[2].double().abs(),
                                      f[3].double().abs(), L)
            scale = ye.abs() + ye.abs().amax(dim=-1, keepdim=True)
            ye = ye.to(dtype).double()
            e, e32 = (y.double() - ye).abs(), (y32.double() - ye).abs()
            at = int((e / scale.clamp_min(1e-300)).argmax())
            print(f"Mamba shape {str(dtype)[6:]} seed {seed}: kernel y {float((e / scale).max()):.3e}, fp32 y "
                  f"{float((e32 / scale).max()):.3e} of the scale; at the kernel's worst element the terms are "
                  f"{float(terms.flatten()[at] / scale.flatten()[at]):.1f} x its scale; over the terms: kernel "
                  f"{float((e / terms.clamp_min(1e-300)).max()):.3e}, fp32 {float((e32 / terms.clamp_min(1e-300)).max()):.3e}; "
                  f"largest terms / scale {float((terms / scale).max()):.1f} ({card})", flush=True)
            del f, y, y32, ye, terms, scale, e, e32


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
    neg5(card)
    mamba(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
