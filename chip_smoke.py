#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the repository root on a machine with an H100 and the CUDA
toolkit: ``python3 chip_smoke.py``. It

1. prints the card's name and power limit (``nvidia-smi``) and turns TF32 off;
2. builds the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all at once) and prints what ``-Xptxas -v`` reports;
3. holds K1 (flash-decode) against its plain PyTorch version, bf16 and
   fp32: random validity, a ring full at capacity, a remainder tile, a row
   valid only in the remainder tile, an all-invalid row, two-shard partials;
4. holds K2 (flash-attention forward) against its plain version: causal
   prefill, and a window with a query offset where a row's first visited
   kv tile is fully masked;
5. serves 16 requests on qwen3-1.7b at full width (random weights from a
   seeded generator) through ``ServeLoop`` in arena mode and checks that
   every prefill went through K2 and every decode step through K1;
6. compares the logits of the kernel path with the plain path;
7. times each kernel, its plain version and the PyTorch library call for
   the same function at the main path's shapes, and times a decode step
   and a prefill to show each kernel's share;
8. prints one ``{"kernels": [...]}`` line with times and bounds, the card
   line, and last ``{"ok": true, "device": {...}}``. ``--out FILE`` also
   writes every measurement to FILE as JSON.

Any failed check raises: the script exits non-zero and prints no result.
Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12  # dense tensor-core bf16
BF16_TOL, FP32_TOL = 3e-2, 1e-4  # kernel vs plain: bf16 as tests/test_kernels.py; fp32 sums in another order
# of the largest |logit|. The two paths round attention outputs to bf16 after
# summing in another order, and 28 bf16 layers carry that forward: a bf16
# ulp at |logit| ~ 4 is 1/32. A wrong mask or head mapping moves logits by
# O(|logit|).
LOGIT_TOL = 5e-2


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def timed_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write every measurement as JSON to this file")
    out_path = ap.parse_args(argv).out
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.dataset import SyntheticCorpus
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.decode_attention import decode_attention_cuda, decode_attention_plain
    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain
    from repro_torch.launch.serve import Request, ServeLoop
    from repro_torch.models import model as M

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    record = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    report = _build.build()
    record["build_s"] = time.perf_counter() - t0
    print(f"build: {record['build_s']:.2f} s for {len(report)} kernels (parallel nvcc)")
    for name, r in report.items():
        print(f"build {name}: {r['seconds']:.2f} s")
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  {line.strip()}")

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def err(a, b):
        return float((a.float() - b.float()).abs().max())

    # -- 3. K1 vs plain ---------------------------------------------------
    B, H, KH, D = 8, 16, 8, 128
    k1_err = {}
    rows = [0, 1, 3, 4, 5, 6, 7]  # all but the all-invalid row 2
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
        worst = 0.0
        for S in (2048, 2050):
            q = rnd(B, H, D, dtype=dtype)
            k, v = rnd(B, S, KH, D, dtype=dtype), rnd(B, S, KH, D, dtype=dtype)
            valid = (torch.rand(B, S, generator=gen, device=dev) > 0.3).to(torch.int32)
            valid[1] = 1  # ring full at capacity
            valid[2] = 0  # all-invalid row
            valid[3] = 0
            valid[3, (S - 1) // 32 * 32:] = 1  # valid only in the last 32-key tile (the remainder at S = 2050)
            for normalize in (True, False):
                got = decode_attention_cuda(q, k, v, valid, scale=D**-0.5, normalize=normalize)
                exp = decode_attention_plain(q, k, v, valid, scale=D**-0.5, normalize=normalize)
                torch.cuda.synchronize()
                check(float(got[0][2].abs().max()) == 0.0 and float(got[2][2].max()) == 0.0,
                      f"K1 all-invalid row is exactly zero ({dtype}, S={S})")
                if normalize:
                    worst = max(worst, err(got[0], exp[0]))
                else:  # partials: acc and l grow with the number of valid keys
                    for a, b in zip(got, exp):
                        rel = err(a[rows], b[rows]) / max(1.0, float(b[rows].abs().max()))
                        check(rel < tol, f"K1 partials vs plain {dtype}, S={S}: {rel} >= {tol}")
            # two shards of S, combined through the partials
            half = S // 2
            parts = [decode_attention_cuda(q, k[:, sl], v[:, sl], valid[:, sl].contiguous(), scale=D**-0.5,
                                           normalize=False)
                     for sl in (slice(0, half), slice(half, S))]
            combined = ops.combine_decode_partials(*zip(*parts))
            whole = decode_attention_plain(q, k, v, valid, scale=D**-0.5)[0]
            worst = max(worst, err(combined[rows], whole[rows]))
        check(worst < tol, f"K1 vs plain {dtype}: {worst} >= {tol}")
        k1_err[str(dtype)] = worst
        print(f"K1 vs plain {dtype}: max abs err {worst:.3e} (tol {tol})")

    # -- 4. K2 vs plain ---------------------------------------------------
    k2_err = {}
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
        worst = 0.0
        # causal prefill; then a window with a query offset: rows late in a
        # 64-row q tile find the tile's first visited kv tile fully masked
        for Sq, Sk, win, off in ((1024, 1024, 0, 0), (256, 1280, 100, 1024)):
            q = rnd(1, Sq, H, D, dtype=dtype)
            k, v = rnd(1, Sk, KH, D, dtype=dtype), rnd(1, Sk, KH, D, dtype=dtype)
            got = flash_attention_cuda(q, k, v, q_offset=off, window=win, scale=D**-0.5)
            exp = flash_attention_plain(q, k, v, q_offset=off, window=win, scale=D**-0.5)
            torch.cuda.synchronize()
            worst = max(worst, err(got, exp))
        check(worst < tol, f"K2 vs plain {dtype}: {worst} >= {tol}")
        k2_err[str(dtype)] = worst
        print(f"K2 vs plain {dtype}: max abs err {worst:.3e} (tol {tol})")

    # -- 5. serve qwen3-1.7b at full width ---------------------------------
    cfg = get_config("qwen3-1.7b")
    t0 = time.perf_counter()
    params = M.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dtype=torch.bfloat16)
    torch.cuda.synchronize()
    print(f"init qwen3-1.7b ({M.count_params_exact(cfg)} params, bf16): {time.perf_counter() - t0:.1f} s")
    kernel_run = RunConfig(remat="none", attention_impl="pallas", decode_attention_impl="kernel")
    lens = [128, 256, 384, 512, 640, 768, 896, 1024] * 2
    corpus = SyntheticCorpus(cfg.vocab_size, max(lens), seed=0)
    reqs = [Request(i, corpus.grain_tokens(i, 1)[0][:n], 32) for i, n in enumerate(lens)]
    loop = ServeLoop(cfg, kernel_run, params, batch=8, max_len=2048, mode="arena", device="cuda")
    loop.warm(128)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    loop.start(reqs, t0=time.perf_counter())
    while loop.tick() != "done":
        pass
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    stats = loop.stats()
    peak = torch.cuda.max_memory_allocated()
    L = cfg.num_layers
    check(stats["completed"] == 16, f"served {stats['completed']}/16")
    check(stats["decode_calls"] < stats["decode_steps"], "arena batches decode steps")
    check(launches["flash_attention"] == L * stats["prefill_calls"] and stats["prefill_calls"] == 16,
          f"K2 launches {launches['flash_attention']} != {L} x {stats['prefill_calls']} prefills")
    check(launches["decode_attention"] == L * stats["decode_calls"],
          f"K1 launches {launches['decode_attention']} != {L} x {stats['decode_calls']} decode calls")
    check(all(len(r.tokens) == 32 for r in reqs), "every request got 32 tokens")
    record["serve"] = {**stats, "launches": launches, "peak_bytes": peak}
    print(f"serve qwen3-1.7b arena batch=8 max_len=2048, 16 requests (prompts 128-1024, gen 32) on {card}: "
          f"{stats['tokens_per_s']:.1f} tok/s, mean TTFT {stats['mean_ttft_s'] * 1e3:.1f} ms, "
          f"{stats['decode_calls']} decode calls, occupancy {stats['slot_occupancy']:.3f}, "
          f"wall {stats['wall_s']:.2f} s, peak memory {peak / 2**30:.2f} GiB; launches {launches}")

    # -- 6. logits: kernel path vs plain path -------------------------------
    plain_run = RunConfig(remat="none", attention_impl="chunked", decode_attention_impl="einsum")
    prompt = torch.as_tensor(np.stack([corpus.grain_tokens(100 + i, 1)[0][:300] for i in range(2)]),
                             dtype=torch.long, device=dev)
    worst, top = 0.0, 0.0
    caches = {}
    logits = {}
    for name, run in (("kernel", kernel_run), ("plain", plain_run)):
        logits[name], caches[name] = M.prefill(cfg, run, params, prompt, 512)
    feed = []
    for step in range(5):
        a, b = logits["kernel"].float(), logits["plain"].float()
        worst, top = max(worst, float((a - b).abs().max())), max(top, float(b.abs().max()))
        if step == 4:
            break
        tok = torch.argmax(a[:, -1], dim=-1, keepdim=True)  # both paths get the same tokens
        feed.append(tok)
        for name, run in (("kernel", kernel_run), ("plain", plain_run)):
            logits[name], _ = M.decode_step(cfg, run, params, caches[name], tok)
    torch.cuda.synchronize()
    check(np.isfinite(worst) and worst <= LOGIT_TOL * max(1.0, top),
          f"logits kernel vs plain: {worst} > {LOGIT_TOL} x {top}")
    record["logits"] = {"max_abs_diff": worst, "max_abs_logit": top, "tol": LOGIT_TOL * max(1.0, top)}
    print(f"logits kernel vs plain (prefill 2x300 + 4 decode steps): max abs diff {worst:.4f}, "
          f"largest |logit| {top:.3f}, tol {LOGIT_TOL * max(1.0, top):.4f}")

    # -- 7. times and bounds at the main path's shapes (bf16) ---------------
    S = 2048
    q1, k1, v1 = rnd(B, H, D, dtype=torch.bfloat16), rnd(B, S, KH, D, dtype=torch.bfloat16), rnd(B, S, KH, D, dtype=torch.bfloat16)
    valid1 = (torch.rand(B, S, generator=gen, device=dev) > 0.3).to(torch.int32)
    mask1 = valid1.bool()[:, None, None, :]
    qs, ks, vs = q1[:, :, None], k1.transpose(1, 2), v1.transpose(1, 2)
    k1_bytes = (q1.numel() + k1.numel() + v1.numel()) * 2 + valid1.numel() * 4 + B * H * D * 4
    k1_flops = 4 * B * H * S * D
    Sq = 1024
    q2, k2, v2 = rnd(1, Sq, H, D, dtype=torch.bfloat16), rnd(1, Sq, KH, D, dtype=torch.bfloat16), rnd(1, Sq, KH, D, dtype=torch.bfloat16)
    q2s, k2s, v2s = q2.transpose(1, 2), k2.transpose(1, 2), v2.transpose(1, 2)
    k2_bytes = (q2.numel() * 2 + k2.numel() + v2.numel()) * 2
    k2_flops = 4 * H * D * Sq * (Sq + 1) // 2
    kernels = []
    for name, fn, plain, lib, nbytes, flops, src, tpu, launches_n, per_step, errs in (
        ("flash_decode", lambda: decode_attention_cuda(q1, k1, v1, valid1, scale=D**-0.5),
         lambda: decode_attention_plain(q1, k1, v1, valid1, scale=D**-0.5),
         lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask1, enable_gqa=True),
         k1_bytes, k1_flops, "src/repro_torch/csrc/decode_attention.cu",
         ("src/repro/kernels/decode_attention.py:31", "src/repro/kernels/decode_attention.py:_decode_kernel"),
         launches["decode_attention"], f"{L} per decode step", k1_err),
        ("flash_attention_fwd", lambda: flash_attention_cuda(q2, k2, v2, scale=D**-0.5),
         lambda: flash_attention_plain(q2, k2, v2, scale=D**-0.5),
         lambda: F.scaled_dot_product_attention(q2s, k2s, v2s, is_causal=True, enable_gqa=True),
         k2_bytes, k2_flops, "src/repro_torch/csrc/flash_attention.cu",
         ("src/repro/kernels/flash_attention.py:28", "src/repro/kernels/flash_attention.py:_flash_kernel"),
         launches["flash_attention"], f"{L} per prefill", k2_err),
    ):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu[0], "tpu_kernel": tpu[1],
            "launches": launches_n, "launches_per_step": per_step,
            "max_abs_err": max(errs.values()), "tol": {"bf16": BF16_TOL, "fp32": FP32_TOL},
            "ms": timed_ms(fn), "plain_ms": timed_ms(plain), "library_ms": timed_ms(lib),
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops,
        })
        kernels[-1]["kernel_ms"] = kernels[-1]["ms"]
        check(launches_n > 0, f"{name} was not launched on the main path")
    record["kernels"] = kernels

    # where a decode step and a prefill spend their time (host clock around
    # synchronised calls at the serve's shapes: 8 slots at position ~1024,
    # one 1024-token prompt)
    arena = M.init_cache(cfg, 8, 2048, dev)
    arena["pos"].fill_(1024)
    toks = torch.zeros((8, 1), dtype=torch.long, device=dev)
    act = torch.ones(8, dtype=torch.bool, device=dev)
    prompt = torch.as_tensor(corpus.grain_tokens(200, 1)[:, :1024], dtype=torch.long, device=dev)

    def host_ms(fn, iters=5):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / iters * 1e3

    step_ms = host_ms(lambda: M.decode_step(cfg, kernel_run, params, arena, toks, active=act))
    prefill_ms = host_ms(lambda: M.prefill(cfg, kernel_run, params, prompt, 2048))
    k1_share, k2_share = L * kernels[0]["ms"] / step_ms, L * kernels[1]["ms"] / prefill_ms
    record["breakdown"] = {"decode_step_ms": step_ms, "k1_share": k1_share,
                           "prefill_1024_ms": prefill_ms, "k2_share": k2_share}
    print(f"decode step (8 slots at ~1024) {step_ms:.2f} ms, {L} x K1 = {k1_share:.1%} of it; "
          f"prefill of 1024 tokens {prefill_ms:.2f} ms, {L} x K2 = {k2_share:.1%} of it ({card})")
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(json.dumps(record, indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
