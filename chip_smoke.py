#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the repository root on a machine with an H100 and the CUDA
toolkit: ``python3 chip_smoke.py``. It

1. prints the card's name and power limit (``nvidia-smi``) and turns TF32 off;
2. builds the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all at once) and prints what ``-Xptxas -v`` reports;
3. holds K1 (flash-decode) against its plain PyTorch version, bf16 and
   fp32: random validity, a ring full at capacity, a row valid only in the
   last 32 keys, one valid only in the last split, an all-invalid row,
   two-shard partials, at S = 2048 and 2050 and at the split boundaries
   (below one split, one short of it, at it, one past it); and checks that
   each row of a batch-8 call is bit-identical to that row called alone;
4. holds K2 (flash-attention forward) against its plain version: causal
   prefill, Sq not a multiple of the 64-row q tile, and a window with a
   query offset where a row's first visited 64-key tile is fully masked;
5. holds K3 (the chunked SSD scan) against its plain version on the same
   inputs widened to fp64 (so that it sums in fp64), bf16 and fp32, each
   element against its own scale: the mLSTM prefill shapes (input gates as the model draws them,
   and up to e^10), a sequence that pads, one below a chunk, P = N = 64,
   loga = 0, loga ~ -5 (its y against the magnitude of the terms each
   element sums), and chunk 64 vs 256; and checks at the prefill
   shape that two calls give the same bits, that each row of the call
   equals that row called alone, and that a call replayed from a CUDA
   graph equals the eager call;
6. serves 16 requests on qwen3-1.7b at full width (random weights from a
   seeded generator) through ``ServeLoop`` in arena mode and checks that
   every prefill went through K2 and every decode step through K1;
7. serves the same 16 requests through ``FleetLoop`` over qwen3-1.7b
   replicas of unequal capacity on the same weights: a fixed pool of two
   batch-8 and one batch-2 arena, an elastic pool that an autoscaler grows
   from one batch-2 replica, and the ``repro_torch.launch.fleet`` entry
   point; checks that every request completes, that K1 and K2 carried every
   decode step and prefill (warm-ups included), and that every stream
   equals, bit for bit, a lone serve's at the same arena batch;
8. compares the logits of the kernel path with the plain path;
9. serves 12 requests on xlstm-1.3b at full width the same way and checks
   that every mLSTM prefill went through K3; holds the first mLSTM block
   (K3 on its scan inputs, its output, its prefill state) in bf16 on real
   activations, and the logits of the first 8 layers in fp32, on the
   kernel path against the plain path (its scans summed in fp64); checks that the full stack's
   logits are finite, and that a parked row's recurrent state is left bit
   for bit;
10. times each kernel (by replaying a CUDA graph of 20 calls, so the
   wrapper's host time is out of the reading; also eagerly), its plain
   version and the PyTorch library call for the same function (where one
   exists) at the main path's shapes, K2 and SDPA also at B 8, Sq = 2048;
   times a qwen3 decode step and prefill eagerly and as CUDA graphs (the
   device's time without the host), times
   decode steps and prefills to show each kernel's share, and splits an
   xlstm prefill with CUDA events inside the call;
11. runs the port's heterogeneous-cluster simulator on the host (no
   device work): the 37 stored golden hashes, the ``check_views=True``
   cases (their accumulators equal a brute-force re-sum, by ``==``), and the
   10^5-request slice of ``fleet_million``, whose event count and per-class
   p99 must equal ``BENCH_simperf.json``'s; prints its wall time and
   events/s beside the host CPU's model;
12. prints one ``{"kernels": [...]}`` line with times and bounds, the card
   line, and last ``{"ok": true, "device": {...}}``. ``--out FILE`` also
   writes every measurement to FILE as JSON.

Any failed check raises: the script exits non-zero and prints no result.
Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import platform
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12  # dense tensor-core bf16
TF32_FLOPS = 495e12  # dense tensor-core TF32
BF16_TOL, FP32_TOL = 3e-2, 1e-4  # kernel vs plain: bf16 as tests/test_kernels.py; fp32 sums in another order
# K3 and the mLSTM block vs plain, each element against its own scale (see
# scaled_err in main: the mLSTM input gate reaches e^10, so one global scale
# would hide the error of every element near the few large ones). bf16: the
# output is rounded to bf16 and two fp32 sums in another order may round to
# neighbouring values; one ulp is at most 2^-7 of an element, so at most
# 2^-8 (3.9e-3) of its scale, and 1e-2 admits two. fp32: sums over ~800
# terms in another order, a few fp32 ulps (6e-8) each. K3's reference is
# the plain version summed in fp64 (k3_exact in main), so the difference is
# the kernel's own error: summed in fp32 the plain version is itself up to
# 5.2e-5 of an element's scale from the exact result at input gates near
# e^10 (scripts/k3_precision.py), beyond the fp32 limit. The kernel and the
# reference both sum the cumulative log-decay in fp64, so the limits carry
# no term for the decay factors' own error. One exception, K3_TERMS_TOL.
K3_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
# The y of the "loga ~ -5" case is held against the magnitude of the terms
# each element sums (ssm_scan_plain in fp64 on |x|, loga, |b|, |c|, as
# scripts/k3_precision.py takes it), not against its own scale: at a decay
# of e^-5 a step an output row is nearly the one product c_t . b_t times
# x_t, and where that product cancels the row's scale falls up to 1e4
# times below the terms it sums. fp32 arithmetic errs relative to the
# terms: over 20 seeds the kernel errs 1.2e-7 to 1.6e-7 of them (the plain
# version summed in fp32 2.3e-5 to 7.7e-5), and 1e-6 is ~16 units of fp32
# roundoff; a wrong kernel errs O(1). In bf16 the y is rounded to bf16, and
# one bf16 unit is at most 2^-7 of |y|, itself at most the terms, so bf16
# keeps K3_TOL's 1e-2 on this measure.
K3_TERMS_TOL = {torch.bfloat16: K3_TOL[torch.bfloat16], torch.float32: 1e-6}
# of the largest |logit|. The two paths round attention outputs to bf16 after
# summing in another order, and 28 bf16 layers carry that forward: a bf16
# ulp at |logit| ~ 4 is 1/32. A wrong mask or head mapping moves logits by
# O(|logit|).
LOGIT_TOL = 5e-2
# xlstm logits, kernel vs plain path, of the largest |logit|, in fp32 on the
# first 8 layers (7 mLSTM, 1 sLSTM) at full width. The random-weight stack
# grows a difference layer by layer (after all 48 the two paths end a few %
# of the largest logit apart in fp32, O(|logit|) in bf16), so the check is
# made where a correct kernel sits far below it and a wrong one, which moves
# logits by O(|logit|), far above.
XLOGIT_TOL, XLOGIT_LAYERS = 1e-3, 8
# The simulator's 10^5-request slice of fleet_million (120 replicas) as
# benchmarks/bench_simperf.py runs it, and what BENCH_simperf.json records
# for it: the event count and the per-class p99 sojourn, to 0.1 s. The
# slice, not the 10^6 preset, for the script's time limit (10^6 took 226 to
# 333 s there).
SIM_SLICE, SIM_EVENTS, SIM_P99 = 100_000, 202_468, {0: 2255.7, 1: 2242.0, 2: 2239.9}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


# Each kernel before its Hopper redesign (PERF.md's kernel table, "earlier
# ms": chip_smoke.py, eager, on an H100 80GB HBM3 at 700 W, each on the tree
# just before its redesign). Quoted, not measured here, so they go to the
# --out record and a labelled printed line, never into the kernels line
EARLIER_MS = {"flash_decode": 1.1745, "flash_attention_fwd": 1.3177, "ssd_scan": 0.7944}
# the kernels line holds names, strings, this run's measurements and
# bound_ms; derived rates, constants and quoted times stay in --out's record
LINE_KEYS = ("name", "route", "source", "replaces", "tpu_kernel", "launches", "launches_per_step",
             "max_abs_err", "max_scaled_err", "ms", "kernel_ms", "eager_ms", "plain_ms", "library_ms",
             "library_note", "timing", "bound_ms", "bound_by", "design")
DESIGN = {
    "flash_decode": "split S into 256-key blocks (fixed, batch-invariant), 16-byte loads, "
                    "8 key rows in flight per lane, fixed-order combine kernel",
    "flash_attention_fwd": "bf16 wgmma (Q K^T from swizzled smem, P V with P in registers), scores in "
                           "registers, 64x64 tiles, three-stage cp.async ring, next tile's Q K^T overlapping "
                           "this tile's softmax, latest q tiles first",
    "ssd_scan": "chunk-parallel on mma.sync TF32, fp32 operands split in 2 TF32 parts (3, with fp64 sums, "
                "on the fp32 path): states blocks (row, 64 of N, 64 of P) over the chunks beside 64x64 "
                "C B^T decay tiles, then output blocks (row, chunk, 64 of t, 64 of P); two-stage cp.async "
                "ring, ldmatrix and 16-byte fragment loads, fp64 cumulative log-decay, P and N padded to 8",
}


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in one
    CUDA graph, replayed ``replays`` times between two events. The host's
    per-call cost (Python checks, allocation, ctypes) is out of the reading."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


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


def serve_fleet(cfg, run, params, reqs, card: str) -> dict:
    """Serve qwen3-1.7b replicas of unequal capacity behind one
    ``FleetLoop``, on phase 6's weights and requests (its token streams are
    the batch-8 reference): (a) a fixed pool of 2 x batch 8 and 1 x batch 2;
    (b) an elastic typed pool grown from one batch-2 replica; (c) the
    ``repro_torch.launch.fleet`` entry point. Raises on any failed check and
    returns what it measured."""
    from repro_torch.core.autoscale import BacklogThresholdScaler
    from repro_torch.kernels import ops
    from repro_torch.launch import fleet
    from repro_torch.launch.serve import Request, ServeLoop

    t_phase = time.perf_counter()
    L = cfg.num_layers
    batch8 = {r.rid: r.tokens for r in reqs}
    prompt = {r.rid: r.prompt for r in reqs}
    lone2 = {}  # rid -> tokens of a lone batch-2 serve
    ticks = []  # (arena batch, host seconds) of each replica tick

    class TimedLoop(ServeLoop):
        """A replica timed from outside: each tick's host time, its warm-up
        (when it began and how long it took) and the clock origin of its
        session, which a fleet shares with it."""

        def tick(self):
            t = time.perf_counter()
            status = super().tick()
            ticks.append((self.batch, time.perf_counter() - t))
            return status

        def warm(self, prompt_len):
            self.warm_at = time.perf_counter()
            super().warm(prompt_len)
            torch.cuda.synchronize()
            self.warm_s = time.perf_counter() - self.warm_at

        def start(self, requests, prompt_len=None, t0=None):
            self.t0 = t0
            super().start(requests, prompt_len=prompt_len, t0=t0)

    def replica(batch):
        return TimedLoop(cfg, run, params, batch=batch, max_len=2048, admission=None, mode="arena",
                         device="cuda")

    def lone_batch2(rids):
        todo = [Request(rid, prompt[rid], 32) for rid in rids if rid not in lone2]
        if todo:
            check(replica(2).run_requests(todo)["completed"] == len(todo), "the lone batch-2 serve completes")
            lone2.update((r.rid, r.tokens) for r in todo)
        return {rid: lone2[rid] for rid in rids}

    def drive(loop, name):
        """One fleet run over fresh copies of the requests, the launch counts
        at 0 just before it: completion, the launch identity, and every
        stream against a lone serve of the same arena batch."""
        freqs = [Request(r.rid, r.prompt, 32) for r in reqs]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        ticks.clear()
        stats = loop.run_requests(freqs)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        # the replicas tick in turn on this thread: the host time of their
        # ticks per arena batch, and the share of the run spent in them
        tick_s = {b: sorted(d for bb, d in ticks if bb == b) for b in sorted({b for b, _ in ticks})}
        in_ticks = sum(d for _, d in ticks) / stats["wall_s"]
        per = [rep.stats() for rep in loop.replicas]
        # every replica was warmed once (at the run's start or at its spawn):
        # one prefill and one arena decode that stats() does not count
        warm = len(loop.replicas)
        calls = {k: sum(p[k] for p in per) for k in ("decode_calls", "prefill_calls")}
        check(stats["completed"] == 16 and all(len(r.tokens) == 32 for r in freqs),
              f"fleet {name}: {stats['completed']}/16 requests with 32 tokens")
        check(sum(stats["completed_per_replica"]) == 16, f"fleet {name}: {stats['completed_per_replica']}")
        check(launches["decode_attention"] == L * (calls["decode_calls"] + warm),
              f"fleet {name}: K1 launches {launches['decode_attention']} != {L} x ({calls['decode_calls']} "
              f"decode calls + {warm} warm-ups)")
        check(launches["flash_attention"] == L * (calls["prefill_calls"] + warm),
              f"fleet {name}: K2 launches {launches['flash_attention']} != {L} x ({calls['prefill_calls']} "
              f"prefills + {warm} warm-ups)")
        # which replica completed each request, from the replicas' own books
        done_on = {}
        for j, rep in enumerate(loop.replicas):
            for r in rep._requests:
                if r.finished >= 0:
                    check(r.rid not in done_on, f"fleet {name}: request {r.rid} completed twice")
                    done_on[r.rid] = j
        check(sorted(done_on) == sorted(batch8), f"fleet {name}: completions {sorted(done_on)}")
        tokens = {r.rid: r.tokens for r in freqs}
        on2 = sorted(rid for rid, j in done_on.items() if loop.replicas[j].batch == 2)
        ref2 = lone_batch2(on2)
        bad = [rid for rid in done_on if tokens[rid] != (ref2[rid] if rid in ref2 else batch8[rid])]
        check(not bad, f"fleet {name}: streams of requests {bad} differ from a lone serve of the same batch")
        out = {**stats, "launches": launches, "peak_bytes": peak, "warm_ups": warm, **calls,
               "completed_on_batch2": on2, "ticks_share_of_wall": in_ticks,
               "ticks": {b: {"n": len(v), "median_ms": v[len(v) // 2] * 1e3, "total_s": sum(v)}
                         for b, v in tick_s.items()},
               "batch2_streams_unlike_batch8": sum(ref2[rid] != batch8[rid] for rid in on2)}
        print(f"fleet {name} on {card}: {stats['tokens_per_s']:.1f} tok/s, mean latency "
              f"{stats['mean_latency_s']:.3f} s, routed {stats['routed_per_replica']}, completed "
              f"{stats['completed_per_replica']}, tok_rate_per_replica "
              f"[{', '.join(f'{x:.1f}' for x in stats['tok_rate_per_replica'])}], redispatched "
              f"{stats['redispatched']}, rebalanced {stats['rebalanced']}, spawned {stats['spawned']}, drained "
              f"{stats['drained']}, {calls['prefill_calls']} prefills, {calls['decode_calls']} decode calls, "
              f"wall {stats['wall_s']:.2f} s, peak memory {peak / 2**30:.2f} GiB; launches {launches}")
        print(f"fleet {name}: replica ticks (host) "
              + ", ".join(f"batch {b}: {len(v)}, median {v[len(v) // 2] * 1e3:.2f} ms, total {sum(v):.2f} s"
                          for b, v in tick_s.items())
              + f"; {in_ticks:.1%} of the wall in replica ticks ({card})")
        print(f"fleet {name}: every stream bit-identical to a lone serve of the same arena batch; "
              f"{len(on2)} completed at batch 2, of which {out['batch2_streams_unlike_batch8']} differ from "
              f"the same request's batch-8 stream")
        return out

    # (a) a fixed heterogeneous pool: the batch-2 replica decodes a quarter
    # of the tokens a step that a batch-8 one does
    record = {"fixed": drive(fleet.FleetLoop(
        [replica(8), replica(8), replica(2)], router="capacity_weighted", admission="admit_all",
        redispatch=True, hedge=False, replica_types=("fast", "fast", "slow")),
        "(a) 2 x batch 8 (fast) + 1 x batch 2 (slow), capacity_weighted")}
    check(all(n > 0 for n in record["fixed"]["routed_per_replica"]),
          f"every replica routed: {record['fixed']['routed_per_replica']}")

    # (b) an elastic typed pool from one batch-2 replica; its spawns are
    # timed from outside: the factory call and the warm-up, the cold-start lag
    factory_s = []

    def fast():
        t = time.perf_counter()
        rep = replica(8)
        factory_s.append(time.perf_counter() - t)
        return rep

    elastic = fleet.FleetLoop(
        [replica(2)], router="capacity_weighted", admission="admit_all", redispatch=True, hedge=False,
        replica_types=("slow",), replica_factory={"fast": fast},
        autoscale=BacklogThresholdScaler(grow_backlog_s=1.0, sustain_s=0.5, cooldown_s=5.0, max_replicas=2))
    record["elastic"] = drive(elastic, "(b) elastic, from 1 x batch 2 (slow), backlog_threshold spawning fast "
                                       "batch 8")
    check(record["elastic"]["spawned"] >= 1 and record["elastic"]["completed_per_replica"][1] >= 1,
          f"fleet (b): a spawned replica served: {record['elastic']['completed_per_replica']}")
    spawned = elastic.replicas[1:]
    warm_s = [rep.warm_s for rep in spawned]
    spawn_at = [rep.warm_at - rep.t0 for rep in spawned]
    record["elastic"].update(factory_s=factory_s, warm_s=warm_s, spawn_at_s=spawn_at)
    print(f"fleet (b) spawns on {card}: at {', '.join(f'{x:.3f}' for x in spawn_at)} s into the run; factory "
          f"call {', '.join(f'{x * 1e3:.2f}' for x in factory_s)} ms, warm-up prefill and decode "
          f"{', '.join(f'{x:.3f}' for x in warm_s)} s")
    del elastic

    # (c) the entry point, on weights of its own
    ops.reset_launches()
    stats = fleet.main(["--arch", "qwen3-1.7b", "--replicas", "2", "--batch", "8", "--requests", "8",
                        "--prompt-len", "256", "--gen", "32", "--device", "cuda"])
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    check(stats["completed"] == 8, f"fleet main: {stats['completed']}/8")
    check(launches["decode_attention"] > 0 and launches["flash_attention"] > 0, f"fleet main launches {launches}")
    record["main"] = {**stats, "launches": launches}
    record["phase_s"] = time.perf_counter() - t_phase
    print(f"fleet main (2 x batch 8, 8 requests, prompt 256, gen 32) on {card}: {stats['tokens_per_s']:.1f} tok/s, "
          f"completed {stats['completed_per_replica']}, wall {stats['wall_s']:.2f} s; launches {launches}; "
          f"the fleet phase took {record['phase_s']:.1f} s")
    return record


def host_cpu() -> str:
    """The host CPU: its model name, or where a sandboxed kernel reports it
    as unknown, its vendor, family and model numbers and clock; and the
    number of CPUs this process sees."""
    info = {}
    with contextlib.suppress(OSError):
        for line in Path("/proc/cpuinfo").read_text().split("\n\n")[0].splitlines():
            key, _, value = line.partition(":")
            info[key.strip()] = value.strip()
    name = info.get("model name", "unknown")
    if name == "unknown" and "model" in info:
        name = (f"{info.get('vendor_id', '')} family {info.get('cpu family', '?')} model {info['model']}, "
                f"{info.get('cpu MHz', '?')} MHz").strip()
    if name == "unknown":
        name = platform.machine()
    return f"{name}, {os.cpu_count()} CPUs"


def simulate(card: str) -> dict:
    """The port's heterogeneous-cluster simulator on the host: the 37 stored
    golden cases (``tests/torch_sim_golden.py``), the ``check_views=True``
    cases, and the 10^5-request slice of ``fleet_million``. No device work."""
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_sim_golden as G

    from repro_torch.core import workload as W

    t_phase = time.perf_counter()
    missed = [c for c in sorted(G.FLEET_CASES) if G.fleet_fingerprint(G.run_fleet_case(W, c)) != G.FLEET_GOLDEN[c]]
    missed += [c for c in sorted(G.WORKLOAD_CASES)
               if G.workload_fingerprint(G.run_workload_case(W, c)) != G.WORKLOAD_GOLDEN[c]]
    n_golden = len(G.FLEET_GOLDEN) + len(G.WORKLOAD_GOLDEN)
    check(n_golden == 37 and not missed, f"simulator golden hashes missed: {missed}")
    for case in G.CHECK_VIEWS_CASES:  # each view build asserts its accumulators == a brute-force re-sum
        res = G.run_check_views_case(W, case)
        check(res.completed + res.n_rejected == len(res.requests) and res.stranded == 0,
              f"check_views {case}: every request completed or rejected")
        if case == "oldest_dispatch/straggler":
            check(res.n_redispatched > 0 or res.n_hedged > 0, "the straggler case re-dispatches or hedges")
    golden_s = time.perf_counter() - t_phase
    spec = W.FLEET_PRESETS["fleet_million"]
    small = W.FleetSpec(**{**{f: getattr(spec, f) for f in spec.__dataclass_fields__}, "n_requests": SIM_SLICE})
    gc.collect()
    gc.disable()  # as bench_simperf.py: the run allocates no cycles, and gen-2 scans would dominate
    try:
        t0 = time.perf_counter()
        res = W.run_fleet(small, seed=0, collect_trace=False, collect_requests=False)
        wall = time.perf_counter() - t0
    finally:
        gc.enable()
        gc.collect()
    p99 = {c: res.latency_quantile(0.99, slo_class=c) for c in sorted(res.sojourns_by_class)}
    check(res.completed + res.n_rejected == SIM_SLICE and res.stranded == 0,
          f"slice: {res.completed} completed + {res.n_rejected} rejected of {SIM_SLICE}, {res.stranded} stranded")
    check(res.n_events == SIM_EVENTS, f"slice events {res.n_events} != {SIM_EVENTS}")
    check(set(p99) == set(SIM_P99) and all(abs(p99[c] - SIM_P99[c]) <= 0.05 for c in SIM_P99),
          f"slice per-class p99 {p99} != {SIM_P99} to 0.1 s")
    cpu = host_cpu()
    out = {"golden": n_golden, "check_views": len(G.CHECK_VIEWS_CASES), "golden_s": golden_s,
           "slice": {"requests": SIM_SLICE, "events": res.n_events, "wall_s": wall,
                     "events_per_s": res.n_events / wall, "class_p99_s": p99,
                     "completed": res.completed, "rejected": res.n_rejected},
           "host_cpu": cpu, "phase_s": time.perf_counter() - t_phase}
    print(f"simulator: {n_golden} golden hashes and {len(G.CHECK_VIEWS_CASES)} check_views cases held in "
          f"{golden_s:.2f} s; fleet_million slice of {SIM_SLICE} requests, 120 replicas: {res.n_events} events in "
          f"{wall:.2f} s = {res.n_events / wall:.0f} events/s on the host ({cpu}; card {card}), per-class p99 "
          + ", ".join(f"{c}: {v:.1f} s" for c, v in p99.items())
          + f"; {res.completed} completed, {res.n_rejected} rejected, none stranded; the phase took "
          f"{out['phase_s']:.1f} s")
    return out


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
    from repro_torch.kernels.decode_attention import SPLIT_KEYS, decode_attention_cuda, decode_attention_plain
    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain
    from repro_torch.kernels.ssm_scan import fold, ssm_scan_cuda, ssm_scan_plain, unfold
    from repro_torch.launch.serve import Request, ServeLoop
    from repro_torch.models import model as M
    from repro_torch.models import ssm

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
    k1_invariant = []

    def held(got, exp, idx, normalize, tol, what):
        """The largest error of a normalised K1 call over rows idx, or, for
        partials, a check of each against its scale (acc and l grow with the
        number of valid keys; the all-invalid row's m = -1e30 is checked
        apart)."""
        if normalize:
            return err(got[0], exp[0])
        keep = [i for i, r in enumerate(idx) if r in rows]
        for a, b in zip(got, exp):
            rel = err(a[keep], b[keep]) / max(1.0, float(b[keep].abs().max()))
            check(rel < tol, f"K1 partials vs plain {what}: {rel} >= {tol}")
        return 0.0

    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
        worst = 0.0
        # the path's cache length and one past it, the entry point's cache
        # (prompt 256 + 32 new tokens + 1), then the split boundaries
        for S in (2048, 2050, 289, 100, SPLIT_KEYS - 1, SPLIT_KEYS, SPLIT_KEYS + 1):
            q = rnd(B, H, D, dtype=dtype)
            k, v = rnd(B, S, KH, D, dtype=dtype), rnd(B, S, KH, D, dtype=dtype)
            valid = (torch.rand(B, S, generator=gen, device=dev) > 0.3).to(torch.int32)
            valid[1] = 1  # ring full at capacity
            valid[2] = 0  # all-invalid row
            valid[3] = 0
            valid[3, (S - 1) // 32 * 32:] = 1  # valid only in the last 32 keys
            valid[5] = 0
            valid[5, (S - 1) // SPLIT_KEYS * SPLIT_KEYS:] = 1  # valid only in the last split
            for normalize in (True, False):
                got = decode_attention_cuda(q, k, v, valid, scale=D**-0.5, normalize=normalize)
                exp = decode_attention_plain(q, k, v, valid, scale=D**-0.5, normalize=normalize)
                torch.cuda.synchronize()
                check(float(got[0][2].abs().max()) == 0.0 and float(got[2][2].max()) == 0.0
                      and torch.equal(got[1][2], exp[1][2]),
                      f"K1 all-invalid row is exactly zero, m = -1e30 ({dtype}, S={S})")
                worst = max(worst, held(got, exp, range(B), normalize, tol, f"{dtype}, S={S}, B=8"))
                # each row alone gives the same bits as in the batch
                alone = [decode_attention_cuda(q[i:i + 1], k[i:i + 1], v[i:i + 1], valid[i:i + 1],
                                               scale=D**-0.5, normalize=normalize)
                         for i in range(B)] if S in (2048, 2050, 289) else None
                if alone:
                    check(all(torch.equal(a[i:i + 1], b) for i in range(B) for a, b in zip(got, alone[i])),
                          f"K1 batch-8 rows bit-identical to batch-1 calls ({dtype}, S={S}, "
                          f"normalize={normalize})")
                    k1_invariant.append(f"B=8, {dtype}, S={S}, normalize={normalize}")
                # the slow replica's arena batch: the same rows in calls of 2
                for i in range(0, B, 2):
                    sl = slice(i, i + 2)
                    pair = (q[sl].clone(), k[sl].clone(), v[sl].clone(), valid[sl].clone())
                    got2 = decode_attention_cuda(*pair, scale=D**-0.5, normalize=normalize)
                    exp2 = decode_attention_plain(*pair, scale=D**-0.5, normalize=normalize)
                    torch.cuda.synchronize()
                    worst = max(worst, held(got2, exp2, range(i, i + 2), normalize, tol, f"{dtype}, S={S}, B=2"))
                    if alone:
                        check(all(torch.equal(a[j:j + 1], b)
                                  for j in range(2) for a, b in zip(got2, alone[i + j])),
                              f"K1 batch-2 rows {i}, {i + 1} bit-identical to batch-1 calls ({dtype}, S={S}, "
                              f"normalize={normalize})")
                if alone:
                    k1_invariant.append(f"B=2, {dtype}, S={S}, normalize={normalize}")
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
    print(f"K1 batch invariance: every row of a batch-8 or batch-2 call bit-identical to the row alone "
          f"({k1_invariant})")
    record["k1_batch_invariant"] = k1_invariant

    # -- 4. K2 vs plain ---------------------------------------------------
    k2_err = {}
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
        worst = 0.0
        # causal prefill; Sq not a multiple of the 64-row q tile; then a
        # window with a query offset: rows late in a 64-row q tile find the
        # tile's first visited 64-key tile fully masked
        for Sq, Sk, win, off in ((1024, 1024, 0, 0), (1000, 1000, 0, 0), (200, 1224, 100, 1024),
                                 (256, 1280, 100, 1024)):
            q = rnd(1, Sq, H, D, dtype=dtype)
            k, v = rnd(1, Sk, KH, D, dtype=dtype), rnd(1, Sk, KH, D, dtype=dtype)
            got = flash_attention_cuda(q, k, v, q_offset=off, window=win, scale=D**-0.5)
            exp = flash_attention_plain(q, k, v, q_offset=off, window=win, scale=D**-0.5)
            torch.cuda.synchronize()
            worst = max(worst, err(got, exp))
        check(worst < tol, f"K2 vs plain {dtype}: {worst} >= {tol}")
        k2_err[str(dtype)] = worst
        print(f"K2 vs plain {dtype}: max abs err {worst:.3e} (tol {tol})")

    # -- 5. K3 vs plain ---------------------------------------------------
    def k3_inputs(B, S, H, P, N, dtype, loga="gate", b_dtype=torch.float32, gate_sd=1.0):
        """mLSTM-like data: x with a ones column last (the normaliser), b =
        k * exp(input gate), the gate's log ~ N(0, gate_sd^2) clamped at
        +-10 as the model clamps it (1 is what the model's random weights
        give; 3 reaches e^10), loga = log sigmoid of an open forget gate
        (or 0, or ~ -5)."""
        x = rnd(B, S, H, P, dtype=dtype)
        x[..., -1] = 1
        c = rnd(B, S, H, N, dtype=dtype)
        gate = torch.exp((gate_sd * torch.randn(B, S, H, 1, generator=gen, device=dev)).clamp(-10, 10))
        b = (torch.randn(B, S, H, N, generator=gen, device=dev) / N**0.5 * gate).to(b_dtype)
        noise = torch.randn(B, S, H, generator=gen, device=dev)
        la = {"gate": F.logsigmoid(3 + noise), "zero": torch.zeros_like(noise), "neg5": -5 + 0.1 * noise}[loga]
        return x, la, b, c

    def scaled_err(a, b):
        """Largest |a - b| / (|b| + the largest |b| of its row), a row being
        the last axis: one time step's P values of y, one state row of h,
        one token's features. Each element is held to its own scale, so a
        few huge gates cannot hide the error of the elements around them;
        where the scale is 0 the two must be equal."""
        a, b = a.float(), b.float()
        scale = b.abs() + b.abs().amax(dim=-1, keepdim=True)
        return float(((a - b).abs() / scale.clamp_min(1e-30)).max())

    def terms_err(a, b, terms):
        """Largest |a - b| over the magnitude of the terms each element of b
        sums (fp64)."""
        return float(((a.double() - b.double()).abs() / terms.clamp_min(1e-300)).max())

    def k3_exact(x, loga, b, c, chunk):
        """K3's reference: the plain version on the same inputs widened to
        fp64, so that it sums in fp64 (summed in fp32 it is itself up to
        5e-5 of an element's scale from the exact result at input gates
        near e^10, scripts/k3_precision.py); y rounded to x's dtype, as the
        kernel rounds it, and h in fp32."""
        y, h = ssm_scan_plain(*(t.double() for t in (x, loga, b, c)), chunk)
        return y.to(x.dtype), h.float()

    K3_PATH = (1, 1024, 4, 513, 512)  # one 1024-token prompt: B, S, H, P = head_dim + 1, N = head_dim
    k3_cases = [  # (name, (B, S, H, P, N), loga, b dtype or None for fp32, sd of the log input gate)
        ("path", K3_PATH, "gate", None, 1.0),
        ("path, input gates up to e^10", K3_PATH, "gate", None, 3.0),
        ("pads: S = 384", (1, 384, 4, 513, 512), "gate", None, 1.0),
        ("below one chunk: S = 100", (2, 100, 3, 17, 40), "gate", None, 1.0),
        ("below one chunk, b in bf16", (2, 100, 3, 17, 40), "gate", torch.bfloat16, 1.0),
        ("P = N = 64", (2, 512, 4, 64, 64), "gate", None, 1.0),
        ("loga = 0", (1, 512, 4, 65, 64), "zero", None, 1.0),
        ("loga ~ -5", (1, 512, 4, 65, 64), "neg5", None, 1.0),
    ]
    k3_err, k3_scaled, k3_fail = {}, {}, []
    for dtype in (torch.bfloat16, torch.float32):
        worst_abs = worst_scaled = 0.0
        for name, shape, loga, b_dtype, gate_sd in k3_cases:
            inputs = k3_inputs(*shape, dtype=dtype, loga=loga, b_dtype=b_dtype or torch.float32, gate_sd=gate_sd)
            f = fold(*inputs, 256)
            y, h = ssm_scan_cuda(*f, 256)
            ye, he = k3_exact(*f, 256)
            torch.cuda.synchronize()
            sy, sh = scaled_err(y, ye), scaled_err(h, he)
            ty, th = K3_TOL[dtype], K3_TOL[torch.float32]
            held_y = f"scaled err y {sy:.3e} (tol {ty:.3e})"
            if loga == "neg5":  # y against the terms it sums (K3_TERMS_TOL)
                terms, _ = ssm_scan_plain(f[0].double().abs(), f[1].double(), f[2].double().abs(),
                                          f[3].double().abs(), 256)
                sy_terms, ty = terms_err(y, ye, terms), K3_TERMS_TOL[dtype]
                held_y = f"y over the terms {sy_terms:.3e} (tol {ty:.3e}), scaled err y {sy:.3e}"
                sy_held = sy_terms
            else:
                sy_held = sy
            print(f"K3 vs plain {dtype}, {name}: {held_y}, "
                  f"h {sh:.3e} (tol {th:.3e}); max abs err y {err(y, ye):.3e}, h {err(h, he):.3e}")
            if not (sy_held <= ty and sh <= th):
                k3_fail.append(f"{dtype}, {name}")
            worst_abs, worst_scaled = max(worst_abs, err(y, ye), err(h, he)), max(worst_scaled, sy, sh)
        # the chunk length does not change the final state
        f = fold(*k3_inputs(1, 512, 4, 513, 512, dtype=dtype), 256)
        _, h64 = ssm_scan_cuda(*f, 64)
        _, h256 = ssm_scan_cuda(*f, 256)
        torch.cuda.synchronize()
        sc, tc = scaled_err(h64, h256), K3_TOL[torch.float32]
        print(f"K3 final state, chunk 64 vs 256 ({dtype}): scaled err {sc:.3e} (tol {tc:.3e})")
        if not sc <= tc:
            k3_fail.append(f"{dtype}, chunk 64 vs 256")
        k3_err[str(dtype)], k3_scaled[str(dtype)] = worst_abs, max(worst_scaled, sc)
    check(not k3_fail, f"K3 vs plain: {k3_fail}")
    # K3 at the prefill shape: two calls give the same bits, each row of the
    # call equals that row called alone, and a call replayed from a CUDA
    # graph equals the eager call (no atomics; nothing is allocated or set
    # inside the launch)
    k3_bits = {}
    for dtype in (torch.bfloat16, torch.float32):
        f = fold(*k3_inputs(*K3_PATH, dtype=dtype), 256)
        y1, h1 = ssm_scan_cuda(*f, 256)
        y2, h2 = ssm_scan_cuda(*f, 256)
        alone = [ssm_scan_cuda(*(t[i:i + 1].clone() for t in f), 256) for i in range(f[0].shape[0])]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            ssm_scan_cuda(*f, 256)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            yg, hg = ssm_scan_cuda(*f, 256)
        graph.replay()
        torch.cuda.synchronize()
        k3_bits[str(dtype)] = {
            "two_calls": torch.equal(y1, y2) and torch.equal(h1, h2),
            "rows_alone": all(torch.equal(y1[i:i + 1], y) and torch.equal(h1[i:i + 1], h) for i, (y, h) in enumerate(alone)),
            "graph_replay": torch.equal(yg, y1) and torch.equal(hg, h1),
        }
        del graph
    print(f"K3 at the prefill shape {tuple(f[0].shape)}, bit for bit: {k3_bits}")
    check(all(all(v.values()) for v in k3_bits.values()), f"K3 bits: {k3_bits}")
    record["k3_bits"] = k3_bits

    # -- 6. serve qwen3-1.7b at full width ---------------------------------
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

    # -- 7. the heterogeneous fleet on qwen3-1.7b ---------------------------
    record["fleet"] = serve_fleet(cfg, kernel_run, params, reqs, card)

    # -- 8. logits: kernel path vs plain path -------------------------------
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

    # -- 9. serve xlstm-1.3b at full width ---------------------------------
    xcfg = get_config("xlstm-1.3b")
    t0 = time.perf_counter()
    xparams = M.init_model(xcfg, torch.Generator(device=dev).manual_seed(0), dtype=torch.bfloat16)
    torch.cuda.synchronize()
    print(f"init xlstm-1.3b ({M.count_params_exact(xcfg)} params, bf16): {time.perf_counter() - t0:.1f} s")
    XL = sum(xcfg.layer_kind(i) == "mlstm" for i in range(xcfg.num_layers))  # 42 mLSTM layers
    XS = xcfg.num_layers - XL  # 6 sLSTM layers
    xlens = [256, 384, 512, 640, 768, 1024] * 2
    xcorpus = SyntheticCorpus(xcfg.vocab_size, max(xlens), seed=0)
    xreqs = [Request(i, xcorpus.grain_tokens(i, 1)[0][:n], 32) for i, n in enumerate(xlens)]
    xloop = ServeLoop(xcfg, kernel_run, xparams, batch=8, max_len=2048, mode="arena", device="cuda")
    xloop.warm(256)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    xloop.start(xreqs, t0=time.perf_counter())
    while xloop.tick() != "done":
        pass
    torch.cuda.synchronize()
    xlaunches = dict(ops.LAUNCHES)
    xstats = xloop.stats()
    xpeak = torch.cuda.max_memory_allocated()
    check(xstats["completed"] == len(xlens), f"served {xstats['completed']}/{len(xlens)}")
    check(xstats["decode_calls"] < xstats["decode_steps"], "arena batches decode steps")
    check(xstats["prefill_calls"] == len(xlens) and xlaunches["ssm_scan"] == XL * xstats["prefill_calls"],
          f"K3 launches {xlaunches['ssm_scan']} != {XL} x {xstats['prefill_calls']} prefills")
    check(xlaunches["flash_attention"] == xlaunches["decode_attention"] == 0, "xlstm has no attention")
    check(all(len(r.tokens) == 32 for r in xreqs), "every request got 32 tokens")
    record["serve_xlstm"] = {**xstats, "launches": xlaunches, "peak_bytes": xpeak}
    print(f"serve xlstm-1.3b arena batch=8, {len(xlens)} requests (prompts 256-1024, gen 32) on {card}: "
          f"{xstats['tokens_per_s']:.1f} tok/s, mean TTFT {xstats['mean_ttft_s'] * 1e3:.1f} ms, "
          f"{xstats['decode_calls']} decode calls, occupancy {xstats['slot_occupancy']:.3f}, "
          f"wall {xstats['wall_s']:.2f} s, peak memory {xpeak / 2**30:.2f} GiB; launches {xlaunches}")

    # -- 10. xlstm: the first mLSTM block; logits; a parked row -------------
    def plain_scan(x, loga, b, c, chunk=256):
        y, h = k3_exact(*fold(x, loga, b, c, chunk), chunk)
        return unfold(y, h, x.shape[0], x.shape[1], x.shape[-1], b.shape[-1])

    xprompt = torch.as_tensor(np.stack([xcorpus.grain_tokens(100 + i, 1)[0][:300] for i in range(2)]),
                              dtype=torch.long, device=dev)
    # The first mLSTM block of the bf16 serve model on the embeddings of two
    # 300-token prompts (the scan pads them to 512): K3 on the scan inputs
    # the block builds, then the block's output and prefill state, kernel
    # path vs plain path. Both paths see the same inputs, so K3's limits hold.
    scan_args = []
    kernel_scan = ops.ssm_scan

    def capture(*args):
        scan_args.append(args)
        return kernel_scan(*args)

    h0 = F.embedding(xprompt, xparams["embed"])
    first = {}
    for name, scan in (("kernel", capture), ("plain", plain_scan)):
        with mock.patch.object(ops, "ssm_scan", scan):
            first[name] = ssm.mlstm_apply_full(xcfg, xparams["layers"][0]["mlstm"], h0, chunk=256,
                                               return_state=True)
    f0 = fold(*scan_args[0])
    y0, s0 = ssm_scan_cuda(*f0, scan_args[0][4])
    ye0, se0 = k3_exact(*f0, scan_args[0][4])
    torch.cuda.synchronize()
    block0 = {"scan_y": scaled_err(y0, ye0), "scan_h": scaled_err(s0, se0),
              "block_out": scaled_err(first["kernel"][0], first["plain"][0]),
              "block_state": scaled_err(first["kernel"][1], first["plain"][1]),
              "tol_bf16": K3_TOL[torch.bfloat16], "tol_fp32": K3_TOL[torch.float32]}
    print(f"xlstm first mLSTM block, bf16, kernel vs plain: scan inputs x {tuple(f0[0].shape)} {f0[0].dtype}, "
          f"b {f0[2].dtype}, c {f0[3].dtype}; scaled err scan y {block0['scan_y']:.3e}, block output "
          f"{block0['block_out']:.3e} (tol {block0['tol_bf16']:.3e}); scan state {block0['scan_h']:.3e}, "
          f"block state {block0['block_state']:.3e} (tol {block0['tol_fp32']:.3e})")
    check(max(block0["scan_y"], block0["block_out"]) <= block0["tol_bf16"]
          and max(block0["scan_h"], block0["block_state"]) <= block0["tol_fp32"],
          f"xlstm first mLSTM block, kernel vs plain: {block0}")

    def logits_run(mcfg, mparams):
        """Prefill the two prompts, then 4 decode steps feeding both paths
        the kernel path's greedy tokens. Returns the largest |kernel -
        plain| logit, the largest |plain| logit, whether all are finite and
        of shape (2, 1, vocab), the caches and the last tokens."""
        logits, caches = {}, {}
        for name in ("kernel", "plain"):
            with mock.patch.object(ops, "ssm_scan", plain_scan) if name == "plain" else contextlib.nullcontext():
                logits[name], caches[name] = M.prefill(mcfg, kernel_run, mparams, xprompt, 512)
        worst, top, sound = 0.0, 0.0, True
        for step in range(5):
            a, b = logits["kernel"].float(), logits["plain"].float()
            worst, top = max(worst, float((a - b).abs().max())), max(top, float(b.abs().max()))
            sound &= all(t.shape == (2, 1, mcfg.vocab_size) and bool(torch.isfinite(t).all()) for t in (a, b))
            if step == 4:
                break
            tok = torch.argmax(a[:, -1], dim=-1, keepdim=True)
            for name in ("kernel", "plain"):
                logits[name], _ = M.decode_step(mcfg, kernel_run, mparams, caches[name], tok)
        torch.cuda.synchronize()
        return worst, top, sound, caches, tok

    # logits, checked in fp32 on the first XLOGIT_LAYERS layers; over all 48
    # layers, in fp32 and in bf16, only finite and of the right shape (the
    # differences are reported)
    x32 = dataclasses.replace(xcfg, compute_dtype="float32")
    x32params = M.init_model(x32, torch.Generator(device=dev).manual_seed(0), dtype=torch.float32)
    xcut = dataclasses.replace(x32, num_layers=XLOGIT_LAYERS)
    worst, top, sound, _, _ = logits_run(xcut, {**x32params, "layers": x32params["layers"][:XLOGIT_LAYERS]})
    full32 = logits_run(x32, x32params)
    full16 = logits_run(xcfg, xparams)
    print(f"xlstm logits kernel vs plain (prefill 2x300 + 4 decode steps): fp32, first {XLOGIT_LAYERS} layers: "
          f"max abs diff {worst:.4e}, largest |logit| {top:.3f}, tol {XLOGIT_TOL * max(1.0, top):.4e}; "
          f"all 48 layers (not checked): fp32 {full32[0]:.4f} at {full32[1]:.3f}, "
          f"bf16 {full16[0]:.4f} at {full16[1]:.3f}")
    check(sound and full32[2] and full16[2], "xlstm logits finite and of shape (2, 1, vocab)")
    check(worst <= XLOGIT_TOL * max(1.0, top),
          f"xlstm logits kernel vs plain (fp32, {XLOGIT_LAYERS} layers): {worst} > {XLOGIT_TOL} x {top}")
    cache, tok = full32[3]["kernel"], full32[4]
    before = [cache["pos"][1].clone(), cache["mlstm"][:, 1].clone()] + [t[:, 1].clone() for t in cache["slstm"].values()]
    row0 = cache["mlstm"][:, 0].clone()
    M.decode_step(x32, kernel_run, x32params, cache, tok, active=torch.tensor([True, False], device=dev))
    after = [cache["pos"][1], cache["mlstm"][:, 1]] + [t[:, 1] for t in cache["slstm"].values()]
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(after, before)), "a parked row's xlstm state is untouched")
    check(not torch.equal(cache["mlstm"][:, 0], row0), "the active row advanced")
    record["first_mlstm_block"] = block0
    record["logits_xlstm"] = {
        f"fp32_{XLOGIT_LAYERS}_layers": {"max_abs_diff": worst, "max_abs_logit": top,
                                         "tol": XLOGIT_TOL * max(1.0, top)},
        "fp32_48_layers": {"max_abs_diff": full32[0], "max_abs_logit": full32[1]},
        "bf16_48_layers": {"max_abs_diff": full16[0], "max_abs_logit": full16[1]},
        "parked_row_bit_identical": True,
    }
    print("xlstm parked row: mLSTM and sLSTM state and position bit-identical")
    del x32params, full32, cache

    # -- 11. times and bounds at the main path's shapes (bf16) --------------
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
    # K3 at one 1024-token mLSTM prefill: x = v with the ones column (bf16),
    # loga fp32, b = k * igate (fp32), c = q (bf16); chunk 256
    f3 = fold(*k3_inputs(*K3_PATH, dtype=torch.bfloat16), 256)
    # the function's bytes and operations at its own widths (P = 513: the
    # kernel's padding to 520 is its own choice)
    B3, S3, H3, P3, N3 = K3_PATH
    BH, L3 = B3 * H3, 256
    k3_bytes = BH * (S3 * P3 * 2 + S3 * 4 + S3 * N3 * 4 + S3 * N3 * 2 + S3 * P3 * 2 + N3 * P3 * 4)
    # what the data needs per row and chunk: C B^T and W X on the causal
    # half, C h and the state update in full
    tri = L3 * (L3 + 1) // 2
    k3_flops = BH * (S3 // L3) * (2 * tri * N3 + 2 * tri * P3 + 4 * L3 * N3 * P3)
    kernels = []
    for name, fn, plain, lib, nbytes, flops, src, tpu, launches_n, per_step, errs in (
        ("flash_decode", lambda: decode_attention_cuda(q1, k1, v1, valid1, scale=D**-0.5),
         lambda: decode_attention_plain(q1, k1, v1, valid1, scale=D**-0.5),
         lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask1, enable_gqa=True),
         k1_bytes, k1_flops, "src/repro_torch/csrc/decode_attention.cu",
         ("src/repro/kernels/decode_attention.py:31", "src/repro/kernels/decode_attention.py:_decode_kernel"),
         launches["decode_attention"], f"{L} per decode step (qwen3-1.7b serve)", k1_err),
        ("flash_attention_fwd", lambda: flash_attention_cuda(q2, k2, v2, scale=D**-0.5),
         lambda: flash_attention_plain(q2, k2, v2, scale=D**-0.5),
         lambda: F.scaled_dot_product_attention(q2s, k2s, v2s, is_causal=True, enable_gqa=True),
         k2_bytes, k2_flops, "src/repro_torch/csrc/flash_attention.cu",
         ("src/repro/kernels/flash_attention.py:28", "src/repro/kernels/flash_attention.py:_flash_kernel"),
         launches["flash_attention"], f"{L} per prefill (qwen3-1.7b serve)", k2_err),
        # no single PyTorch call computes a chunked scan with its final state;
        # the plain version is timed on the path's own inputs (fp32 sums)
        ("ssd_scan", lambda: ssm_scan_cuda(*f3, 256), lambda: ssm_scan_plain(*f3, 256), None,
         k3_bytes, k3_flops, "src/repro_torch/csrc/ssm_scan.cu",
         ("src/repro/kernels/ssm_scan.py:30", "src/repro/kernels/ssm_scan.py:_ssd_kernel"),
         xlaunches["ssm_scan"], f"{XL} per prefill (xlstm-1.3b serve)", k3_err),
    ):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
        # each kernel takes tens of microseconds, about its wrapper's host time,
        # so a graph replay reads its device time; the eager call beside it
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu[0], "tpu_kernel": tpu[1],
            "launches": launches_n, "launches_per_step": per_step,
            "max_abs_err": max(errs.values()), "tol": {"bf16": BF16_TOL, "fp32": FP32_TOL},
            "ms": graph_ms(fn), "eager_ms": timed_ms(fn), "plain_ms": timed_ms(plain),
            "library_ms": graph_ms(lib) if lib else None,
            "timing": "CUDA graph of 20 calls, replayed 5 times",
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops, "design": DESIGN[name],
        })
        kernels[-1]["kernel_ms"] = kernels[-1]["ms"]
        check(launches_n > 0, f"{name} was not launched on the main path")
    kernels[0]["achieved_tb_per_s"] = k1_bytes / kernels[0]["ms"] / 1e9
    kernels[1]["achieved_tflop_per_s"] = k2_flops / kernels[1]["ms"] / 1e9
    # K2 and SDPA where blocks are plenty (B 8, Sq = Sk = 2048): the kernel's
    # throughput, apart from the single wave of unequal causal tiles at B 1
    q8, k8, v8 = rnd(8, 2 * Sq, H, D, dtype=torch.bfloat16), rnd(8, 2 * Sq, KH, D, dtype=torch.bfloat16), \
        rnd(8, 2 * Sq, KH, D, dtype=torch.bfloat16)
    k8_flops = 4 * 8 * H * D * (2 * Sq) * (2 * Sq + 1) // 2
    k8_ms = graph_ms(lambda: flash_attention_cuda(q8, k8, v8, scale=D**-0.5))
    k8_lib = graph_ms(lambda: F.scaled_dot_product_attention(q8.transpose(1, 2), k8.transpose(1, 2), v8.transpose(1, 2),
                                                             is_causal=True, enable_gqa=True))
    kernels[1]["b8_s2048"] = {"ms": k8_ms, "library_ms": k8_lib, "tflop_per_s": k8_flops / k8_ms / 1e9,
                              "library_tflop_per_s": k8_flops / k8_lib / 1e9}
    print(f"flash_attention_fwd at B 8, Sq = Sk = 2048: {k8_ms:.5f} ms ({k8_flops / k8_ms / 1e9:.1f} TFLOP/s), "
          f"SDPA {k8_lib:.5f} ms ({k8_flops / k8_lib / 1e9:.1f} TFLOP/s) ({card})")
    del q8, k8, v8
    for kern in kernels[:2]:
        rate = (f"{kern['achieved_tb_per_s']:.3f} TB/s" if "achieved_tb_per_s" in kern
                else f"{kern['achieved_tflop_per_s']:.2f} TFLOP/s")
        print(f"{kern['name']}: {kern['ms']:.5f} ms device ({rate}; bound {kern['bound_ms']:.5f} ms by "
              f"{kern['bound_by']}), eager call {kern['eager_ms']:.5f} ms, SDPA {kern['library_ms']:.5f} ms ({card})")
    record["earlier_ms"] = {"ms": EARLIER_MS, "from": "quoted from PERF.md (eager, before the redesign), "
                                                      "not measured in this run"}
    print("quoted from PERF.md, not measured in this run: before the redesign, eager, "
          + ", ".join(f"{k} {v} ms" for k, v in EARLIER_MS.items()) + " (H100 80GB HBM3, 700 W)")
    kernels[2].update(tol={"bf16": K3_TOL[torch.bfloat16], "fp32": K3_TOL[torch.float32], "scaled": True,
                           "reference": "the plain version on the inputs widened to fp64",
                           "terms": {"bf16": K3_TERMS_TOL[torch.bfloat16], "fp32": K3_TERMS_TOL[torch.float32],
                                     "on": "the y of the loga ~ -5 case, against the magnitude of the terms "
                                           "each element sums"}},
                      max_scaled_err=max(k3_scaled.values()),
                      library_note="no single PyTorch call computes a chunked scan")
    record["kernels"] = kernels
    # K3 takes each fp32 product as two TF32 products on the bf16 path: its
    # operations at the TF32 peak (a floor for this design, not a time)
    record["k3_tf32_split_floor_ms"] = 2 * k3_flops / TF32_FLOPS * 1e3
    print(f"K3: {k3_flops / 1e9:.3f} GFLOP, twice that as split TF32 products at the TF32 peak (495 TFLOP/s) "
          f"is a floor of {record['k3_tf32_split_floor_ms']:.5f} ms; kernel {kernels[2]['ms']:.5f} ms device, "
          f"{kernels[2]['eager_ms']:.5f} ms eager call, bound {kernels[2]['bound_ms']:.6f} ms by "
          f"{kernels[2]['bound_by']} ({card})")

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
    # the same step and prefill replayed as CUDA graphs: their device time
    # with no host in the way, so 1 - graph / eager is the share of the
    # eager call in which the device waits for the host
    step_graph_ms = graph_ms(lambda: M.decode_step(cfg, kernel_run, params, arena, toks, active=act), iters=4)
    prefill_graph_ms = graph_ms(lambda: M.prefill(cfg, kernel_run, params, prompt, 2048), iters=2)
    k1_share, k2_share = L * kernels[0]["ms"] / step_ms, L * kernels[1]["ms"] / prefill_ms
    k1_eager_share, k2_eager_share = L * kernels[0]["eager_ms"] / step_ms, L * kernels[1]["eager_ms"] / prefill_ms
    # xlstm: a decode step with 8 slots; a 1024-token prefill split inside
    # itself: CUDA events around the whole prefill, around each K3 call (its
    # wrapper: padding, fold, kernel, unfold) and around each sLSTM block
    # (its time loop), all in the same call, so the parts sum to at most the
    # whole. On a host-bound stretch an event pair spans the device's wait
    # for the host too, which is the time the prefill spends there.
    xarena = M.init_cache(xcfg, 8, 2048, dev)
    xprompt = torch.as_tensor(xcorpus.grain_tokens(200, 1)[:, :1024], dtype=torch.long, device=dev)
    x_step_ms = host_ms(lambda: M.decode_step(xcfg, kernel_run, xparams, xarena, toks, active=act))

    def split_prefill():
        spans = {"ssm_scan": [], "slstm": []}

        def spanned(key, fn):
            def call(*args, **kwargs):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                out = fn(*args, **kwargs)
                b.record()
                spans[key].append((a, b))
                return out
            return call

        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with mock.patch.object(ops, "ssm_scan", spanned("ssm_scan", ops.ssm_scan)), \
                mock.patch.object(ssm, "slstm_apply_full", spanned("slstm", ssm.slstm_apply_full)):
            a.record()
            M.prefill(xcfg, kernel_run, xparams, xprompt, 2048)
            b.record()
        torch.cuda.synchronize()
        check(len(spans["ssm_scan"]) == XL and len(spans["slstm"]) == XS, "every block of the prefill was timed")
        return a.elapsed_time(b), {k: sum(s.elapsed_time(e) for s, e in v) for k, v in spans.items()}

    split_prefill()  # warm-up
    splits = [split_prefill() for _ in range(2)]
    for total, part in splits:
        check(part["ssm_scan"] + part["slstm"] <= total, f"prefill parts {part} within the whole {total}")
    record["breakdown"] = {"decode_step_ms": step_ms, "k1_share": k1_share, "k1_eager_share": k1_eager_share,
                           "decode_step_graph_ms": step_graph_ms, "decode_step_host_wait": 1 - step_graph_ms / step_ms,
                           "k1_share_of_graph_step": L * kernels[0]["ms"] / step_graph_ms,
                           "prefill_1024_ms": prefill_ms, "k2_share": k2_share, "k2_eager_share": k2_eager_share,
                           "prefill_graph_ms": prefill_graph_ms, "prefill_host_wait": 1 - prefill_graph_ms / prefill_ms,
                           "k2_share_of_graph_prefill": L * kernels[1]["ms"] / prefill_graph_ms,
                           "xlstm_decode_step_ms": x_step_ms,
                           "xlstm_prefill_1024": [{"ms": total, "k3_calls_ms": part["ssm_scan"],
                                                   "slstm_blocks_ms": part["slstm"]} for total, part in splits]}
    print(f"decode step (8 slots at ~1024) {step_ms:.2f} ms, {L} x K1 = {k1_share:.1%} of it on the device, "
          f"{k1_eager_share:.1%} as eager calls; prefill of 1024 tokens {prefill_ms:.2f} ms, {L} x K2 = "
          f"{k2_share:.1%} of it on the device, {k2_eager_share:.1%} as eager calls ({card})")
    print(f"as CUDA graphs: decode step {step_graph_ms:.3f} ms ({L} x K1 = {L * kernels[0]['ms'] / step_graph_ms:.1%}), "
          f"prefill {prefill_graph_ms:.3f} ms ({L} x K2 = {L * kernels[1]['ms'] / prefill_graph_ms:.1%}); the eager "
          f"step waits for the host {1 - step_graph_ms / step_ms:.1%} of its time, the prefill "
          f"{1 - prefill_graph_ms / prefill_ms:.1%} ({card})")
    print(f"xlstm-1.3b: decode step (8 slots) {x_step_ms:.2f} ms ({card})")
    for total, part in splits:
        print(f"xlstm-1.3b prefill of 1024 tokens (CUDA events inside one call): {total:.2f} ms; {XL} K3 calls "
              f"{part['ssm_scan']:.2f} ms = {part['ssm_scan'] / total:.1%} ({XL} x kernel alone = "
              f"{XL * kernels[2]['ms'] / total:.1%}); {XS} sLSTM blocks {part['slstm']:.2f} ms = "
              f"{part['slstm'] / total:.1%} ({card})")

    # -- 11. the heterogeneous-cluster simulator, on the host ---------------
    record["simulator"] = simulate(card)

    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(json.dumps(record, indent=1, default=str))
    print(f"tolerances against the plain versions: flash_decode and flash_attention_fwd {BF16_TOL} (bf16), "
          f"{FP32_TOL} (fp32); ssd_scan {K3_TOL[torch.bfloat16]} (bf16), {K3_TOL[torch.float32]} (fp32) "
          "element by element, scaled, against the plain version summed in fp64 (the y of its loga ~ -5 case "
          f"against the magnitude of the terms it sums: {K3_TERMS_TOL[torch.bfloat16]} (bf16), "
          f"{K3_TERMS_TOL[torch.float32]} (fp32))")
    print(json.dumps({"kernels": [{k: kern[k] for k in LINE_KEYS if k in kern} for kern in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
