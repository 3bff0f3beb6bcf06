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
   (below one split, one short of it, at it, one past it), each output
   within an absolute limit and each element within ``ATTN_SCALED_TOL`` of
   its own scale (as K2 below); and checks that each row of a batch-8 call
   is bit-identical to that row called alone;
4. holds K2 (flash-attention forward) against its plain version: causal
   prefill, Sq not a multiple of the 64-row q tile, and a window with a
   query offset where a row's first visited 64-key tile is fully masked;
   then holds K1 and K2 at the head groupings of the dense, MoE, hybrid and
   frontend archs (G = 1, 6, 16, 8 and 7 q heads per KV head at head_dim
   128, G = 1 at head_dim 64): K1 at S 2048, over a wrapped ring and at the
   serves' own shapes (moonshot's ring of 1057 at G 1, mixtral's batch 4 at
   G 6, jamba's ring of 4129 at G 8, llava's batch 4 over 2304 at G 7,
   musicgen's ring of 1057 at head_dim 64), its rows at G 16
   batch-invariant, K2 causal at Sq 1024 and at each serve's longest
   prefill (at G 6 with window 4096 at Sq 8192); and times each at its
   serve's shapes;
5. holds K3 (the chunked SSD scan) against its plain version on the same
   inputs widened to fp64 (so that it sums in fp64), bf16 and fp32, each
   element against its own scale: the mLSTM prefill shapes (input gates as the model draws them,
   and up to e^10), a sequence that pads, one below a chunk, P = N = 64,
   loga = 0, loga ~ -5 (its y against the magnitude of the terms each
   element sums), and chunk 64 vs 256; and checks at the prefill
   shape that two calls give the same bits, that each row of the call
   equals that row called alone, and that a call replayed from a CUDA
   graph equals the eager call; then K3 at jamba's Mamba layout (128 heads
   of P = 128, N = 64, c shared by every head) over prompts of 1000 and
   4096 tokens the same way, its rows batch-invariant and a graph replay
   equal to the eager call, and times it at the 4096-token prefill, alone
   and with the fold that lays out its inputs (``ops.ssm_scan``), beside a
   byte bound that counts c once per token;
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
12. (run right after phase 5, while the card holds nothing else) serves
   moonshot-v1-16b-a3b (48 layers, 64 experts top-6) at full width in bf16:
   first the kernel path against the plain path with fp32 weights cut to 4
   layers (logits and every layer's routing); then 16 prompts through one
   ``ServeLoop`` arena of batch 8, checking the launch identity (K1 = 48 x
   decode calls, K2 = 48 x prefills) and reporting each prefill's dropped
   share; the decode step eager and as a CUDA graph beside its byte bound;
   and the 48-layer bf16 logits of both paths, finite, with the share of
   routings on which they agree;
13. serves mixtral-8x22b at full width cut to 4 layers: the paths against
   each other in fp32 on 2 layers past the 4096 window, then 4 prompts of
   2048-8192 tokens through an arena of batch 4, K2 windowed on every
   prefill and K1 over the wrapped ring;
14. serves jamba-1.5-large-398b at full width cut to 4 layers (Mamba +
   dense FFN, Mamba + MoE, Mamba + dense FFN, attention + MoE): one 8-layer
   period is 45.1e9 parameters, ~90 GB in bf16, which no single H100
   holds, so the cut keeps the first three Mamba layers and the period's
   attention layer (22,974,884,480 parameters, 45.9 GB). The paths against
   each other in fp32 on the first 2 layers (K3 against its plain version
   summed in fp64; logits and routing); 8 prompts of 256-4096 tokens
   through an arena of batch 8 with K3 = 3 x prefills, K2 = prefills, K1 =
   decode calls, each prefill's dropped share; a parked row's position,
   KV and four Mamba tensors left bit for bit; the decode step eager and
   as a CUDA graph beside its byte bound;
15. serves musicgen-medium at full width (48 layers, MHA, head_dim 64): the
   paths against each other in fp32 on 4 layers after 256 prefix
   features; 16 prompts of 128-1024 through an arena of batch 8; a prefill
   of 256 seeded audio-frame features before 1024 tokens (every K2 call at
   Sq 1280) and 4 decode steps from it;
16. serves llava-next-34b at full width (60 layers, G = 7; 68.8 GB in
   bf16) the same way through an arena of batch 4 and a ring of 2304, 8
   prompts of 256-2048, its prefix 256 vision-patch features. Phases 12-16
   run right after phase 5 while the card holds nothing else, each freeing
   its weights; the depth cuts are mixtral's and jamba's, every width is
   the published one;
17. (right after phase 16, while the card holds nothing else) trains:
   K2's gradient (the kernel's forward, the reference's recompute
   backward) against autograd through the plain forward at the training
   shape, bf16 and fp32, with a ``grad_fn`` and no launch in the backward;
   qwen3-1.7b at full width through ``repro_torch.launch.train.main``, pods
   1.0 and 0.5, 3 microbatches of 2 x 1024 tokens a step, 6 steps: loss,
   grad norm, schedule and virtual times per step, the loss of held-out
   microbatches before the first step and after each, ms per grad
   microbatch and per update, tok/s, peak memory and the share of a
   microbatch in K2's forwards and in the recompute backwards; checks
   finite losses, a held-out loss that falls, K2 = 28 x grad microbatches
   and a non-zero gradient for every parameter; then, at 2 layers, one
   fp32 grad step kernel path vs plain path (loss and every gradient) and
   5 steps with the int8 + error-feedback combine (held-out loss falls);
   a checkpoint of CUDA tensors restored bit for bit with a node lost, and
   a smoke run that loses a pod at step 3, restores and goes on over a
   re-proportioned schedule;
18. (right after phase 17) trains the SSM families: K3 at the training
   shapes (xlstm's folded x (8, 1024, 513), Mamba's (256, 2048, 128) with
   c shared by the heads), bf16 and fp32, against its plain version summed
   in fp64 (y against the terms it sums, h against its own scale), and a
   backward through ``ops.ssm_scan`` (one forward launch, none in the
   backward, every input a finite gradient equal to plain autograd's);
   K3 timed at xlstm's training shape beside its recompute backward;
   xlstm-1.3b at full width through ``repro_torch.launch.train.main``,
   pods 1.0 and 0.5, 3 microbatches of 2 x 1024 a step, 3 steps, as
   phase 17 measures qwen3, with CUDA events around each K3 forward, each
   K3 recompute backward and each sLSTM block's forward and backward; it
   checks K3 = 42 x grad microbatches, finite losses and a non-zero
   gradient for every parameter; then one fp32 grad step of
   xlstm cut to one period (7 mLSTM + 1 sLSTM) and of jamba-smoke's period
   widened to d_model 256 (K2 and K3 both run) on the kernel path, the
   plain path and the plain path in fp64: the kernel path's gradients no
   further from fp64 than ``SSM_GRAD_MARGIN`` times the plain path's;
19. (right after phase 18) trains moonshot-v1-16b-a3b at published widths
   cut to 3 layers (its dropped share and aux loss per microbatch at the
   training capacity factor) and musicgen-medium at full width (8 prefix
   frames before each microbatch's tokens) as phase 17 trains qwen3; one
   qwen3-1.7b grad microbatch under ``remat`` "none" (twice), "full" and
   "dots" (ms, peak, K2 launches, gradients against "none"); and the
   ``-smoke`` config of every arch, at d_model 256, for 2 steps;
20. (right after phase 19) the distribution layer: K1 with partials on 4
   sequence shards of 8192 keys at qwen3-1.7b's layout and decode_32k's
   length (B 8, bf16; a row valid in shard 0 only and an all-invalid row),
   combined, against one K1 call over 32768 keys and the plain version,
   and timed beside the one call; ``sharded_decode_attention`` on a
   one-rank NCCL (1, 1) mesh against the one call; ``pipeline_apply`` of
   one qwen3-1.7b block over 4 microbatches of (2, 1024) against a
   sequential run; and qwen3-1.7b's sharded train step at full width
   through ``make_train_step(cfg, run, rules)`` (params and AdamW state
   placed by ``model_specs``/``opt_state_specs``, 28 K2 launches a step,
   each through the wrappers' DTensor path) against the unsharded step
   (losses to 1e-3, ms per step, peak within 1 GiB), and at a 2-layer fp32
   cut (params to 1e-4); then moonshot-v1-16b-a3b cut to 3 layers the same
   way (the loss on each rank's own rows, MoE routing on each rank's own
   groups). NCCL places one rank per card, so the multi-rank behaviour is
   held across four cards by ``scripts/multicard_smoke.py`` (PERF.md's
   4-card figures) and on gloo CPU groups by ``tests/test_torch_parallel.py``;
21. (right after phase 20) the sharded serve steps and the dry-run: (a)
   qwen3-1.7b at full width on the one-rank NCCL (1, 1) mesh, params placed
   by ``model_specs``, the cache by ``cache_specs`` (its sequence over
   ``model``): phase 6's 8 prompt lengths (128-1024) each prefilled alone
   by ``make_prefill_step`` (max_len 2048), the caches stacked into one
   batch-8 cache, 32 greedy ``make_serve_step`` steps, against the
   unsharded ``prefill``/``decode_step`` on the same weights: every bf16
   logit bit for bit (one rank: the same kernels on the same operands)
   and the streams never parting, identical streams and logits to 1e-4 on
   a 2-layer fp32 cut, 28 K2 launches a prefill through the wrappers'
   DTensor path and 28 K1 launches a step through
   ``sharded_decode_attention``, ms per decode step, the device time of 3
   more steps (``torch.profiler``, NCCL's apart) and peak GiB of both, and
   K1 and K2 timed at the path's shapes; (b) the ``-smoke`` config of
   every arch (d_model 256, fp32; the frontends after 16 seeded features):
   a prefill and 4 decode steps sharded against unsharded, streams
   identical and logits to 1e-4 of the largest; (c) ``python -m
   repro_torch.launch.dryrun`` in a subprocess (its fake process group
   apart from the NCCL one) for qwen3-1.7b, xlstm-1.3b and
   moonshot-v1-16b-a3b at train_4k, prefill_32k and decode_32k on the
   16 x 16 mesh: each record's t_compute, t_memory, t_collective (predicted
   from the H100 nameplate peaks), dominant term and peak bytes per device
   (each below the card's memory, and beside its earlier figure), and the
   seconds each cell took;
22. prints one ``{"kernels": [...]}`` line with times and bounds (and the
   launches of each serve path and of training; for K1 and K2 the times at
   each head grouping, K2 and K3 also at the training shape, K3 at the
   Mamba shape, K1 sharded over 4 shards of decode_32k, and the rows
   "flash_decode sharded serve" and "flash_attention sharded prefill" of
   phase 21 with their launches per step and per prefill), the seconds of
   each phase, the card line, and last ``{"ok": true, "device": {...}}``.
   ``--out FILE`` also writes every measurement to FILE as JSON.

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

# the frontends' prefix length, as the JAX package's workloads give it
from repro_torch.models.model import DEFAULT_PREFIX_LEN as PREFIX_LEN  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12  # dense tensor-core bf16
TF32_FLOPS = 495e12  # dense tensor-core TF32
BF16_TOL, FP32_TOL = 3e-2, 1e-4  # kernel vs plain: bf16 as tests/test_kernels.py; fp32 sums in another order
# K1 and K2 vs plain besides, each element against its own scale (|plain| +
# the largest |plain| of its row of head_dim values, scaled_err), keyed by
# the output's dtype. With random q, k, v over thousands of keys a typical
# |out| is sqrt(e / keys), 0.02 to 0.06, so the absolute limits above are
# about one typical value: on an H100, K1 ignoring the last 32 of 4129 keys
# errs 2.3e-2 absolute, under 3e-2, and 0.23 of the scale
# (scripts/attn_fault_check.py plants such faults in a copy). bf16 (K2's
# output): one bf16 unit is at most 2^-7 of an element, so at most 2^-8
# (3.9e-3) of its scale, and 1e-2 admits two. fp32 (K1's output in either
# input type, K2's fp32 kernel): sums over up to 8192 keys in another order,
# which a correct kernel keeps within 3e-6 of the scale on an H100; 1e-4
# admits thirty times that.
ATTN_SCALED_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
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
# no term for the decay factors' own error. Exceptions: K3_TERMS_TOL.
K3_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
# The y of the "loga ~ -5" case, and of the Mamba-shape cases (decays down
# to e^-11 a step), is held against the magnitude of the terms each element
# sums (ssm_scan_plain in fp64 on |x|, loga, |b|, |c|, as
# scripts/k3_precision.py takes it), not against its own scale: at a decay
# of e^-5 a step an output row is nearly the one product c_t . b_t times
# x_t, and where that product cancels the row's scale falls up to 1e4
# times below the terms it sums. fp32 arithmetic errs relative to the
# terms: over 20 seeds the kernel errs 1.2e-7 to 1.6e-7 of them (the plain
# version summed in fp32 2.3e-5 to 7.7e-5), at the Mamba shape over 10
# seeds 1.4e-7 to 1.7e-7 (4.2e-6 to 2.1e-5 of the row's own scale), and
# 1e-6 is ~16 units of fp32 roundoff; a wrong kernel errs O(1). In bf16 the y is rounded to bf16, and
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
# jamba-1.5-large-398b at full width cut to JAMBA_LAYERS layers (Mamba +
# dense FFN, Mamba + MoE, Mamba + dense FFN, attention + MoE: 22,974,884,480
# parameters, 45.9 GB in bf16; tests/test_torch_mamba.py holds the count
# against the JAX package's per-layer definitions): one 8-layer period is
# 45.1e9 parameters, ~90 GB in bf16, which no single H100 holds. Its serve:
# two prompts each of 256, 1000 (not a multiple of K3's 256-step chunk),
# 2048 and 4096 (one and two MoE groups of 2048) through an arena of batch
# 8, a ring for 4096 + 32 new tokens + 1. Its fp32 check, kernel vs plain
# path, runs the first JAMBA_CHECK_LAYERS layers (two Mamba layers, one
# with MoE: 48.6 GB of fp32 weights).
JAMBA_LAYERS, JAMBA_CHECK_LAYERS, JAMBA_CUT_PARAMS = 4, 2, 22_974_884_480
JAMBA_LENS, JAMBA_MAX_LEN = (256, 1000, 2048, 4096) * 2, 4129
# musicgen-medium at full width (48 layers, 24 MHA heads of 64): 16 prompts
# of 128-1024 through an arena of batch 8, a ring for 1024 + 32 + 1
MUSICGEN_LENS, MUSICGEN_MAX_LEN = (128, 256, 384, 512, 640, 768, 896, 1024) * 2, 1057
# llava-next-34b at full width: 34.4e9 parameters, 68.8 GB in bf16, leave
# ~11 GB of the card, so an arena of batch 4 and a ring of 2304 (2.3 GB of
# KV over 60 layers) for prompts up to 2048 + 32 new tokens
LLAVA_LENS, LLAVA_BATCH, LLAVA_MAX_LEN = (256, 512, 1024, 2048) * 2, 4, 2304
# the frontends' prefix prefill: PREFIX_LEN seeded features, then FRONTEND_PROMPT
# tokens; the fp32 kernel-vs-plain check on the first FRONTEND_CHECK_LAYERS
FRONTEND_PROMPT, FRONTEND_CHECK_LAYERS = 1024, 4
# K3 at jamba's Mamba layout: H = d_inner / 128 heads of P = 128 (the
# block's head width), N = d_state, over one prompt of 1000 tokens (not a
# multiple of the 256-step chunk) and one of 4096 (its serve's longest)
K3_MAMBA_SHAPE, K3_MAMBA_SEQS = (128, 128, 64), (1000, 4096)
# Head groupings (q heads per KV head) and head widths of the dense, MoE,
# hybrid and frontend archs, beside qwen3's G = 2 of phases 3 and 4: (G, H,
# KH, head_dim, the archs that run it, K1 at the shape its serve gives it
# (batch, ring, every key valid, what), K2 at its serve's longest prefill
# (Sq, window, what)). llama3-405b and internlm2-20b are not served.
GROUPINGS = (
    (1, 16, 16, 128, "moonshot-v1-16b-a3b", (8, 1057, False, "moonshot decode, 8 slots, ring of 1057"),
     (1024, 0, "moonshot prefill of 1024")),
    (6, 48, 8, 128, "internlm2-20b, mixtral-8x22b", (4, 4096, True, "mixtral decode, 4 slots, wrapped 4096 ring"),
     (8192, 4096, "mixtral prefill of 8192, window 4096")),
    (16, 128, 8, 128, "llama3-405b", (8, 2048, False, "llama3-405b decode, 8 slots at 2048"),
     (1024, 0, "llama3-405b prefill of 1024")),
    (8, 64, 8, 128, "jamba-1.5-large-398b", (8, JAMBA_MAX_LEN, False, "jamba decode, 8 slots, ring of 4129"),
     (4096, 0, "jamba prefill of 4096")),
    (7, 56, 8, 128, "llava-next-34b", (LLAVA_BATCH, LLAVA_MAX_LEN, False, "llava decode, 4 slots, ring of 2304"),
     (2048, 0, "llava prefill of 2048")),
    (1, 24, 24, 64, "musicgen-medium", (8, MUSICGEN_MAX_LEN, False, "musicgen decode, 8 slots, ring of 1057"),
     (PREFIX_LEN + FRONTEND_PROMPT, 0, "musicgen prefill of 256 prefix features + 1024 tokens")),
)
# Logits, kernel vs plain path, of the largest |logit|, in fp32 at a cut
# depth (moonshot 4 layers, mixtral 2, jamba 2, musicgen and llava 4). For
# the MoE stacks: in bf16 a 1e-2 difference in an
# attention output can flip a near-tie between experts, and the flipped
# token's FFN output then moves by a large share, so the bf16 full-depth
# logits are only checked finite and the share of routings the two paths
# agree on is reported. In fp32 the two paths stay 1e-6 to 1e-5 of the
# largest |logit| apart, which flips no routing; the limit admits that and
# refuses an O(|logit|) error.
CUT_LOGIT_TOL, MOE_LAYERS, MIXTRAL_LAYERS, MIXTRAL_CHECK_LAYERS = 1e-3, 4, 4, 2


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
LINE_KEYS = ("name", "route", "source", "replaces", "tpu_kernel", "launches", "launches_per_step", "one_call_ms",
             "launches_by_path", "max_abs_err", "max_scaled_err", "max_scaled_err_by_dtype",
             "max_terms_err_mamba_shape", "ms", "kernel_ms",
             "eager_ms", "plain_ms", "library_ms", "library_note", "timing", "bound_ms", "bound_by", "groupings",
             "mamba_shape", "training_shape", "design")
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


def scaled_err(a, b) -> float:
    """Largest |a - b| / (|b| + the largest |b| of its row), a row being
    the last axis: one time step's P values of y, one state row of h, one
    token's features. Each element is held to its own scale, so a few huge
    gates cannot hide the error of the elements around them; where the
    scale is 0 the two must be equal."""
    a, b = a.float(), b.float()
    scale = b.abs() + b.abs().amax(dim=-1, keepdim=True)
    return float(((a - b).abs() / scale.clamp_min(1e-30)).max())


def terms_err(a, b, terms) -> float:
    """Largest |a - b| over the magnitude of the terms each element of b
    sums (fp64)."""
    return float(((a.double() - b.double()).abs() / terms.clamp_min(1e-300)).max())


def k3_terms(x, loga, b, c, chunk):
    """The magnitude of the terms each element of y sums: the plain version
    in fp64 on |x|, loga, |b|, |c| (folded inputs)."""
    from repro_torch.kernels.ssm_scan import ssm_scan_plain

    return ssm_scan_plain(x.double().abs(), loga.double(), b.double().abs(), c.double().abs(), chunk)[0]


def k3_exact(x, loga, b, c, chunk):
    """K3's reference: the plain version on the same (folded) inputs widened
    to fp64, so that it sums in fp64 (summed in fp32 it is itself up to
    5e-5 of an element's scale from the exact result at input gates near
    e^10, scripts/k3_precision.py); y rounded to x's dtype, as the kernel
    rounds it, and h in fp32."""
    from repro_torch.kernels.ssm_scan import ssm_scan_plain

    y, h = ssm_scan_plain(*(t.double() for t in (x, loga, b, c)), chunk)
    return y.to(x.dtype), h.float()


def plain_scan(x, loga, b, c, chunk=256):
    """The plain path's stand-in for ``ops.ssm_scan`` (model layout in and
    out): :func:`k3_exact` on the folded inputs."""
    from repro_torch.kernels.ssm_scan import fold, unfold

    y, h = k3_exact(*fold(x, loga, b, c, chunk), chunk)
    return unfold(y, h, x.shape[0], x.shape[1], x.shape[-1], b.shape[-1])


def k3_inputs(gen, B, S, H, P, N, dtype, loga="gate", b_dtype=torch.float32, gate_sd=1.0):
    """mLSTM-like K3 inputs in the model layout, on ``gen``'s device: x
    with a ones column last (the normaliser), b = k * exp(input gate), the
    gate's log ~ N(0, gate_sd^2) clamped at +-10 as the model clamps it (1
    is what the model's random weights give; 3 reaches e^10), loga = log
    sigmoid of an open forget gate (or 0, or ~ -5)."""
    dev = gen.device
    x = torch.randn(B, S, H, P, generator=gen, device=dev).to(dtype)
    x[..., -1] = 1
    c = torch.randn(B, S, H, N, generator=gen, device=dev).to(dtype)
    gate = torch.exp((gate_sd * torch.randn(B, S, H, 1, generator=gen, device=dev)).clamp(-10, 10))
    b = (torch.randn(B, S, H, N, generator=gen, device=dev) / N**0.5 * gate).to(b_dtype)
    noise = torch.randn(B, S, H, generator=gen, device=dev)
    la = {"gate": torch.nn.functional.logsigmoid(3 + noise), "zero": torch.zeros_like(noise),
          "neg5": -5 + 0.1 * noise}[loga]
    return x, la, b, c


def k3_bit_checks(f, rows: int) -> dict:
    """K3 on the folded inputs ``f``, bit for bit: two calls give the same
    bits, each group of ``rows`` rows (one head, or one prompt's heads)
    called alone gives the bits it gives in the call, and a call replayed
    from a CUDA graph equals the eager call (no atomics; nothing is
    allocated or set inside the launch)."""
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda

    y1, h1 = ssm_scan_cuda(*f, 256)
    y2, h2 = ssm_scan_cuda(*f, 256)
    starts = range(0, f[0].shape[0], rows)
    alone = [ssm_scan_cuda(*(t[i:i + rows].clone() for t in f), 256) for i in starts]
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
    return {"two_calls": torch.equal(y1, y2) and torch.equal(h1, h2),
            "rows_alone": all(torch.equal(y1[i:i + rows], y) and torch.equal(h1[i:i + rows], h)
                              for i, (y, h) in zip(starts, alone)),
            "graph_replay": torch.equal(yg, y1) and torch.equal(hg, h1)}


def eager_ms(fn, iters: int = 5) -> float:
    """Host time of one synchronised call of ``fn`` (after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / iters * 1e3


def leaves(tree):
    """The tensors of a parameter or cache tree (dicts and lists)."""
    if isinstance(tree, torch.Tensor):
        yield tree
        return
    for v in tree.values() if isinstance(tree, dict) else tree:
        yield from leaves(v)


def free_card() -> None:
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def k1_bound(q, k, valid) -> dict:
    """K1's least time on the card for this call's data: q and the mask
    read once, the fp32 output written once, and the K and V of the valid
    keys only (no other key enters the result, though the kernel reads
    every key); 4 D operations per (q head, valid key): the scores and the
    weighted values."""
    n_valid = int((valid != 0).sum())
    b, h, d = q.shape
    nbytes = (q.numel() * q.element_size() + valid.numel() * valid.element_size() + b * h * d * 4
              + 2 * n_valid * k.shape[2] * d * k.element_size())
    flops = 4 * h * d * n_valid
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return {"bound_ms": max(t_b, t_o), "bound_by": "bytes" if t_b >= t_o else "operations", "bytes": nbytes,
            "flops": flops}


def window_pairs(sq: int, window: int) -> int:
    """(query, key) pairs a causal attention of ``sq`` rows visits."""
    if not window:
        return sq * (sq + 1) // 2
    w = min(window, sq)
    return w * (w + 1) // 2 + (sq - w) * w


def groupings(rnd, gen, card: str) -> dict:
    """K1 and K2 at the head groupings and widths of the dense, MoE, hybrid
    and frontend archs (``GROUPINGS``: G = 1, 6, 16, 8, 7 at head_dim 128,
    G = 1 at 64) against their plain versions in bf16 and fp32 at the
    tolerances of phases 3 and 4, absolute and each element against its own
    scale (``ATTN_SCALED_TOL``): K1 at S 2048 with phase 3's masks, over
    a wrapped ring (every key of a 4096-key ring valid), and at each serve's
    own K1 shape (moonshot's ring of 1057 at G 1, a tail of 33 after four
    256-key splits; mixtral's batch 4 over the wrapped ring at G 6; jamba's
    ring of 4129 at G 8; llava's batch 4 over 2304 at G 7; musicgen's ring
    of 1057 at head_dim 64); its rows at G 16 bit-identical to each row
    alone; K2 causal at Sq 1024 and at each serve's longest prefill (at G 6
    with window 4096 at Sq 8192), its plain version in chunks of 1024 query
    rows. Then each timed in bf16 at the shapes its serve gives it, beside
    its bound and SDPA."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import SPLIT_KEYS, decode_attention_cuda, decode_attention_plain
    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain
    from repro_torch.models.common import causal_mask

    t_phase = time.perf_counter()
    dev = torch.device("cuda")

    def err(a, b):
        return float((a.float() - b.float()).abs().max())

    def k2_plain(q, k, v, window, scale):
        """The plain version over 1024-row query chunks, each against the
        keys it can see (shift-invariant masks: q_offset = chunk start -
        first key)."""
        outs = []
        for i0 in range(0, q.shape[1], 1024):
            i1 = min(i0 + 1024, q.shape[1])
            k0 = max(0, i0 - window + 1) if window else 0
            outs.append(flash_attention_plain(q[:, i0:i1], k[:, k0:i1], v[:, k0:i1], q_offset=i0 - k0,
                                              window=window, scale=scale))
        return torch.cat(outs, dim=1)

    def masks(b, S):
        """Phase 3's masks: random validity; row 1 full; row 2 all-invalid;
        row 3 valid only in the last 32 keys; one row (5, or 0 in a batch
        below 6) valid only in the last split. Returns the mask and the rows
        held (all but the all-invalid one)."""
        valid = (torch.rand(b, S, generator=gen, device=dev) > 0.3).to(torch.int32)
        valid[1] = 1
        valid[2] = 0
        valid[3] = 0
        valid[3, (S - 1) // 32 * 32:] = 1
        last = 5 if b > 5 else 0
        valid[last] = 0
        valid[last, (S - 1) // SPLIT_KEYS * SPLIT_KEYS:] = 1
        return valid, [i for i in range(b) if i != 2]

    rec = {"k1_err": {}, "k2_err": {}, "k1_scaled": {}, "k2_scaled": {}, "k1_cases": [], "k1_batch_invariant": [],
           "k1_times": [], "k2_times": []}
    for G, H, KH, D, archs, (b1, s1, ring1, _), (sq2, win2, _) in GROUPINGS:
        scale, key = D**-0.5, f"G{G} hd{D}"
        for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
            worst = scaled = 0.0
            # (S, every key valid, batch): S 2048, a wrapped ring, and the serve's own shape
            cases = [(2048, False, 8), (4096, True, 8)]
            cases += [] if (s1, ring1, b1) in cases else [(s1, ring1, b1)]
            for S, ring, b in cases:
                q = rnd(b, H, D, dtype=dtype)
                k, v = rnd(b, S, KH, D, dtype=dtype), rnd(b, S, KH, D, dtype=dtype)
                if ring:
                    valid, rows = torch.ones(b, S, dtype=torch.int32, device=dev), list(range(b))
                else:
                    valid, rows = masks(b, S)
                got = decode_attention_cuda(q, k, v, valid, scale=scale)
                exp = decode_attention_plain(q, k, v, valid, scale=scale)
                torch.cuda.synchronize()
                if not ring:
                    check(float(got[0][2].abs().max()) == 0.0, f"K1 {key}: the all-invalid row is exactly zero")
                worst = max(worst, err(got[0][rows], exp[0][rows]))
                scaled = max(scaled, scaled_err(got[0][rows], exp[0][rows]))
                rec["k1_cases"].append(f"G={G}, hd={D}, B={b}, S={S}, {'wrapped ring' if ring else 'masks'}, {dtype}")
                if G == 16 and not ring:
                    alone = [decode_attention_cuda(q[i:i + 1], k[i:i + 1], v[i:i + 1], valid[i:i + 1], scale=scale)
                             for i in range(b)]
                    check(all(torch.equal(x[i:i + 1], y) for i in range(b) for x, y in zip(got, alone[i])),
                          f"K1 G 16 batch-8 rows bit-identical to batch-1 calls ({dtype})")
                    rec["k1_batch_invariant"].append(f"G=16, B=8, {dtype}, S={S}")
            # K1's output is fp32 whatever its inputs' type
            stol = ATTN_SCALED_TOL[torch.float32]
            check(worst < tol, f"K1 vs plain at {key} ({H}/{KH}) {dtype}: {worst} >= {tol}")
            check(scaled <= stol, f"K1 vs plain at {key} ({H}/{KH}) {dtype}: scaled err {scaled} > {stol}")
            rec["k1_err"][f"{key} {dtype}"], rec["k1_scaled"][f"{key} {dtype}"] = worst, scaled
            worst = scaled = 0.0
            for Sq, window in sorted({(1024, 0), (sq2, win2)}):
                q = rnd(1, Sq, H, D, dtype=dtype)
                k, v = rnd(1, Sq, KH, D, dtype=dtype), rnd(1, Sq, KH, D, dtype=dtype)
                got, exp = flash_attention_cuda(q, k, v, window=window, scale=scale), k2_plain(q, k, v, window, scale)
                worst, scaled = max(worst, err(got, exp)), max(scaled, scaled_err(got, exp))
            check(worst < tol, f"K2 vs plain at {key} ({H}/{KH}) {dtype}: {worst} >= {tol}")
            check(scaled <= ATTN_SCALED_TOL[dtype],
                  f"K2 vs plain at {key} ({H}/{KH}) {dtype}: scaled err {scaled} > {ATTN_SCALED_TOL[dtype]}")
            rec["k2_err"][f"{key} {dtype}"], rec["k2_scaled"][f"{key} {dtype}"] = worst, scaled
            print(f"K1, K2 vs plain at G {G}, head_dim {D} ({H} q heads / {KH} KV heads: {archs}), {dtype}: max abs "
                  f"err K1 {rec['k1_err'][f'{key} {dtype}']:.3e}, K2 {worst:.3e} (tol {tol}); scaled err K1 "
                  f"{rec['k1_scaled'][f'{key} {dtype}']:.3e} (tol {stol:.0e}), K2 {scaled:.3e} "
                  f"(tol {ATTN_SCALED_TOL[dtype]:.0e})")
    print(f"K1 cases held against the plain version: {rec['k1_cases']}")
    print(f"K1 batch invariance at G 16: {rec['k1_batch_invariant']}")

    # times at the shapes each grouping's serve gives the kernels (bf16)
    bf = torch.bfloat16
    for G, H, KH, D, _, (b, S, ring, what), _ in GROUPINGS:
        scale = D**-0.5
        q, k, v = rnd(b, H, D, dtype=bf), rnd(b, S, KH, D, dtype=bf), rnd(b, S, KH, D, dtype=bf)
        if ring:
            valid = torch.ones(b, S, dtype=torch.int32, device=dev)
        else:
            ends = torch.randint(128, S + 1, (b, 1), generator=gen, device=dev)
            valid = (torch.arange(S, device=dev)[None] < ends).to(torch.int32)
        mask = valid.bool()[:, None, None, :]
        bound = k1_bound(q, k, valid)
        t = {"G": G, "head_dim": D, "shape": f"q ({b},{H},{D}), k/v ({b},{S},{KH},{D}) bf16", "what": what,
             "ms": graph_ms(lambda: decode_attention_cuda(q, k, v, valid, scale=scale)),
             "plain_ms": timed_ms(lambda: decode_attention_plain(q, k, v, valid, scale=scale)),
             "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(
                 q[:, :, None], k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask, enable_gqa=True)),
             "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"], "bytes": bound["bytes"]}
        rec["k1_times"].append(t)
    for G, H, KH, D, _, _, (Sq, window, what) in GROUPINGS:
        scale = D**-0.5
        q, k, v = rnd(1, Sq, H, D, dtype=bf), rnd(1, Sq, KH, D, dtype=bf), rnd(1, Sq, KH, D, dtype=bf)
        flops = 4 * H * D * window_pairs(Sq, window)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
        qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        if window:
            # SDPA takes no window: an explicit mask, and K, V repeated to the
            # q heads (its memory-efficient path takes no GQA)
            mask = causal_mask(Sq, Sq, 0, window, dev)
            kr, vr = ks.repeat_interleave(G, dim=1), vs.repeat_interleave(G, dim=1)
            lib = lambda: F.scaled_dot_product_attention(qs, kr, vr, attn_mask=mask)  # noqa: E731
            note = f"SDPA with a (Sq, Sk) bool mask, K and V repeated to the {H} q heads"
        else:
            lib = lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)  # noqa: E731
            note = "SDPA, GQA, causal"
        t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        t = {"G": G, "head_dim": D, "shape": f"q (1,{Sq},{H},{D}), k/v (1,{Sq},{KH},{D}) bf16, window {window}",
             "what": what, "ms": graph_ms(lambda: flash_attention_cuda(q, k, v, window=window, scale=scale), iters=5),
             "plain_ms": timed_ms(lambda: k2_plain(q, k, v, window, scale), iters=3),
             "library_ms": graph_ms(lib, iters=5), "library_note": note,
             "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
             "flops": flops}
        rec["k2_times"].append(t)
        del q, k, v, qs, ks, vs, lib
        if window:
            del kr, vr, mask
    for name, times in (("K1", rec["k1_times"]), ("K2", rec["k2_times"])):
        for t in times:
            print(f"{name} at G {t['G']}, head_dim {t['head_dim']} ({t['what']}; {t['shape']}): {t['ms']:.5f} ms "
                  f"device (graph replay), bound {t['bound_ms']:.5f} ms by {t['bound_by']}, plain "
                  f"{t['plain_ms']:.4f} ms, SDPA {t['library_ms']:.5f} ms ({card})")
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"the groupings phase took {rec['phase_s']:.1f} s")
    free_card()
    return rec


def paths_agree(cfg, params, prompt, max_len, steps: int = 4, prefix=None) -> dict:
    """Prefill ``prompt`` (after the frontend's ``prefix`` features, where
    given) and decode ``steps`` tokens on the kernel path (K2, K1, K3) and
    on the plain path (chunked attention, einsum decode, :func:`plain_scan`
    for K3), both fed the kernel path's greedy tokens. Returns the largest
    |kernel - plain| logit, the largest |plain| logit, whether every logit
    is finite and of shape (B, 1, vocab), and, for a MoE stack, how the two
    paths routed: the share of (token, slot) choices they agree on and
    whether all agree, over how many MoE calls."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models import moe

    runs = {"kernel": RunConfig(remat="none", attention_impl="pallas", decode_attention_impl="kernel"),
            "plain": RunConfig(remat="none", attention_impl="chunked", decode_attention_impl="einsum")}
    routes = {name: [] for name in runs}
    route = moe.route

    @contextlib.contextmanager
    def spied(name):
        def call(*args, **kwargs):
            r = route(*args, **kwargs)
            routes[name].append(r.top_i)
            return r
        with mock.patch.object(moe, "route", call), \
                mock.patch.object(ops, "ssm_scan", plain_scan if name == "plain" else ops.ssm_scan):
            yield

    logits, caches = {}, {}
    for name, run in runs.items():
        with spied(name):
            logits[name], caches[name] = M.prefill(cfg, run, params, prompt, max_len, prefix_features=prefix)
    worst, top, sound = 0.0, 0.0, True
    for step in range(steps + 1):
        a, b = logits["kernel"].float(), logits["plain"].float()
        worst, top = max(worst, float((a - b).abs().max())), max(top, float(b.abs().max()))
        sound &= all(t.shape == (prompt.shape[0], 1, cfg.vocab_size) and bool(torch.isfinite(t).all()) for t in (a, b))
        if step == steps:
            break
        tok = torch.argmax(a[:, -1], dim=-1, keepdim=True)
        for name, run in runs.items():
            with spied(name):
                logits[name], _ = M.decode_step(cfg, run, params, caches[name], tok)
    torch.cuda.synchronize()
    pairs = list(zip(routes["kernel"], routes["plain"]))
    same = sum(int((x == y).sum()) for x, y in pairs)
    total = sum(x.numel() for x, _ in pairs)
    out = {"max_abs_diff": worst, "max_abs_logit": top, "sound": sound, "moe_calls": len(pairs)}
    if pairs:
        out.update(routing_agree=same / total, routing_identical=same == total)
    return out


def serve_arena(cfg, params, lens, max_len: int, batch: int, card: str, spy_kernels: bool = False) -> dict:
    """Serve ``lens`` SyntheticCorpus prompts, 32 new tokens each, greedy,
    admit_all, through one ``ServeLoop`` arena on the kernel path, the launch
    counts at 0 just before. Checks completion and the exact launch
    identity (K1 = attention layers x decode calls, K2 = attention layers x
    prefills, K3 = Mamba and mLSTM layers x prefills); records each
    prefill's ``moe_drop_frac`` (mean and max over its MoE layers), and
    with ``spy_kernels`` the window of every K2 call and whether K1 read a
    wrapped ring (every key of a row valid at full ring capacity). The spies
    only keep references inside the timed window (each K1 mask is a fresh
    tensor per call); they are reduced after it."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.dataset import SyntheticCorpus
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import Request, ServeLoop
    from repro_torch.models import moe

    run = RunConfig(remat="none", attention_impl="pallas", decode_attention_impl="kernel")
    corpus = SyntheticCorpus(cfg.vocab_size, max(lens), seed=0)
    reqs = [Request(i, corpus.grain_tokens(i, 1)[0][:n], 32) for i, n in enumerate(lens)]
    # the kernel spies are Python, which a replayed decode step does not
    # run: a spying serve builds its loop without warm-up, so no step is
    # captured and every one runs eagerly
    loop = ServeLoop(cfg, run, params, batch=batch, max_len=max_len, mode="arena", warmup=not spy_kernels,
                     device="cuda")
    loop.warm(min(lens))
    drops, windows, wrapped = [], [], []
    moe_apply, flash, decode = moe.moe_apply, ops.flash_attention, ops.decode_attention

    def spy_moe(c, p, x, inference=False, **kw):
        y, aux = moe_apply(c, p, x, inference=inference, **kw)
        if x.shape[1] > 1:
            drops.append(aux["moe_drop_frac"])
        return y, aux

    def spy_flash(*args, **kwargs):
        windows.append(kwargs.get("window", 0))
        return flash(*args, **kwargs)

    def spy_decode(q, k, v, valid, **kwargs):
        wrapped.append(valid)
        return decode(q, k, v, valid, **kwargs)

    patches = [mock.patch.object(moe, "moe_apply", spy_moe)]
    if spy_kernels:
        patches += [mock.patch.object(ops, "flash_attention", spy_flash),
                    mock.patch.object(ops, "decode_attention", spy_decode)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        loop.start(reqs, t0=time.perf_counter())
        while loop.tick() != "done":
            pass
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    stats = loop.stats()
    peak = torch.cuda.max_memory_allocated()
    L = cfg.num_layers
    kinds = [cfg.layer_kind(i) for i in range(L)]
    n_attn, n_scan = kinds.count("attn"), kinds.count("mamba") + kinds.count("mlstm")
    n_moe = sum(cfg.layer_is_moe(i) for i in range(L))
    check(stats["completed"] == len(lens) and all(len(r.tokens) == 32 for r in reqs),
          f"{cfg.name}: {stats['completed']}/{len(lens)} requests with 32 tokens")
    check(stats["decode_calls"] < stats["decode_steps"], f"{cfg.name}: the arena batches decode steps")
    check(stats["prefill_calls"] == len(lens) and launches["flash_attention"] == n_attn * stats["prefill_calls"],
          f"{cfg.name}: K2 launches {launches['flash_attention']} != {n_attn} x {stats['prefill_calls']} prefills")
    check(launches["decode_attention"] == n_attn * stats["decode_calls"],
          f"{cfg.name}: K1 launches {launches['decode_attention']} != {n_attn} x {stats['decode_calls']} decode calls")
    check(stats["decode_graph_replays"] == (0 if spy_kernels else stats["decode_calls"]),
          f"{cfg.name}: {stats['decode_graph_replays']} of {stats['decode_calls']} decode calls replayed")
    check(launches["ssm_scan"] == n_scan * stats["prefill_calls"],
          f"{cfg.name}: K3 launches {launches['ssm_scan']} != {n_scan} x {stats['prefill_calls']} prefills")
    check(len(drops) == n_moe * len(lens), f"{cfg.name}: {len(drops)} MoE prefill calls != {n_moe} x {len(lens)}")
    out = {**stats, "launches": launches, "peak_bytes": peak, "prompt_lens": list(lens), "layers": L,
           "k1_per_decode_call": launches["decode_attention"] / stats["decode_calls"],
           "k2_per_prefill": launches["flash_attention"] / stats["prefill_calls"],
           "k3_per_prefill": launches["ssm_scan"] / stats["prefill_calls"]}
    if n_moe:
        per = torch.stack(drops).view(len(lens), n_moe).float()
        out.update(prefill_drop_frac_mean=per.mean(1).tolist(), prefill_drop_frac_max=per.amax(1).tolist())
    if spy_kernels:
        out["k2_windows"] = sorted(set(windows))
        out["k1_wrapped_calls"] = sum(bool(m.bool().all(dim=1).any()) for m in wrapped)
    print(f"serve {cfg.name} arena batch={batch} max_len={max_len}, {len(lens)} requests (prompts {sorted(set(lens))}, "
          f"gen 32) on {card}: {stats['tokens_per_s']:.1f} tok/s, mean TTFT {stats['mean_ttft_s'] * 1e3:.1f} ms, "
          f"{stats['decode_calls']} decode calls, {stats['prefill_calls']} prefills, occupancy "
          f"{stats['slot_occupancy']:.3f}, wall {stats['wall_s']:.2f} s, peak memory {peak / 2**30:.2f} GiB; "
          f"launches {launches}")
    if n_moe:
        print(f"{cfg.name} moe_drop_frac per prefill (mean over {n_moe} MoE layers): "
              + ", ".join(f"{n}: {d:.4f}" for n, d in zip(lens, out["prefill_drop_frac_mean"])))
    return out


def decode_step_bound(cfg, params, max_len: int, pos: int, card: str) -> dict:
    """A decode step at batch 8 on a fresh arena of ring ``max_len`` whose
    rows sit at ``pos``: eager (host clock) and replayed as a CUDA graph,
    beside its byte bound, from the tensors it must move: every weight but
    the embedding (8 rows of it) and the experts; the experts, all of them
    (as the batched product over E reads them) or only those this step
    routed to; the whole cache read (KV and Mamba state) and the Mamba
    state written (each row's new K and V slot, under 0.01 % of the KV, is
    left out); the logits written."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import model as M
    from repro_torch.models import moe

    dev = torch.device("cuda")
    run = RunConfig(remat="none", attention_impl="pallas", decode_attention_impl="kernel")
    arena = M.init_cache(cfg, 8, max_len, dev)
    arena["pos"].fill_(pos)
    toks = torch.randint(0, cfg.vocab_size, (8, 1), generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    act = torch.ones(8, dtype=torch.bool, device=dev)
    experts_hit = []
    route = moe.route

    def spy(*args, **kwargs):
        r = route(*args, **kwargs)
        experts_hit.append(int(r.top_i.unique().numel()))
        return r

    with mock.patch.object(moe, "route", spy):
        M.decode_step(cfg, run, params, arena, toks, active=act)
    arena["pos"].fill_(pos)
    step_ms = eager_ms(lambda: M.decode_step(cfg, run, params, arena, toks, active=act))
    arena["pos"].fill_(pos)
    step_graph_ms = graph_ms(lambda: M.decode_step(cfg, run, params, arena, toks, active=act), iters=4)

    def nbytes(t):
        return t.numel() * t.element_size()

    e_bytes = [sum(nbytes(blk["moe"][w]) for w in ("gate", "up", "down")) for blk in params["layers"] if "moe" in blk]
    other = sum(nbytes(t) for t in leaves(params)) - sum(e_bytes) - nbytes(params["embed"]) \
        + 8 * cfg.d_model * params["embed"].element_size()
    kv = sum(nbytes(arena[k]) for k in ("k", "v") if k in arena)
    state = sum(nbytes(t) for t in leaves(arena.get("mamba", {})))
    logits_out = 8 * cfg.vocab_size * 2
    routed = sum(b * n / cfg.num_experts for b, n in zip(e_bytes, experts_hit))
    st = {"eager_ms": step_ms, "graph_ms": step_graph_ms, "host_wait": 1 - step_graph_ms / step_ms,
          "bytes_all_experts": other + sum(e_bytes) + kv + 2 * state + logits_out,
          "bytes_routed_experts": other + routed + kv + 2 * state + logits_out,
          "expert_bytes": sum(e_bytes), "other_weight_bytes": other, "kv_bytes": kv, "mamba_state_bytes": state,
          "experts_routed_per_layer_mean": sum(experts_hit) / len(experts_hit)}
    st["bound_ms_all_experts"] = st["bytes_all_experts"] / HBM_BYTES_PER_S * 1e3
    st["bound_ms_routed_experts"] = st["bytes_routed_experts"] / HBM_BYTES_PER_S * 1e3
    print(f"{cfg.name} ({cfg.num_layers} layers) decode step (8 slots at {pos}, ring {max_len}): eager "
          f"{step_ms:.2f} ms, CUDA graph {step_graph_ms:.3f} ms, the eager step waits for the host "
          f"{st['host_wait']:.1%}; byte bound {st['bound_ms_all_experts']:.3f} ms reading every expert "
          f"({st['expert_bytes'] / 1e9:.2f} GB experts, {other / 1e9:.2f} GB other weights, {kv / 1e9:.2f} GB KV, "
          f"{state / 1e9:.3f} GB Mamba state read and written), {st['bound_ms_routed_experts']:.3f} ms reading only "
          f"the routed ones ({st['experts_routed_per_layer_mean']:.1f} of {cfg.num_experts} per layer) ({card})")
    return st


def fp32_cut_check(cut, prompt, max_len: int, what: str, prefix=None) -> dict:
    """``cut``, a config at a cut depth in fp32, on fp32 random weights from
    seed 0: :func:`paths_agree` on ``prompt`` (after ``prefix``), the logits
    within CUT_LOGIT_TOL of the largest |logit| and, for a MoE stack, the
    same routing on both paths. Frees the weights."""
    from repro_torch.models import model as M

    params = M.init_model(cut, torch.Generator(device="cuda").manual_seed(0), dtype=torch.float32)
    agree = paths_agree(cut, params, prompt, max_len, prefix=prefix)
    agree["tol"] = CUT_LOGIT_TOL * max(1.0, agree["max_abs_logit"])
    agree["weights_gb"] = sum(t.numel() * t.element_size() for t in leaves(params)) / 1e9
    del params
    free_card()
    routing = (f"routing identical: {agree['routing_identical']} over {agree['moe_calls']} MoE calls"
               if agree["moe_calls"] else "no MoE")
    print(f"{cut.name} fp32, first {cut.num_layers} layers ({agree['weights_gb']:.1f} GB of weights), kernel vs "
          f"plain ({what}): max abs diff {agree['max_abs_diff']:.4e}, largest |logit| {agree['max_abs_logit']:.3f}, "
          f"tol {agree['tol']:.4e}; {routing}")
    check(agree["sound"] and agree["max_abs_diff"] <= agree["tol"],
          f"{cut.name} fp32 {cut.num_layers}-layer logits kernel vs plain: {agree}")
    check(not agree["moe_calls"] or agree["routing_identical"],
          f"{cut.name} fp32 {cut.num_layers} layers: the two paths route alike: {agree}")
    return agree


def serve_moonshot(card: str) -> dict:
    """moonshot-v1-16b-a3b at full width, bf16: (a) the kernel path against
    the plain path with the weights in fp32, cut to the first MOE_LAYERS
    layers, logits within CUT_LOGIT_TOL and identical routing; (b) the
    48-layer model (random weights from a seeded generator on the card, its
    parameter count equal to ``count_params_exact``) serving 16 prompts
    through one ``ServeLoop`` arena; (c) the decode step at batch 8, eager
    and replayed as a CUDA graph, beside its byte bound; (d) the full-depth
    bf16 logits of both paths finite, and how often they route alike."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cfg = get_config("moonshot-v1-16b-a3b")
    L = cfg.num_layers
    rec = {}
    # (a) fp32, MOE_LAYERS layers: two 512-token prompts (one dispatch group each)
    prompt = torch.randint(0, cfg.vocab_size, (2, 512), generator=torch.Generator(device=dev).manual_seed(1),
                           device=dev)
    rec["fp32_cut"] = fp32_cut_check(dataclasses.replace(cfg, num_layers=MOE_LAYERS, compute_dtype="float32"),
                                     prompt, 520, "prefill 2x512 + 4 decode steps")

    # (b) the full-width serve
    t0 = time.perf_counter()
    params = M.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    rec["params"], rec["init_s"] = n_params, time.perf_counter() - t0
    check(n_params == M.count_params_exact(cfg), f"moonshot: {n_params} params != {M.count_params_exact(cfg)}")
    print(f"init moonshot-v1-16b-a3b ({n_params} params = count_params_exact, "
          f"{M.count_active_params_exact(cfg)} active per token, bf16, "
          f"{n_params * 2 / 1e9:.1f} GB): {rec['init_s']:.1f} s")
    lens = [128, 256, 384, 512] * 3 + [1024] * 4
    rec["serve"] = serve_arena(cfg, params, lens, 1057, 8, card)

    # (c) the decode step at batch 8 (a fresh arena at position 1024)
    rec["step"] = decode_step_bound(cfg, params, 1057, 1024, card)

    # (d) full depth, bf16: finite logits, and how often the paths route alike
    prompt = torch.randint(0, cfg.vocab_size, (2, 512), generator=torch.Generator(device=dev).manual_seed(3),
                           device=dev)
    full = paths_agree(cfg, params, prompt, 520)
    check(full["sound"], f"moonshot bf16 {L}-layer logits finite and of shape (2, 1, vocab): {full}")
    rec["bf16_full"] = full
    print(f"moonshot bf16, all {L} layers, kernel vs plain (prefill 2x512 + 4 decode steps, not checked): max abs "
          f"diff {full['max_abs_diff']:.4f} at largest |logit| {full['max_abs_logit']:.3f}; the paths agree on "
          f"{full['routing_agree']:.4%} of (token, slot) routings over {full['moe_calls']} MoE calls")
    del params
    free_card()
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"the moonshot phase took {rec['phase_s']:.1f} s")
    return rec


def serve_mixtral_cut(card: str) -> dict:
    """mixtral-8x22b at full width, cut to MIXTRAL_LAYERS layers (the only
    cut): (a) the kernel path against the plain path with the weights in
    fp32, cut to MIXTRAL_CHECK_LAYERS layers, on a 6144-token prompt (past
    the 4096 window, so the prefill wraps the ring), logits within
    CUT_LOGIT_TOL and identical routing; (b) bf16, one ``ServeLoop`` arena
    of batch 4 over prompts of 2048, 4096, 6144 and 8192 (multiples of the
    2048 dispatch group, before, at and past the window): K2 runs with
    window 4096 on every prefill and K1 over the wrapped ring."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    full = get_config("mixtral-8x22b")
    cfg = dataclasses.replace(full, num_layers=MIXTRAL_LAYERS)
    rec = {"cut": f"num_layers {full.num_layers} -> {MIXTRAL_LAYERS}; every width as published"}
    print(f"mixtral-8x22b cut: {rec['cut']} (d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, "
          f"{cfg.num_experts} experts top-{cfg.experts_per_token}, d_ff {cfg.ffn_dim}, window {cfg.sliding_window}, "
          f"group {cfg.moe_group_size})")
    prompt = torch.randint(0, cfg.vocab_size, (1, 6144), generator=torch.Generator(device=dev).manual_seed(1),
                           device=dev)
    rec["fp32_cut"] = fp32_cut_check(
        dataclasses.replace(cfg, num_layers=MIXTRAL_CHECK_LAYERS, compute_dtype="float32"), prompt, 6144 + 8,
        "prefill 1x6144 past the window + 4 decode steps over the wrapped ring")

    t0 = time.perf_counter()
    params = M.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dtype=torch.bfloat16)
    torch.cuda.synchronize()
    rec["params"], rec["init_s"] = sum(t.numel() for t in leaves(params)), time.perf_counter() - t0
    check(rec["params"] == M.count_params_exact(cfg), "mixtral cut: parameter count")
    print(f"init mixtral-8x22b cut to {MIXTRAL_LAYERS} layers ({rec['params']} params, bf16, "
          f"{rec['params'] * 2 / 1e9:.1f} GB): {rec['init_s']:.1f} s")
    rec["serve"] = serve_arena(cfg, params, [2048, 4096, 6144, 8192], 8225, 4, card, spy_kernels=True)
    check(rec["serve"]["k2_windows"] == [cfg.sliding_window],
          f"mixtral: every K2 call with window {cfg.sliding_window}: {rec['serve']['k2_windows']}")
    check(rec["serve"]["k1_wrapped_calls"] > 0, "mixtral: K1 ran over a wrapped ring")
    print(f"mixtral: K2 windows {rec['serve']['k2_windows']}; {rec['serve']['k1_wrapped_calls']} K1 calls read a "
          f"wrapped ring ({card})")
    del params
    free_card()
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"the mixtral phase took {rec['phase_s']:.1f} s")
    return rec


def serve_jamba_cut(card: str) -> dict:
    """jamba-1.5-large-398b at full width, cut to JAMBA_LAYERS layers: (a) the
    kernel path against the plain path (K3 against :func:`plain_scan`) with
    the weights in fp32, cut to the first JAMBA_CHECK_LAYERS layers, on two
    1000-token prompts; (b) bf16, JAMBA_CUT_PARAMS parameters, serving
    JAMBA_LENS through one arena of batch 8 (K3 = 3 x prefills, K2 =
    prefills, K1 = decode calls; each prefill's dropped share); (c) a
    parked row's position, KV and four Mamba tensors left bit for bit by a
    decode step that advances the other row; (d) the decode step at batch
    8, eager and as a CUDA graph, beside its byte bound."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import model as M

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    full = get_config("jamba-1.5-large-398b")
    cfg = dataclasses.replace(full, num_layers=JAMBA_LAYERS)
    blocks = [f"{cfg.layer_kind(i)} + {'MoE' if cfg.layer_is_moe(i) else 'dense FFN'}" for i in range(JAMBA_LAYERS)]
    rec = {"cut": f"num_layers {full.num_layers} -> {JAMBA_LAYERS}; every width as published", "blocks": blocks}
    print(f"jamba-1.5-large-398b cut: {rec['cut']} ({', '.join(blocks)}; d_model {cfg.d_model}, d_inner "
          f"{cfg.d_inner}, d_state {cfg.d_state}, {cfg.num_heads}/{cfg.num_kv_heads} heads, {cfg.num_experts} "
          f"experts top-{cfg.experts_per_token}, d_ff {cfg.ffn_dim}, group {cfg.moe_group_size})")
    prompt = torch.randint(0, cfg.vocab_size, (2, 1000), generator=torch.Generator(device=dev).manual_seed(1),
                           device=dev)
    rec["fp32_cut"] = fp32_cut_check(
        dataclasses.replace(cfg, num_layers=JAMBA_CHECK_LAYERS, compute_dtype="float32"), prompt, 1008,
        "prefill 2x1000 + 4 decode steps; K3 against the plain scan summed in fp64")

    t0 = time.perf_counter()
    params = M.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dtype=torch.bfloat16)
    torch.cuda.synchronize()
    rec["params"], rec["init_s"] = sum(t.numel() for t in leaves(params)), time.perf_counter() - t0
    check(rec["params"] == M.count_params_exact(cfg) == JAMBA_CUT_PARAMS,
          f"jamba cut: {rec['params']} params, count_params_exact {M.count_params_exact(cfg)}, {JAMBA_CUT_PARAMS}")
    print(f"init jamba-1.5-large-398b cut to {JAMBA_LAYERS} layers ({rec['params']} params = count_params_exact, "
          f"bf16, {rec['params'] * 2 / 1e9:.1f} GB): {rec['init_s']:.1f} s")
    rec["serve"] = serve_arena(cfg, params, JAMBA_LENS, JAMBA_MAX_LEN, 8, card)
    sv = rec["serve"]
    print(f"jamba: {sv['k3_per_prefill']:g} K3, {sv['k2_per_prefill']:g} K2 per prefill, {sv['k1_per_decode_call']:g} "
          f"K1 per decode call ({card})")

    # (c) a parked row: two 300-token prompts, one decode step with row 1 parked
    run = RunConfig(remat="none", attention_impl="pallas", decode_attention_impl="kernel")
    gen = torch.Generator(device=dev).manual_seed(2)
    _, cache = M.prefill(cfg, run, params, torch.randint(0, cfg.vocab_size, (2, 300), generator=gen, device=dev), 320)

    def row(i):
        return [cache["pos"][i], cache["k"][:, i], cache["v"][:, i]] + [t[:, i] for t in cache["mamba"].values()]

    before, row0 = [t.clone() for t in row(1)], [t.clone() for t in row(0)]
    tok = torch.randint(0, cfg.vocab_size, (2, 1), generator=gen, device=dev)
    M.decode_step(cfg, run, params, cache, tok, active=torch.tensor([True, False], device=dev))
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(row(1), before)),
          "jamba: a parked row's position, KV and Mamba state (conv_x, conv_b, conv_c, ssm) are untouched")
    check(not any(torch.equal(a, b) for a, b in zip(row(0)[3:], row0[3:])), "jamba: the active row's Mamba state moved")
    rec["parked_row_bit_identical"] = True
    print("jamba parked row: position, KV and the four Mamba tensors bit-identical; the active row's moved")
    del cache

    # (d) the decode step at batch 8 (a fresh arena at position 4096)
    rec["step"] = decode_step_bound(cfg, params, JAMBA_MAX_LEN, 4096, card)
    del params
    free_card()
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"the jamba phase took {rec['phase_s']:.1f} s")
    return rec


def serve_frontend(arch: str, lens, batch: int, max_len: int, card: str) -> dict:
    """``arch`` (musicgen-medium or llava-next-34b) at full width: (a) the
    kernel path against the plain path with the weights in fp32, cut to the
    first FRONTEND_CHECK_LAYERS layers, on PREFIX_LEN seeded prefix features
    before a 256-token prompt, then 4 decode steps; (b) bf16, its parameter
    count equal to ``count_params_exact``, serving ``lens`` through one arena
    of ``batch`` on tokens alone, as the serving loop takes them; (c) a
    prefill of PREFIX_LEN seeded bf16 features (128-dim audio frames or
    1152-dim vision patches) before a FRONTEND_PROMPT-token prompt: every K2
    call at Sq = PREFIX_LEN + FRONTEND_PROMPT; then 4 decode steps through
    K1 from that cache, the logits finite."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cfg = get_config(arch)
    feat = M.FRONTEND_FEATURE_DIM[cfg.frontend]
    rec = {"frontend": cfg.frontend, "feature_dim": feat}
    print(f"{arch}: {cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
          f"{cfg.head_dim_}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; frontend {cfg.frontend} ({feat}-dim features)")
    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (2, 256), generator=gen, device=dev)
    prefix = torch.randn(2, PREFIX_LEN, feat, generator=gen, device=dev)
    rec["fp32_cut"] = fp32_cut_check(
        dataclasses.replace(cfg, num_layers=FRONTEND_CHECK_LAYERS, compute_dtype="float32"), prompt,
        PREFIX_LEN + 256 + 8, f"prefill of {PREFIX_LEN} prefix features + 2x256 tokens + 4 decode steps",
        prefix=prefix)

    t0 = time.perf_counter()
    params = M.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dtype=torch.bfloat16)
    torch.cuda.synchronize()
    rec["params"], rec["init_s"] = sum(t.numel() for t in leaves(params)), time.perf_counter() - t0
    check(rec["params"] == M.count_params_exact(cfg), f"{arch}: parameter count")
    print(f"init {arch} ({rec['params']} params = count_params_exact, bf16, {rec['params'] * 2 / 1e9:.1f} GB): "
          f"{rec['init_s']:.1f} s")
    rec["serve"] = serve_arena(cfg, params, lens, max_len, batch, card)

    # (c) the prefix prefill, then decode steps on its cache
    run = RunConfig(remat="none", attention_impl="pallas", decode_attention_impl="kernel")
    tokens = torch.randint(0, cfg.vocab_size, (1, FRONTEND_PROMPT), generator=gen, device=dev)
    feats = torch.randn(1, PREFIX_LEN, feat, generator=gen, device=dev).to(torch.bfloat16)
    seen = []
    flash = ops.flash_attention

    def spy(q, *args, **kwargs):
        seen.append(q.shape[1])
        return flash(q, *args, **kwargs)

    seq = PREFIX_LEN + FRONTEND_PROMPT
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    with mock.patch.object(ops, "flash_attention", spy):
        logits, cache = M.prefill(cfg, run, params, tokens, seq + 8, prefix_features=feats)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    sound = bool(torch.isfinite(logits).all())
    for _ in range(4):
        logits, cache = M.decode_step(cfg, run, params, cache, torch.argmax(logits[:, -1], dim=-1, keepdim=True))
        sound &= bool(torch.isfinite(logits).all())
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    L = cfg.num_layers
    check(seen == [seq] * L and launches["flash_attention"] == L,
          f"{arch}: every K2 call of the prefix prefill at Sq = {PREFIX_LEN} + {FRONTEND_PROMPT}: {sorted(set(seen))}")
    check(launches["decode_attention"] == 4 * L and int(cache["pos"][0]) == seq + 4 and sound,
          f"{arch}: 4 decode steps after the prefix prefill, finite logits: {launches}, pos {cache['pos'].tolist()}")
    rec["prefix_prefill"] = {"k2_sq": seq, "k2_calls": launches["flash_attention"], "prefill_s": prefill_s,
                             "k1_calls": launches["decode_attention"], "logits_finite": sound}
    print(f"{arch} prefix prefill ({PREFIX_LEN} {cfg.frontend} + {FRONTEND_PROMPT} tokens, bf16): {L} K2 calls at "
          f"Sq {seq}, {prefill_s * 1e3:.1f} ms on the host clock; 4 decode steps, {launches['decode_attention']} K1 "
          f"calls, logits finite ({card})")
    del params, cache, logits
    free_card()
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"the {arch} phase took {rec['phase_s']:.1f} s")
    return rec


def mamba_scan_inputs(gen, B: int, S: int, dtype):
    """K3's inputs in the model layout as the Mamba-2 block builds them at
    jamba's width (``K3_MAMBA_SHAPE``: 128 heads of P = 128, N = 64), on
    ``gen``'s device: x in the compute dtype; dt = softplus(u + dt_bias),
    dt_bias in [-4, -1]; loga = -dt A per head, A in [1, e^1.3] (down to
    about -11 a step); b = B_t dt rounded to the compute dtype; c = C_t, the
    same for every head (a broadcast view, as the block hands it)."""
    H, P, N = K3_MAMBA_SHAPE
    dev = gen.device
    x = torch.randn(B, S, H, P, generator=gen, device=dev).to(dtype)
    bias = torch.rand(H, generator=gen, device=dev) * 3 - 4
    a = torch.exp(torch.rand(H, generator=gen, device=dev) * 1.3)
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=gen, device=dev) + bias)
    b = (torch.randn(B, S, 1, N, generator=gen, device=dev) * dt[..., None]).to(dtype)
    c = torch.randn(B, S, 1, N, generator=gen, device=dev).to(dtype).expand(B, S, H, N)
    return x, dt * -a, b, c


def k3_mamba(gen, card: str) -> dict:
    """K3 at the Mamba-2 layout of jamba (:func:`mamba_scan_inputs`, folded)
    against :func:`k3_exact`, bf16 and fp32, over one prompt of 1000 tokens
    (pads to 1024) and one of 4096: h against each element's own scale
    (K3_TOL), y against the magnitude of the terms it sums (K3_TERMS_TOL,
    as phase 5's "loga ~ -5" case: at Mamba's decays, down to e^-11 a step,
    a row of y is nearly c_t . b_t times x_t and cancels with that dot
    product, so its own scale falls up to ~5000 times below the terms;
    scripts/k3_precision.py), its scaled error reported; then, at two
    1000-token prompts in bf16, :func:`k3_bit_checks` with each prompt's
    rows called alone; and timed at the 4096-token prefill (bf16): the
    kernel on inputs folded in advance, beside its bound and the plain
    version, and ``ops.ssm_scan`` on the block's own inputs, which is what
    one Mamba layer of a jamba prefill pays (fold's padding, transposes and
    copies of the broadcast c, the kernel, unfold)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssm_scan import fold, ssm_scan_cuda, ssm_scan_plain

    t_phase = time.perf_counter()
    H, P, N = K3_MAMBA_SHAPE
    rec = {"err": {}, "fail": []}
    for dtype in (torch.bfloat16, torch.float32):
        for S in K3_MAMBA_SEQS:
            f = fold(*mamba_scan_inputs(gen, 1, S, dtype), 256)
            y, h = ssm_scan_cuda(*f, 256)
            ye, he = k3_exact(*f, 256)
            torch.cuda.synchronize()
            ty, sy, sh = terms_err(y, ye, k3_terms(*f, 256)), scaled_err(y, ye), scaled_err(h, he)
            rec["err"][f"{dtype}, S {S}"] = {"y_over_terms": ty, "h": sh, "y_scaled": sy}
            print(f"K3 vs plain at the Mamba shape (x {tuple(f[0].shape)}, b, c {tuple(f[2].shape)}, c shared by "
                  f"the heads) {dtype}, S {S}: y over the terms {ty:.3e} (tol {K3_TERMS_TOL[dtype]:.0e}), scaled "
                  f"err y {sy:.3e}, h {sh:.3e} (tol {K3_TOL[torch.float32]:.0e})")
            if not (ty <= K3_TERMS_TOL[dtype] and sh <= K3_TOL[torch.float32]):
                rec["fail"].append(f"{dtype}, S {S}")
            del f, y, h, ye, he
    check(not rec["fail"], f"K3 vs plain at the Mamba shape: {rec['fail']}")
    f = fold(*mamba_scan_inputs(gen, 2, K3_MAMBA_SEQS[0], torch.bfloat16), 256)
    rec["bits"] = k3_bit_checks(f, H)
    print(f"K3 at the Mamba shape, two prompts (x {tuple(f[0].shape)}), bit for bit: {rec['bits']}")
    check(all(rec["bits"].values()), f"K3 bits at the Mamba shape: {rec['bits']}")
    del f

    # timed at one 4096-token prefill, bf16. The bound: the bytes the
    # function must move (x, loga, b per head, c once per token, as the
    # block has them; y and h written once) and its operations (C B^T and
    # W X on the causal half, C h and the state update in full) at the bf16
    # peak. The kernel is handed c folded, one copy per head: those bytes
    # are reported beside it, not counted in the bound.
    S, L = K3_MAMBA_SEQS[-1], 256
    x, loga, b, c = mamba_scan_inputs(gen, 1, S, torch.bfloat16)
    f = fold(x, loga, b, c, L)
    bh = f[0].shape[0]
    c_token = c.shape[0] * S * N * c.element_size()
    nbytes = sum(t.numel() * t.element_size() for t in (x, loga, b)) + c_token \
        + x.numel() * x.element_size() + bh * N * P * 4
    tri = L * (L + 1) // 2
    flops = bh * (S // L) * (2 * tri * N + 2 * tri * P + 4 * L * N * P)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    launches = ops.LAUNCHES["ssm_scan"]
    rec["times"] = {"shape": f"x {tuple(f[0].shape)} bf16, loga fp32, b, c {tuple(f[2].shape)} bf16; chunk 256",
                    "ms": graph_ms(lambda: ssm_scan_cuda(*f, 256), iters=5),
                    "eager_ms": timed_ms(lambda: ssm_scan_cuda(*f, 256), iters=5),
                    "with_fold_ms": graph_ms(lambda: ops.ssm_scan(x, loga, b, c, L), iters=5),
                    "with_fold_eager_ms": timed_ms(lambda: ops.ssm_scan(x, loga, b, c, L), iters=5),
                    "plain_ms": timed_ms(lambda: ssm_scan_plain(*f, 256), iters=3), "library_ms": None,
                    "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "bytes": nbytes, "c_per_head_bytes": f[3].numel() * f[3].element_size(), "flops": flops,
                    "tf32_split_floor_ms": 2 * flops / TF32_FLOPS * 1e3}
    ops.LAUNCHES["ssm_scan"] = launches  # the timing's calls are no path's launches
    t = rec["times"]
    print(f"K3 at the Mamba shape ({t['shape']}): {t['ms']:.5f} ms device (graph replay), eager {t['eager_ms']:.5f} "
          f"ms, bound {t['bound_ms']:.5f} ms by {t['bound_by']} ({nbytes / 1e6:.1f} MB with c once per token; c "
          f"folded per head is {t['c_per_head_bytes'] / 1e6:.1f} MB; {flops / 1e9:.2f} GFLOP; split TF32 floor "
          f"{t['tf32_split_floor_ms']:.5f} ms), plain {t['plain_ms']:.4f} ms; ops.ssm_scan on the block's inputs "
          f"(fold, kernel, unfold: one Mamba layer of a 4096-token prefill) {t['with_fold_ms']:.5f} ms device, "
          f"{t['with_fold_eager_ms']:.5f} ms eager ({card})")
    del x, loga, b, c, f
    free_card()
    rec["phase_s"] = time.perf_counter() - t_phase
    return rec


# -- 17. training --------------------------------------------------------
# qwen3-1.7b at full width through repro_torch.launch.train.main: pods of
# speed 1.0 and 0.5, microbatches of 2 x 1024 tokens, 3 a step (schedule
# (2, 1)), the trainer's own lr (3e-4 after 5 warmup steps). A step's loss
# is its last microbatch's: 2048 tokens of the synthetic corpus (each
# sequence an arithmetic progression mod 151,936 from a random start, its
# step below 16, 2% of tokens replaced at random). From random weights
# that loss moves by about 0.04 from batch to batch, more than 6 steps
# teach (0.014 on held-out batches). So the check that training lowers
# the loss is made on HELD_OUT fixed microbatches (another seed), their
# mean loss taken before the first step and after each one.
TRAIN_ARGS = ["--arch", "qwen3-1.7b", "--steps", "6", "--batch", "2", "--seq", "1024", "--microbatches", "3",
              "--pods", "1.0,0.5", "--log-every", "100", "--device", "cuda"]
HELD_OUT, HELD_OUT_SEED = 4, 99
# K2's gradient (the kernel's forward, the reference's recompute backward)
# against autograd through the plain forward, at qwen3's training shape (B,
# S, H, KH, head_dim) and at a window with a query offset, each gradient's
# largest error over its largest |g| (at least 1): fp32 1e-5 (one fp32
# function differentiated two ways, its sums in another order); bf16
# BF16_TOL, the forward's limit (both round the same fp32 gradients to
# bf16, one unit apart at most). Each element besides against its own
# scale (scaled_err), ATTN_SCALED_TOL as the forward's output.
K2_TRAIN_SHAPE = (2, 1024, 16, 8, 128)
K2_GRAD_CASES = ((K2_TRAIN_SHAPE, 0, 0), ((1, 100, 4, 2, 128), 70, 1024))
K2_GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: BF16_TOL}
# the fp32 one-step check at a cut depth: the loss to 1e-5 of itself and
# every gradient to TRAIN_GRAD_TOL of its leaf's largest |g|, kernel path
# (K2, recompute backward) against the plain path (chunked attention under
# autograd). Both differentiate one fp32 function with sums in other
# orders; a wrong mask, scale or head mapping in either direction moves a
# gradient by O(|g|). The sound path read 4.5e-6 on an H100; the limit
# sits 22x above that, a decade below an error of 1e-3 of a leaf's scale.
TRAIN_CUT_LAYERS, TRAIN_GRAD_TOL = 2, 1e-4
SMOKE_D_MODEL = 256  # the checkpoint and elastic runs: qwen3-1.7b-smoke with heads of 64


def named_leaves(tree, path=""):
    """(path, tensor) in the order of ``models/common.py::tree_leaves``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from named_leaves(t, f"{path}/{i}")
    else:
        yield path, tree


def k2_grad_check(gen, shape, dtype, window: int = 0, q_offset: int = 0) -> dict:
    """``ops.flash_attention`` on CUDA tensors that require a gradient: the
    output has a ``grad_fn``, one K2 launch and none in the backward; dq,
    dk and dv keep the inputs' dtype and are held against autograd through
    :func:`flash_attention_plain` on the same inputs and cotangent. Returns
    each gradient's error over its largest |g| (``err``), its scaled error
    and whether it passes ``K2_GRAD_TOL`` and ``ATTN_SCALED_TOL``."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_plain

    B, S, H, KH, D = shape
    sk = S + q_offset
    q, g = (torch.randn(B, S, H, D, generator=gen, device="cuda").to(dtype) for _ in range(2))
    k, v = (torch.randn(B, sk, KH, D, generator=gen, device="cuda").to(dtype) for _ in range(2))
    got = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(*got, q_offset=q_offset, window=window)
    has_grad_fn, fwd = out.grad_fn is not None, ops.LAUNCHES["flash_attention"] - before
    out.backward(g)
    bwd = ops.LAUNCHES["flash_attention"] - before - fwd
    flash_attention_plain(*ref, q_offset=q_offset, window=window, scale=D**-0.5).backward(g)
    torch.cuda.synchronize()
    res = {"shape": list(shape), "window": window, "q_offset": q_offset, "dtype": str(dtype), "tol": K2_GRAD_TOL[dtype],
           "grad_fn": has_grad_fn, "forward_launches": fwd, "backward_launches": bwd,
           "dtype_kept": all(t.grad is not None and t.grad.dtype == dtype for t in got), "err": {}, "scaled": {}}
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        if a.grad is None:
            res["err"][name] = res["scaled"][name] = float("inf")
            continue
        res["err"][name] = float((a.grad.float() - b.grad.float()).abs().max()) / max(1.0, float(b.grad.abs().max()))
        res["scaled"][name] = scaled_err(a.grad, b.grad)
    res["ok"] = (has_grad_fn and fwd == 1 and bwd == 0 and res["dtype_kept"]
                 and max(res["err"].values()) <= K2_GRAD_TOL[dtype]
                 and max(res["scaled"].values()) <= ATTN_SCALED_TOL[dtype])
    return res


@contextlib.contextmanager
def stepping(cfg, held_losses: list, walls: list, held_out: int = HELD_OUT):
    """Patch ``HetCoordinator.step`` to record the host seconds of each
    global step (the step ends in a host sync: its metrics) in ``walls``,
    and the mean loss of ``held_out`` fixed microbatches of 2 x 1024 tokens
    (seed HELD_OUT_SEED; a frontend's 8 prefix features before them, as
    the trainer feeds them) before the first step and after each in
    ``held_losses``, on the plain path: chunked attention, the plain scan
    (:func:`plain_scan`) and the sLSTM block as it was when this was
    entered, so no kernel launches and no span is recorded there."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.coordinator import HetCoordinator
    from repro_torch.data.dataset import batch_iterator
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models import ssm

    batches = batch_iterator(cfg, 1024, 2, seed=HELD_OUT_SEED, frontend_prefix=8 if cfg.frontend else 0)
    held = [b for _, b in zip(range(held_out), batches)]
    plain_run = RunConfig(remat="none", attention_impl="chunked")
    coord_step, slstm = HetCoordinator.step, ssm.slstm_apply_full

    @torch.no_grad()
    def held_out_loss(params):
        total = 0.0
        dev = params["embed"].device
        with mock.patch.object(ops, "ssm_scan", plain_scan), mock.patch.object(ssm, "slstm_apply_full", slstm):
            for b in held:
                b = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
                logits, aux = M.forward(cfg, plain_run, params, b["tokens"].long(), b.get("prefix_features"))
                total += float(M.lm_loss(cfg, plain_run, logits[:, :-1], b["labels"][:, 1:].long(), None, aux)[0])
        return total / len(held)

    def step(self, params, *args):
        if not held_losses:
            held_losses.append(held_out_loss(params))
        t = time.perf_counter()
        res = coord_step(self, params, *args)
        walls.append(time.perf_counter() - t)
        held_losses.append(held_out_loss(res[0]))
        return res

    with mock.patch.object(HetCoordinator, "step", step):
        yield


class _BackwardMark(torch.autograd.Function):
    """The identity, recording a CUDA event into ``sink`` when its
    gradient passes in the backward."""

    @staticmethod
    def forward(ctx, x, sink):
        ctx.sink = sink
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        ctx.sink.append(event)
        return g, None


def spanned(spans: dict, key: str, fn, backward: bool = False, training_only: bool = True):
    """``fn`` with CUDA events around each call, appended as a pair to
    ``spans[key]`` (with ``training_only``, calls with gradients off, such
    as a held-out loss's, are not recorded). With ``backward`` (for a block
    ``fn(cfg, params, x)``), also the span of its backward, from the
    gradient reaching its output to the gradient leaving for x, in
    ``spans[key + "_bwd"]`` (the residual add around the block is outside
    both)."""
    def call(*args, **kwargs):
        if training_only and not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        ends, starts = [], []
        if backward:
            args = (*args[:2], _BackwardMark.apply(args[2], ends), *args[3:])
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn(*args, **kwargs)
        b.record()
        spans[key].append((a, b))
        if backward:
            out = _BackwardMark.apply(out, starts)
            spans[key + "_bwd"].append((starts, ends))
        return out
    return call


def timed_train(argv, cfg, spies: dict, held_out: int = HELD_OUT, blocks: dict | None = None) -> dict:
    """``repro_torch.launch.train.main(argv)`` with CUDA events around each
    grad microbatch, each update and each call of ``spies`` (key ->
    (module, name)), and, for each of ``blocks`` (key -> (module, name) of
    a block function), around its forward and its backward; the host clock
    around each global step; held-out losses as :func:`stepping` takes
    them; each microbatch's metrics; whether the first microbatch gave
    every leaf a non-zero gradient; the launches and the peak. Returns the
    record, with each span's share of a microbatch and its median ms over
    the microbatches after the first step's (those warm up)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod
    from repro_torch.models import model as M
    from repro_torch.optim import adamw

    blocks = blocks or {}
    spans = {"grad": [], "update": [], **{k: [] for k in spies}, **{k + s: [] for k in blocks for s in ("", "_bwd")}}
    walls, zero_grads, mb_metrics, mb_tokens, held_losses = [], {}, [], [], []
    make = train_mod.make_grad_step

    def make_timed(cfg_, run):
        step = spanned(spans, "grad", make(cfg_, run), training_only=False)

        def grad_step(params, batch):
            grads_, metrics = step(params, batch)
            mb_metrics.append(metrics)
            mb_tokens.append(batch["labels"].size)  # a frontend's prefix positions included
            if not zero_grads:  # once, outside the timed span: every leaf got a gradient
                named = list(named_leaves(grads_))
                nonzero = torch.stack([(t != 0).any() for _, t in named]).tolist()
                zero_grads.update(leaves=len(named), zero=[p for (p, _), nz in zip(named, nonzero) if not nz])
            return grads_, metrics
        return grad_step

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(stepping(cfg, held_losses, walls, held_out))
        stack.enter_context(mock.patch.object(train_mod, "make_grad_step", make_timed))
        stack.enter_context(mock.patch.object(adamw, "adamw_update", spanned(spans, "update", adamw.adamw_update,
                                                                             training_only=False)))
        for key, (mod, name) in spies.items():
            # a backward runs with gradients off: its spans are recorded always
            stack.enter_context(mock.patch.object(mod, name, spanned(spans, key, getattr(mod, name),
                                                                     training_only=not key.endswith("_bwd"))))
        for key, (mod, name) in blocks.items():
            stack.enter_context(mock.patch.object(mod, name, spanned(spans, key, getattr(mod, name), backward=True)))
        res = train_mod.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, peak = dict(ops.LAUNCHES), torch.cuda.max_memory_allocated()
    ms = {k: [a.elapsed_time(b) if isinstance(a, torch.cuda.Event) else a[0].elapsed_time(b[0]) for a, b in v]
          for k, v in spans.items()}
    hist = res["history"]
    mbs = len(ms["grad"])
    first_mb = sum(hist[0]["schedule"])
    steady = range(first_mb, mbs)
    rec = {
        "args": argv, "params": M.count_params_exact(cfg), "losses": [h["loss"] for h in hist],
        "held_out_losses": held_losses, "grad_norms": [h["grad_norm"] for h in hist],
        "schedules": [h["schedule"] for h in hist], "virtual_s": [h["virtual_s"] for h in hist],
        "homo_s": [h["homo_s"] for h in hist], "grad_microbatches": mbs, "launches": launches, "peak_bytes": peak,
        "wall_s": wall, "step_wall_s": walls, "microbatch_ms": ms["grad"], "update_ms": ms["update"],
        "microbatch_ms_median": float(np.median([ms["grad"][i] for i in steady])),
        "update_ms_median": float(np.median(ms["update"][1:])), "step_s_median": float(np.median(walls[1:])),
        "microbatch_metrics": [{k: float(v) for k, v in m.items()} for m in mb_metrics],
        "zero_grad_leaves": zero_grads, "calls": {}, "share": {}, "ms_median": {},
    }
    rec["tokens_per_s"] = sum(mb_tokens) / len(hist) / rec["step_s_median"]
    for key in ms.keys() - {"grad", "update"}:
        n, rem = divmod(len(ms[key]), mbs)
        rec["calls"][key] = len(ms[key])
        if n and not rem:  # the same number of calls in every microbatch
            rec["share"][key] = float(np.mean([sum(ms[key][i * n:(i + 1) * n]) / ms["grad"][i] for i in steady]))
            rec["ms_median"][key] = float(np.median(ms[key][first_mb * n:]))
    return rec


def print_train(name: str, rec: dict, card: str) -> None:
    for i, (loss, norm, sched) in enumerate(zip(rec["losses"], rec["grad_norms"], rec["schedules"])):
        print(f"train {name} step {i}: loss {loss:.4f}, grad norm {norm:.4f}, schedule {sched}, het "
              f"{rec['virtual_s'][i]:.2f} s, homo {rec['homo_s'][i]:.2f} s (virtual)")
    parts = "; ".join(f"{rec['calls'][k] // rec['grad_microbatches']} x {k} {rec['share'][k]:.1%} of a microbatch "
                      f"({rec['ms_median'][k]:.4f} ms each)" for k in sorted(rec["share"]))
    print(f"train {name} ({rec['params']} params, fp32 master weights, bf16 compute; {' '.join(rec['args'])}) on "
          f"{card}: {rec['microbatch_ms_median']:.1f} ms per grad microbatch, {rec['update_ms_median']:.1f} ms per "
          f"update, {rec['step_s_median']:.3f} s per step, {rec['tokens_per_s']:.0f} tok/s, peak "
          f"{rec['peak_bytes'] / 2**30:.2f} GiB; {parts}; launches {rec['launches']}")
    print(f"train {name} held-out loss before the first step and after each: "
          + ", ".join(f"{x:.4f}" for x in rec["held_out_losses"]))


def check_train(name: str, rec: dict, cfg, kernel: str, per_microbatch: int, falls: bool = False) -> None:
    """Finite losses and held-out losses (with ``falls``, a held-out loss
    that falls), ``kernel`` launched ``per_microbatch`` times a grad
    microbatch (a forward each), and a non-zero gradient for every
    parameter. Three steps, as phases 18 and 19 run, are still in the
    learning-rate warmup (5 steps) and move the held-out loss less than
    it moves between batches, so only phase 17's six steps are held to a
    fall."""
    from repro_torch.models import model as M

    losses, held = rec["losses"], rec["held_out_losses"]
    check(all(np.isfinite(losses + held)) and len(held) == len(losses) + 1 and (held[-1] < held[0] or not falls),
          f"{name} training: losses {losses}, held-out losses {held}")
    check(rec["launches"][kernel] == per_microbatch * rec["grad_microbatches"],
          f"{name}: {kernel} launches {rec['launches'][kernel]} != {per_microbatch} x {rec['grad_microbatches']} "
          "grad microbatches")
    check(rec["zero_grad_leaves"].get("leaves") == len(list(named_leaves(M.model_defs(cfg))))
          and not rec["zero_grad_leaves"]["zero"], f"{name}: every parameter got a non-zero gradient: "
          f"{rec['zero_grad_leaves']}")


def train_phase(card: str) -> dict:
    """Phase 17 (run after the large serves, while the card holds nothing
    else; frees everything at its end): K2's gradient at the training
    shape; qwen3-1.7b trained at full width through ``launch.train.main``
    (CUDA events around each grad microbatch, each update, each K2 forward
    and each recompute backward; the host clock around each global step);
    the fp32 one-step check at a cut depth; the int8 + error-feedback
    combine at that depth; a checkpoint of CUDA tensors restored bit for
    bit with a node lost, and a smoke run that loses a pod at step 3 and
    restores."""
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.dataset import batch_iterator
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.steps import make_grad_step, make_train_step
    from repro_torch.models import model as M
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.optim import adamw

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(17)
    # -- K2's gradient ------------------------------------------------------
    grads = [k2_grad_check(gen, shape, dtype, window=win, q_offset=off)
             for shape, win, off in K2_GRAD_CASES for dtype in (torch.bfloat16, torch.float32)]
    for r in grads:
        print(f"K2 gradient (kernel forward, recompute backward) vs autograd through the plain forward, "
              f"{r['dtype']}, shape {r['shape']}, window {r['window']}, offset {r['q_offset']}: over the largest "
              f"|g| {', '.join(f'{n} {e:.3e}' for n, e in r['err'].items())} (tol {r['tol']}); "
              f"scaled {', '.join(f'{n} {e:.3e}' for n, e in r['scaled'].items())}; grad_fn {r['grad_fn']}, "
              f"launches {r['forward_launches']} forward, {r['backward_launches']} backward")
    check(all(r["ok"] for r in grads), f"K2 gradient vs plain autograd: {[r for r in grads if not r['ok']]}")
    out["k2_grad"] = grads
    free_card()

    # -- qwen3-1.7b at full width through train.main ------------------------
    cfg = get_config("qwen3-1.7b")
    L = cfg.num_layers
    train = timed_train(TRAIN_ARGS, cfg, {"k2_fwd": (ops, "flash_attention"),
                                          "k2_bwd": (ops, "flash_attention_ref_vjp")})
    print_train("qwen3-1.7b", train, card)
    check_train("qwen3-1.7b", train, cfg, "flash_attention", L, falls=True)
    check(train["grad_microbatches"] == 18 and all(h == [2, 1] for h in train["schedules"]),
          f"qwen3-1.7b training schedules {train['schedules']}, {train['grad_microbatches']} grad microbatches")
    check(train["calls"]["k2_fwd"] == train["calls"]["k2_bwd"] == L * train["grad_microbatches"],
          f"K2 forwards and recompute backwards {train['calls']} != {L} x {train['grad_microbatches']}")
    out["train"] = train
    free_card()

    # -- the fp32 one-step check at a cut depth -----------------------------
    cut = dataclasses.replace(cfg, num_layers=TRAIN_CUT_LAYERS, compute_dtype="float32")
    params = M.init_model(cut, torch.Generator(device="cuda").manual_seed(0))
    batch = next(batch_iterator(cut, 1024, 2, seed=0))
    ops.reset_launches()
    gk, mk = make_grad_step(cut, RunConfig(remat="none", attention_impl="pallas"))(params, batch)
    k2_cut = ops.LAUNCHES["flash_attention"]
    gp, mp = make_grad_step(cut, RunConfig(remat="none", attention_impl="chunked"))(params, batch)
    worst = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(tree_leaves(gk), tree_leaves(gp)))
    dloss = abs(float(mk["loss"]) - float(mp["loss"]))
    out["fp32_cut"] = {"layers": TRAIN_CUT_LAYERS, "loss": float(mp["loss"]), "loss_diff": dloss,
                       "grad_worst_over_leaf_scale": worst, "tol": TRAIN_GRAD_TOL, "k2_launches": k2_cut}
    print(f"qwen3-1.7b fp32, {TRAIN_CUT_LAYERS} layers, one grad step on 2 x 1024 tokens, kernel path vs plain "
          f"path: loss {float(mp['loss']):.6f}, diff {dloss:.3e}; worst gradient {worst:.3e} of its leaf's "
          f"largest |g| (tol {TRAIN_GRAD_TOL}); K2 launches {k2_cut}")
    check(k2_cut == TRAIN_CUT_LAYERS and dloss <= 1e-5 * abs(float(mp["loss"])) and worst <= TRAIN_GRAD_TOL,
          f"fp32 cut training step, kernel vs plain: {out['fp32_cut']}")
    del params, gk, gp
    free_card()

    # -- the int8 + error-feedback combine at the cut depth -----------------
    ops.reset_launches()
    cheld = []
    with stepping(dataclasses.replace(cfg, num_layers=TRAIN_CUT_LAYERS), cheld, []):
        res = train_mod.main(["--arch", "qwen3-1.7b", "--layers", str(TRAIN_CUT_LAYERS), "--steps", "5",
                              "--batch", "2", "--seq", "1024", "--microbatches", "3", "--pods", "1.0,0.5",
                              "--compress", "--log-every", "100", "--device", "cuda"])
    closses = [h["loss"] for h in res["history"]]
    out["compressed_cut"] = {"layers": TRAIN_CUT_LAYERS, "losses": closses, "held_out_losses": cheld,
                             "launches": dict(ops.LAUNCHES)}
    print(f"qwen3-1.7b, {TRAIN_CUT_LAYERS} layers, int8 + error-feedback combine over pods 1.0 and 0.5: losses "
          + ", ".join(f"{x:.4f}" for x in closses) + "; held-out before the first step and after each: "
          + ", ".join(f"{x:.4f}" for x in cheld))
    check(all(np.isfinite(closses + cheld)) and cheld[-1] < cheld[0]
          and ops.LAUNCHES["flash_attention"] == TRAIN_CUT_LAYERS * 3 * 5,
          f"compressed combine trains: {out['compressed_cut']}")
    del res
    free_card()

    # -- checkpoints of CUDA tensors; elastic restore at smoke size ---------
    # qwen3-1.7b-smoke at d_model 256: its 4 heads are then 64 wide, the
    # narrowest head K2 takes (the smoke config's own 16 it refuses)
    smoke = dataclasses.replace(get_config("qwen3-1.7b-smoke"), d_model=SMOKE_D_MODEL, head_dim=64)
    run = RunConfig(remat="none", attention_impl="pallas")
    params = M.init_model(smoke, torch.Generator(device="cuda").manual_seed(0))
    opt = adamw.init_opt_state(params)
    params, opt, _ = make_train_step(smoke, run)(params, opt, next(batch_iterator(smoke, 64, 4, seed=0)))
    state = {"params": params, "opt_state": opt, "step": opt["step"]}
    rounds = {}
    with tempfile.TemporaryDirectory() as d:
        for red in ("replicate", "stripe"):
            # 5 nodes: a stripe group of 4 shards keeps its parity on a fifth
            cm = CheckpointManager(f"{d}/{red}", num_nodes=5, num_shards=8, redundancy=red)
            cm.save(1, state)
            got, info = cm.restore(1, tree_map(torch.zeros_like, state), failed_nodes={"node1"})
            pairs = list(zip(tree_leaves(got), tree_leaves(state)))
            rounds[red] = {"leaves": len(pairs), "recovery_reads": info["recovery_reads"],
                           "bit_equal": all(a.device == b.device and a.dtype == b.dtype and torch.equal(a, b)
                                             for a, b in pairs)}
        events = train_mod.main(["--arch", "qwen3-1.7b-smoke", "--d-model", str(SMOKE_D_MODEL), "--steps", "6",
                                 "--batch", "4", "--seq", "64", "--microbatches", "8", "--pods", "1.0,1.0,0.5,0.25",
                                 "--kill-pod", "1", "--kill-at", "3", "--ckpt-dir", f"{d}/train",
                                 "--ckpt-every", "2", "--log-every", "100", "--device", "cuda"])
    scheds = [h["schedule"] for h in events["history"]]
    kinds = [e["kind"] for e in events["elastic_events"]]
    out["checkpoint"] = {"rounds": rounds, "elastic_events": events["elastic_events"], "schedules": scheds}
    print(f"checkpoint of CUDA tensors, node1 lost: {rounds}; smoke run losing pod1 at step 3: events {kinds}, "
          f"schedules {scheds}")
    check(all(r["bit_equal"] for r in rounds.values()), f"checkpoint restored bit for bit: {rounds}")
    check(kinds == ["pod_dead", "restored"] and events["elastic_events"][1]["detail"]["step"] == 2
          and all(len(x) == 4 for x in scheds[:3]) and all(len(x) == 3 and sum(x) == 8 for x in scheds[3:])
          and all(np.isfinite(h["loss"]) for h in events["history"]),
          f"elastic restore and re-proportioned schedule: {out['checkpoint']}")
    del params, opt, state
    free_card()
    return out


# -- 18. SSM training -------------------------------------------------------
# xlstm-1.3b at full width through launch.train.main: pods 1.0 and 0.5, 3
# microbatches of 2 x 1024 a step, 3 steps, the trainer's lr (3e-4). Its
# 6 sLSTM layers run a Python time loop in the forward and the backward, so
# a microbatch takes seconds: the held-out loss is taken on 2 microbatches.
XLSTM_TRAIN_ARGS = ["--arch", "xlstm-1.3b", "--steps", "3", "--batch", "2", "--seq", "1024", "--microbatches", "3",
                    "--pods", "1.0,0.5", "--log-every", "100", "--device", "cuda"]
XLSTM_HELD_OUT = 2
# K3 at the training shapes: xlstm's mLSTM scan at 2 x 1024 (folded x (8,
# 1024, 513)) and Mamba's at 2 x 2048 (K3_MAMBA_SHAPE, c shared by the heads)
K3_TRAIN_XLSTM, K3_TRAIN_MAMBA = (2, 1024, 4, 513, 512), (2, 2048)
# The fp32 one-step checks at a cut depth on 2 x 1024 tokens: xlstm-1.3b
# cut to one period (7 mLSTM + 1 sLSTM) and jamba-smoke's period widened to
# d_model 256 (attention heads of 64, K2's narrowest; 4 Mamba heads of
# 128). The kernel path (K2, K3, their recompute backwards) and the plain
# path (chunked attention, the plain scan in fp32 under autograd) are each
# held against the plain path in fp64 (the exact gradient to fp32's eyes):
# the worst leaf's error over its largest |g|, at least GRAD_FLOOR (sLSTM's
# input-gate biases get |g| ~ 1e-11, as in tests/test_torch_train.py). The
# SSM stacks' fp32 gradients are ill-conditioned at random weights (on the
# CPU at smoke size the reference's own are 1e-3 to 1e-2 of a leaf's scale
# from fp64), so the kernel path is held no further from fp64 than
# SSM_GRAD_MARGIN times the plain fp32 path is; a wrong kernel or backward
# moves a gradient by O(|g|).
SSM_CUT_LAYERS, GRAD_FLOOR, SSM_GRAD_MARGIN = 8, 1e-6, 2.0
JAMBA_CUT_D_MODEL = 256


def k3_grad_check(x, loga, b, c, chunk: int = 256) -> dict:
    """A backward through ``ops.ssm_scan`` on CUDA tensors in the model
    layout (c of shape (B, S, 1, N) where the heads share it, broadcast at
    the call as the Mamba block does): the forward is one K3 launch and the
    backward none; every input gets a finite gradient of its own dtype and
    shape, equal to autograd through the plain version on the same inputs
    (the same recompute: this checks the wiring)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssm_scan import fold, ssm_scan_plain, unfold

    B, S, H, P = x.shape
    N = b.shape[-1]
    got = [t.detach().clone().requires_grad_() for t in (x, loga, b, c)]
    ref = [t.detach().clone().requires_grad_() for t in (x, loga, b, c)]
    gy = torch.randn(x.shape, device=x.device).to(x.dtype)
    before = ops.LAUNCHES["ssm_scan"]
    y, _ = ops.ssm_scan(*got[:3], got[3].expand(B, S, H, N), chunk)
    fwd = ops.LAUNCHES["ssm_scan"] - before
    has_grad_fn = y.grad_fn is not None
    y.backward(gy)
    bwd = ops.LAUNCHES["ssm_scan"] - before - fwd
    yf, hf = ssm_scan_plain(*fold(*ref[:3], ref[3].expand(B, S, H, N), chunk), chunk)
    unfold(yf, hf, B, S, P, N)[0].backward(gy)
    torch.cuda.synchronize()
    grads = {n: (a.grad is not None and a.grad.dtype == a.dtype and a.grad.shape == a.shape
                 and bool(torch.isfinite(a.grad).all()), a.grad is not None and torch.equal(a.grad, r.grad))
             for n, a, r in zip(("dx", "dloga", "db", "dc"), got, ref)}
    res = {"shape": f"x {tuple(x.shape)} {x.dtype}, b {tuple(b.shape)} {b.dtype}, c {tuple(c.shape)}",
           "grad_fn": has_grad_fn, "forward_launches": fwd, "backward_launches": bwd,
           "sound": {n: v[0] for n, v in grads.items()}, "equal_plain_autograd": {n: v[1] for n, v in grads.items()}}
    res["ok"] = has_grad_fn and fwd == 1 and bwd == 0 and all(all(v) for v in grads.values())
    return res


def grad_worst(got, exp) -> float:
    """The worst leaf's largest |got - exp| over its largest |exp|, at
    least GRAD_FLOOR."""
    from repro_torch.models.common import tree_leaves

    return max(float((a.double() - b.double()).abs().max()) / max(float(b.abs().max()), GRAD_FLOOR)
               for a, b in zip(tree_leaves(got), tree_leaves(exp)))


def plain_scan_fp32(x, loga, b, c, chunk=256):
    """The plain path's fp32 stand-in for ``ops.ssm_scan``: the plain
    version on the folded inputs in their own dtypes (as the CPU runs it),
    differentiated straight through by autograd."""
    from repro_torch.kernels.ssm_scan import fold, ssm_scan_plain, unfold

    y, h = ssm_scan_plain(*fold(x, loga, b, c, chunk), chunk)
    return unfold(y, h, x.shape[0], x.shape[1], x.shape[-1], b.shape[-1])


def ssm_cut_grad_check(cut, what: str) -> dict:
    """One fp32 grad step of ``cut`` on random weights from seed 0 and 2 x
    1024 tokens on the kernel path, the plain path, and the plain path in
    fp64: the losses to 1e-5 of each other, and the kernel path's worst
    gradient error against fp64 (:func:`grad_worst`) at most SSM_GRAD_MARGIN
    times the plain fp32 path's. Frees the weights."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.dataset import batch_iterator
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_grad_step
    from repro_torch.models import model as M
    from repro_torch.models.common import tree_map

    params = M.init_model(cut, torch.Generator(device="cuda").manual_seed(0))
    batch = next(batch_iterator(cut, 1024, 2, seed=0))
    kernel_run = RunConfig(remat="none", attention_impl="pallas", ssd_chunk=256)
    plain_run = RunConfig(remat="none", attention_impl="chunked", ssd_chunk=256)
    ops.reset_launches()
    gk, mk = make_grad_step(cut, kernel_run)(params, batch)
    launches = dict(ops.LAUNCHES)
    with mock.patch.object(ops, "ssm_scan", plain_scan_fp32):
        gp, mp = make_grad_step(cut, plain_run)(params, batch)
    with mock.patch.object(ops, "ssm_scan", plain_scan):
        g64, _ = make_grad_step(dataclasses.replace(cut, compute_dtype="float64"), plain_run)(
            tree_map(torch.Tensor.double, params), batch)
    rec = {"layers": cut.num_layers, "d_model": cut.d_model, "loss": float(mp["loss"]),
           "loss_diff": abs(float(mk["loss"]) - float(mp["loss"])), "kernel_vs_fp64": grad_worst(gk, g64),
           "plain_vs_fp64": grad_worst(gp, g64), "kernel_vs_plain": grad_worst(gk, gp), "margin": SSM_GRAD_MARGIN,
           "launches": launches, "params": sum(t.numel() for t in leaves(params))}
    del params, gk, gp, g64
    free_card()
    print(f"{cut.name} fp32, {cut.num_layers} layers at d_model {cut.d_model} ({what}; {rec['params']} params), one "
          f"grad step on 2 x 1024 tokens: loss {rec['loss']:.6f}, kernel vs plain diff {rec['loss_diff']:.3e}; worst "
          f"gradient over its leaf's largest |g| (at least {GRAD_FLOOR}): kernel path vs fp64 "
          f"{rec['kernel_vs_fp64']:.3e}, plain fp32 path vs fp64 {rec['plain_vs_fp64']:.3e} (the kernel path at most "
          f"{SSM_GRAD_MARGIN}x that), kernel vs plain {rec['kernel_vs_plain']:.3e}; launches {launches}")
    check(rec["loss_diff"] <= 1e-5 * abs(rec["loss"])
          and rec["kernel_vs_fp64"] <= SSM_GRAD_MARGIN * rec["plain_vs_fp64"],
          f"{cut.name} fp32 cut training step, kernel vs plain: {rec}")
    return rec


def ssm_training(card: str) -> dict:
    """Phase 18 (right after phase 17; frees everything at its end): K3 at
    the training shapes against its plain version, and its gradient's
    wiring; xlstm-1.3b trained at full width through ``launch.train.main``
    (CUDA events around each grad microbatch, update, K3 forward, K3
    recompute backward and each sLSTM block's forward and backward); K3
    timed at xlstm's training shape beside its recompute backward; the fp32
    kernel-vs-plain grad steps of xlstm cut to one period and of jamba-smoke's
    period widened."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssm_scan import fold, ssm_scan_cuda, ssm_scan_plain, ssm_scan_ref_vjp
    from repro_torch.models import ssm

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(18)
    out = {"k3_forward": {}, "k3_grad": {}}
    fails = []
    for dtype in (torch.bfloat16, torch.float32):
        shapes = {"xlstm": k3_inputs(gen, *K3_TRAIN_XLSTM, dtype=dtype),
                  "mamba": mamba_scan_inputs(gen, *K3_TRAIN_MAMBA, dtype)}
        for name, inputs in shapes.items():
            f = fold(*inputs, 256)
            y, h = ssm_scan_cuda(*f, 256)
            ye, he = k3_exact(*f, 256)
            torch.cuda.synchronize()
            r = {"x": tuple(f[0].shape), "y_over_terms": terms_err(y, ye, k3_terms(*f, 256)),
                 "y_scaled": scaled_err(y, ye), "h": scaled_err(h, he)}
            out["k3_forward"][f"{name}, {dtype}"] = r
            print(f"K3 vs plain at the {name} training shape (folded x {r['x']}) {dtype}: y over the terms "
                  f"{r['y_over_terms']:.3e} (tol {K3_TERMS_TOL[dtype]:.0e}), scaled err y {r['y_scaled']:.3e}, "
                  f"h {r['h']:.3e} (tol {K3_TOL[torch.float32]:.0e})")
            if not (r["y_over_terms"] <= K3_TERMS_TOL[dtype] and r["h"] <= K3_TOL[torch.float32]):
                fails.append(f"{name}, {dtype}")
            x, loga, b, c = inputs
            g = k3_grad_check(x, loga, b, c[:, :, :1] if name == "mamba" else c)
            out["k3_grad"][f"{name}, {dtype}"] = g
            print(f"K3 gradient through ops.ssm_scan ({g['shape']}): grad_fn {g['grad_fn']}, launches "
                  f"{g['forward_launches']} forward, {g['backward_launches']} backward; finite, dtype and shape kept "
                  f"{g['sound']}; equal to autograd through the plain version {g['equal_plain_autograd']}")
            if not g["ok"]:
                fails.append(f"{name}, {dtype}, gradient")
            del f, y, h, ye, he, inputs, x, loga, b, c
        free_card()
    check(not fails, f"K3 at the training shapes: {fails}")

    # K3 at xlstm's training shape, bf16, as the model hands it (x and c
    # bf16, b fp32): the kernel by graph replay and eager, the plain
    # version, the recompute backward of one layer (y's cotangent only), and
    # the bound at the function's own widths (P 513)
    f = fold(*k3_inputs(gen, *K3_TRAIN_XLSTM, dtype=torch.bfloat16), 256)
    gy = torch.randn(f[0].shape, generator=gen, device=gen.device).to(torch.bfloat16)
    B3, S3, H3, P3, N3 = K3_TRAIN_XLSTM
    BH, L3 = B3 * H3, 256
    nbytes = BH * (S3 * P3 * 2 + S3 * 4 + S3 * N3 * 4 + S3 * N3 * 2 + S3 * P3 * 2 + N3 * P3 * 4)
    tri = L3 * (L3 + 1) // 2
    flops = BH * (S3 // L3) * (2 * tri * N3 + 2 * tri * P3 + 4 * L3 * N3 * P3)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    out["k3_training_shape"] = {
        "shape": f"folded x {tuple(f[0].shape)} bf16, loga fp32, b {tuple(f[2].shape)} fp32, c bf16; chunk 256 "
                 "(xlstm-1.3b train, 2 x 1024)",
        "ms": graph_ms(lambda: ssm_scan_cuda(*f, 256)), "eager_ms": timed_ms(lambda: ssm_scan_cuda(*f, 256)),
        "plain_ms": timed_ms(lambda: ssm_scan_plain(*f, 256)), "library_ms": None,
        "recompute_backward_ms": timed_ms(lambda: ssm_scan_ref_vjp(*f, gy, None, 256)),
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "flops": flops,
    }
    t = out["k3_training_shape"]
    print(f"ssd_scan at the training shape ({t['shape']}): {t['ms']:.5f} ms device (graph replay), eager "
          f"{t['eager_ms']:.5f} ms, bound {t['bound_ms']:.6f} ms by {t['bound_by']}, plain {t['plain_ms']:.4f} ms; "
          f"recompute backward {t['recompute_backward_ms']:.4f} ms ({card})")
    del f, gy
    free_card()

    # xlstm-1.3b at full width through train.main
    xcfg = get_config("xlstm-1.3b")
    XL = sum(xcfg.layer_kind(i) == "mlstm" for i in range(xcfg.num_layers))
    XS = xcfg.num_layers - XL
    train = timed_train(XLSTM_TRAIN_ARGS, xcfg, {"k3_fwd": (ops, "ssm_scan"), "k3_bwd": (ops, "ssm_scan_ref_vjp")},
                        held_out=XLSTM_HELD_OUT, blocks={"slstm": (ssm, "slstm_apply_full")})
    print_train("xlstm-1.3b", train, card)
    check_train("xlstm-1.3b", train, xcfg, "ssm_scan", XL)
    mbs = train["grad_microbatches"]
    check(train["calls"]["k3_fwd"] == train["calls"]["k3_bwd"] == XL * mbs
          and train["calls"]["slstm"] == train["calls"]["slstm_bwd"] == XS * mbs
          and train["launches"]["flash_attention"] == 0 and mbs == 9,
          f"xlstm training: {XL} K3 forwards and recompute backwards and {XS} sLSTM blocks a microbatch over 9 "
          f"microbatches: {train['calls']}, launches {train['launches']}")
    out["train"] = train
    free_card()

    # the fp32 kernel-vs-plain grad steps at a cut depth
    x32 = dataclasses.replace(xcfg, num_layers=SSM_CUT_LAYERS, compute_dtype="float32")
    out["xlstm_cut"] = ssm_cut_grad_check(x32, "one period: 7 mLSTM + 1 sLSTM, full width")
    jsmoke = get_config("jamba-1.5-large-398b-smoke")
    jcut = dataclasses.replace(jsmoke, num_layers=jsmoke.period, d_model=JAMBA_CUT_D_MODEL,
                               head_dim=JAMBA_CUT_D_MODEL // jsmoke.num_heads, compute_dtype="float32")
    out["jamba_cut"] = ssm_cut_grad_check(jcut, f"one period, widened: attention heads of {jcut.head_dim}, "
                                                f"{ssm.mamba_heads(jcut)} Mamba heads of {ssm.MAMBA_HEAD_DIM}")
    check(out["xlstm_cut"]["launches"]["ssm_scan"] == SSM_CUT_LAYERS - 1
          and out["jamba_cut"]["launches"]["ssm_scan"] == jcut.num_layers - 1
          and out["jamba_cut"]["launches"]["flash_attention"] == 1,
          f"the cut checks ran K3 on every scan and K2 on jamba's attention layer: {out['xlstm_cut']['launches']}, "
          f"{out['jamba_cut']['launches']}")
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# -- 19. MoE, frontend and remat training -----------------------------------
# moonshot-v1-16b-a3b at published widths cut to 3 of 48 layers (2.383e9
# parameters: five fp32 copies fit beside the activations), musicgen-medium
# at full width (1.819e9, 48 layers, heads of 64, 8 prefix frames before
# 1016 tokens), each as phase 17 trains qwen3 (2 x 1024 a microbatch, 3 a
# step over pods 1.0 and 0.5), 3 steps
MOE_TRAIN_LAYERS, FAMILY_STEPS = 3, "3"
FAMILY_ARGS = ["--steps", FAMILY_STEPS, "--batch", "2", "--seq", "1024", "--microbatches", "3", "--pods", "1.0,0.5",
               "--log-every", "100", "--device", "cuda"]
# the -smoke configs of all ten archs through train.main on the card, at
# d_model 256 (heads of 64: K2 refuses the smoke configs' 16)
SMOKE_TRAIN_ARGS = ["--d-model", str(SMOKE_D_MODEL), "--steps", "2", "--batch", "2", "--seq", "64",
                    "--microbatches", "3", "--pods", "1.0,0.5", "--log-every", "100", "--device", "cuda"]


def remat_compare(card: str) -> dict:
    """qwen3-1.7b at full width (fp32 weights, bf16 compute), one grad
    microbatch of 2 x 1024 under ``remat`` "none" (twice: the device's own
    spread), "full" and "dots", each after a warm-up call of its own (the
    first checkpointed call imports ``torch._dynamo``, seconds): ms (CUDA
    events), peak GiB and the peak above what was allocated before the
    step, K2 launches, and each mode's largest gradient difference from the
    first "none"."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.dataset import batch_iterator
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_grad_step
    from repro_torch.models import model as M
    from repro_torch.models.common import tree_leaves

    cfg = get_config("qwen3-1.7b")
    params = M.init_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    batch = next(batch_iterator(cfg, 1024, 2, seed=0))
    base, rec = None, {}
    for name, mode in (("warm-up", "none"), ("none", "none"), ("none again", "none"), ("warm-up", "full"),
                       ("full", "full"), ("warm-up", "dots"), ("dots", "dots")):
        step = make_grad_step(cfg, RunConfig(remat=mode, attention_impl="pallas"))
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        grads, metrics = step(params, batch)
        b.record()
        torch.cuda.synchronize()
        if name == "warm-up":
            del grads
            continue
        peak = torch.cuda.max_memory_allocated()
        rec[name] = {"ms": a.elapsed_time(b), "peak_gib": peak / 2**30, "above_gib": (peak - before) / 2**30,
                     "k2_launches": ops.LAUNCHES["flash_attention"], "loss": float(metrics["loss"])}
        if base is None:
            base = grads
        else:
            rec[name]["grad_diff"] = max(float((x - y).abs().max()) for x, y in zip(tree_leaves(grads),
                                                                                   tree_leaves(base)))
            del grads
    del params, base
    free_card()
    for name, r in rec.items():
        print(f"qwen3-1.7b, one grad microbatch (2 x 1024) under remat {name!r}: {r['ms']:.1f} ms, peak "
              f"{r['peak_gib']:.2f} GiB ({r['above_gib']:.2f} above the weights and held gradients), K2 launches "
              f"{r['k2_launches']}, loss {r['loss']:.6f}"
              + (f", largest gradient difference from 'none' {r['grad_diff']:.3e}" if "grad_diff" in r else "")
              + f" ({card})")
    L = cfg.num_layers
    check(rec["none"]["k2_launches"] == L and rec["full"]["k2_launches"] == 2 * L
          and rec["dots"]["k2_launches"] == 2 * L,
          f"K2 launches under remat none / full / dots: {[r['k2_launches'] for r in rec.values()]}")
    noise = rec["none again"]["grad_diff"]
    check(all(rec[m]["grad_diff"] <= noise for m in ("full", "dots")) and rec["full"]["loss"] == rec["none"]["loss"]
          and rec["dots"]["loss"] == rec["none"]["loss"],
          f"remat full and dots give the gradients of none (within none's own spread {noise}): {rec}")
    return rec


def family_training(card: str) -> dict:
    """Phase 19 (right after phase 18; frees everything at its end):
    moonshot-v1-16b-a3b cut to MOE_TRAIN_LAYERS layers and musicgen-medium
    at full width trained through ``launch.train.main`` as phase 17 trains
    qwen3 (K2's spans; moonshot's dropped share and aux loss per grad
    microbatch at the training capacity factor); qwen3-1.7b's grad
    microbatch under each ``remat``; the ``-smoke`` config of every arch
    trained for 2 steps."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod

    t_phase = time.perf_counter()
    out = {}
    k2 = {"k2_fwd": (ops, "flash_attention"), "k2_bwd": (ops, "flash_attention_ref_vjp")}
    mcfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"), num_layers=MOE_TRAIN_LAYERS)
    train = timed_train(["--arch", "moonshot-v1-16b-a3b", "--layers", str(MOE_TRAIN_LAYERS), *FAMILY_ARGS], mcfg, k2)
    print_train(f"moonshot-v1-16b-a3b ({MOE_TRAIN_LAYERS} layers)", train, card)
    drops = [m["moe_drop_frac"] for m in train["microbatch_metrics"]]
    auxes = [m["moe_aux"] for m in train["microbatch_metrics"]]
    print(f"train moonshot-v1-16b-a3b ({MOE_TRAIN_LAYERS} layers), capacity factor {mcfg.moe_capacity_factor}: "
          f"dropped share per grad microbatch " + ", ".join(f"{d:.3f}" for d in drops)
          + "; moe_aux " + ", ".join(f"{a:.3f}" for a in auxes))
    check_train("moonshot-v1-16b-a3b", train, mcfg, "flash_attention", MOE_TRAIN_LAYERS)
    check(all(0 <= d < 1 for d in drops) and all(np.isfinite(auxes)), f"moonshot dropped shares {drops}, aux {auxes}")
    out["moonshot"] = train
    free_card()

    gcfg = get_config("musicgen-medium")
    train = timed_train(["--arch", "musicgen-medium", *FAMILY_ARGS], gcfg, k2)
    print_train("musicgen-medium", train, card)
    check_train("musicgen-medium", train, gcfg, "flash_attention", gcfg.num_layers)
    out["musicgen"] = train
    free_card()

    out["remat"] = remat_compare(card)

    smoke = {}
    for arch in ARCH_IDS:
        ops.reset_launches()
        res = train_mod.main(["--arch", f"{arch}-smoke", *SMOKE_TRAIN_ARGS])
        cfg = get_config(f"{arch}-smoke")
        kinds = {cfg.layer_kind(i) for i in range(cfg.num_layers)}
        smoke[arch] = {"losses": [h["loss"] for h in res["history"]], "launches": dict(ops.LAUNCHES)}
        check(all(np.isfinite(smoke[arch]["losses"])) and len(smoke[arch]["losses"]) == 2
              and (ops.LAUNCHES["flash_attention"] > 0) == ("attn" in kinds)
              and (ops.LAUNCHES["ssm_scan"] > 0) == bool(kinds & {"mlstm", "mamba"}),
              f"{arch}-smoke trains on the card through its kernels: {smoke[arch]}")
    print(f"train the -smoke configs at d_model {SMOKE_D_MODEL} (2 steps): "
          + "; ".join(f"{a} losses {', '.join(f'{x:.4f}' for x in r['losses'])}, launches {r['launches']}"
                      for a, r in smoke.items()))
    out["smoke"] = smoke
    free_card()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# The distribution phase. K1 shard by shard: qwen3-1.7b's attention layout
# (16 q heads, 8 KV heads of 128) at decode_32k's length (32768 keys,
# src/repro/configs/base.py:274), 8 rows, bf16: 1.07 GB of K and V, cut
# into 4 sequence shards of 8192 keys. The pipeline: one qwen3-1.7b block
# at full width over 4 microbatches of (2, 1024). The sharded train step:
# qwen3-1.7b at full width, one microbatch of 2 x 1024 tokens, timed over
# DIST_TRAIN_STEPS steps after the first; its fp32 check on a 2-layer cut.
DIST_DECODE, DIST_SHARDS = (8, 32768, 16, 8, 128), 4
DIST_PIPE = (4, 2, 1024)
DIST_TRAIN_SEQ, DIST_TRAIN_STEPS, DIST_CUT_LAYERS = (2, 1024), 2, 2
DIST_LOSS_RTOL, DIST_CUT_TOL = 1e-3, 1e-4
DIST_PEAK_SLACK_GIB = 1.0  # a sharded step's peak over the unsharded one's, on one rank


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def distribution_phase(card: str) -> dict:
    """Phase 20 (right after phase 19, while the card holds nothing else;
    destroys its process group and frees everything at its end): (a) K1
    shard by shard at qwen3-1.7b's layout and decode_32k's length, combined
    by ``ops.combine_decode_partials``, against one K1 call and the plain
    version, and timed beside the one call; (b) ``sharded_decode_attention``
    on a one-rank NCCL (1, 1) mesh of ("data", "model"), whose K1 launch is
    this row's launch; (c) ``pipeline_apply`` of one qwen3-1.7b block over 4
    microbatches on a one-rank ("pod", "data") mesh against a sequential
    run; (d) qwen3-1.7b's sharded train step at full width through
    ``make_train_step(cfg, run, rules)``, params and optimizer state placed
    by ``model_specs``/``opt_state_specs``, against the unsharded step; (e)
    the same for moonshot-v1-16b-a3b cut to MOE_TRAIN_LAYERS layers."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_cuda, decode_attention_plain
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import distribute_tree, make_train_step
    from repro_torch.models import model as M
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.optim import adamw
    from repro_torch.parallel.flash_decode import sharded_decode_attention
    from repro_torch.parallel.pipeline import pipeline_apply
    from repro_torch.parallel.sharding import rules_from_mesh

    import torch.nn.functional as F

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20)
    out = {}

    # -- (a) K1 shard by shard, one process ------------------------------
    B, S, H, KH, D = DIST_DECODE
    n, step = DIST_SHARDS, DIST_DECODE[1] // DIST_SHARDS
    q = torch.randn((B, H, D), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((B, S, KH, D), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((B, S, KH, D), generator=gen, device=dev).to(torch.bfloat16)
    valid_b = torch.rand((B, S), generator=gen, device=dev) > 0.2
    valid_b[B - 2, step:] = False  # valid keys in shard 0 only: three shards empty
    valid_b[B - 1] = False  # no valid key
    valid = valid_b.to(torch.int32)
    cuts = [slice(i * step, (i + 1) * step) for i in range(n)]
    vcuts = [valid[:, c].contiguous() for c in cuts]
    scale = D**-0.5

    def sharded():
        parts = [decode_attention_cuda(q, k[:, c], v[:, c], vc, scale=scale, normalize=False)
                 for c, vc in zip(cuts, vcuts)]
        return ops.combine_decode_partials(*zip(*parts))

    def whole():
        return decode_attention_cuda(q, k, v, valid, scale=scale)[0]

    got, one = sharded(), whole()
    plain = decode_attention_plain(q, k, v, valid, scale=scale)[0]
    torch.cuda.synchronize()
    errs = {"vs_one_call": float((got - one).abs().max()), "vs_plain": float((got - plain).abs().max()),
            "scaled_vs_one_call": scaled_err(got, one), "scaled_vs_plain": scaled_err(got, plain),
            "one_call_vs_plain": float((one - plain).abs().max())}
    out["k1_sharded_err"] = errs
    print(f"K1 sharded {n} x {step} at q {tuple(q.shape)}, k/v {tuple(k.shape)} bf16: max abs err vs one call "
          f"{errs['vs_one_call']:.3e}, vs plain {errs['vs_plain']:.3e} (tol {BF16_TOL}); scaled {errs['scaled_vs_one_call']:.3e}, "
          f"{errs['scaled_vs_plain']:.3e} (tol {ATTN_SCALED_TOL[torch.float32]:.0e})")
    for key in ("vs_one_call", "vs_plain", "one_call_vs_plain"):
        check(errs[key] < BF16_TOL, f"K1 sharded: {key} {errs}")
    for key in ("scaled_vs_one_call", "scaled_vs_plain"):
        check(errs[key] <= ATTN_SCALED_TOL[torch.float32], f"K1 sharded: {key} {errs}")
    check(bool((got[B - 1] == 0).all() and (one[B - 1] == 0).all()), "K1 sharded: the all-invalid row is exact zeros")
    bound = k1_bound(q, k, valid)
    nbytes = bound["bytes"]
    qs, ks, vs = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    mask = valid_b[:, None, None, :]
    times = {"ms": graph_ms(sharded), "one_call_ms": graph_ms(whole),
             "plain_ms": timed_ms(lambda: decode_attention_plain(q, k, v, valid, scale=scale)),
             "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                                           enable_gqa=True)),
             "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"], "bytes": nbytes}
    out["k1_sharded"] = times
    print(f"K1 sharded {n} x {step} + combine: {times['ms']:.5f} ms device; one K1 call over {S}: "
          f"{times['one_call_ms']:.5f} ms; bound {times['bound_ms']:.5f} ms by {times['bound_by']} "
          f"({nbytes / 1e9:.3f} GB); plain {times['plain_ms']:.4f} ms; SDPA {times['library_ms']:.5f} ms ({card})")
    del plain, got

    # -- (b) sharded_decode_attention on a one-rank NCCL mesh -------------
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        mesh = make_mesh((1, 1))
        ops.reset_launches()
        res = sharded_decode_attention(q, k, v, valid_b, mesh).full_tensor()
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        # the result is in q's dtype (bf16): within the fp32 limit of one K1
        # call's fp32 output after the rounding to bf16 (2^-8 of the value)
        err = float((res.float() - one).abs().max())
        over = float(((res.float() - one).abs() - one.abs() * 2**-8).max())
        check(launches["decode_attention"] == 1, f"sharded_decode_attention launched K1 {launches}")
        check(over <= FP32_TOL and bool((res[B - 1] == 0).all()),
              f"sharded_decode_attention on the NCCL mesh vs one K1 call: {err}, past the bf16 rounding {over}")
        out["nccl_decode"] = {"max_abs_err": err, "past_bf16_rounding": over, "launches": launches["decode_attention"],
                              "mesh": list(mesh.mesh_dim_names)}
        print(f"sharded_decode_attention on a one-rank NCCL (1, 1) mesh: max abs err vs one K1 call {err:.3e}, "
              f"{over:.3e} past the rounding to bf16 (tol {FP32_TOL}), K1 launches {launches['decode_attention']}")
        print("NCCL places one rank per card: the multi-rank combine, pipeline, sharded train step and serve are "
              "held across four cards by scripts/multicard_smoke.py (PERF.md's 4-card figures) and on gloo CPU "
              "groups by tests/test_torch_parallel.py")
        del q, k, v, valid, valid_b, vcuts, res, one
        free_card()

        # -- (c) pipeline_apply on the one-rank group ----------------------
        cfg = get_config("qwen3-1.7b")
        run = RunConfig(remat="none", attention_impl="pallas", z_loss=0.0)
        blk = M.init_model(dataclasses.replace(cfg, num_layers=1), torch.Generator(device=dev).manual_seed(0),
                           dtype=torch.bfloat16)["layers"][0]
        Mb, Bp, Sp = DIST_PIPE
        x = torch.randn((Mb, Bp, Sp, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
        positions = torch.arange(Sp, device=dev)[None, :]

        def block(p, h):
            return M._block_full(cfg, run, p, "attn", h, positions)[0]

        pmesh = make_mesh((1, 1), ("pod", "data"))
        with torch.no_grad():
            ops.reset_launches()
            piped = pipeline_apply(block, tree_map(lambda t: t[None], blk), x, pmesh, stage_axis="pod")
            pipe_launches = ops.LAUNCHES["flash_attention"]
            seq = torch.stack([block(blk, x[i]) for i in range(Mb)])
        torch.cuda.synchronize()
        perr = float((piped.float() - seq.float()).abs().max())
        check(perr <= 1e-2 * float(seq.float().abs().max()) and pipe_launches == Mb,
              f"pipeline_apply vs sequential: err {perr}, K2 {pipe_launches}")
        out["pipeline"] = {"max_abs_err": perr, "k2_launches": pipe_launches, "microbatches": Mb}
        print(f"pipeline_apply of one qwen3-1.7b block, {Mb} microbatches of {(Bp, Sp)}, one stage: "
              f"max abs err vs sequential {perr:.3e}, K2 launches {pipe_launches}")
        del blk, x, piped, seq
        free_card()

        # -- (d) the sharded train step of qwen3-1.7b ----------------------
        mesh = make_mesh((1, 1))
        rules = rules_from_mesh(mesh)
        corpus_rng = np.random.default_rng(20)
        bt, st = DIST_TRAIN_SEQ

        def batches(vocab: int) -> list:
            return [{"tokens": corpus_rng.integers(0, vocab, (bt, st)), "labels": corpus_rng.integers(0, vocab, (bt, st)),
                     "mask": np.ones((bt, st), np.float32)} for _ in range(1 + DIST_TRAIN_STEPS)]

        def run_steps(c, sharded_run: bool, steps: int, data: list):
            params = M.init_model(c, torch.Generator(device=dev).manual_seed(0))
            opt = adamw.init_opt_state(params)
            if sharded_run:
                specs = M.model_specs(c, rules)
                params = distribute_tree(params, specs, mesh)
                opt = distribute_tree(opt, adamw.opt_state_specs(specs), mesh)
            step_fn = make_train_step(c, run, rules if sharded_run else None)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            losses, ms, k2, local = [], [], [], []
            real = ops._on_local_heads

            def spy(*a, **kw):
                local.append(1)
                return real(*a, **kw)

            with mock.patch.object(ops, "_on_local_heads", spy):
                for i in range(steps):
                    ops.reset_launches()
                    local.clear()
                    t0 = time.perf_counter()
                    params, opt, metrics = step_fn(params, opt, data[i])
                    loss = float(metrics["loss"])
                    ms.append((time.perf_counter() - t0) * 1e3)
                    losses.append(loss)
                    k2.append((ops.LAUNCHES["flash_attention"], len(local)))
            peak = torch.cuda.max_memory_allocated() / 2**30
            return params, {"losses": losses, "ms": ms, "k2_and_dtensor_calls": k2, "peak_gib": peak}

        def sharded_vs_unsharded(c, name: str) -> dict:
            """``c``'s train step unsharded, then sharded: losses within
            DIST_LOSS_RTOL, every K2 launch of the sharded step through the
            DTensor path, and the sharded peak within DIST_PEAK_SLACK_GIB of
            the unsharded."""
            L = c.num_layers
            data = batches(c.vocab_size)
            # the params each run returns are dropped at once: kept, they
            # would sit in the next run's peak
            plain_rec = run_steps(c, False, 1 + DIST_TRAIN_STEPS, data)[1]
            free_card()
            shard_rec = run_steps(c, True, 1 + DIST_TRAIN_STEPS, data)[1]
            free_card()
            for a, b_ in zip(plain_rec["losses"], shard_rec["losses"]):
                check(np.isfinite(a) and abs(a - b_) <= DIST_LOSS_RTOL * abs(a),
                      f"{name} sharded vs unsharded loss {shard_rec['losses']} vs {plain_rec['losses']}")
            check(all(kk == (L, L) for kk in shard_rec["k2_and_dtensor_calls"]),
                  f"{name}: every K2 launch of the sharded step went through the DTensor path: "
                  f"{shard_rec['k2_and_dtensor_calls']}")
            check(all(kk == (L, 0) for kk in plain_rec["k2_and_dtensor_calls"]),
                  f"{name}: the unsharded step ran K2 {plain_rec['k2_and_dtensor_calls']}")
            check(shard_rec["peak_gib"] <= plain_rec["peak_gib"] + DIST_PEAK_SLACK_GIB,
                  f"{name}: sharded peak {shard_rec['peak_gib']:.2f} GiB against unsharded {plain_rec['peak_gib']:.2f}")
            for side, r in (("unsharded", plain_rec), ("sharded (1, 1) mesh", shard_rec)):
                print(f"{name} train step {side}, {bt} x {st} tokens: losses "
                      + ", ".join(f"{x_:.5f}" for x_ in r["losses"]) + "; ms per step "
                      + ", ".join(f"{x_:.1f}" for x_ in r["ms"]) + f" (first incl. warm-up); K2 launches and DTensor "
                      f"calls per step {r['k2_and_dtensor_calls']}; peak {r['peak_gib']:.2f} GiB ({card})")
            return {"unsharded": plain_rec, "sharded": shard_rec}

        out["train"] = sharded_vs_unsharded(cfg, "qwen3-1.7b")

        cut = dataclasses.replace(cfg, num_layers=DIST_CUT_LAYERS, compute_dtype="float32")
        data = batches(cut.vocab_size)
        p_plain, _ = run_steps(cut, False, 1, data)
        p_shard, _ = run_steps(cut, True, 1, data)
        cut_err = max(float((a - b_.full_tensor()).abs().max())
                      for a, b_ in zip(tree_leaves(p_plain), tree_leaves(p_shard)))
        check(cut_err < DIST_CUT_TOL, f"{DIST_CUT_LAYERS}-layer fp32 cut: sharded vs unsharded params {cut_err}")
        out["train"]["cut_fp32_max_param_err"] = cut_err
        print(f"qwen3-1.7b cut to {DIST_CUT_LAYERS} layers, fp32, one step: params sharded vs unsharded max abs "
              f"err {cut_err:.3e} (tol {DIST_CUT_TOL})")
        del p_plain, p_shard
        free_card()

        # -- (e) the sharded train step of moonshot-v1-16b-a3b cut to 3 layers
        mcut = dataclasses.replace(get_config("moonshot-v1-16b-a3b"), num_layers=MOE_TRAIN_LAYERS)
        out["train_moe"] = sharded_vs_unsharded(mcut, f"moonshot-v1-16b-a3b cut to {MOE_TRAIN_LAYERS} layers")
    finally:
        dist.destroy_process_group()
    free_card()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# The sharded serve steps. qwen3-1.7b at full width on the one-rank NCCL
# (1, 1) mesh: the 8 prompt lengths of phase 6 (128-1024, SyntheticCorpus),
# each prefilled alone by make_prefill_step into a cache of SERVE_MAX_LEN
# laid out by cache_specs, the 8 caches stacked into one batch-8 cache (its
# rows at different positions), then SERVE_STEPS greedy make_serve_step
# steps; against the unsharded prefill and decode_step on the same weights,
# in bf16 at full width and in fp32 on a SERVE_CUT_LAYERS-layer cut. Then
# the -smoke config of every arch at d_model SMOKE_D_MODEL (heads of 64, as
# phase 19 trains them) in fp32: SMOKE_SERVE = (batch, prompt, max_len,
# decode steps), the frontends with SMOKE_PREFIX seeded features first.
# Then the dry-run of DRYRUN_ARCHS x DRYRUN_SHAPES on the 16 x 16 mesh.
SERVE_LENS, SERVE_MAX_LEN, SERVE_STEPS, SERVE_CUT_LAYERS = (128, 256, 384, 512, 640, 768, 896, 1024), 2048, 32, 2
SERVE_CUT_TOL = 1e-4  # fp32 logits, sharded vs unsharded: the same kernels on one rank, summed in the same order
SERVE_PROFILED = 3  # decode steps traced after the timed ones, for the device's share of a step
SMOKE_SERVE, SMOKE_PREFIX, SMOKE_TOL = (4, 64, 128, 4), 16, 1e-4  # SMOKE_TOL: of the largest |logit|, fp32
DRYRUN_ARCHS = ("qwen3-1.7b", "xlstm-1.3b", "moonshot-v1-16b-a3b")
DRYRUN_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
# each cell's peak GiB per device before every rank took the loss on its own
# rows and routed its own MoE groups (this phase on PyTorch 2.11, H100 80GB
# HBM3); the five cells that change did not touch may grow by at most
# DRYRUN_PEAK_GROWTH over it
DRYRUN_EARLIER_PEAK_GIB = {
    "qwen3-1.7b:train_4k": 705.52, "qwen3-1.7b:prefill_32k": 2.31, "qwen3-1.7b:decode_32k": 3.58,
    "xlstm-1.3b:train_4k": 234.42, "xlstm-1.3b:prefill_32k": 4.87, "xlstm-1.3b:decode_32k": 2.15,
    "moonshot-v1-16b-a3b:train_4k": 762.11, "moonshot-v1-16b-a3b:prefill_32k": 204.23,
    "moonshot-v1-16b-a3b:decode_32k": 8.33}
DRYRUN_REPAIRED = ("qwen3-1.7b:train_4k", "xlstm-1.3b:train_4k", "moonshot-v1-16b-a3b:train_4k",
                   "moonshot-v1-16b-a3b:prefill_32k")
DRYRUN_PEAK_GROWTH = 1.1


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def stack_caches(caches: list) -> dict:
    """Batch-1 caches as one cache of their rows (batch on dim 1, ``pos`` on
    dim 0), each DTensor laid out again as the first cache's."""
    def cat(ts, dim):
        out = torch.cat(ts, dim=dim)
        return out.redistribute(ts[0].device_mesh, ts[0].placements) if hasattr(ts[0], "placements") else out

    return {key: {k: cat([c[key][k] for c in caches], 1) for k in t} if isinstance(t, dict)
            else cat([c[key] for c in caches], 0 if key == "pos" else 1) for key, t in caches[0].items()}


def step_device_ms(step_once, n: int) -> dict:
    """The device time of ``n`` more calls of ``step_once``, per call, from
    ``torch.profiler``: every kernel, copy and fill summed, and among them
    NCCL's; and the host's wall time under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step_once()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    attr = "device_time_total" if events and hasattr(events[0], "device_time_total") else "cuda_time_total"
    return {"device_ms": sum(getattr(e, attr) for e in events) / 1e3 / n,
            "nccl_ms": sum(getattr(e, attr) for e in events if "nccl" in e.key.lower()) / 1e3 / n,
            "device_ops": sum(e.count for e in events) / n, "wall_ms_profiled": wall}


def sharded_serve_phase(card: str) -> dict:
    """Phase 21 (right after phase 20, while the card holds nothing else;
    destroys its process group and frees everything at its end): (a)
    qwen3-1.7b's sharded prefill and decode steps at full width
    (``launch/steps.py::make_prefill_step``/``make_serve_step`` with the
    rules of a one-rank NCCL (1, 1) mesh: params placed by ``model_specs``,
    the cache by ``cache_specs``, its sequence over ``model``) against the
    unsharded ``prefill``/``decode_step``: 28 K2 launches a prefill through
    the wrappers' DTensor path, 28 K1 launches a step through
    ``sharded_decode_attention``; every bf16 logit bit for bit and the
    streams never parting; identical streams and logits to 1e-4 on an fp32
    cut; ms per step, the device time of a step (``torch.profiler``) and
    peak; K1 and K2 timed at the path's shapes; (b) the ``-smoke`` config of every arch, sharded against
    unsharded; (c) ``python -m repro_torch.launch.dryrun`` in a subprocess
    (a fake process group apart from the NCCL one) on DRYRUN_ARCHS x
    DRYRUN_SHAPES at the 16 x 16 mesh, each cell's peak per device below the
    card's memory."""
    import torch.distributed as dist
    import torch.nn.functional as F

    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.dataset import SyntheticCorpus
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_cuda, decode_attention_plain
    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import distribute_tree, make_prefill_step, make_serve_step
    from repro_torch.models import attention as A
    from repro_torch.models import model as M
    from repro_torch.models.model import FRONTEND_FEATURE_DIM
    from repro_torch.parallel.sharding import rules_from_mesh

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    out = {}
    cfg = get_config("qwen3-1.7b")
    run = RunConfig(remat="none", attention_impl="pallas", decode_attention_impl="kernel")
    corpus = SyntheticCorpus(cfg.vocab_size, max(SERVE_LENS), seed=0)
    prompts = [corpus.grain_tokens(i, 1)[:, :n] for i, n in enumerate(SERVE_LENS)]

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        mesh = make_mesh((1, 1))
        rules = rules_from_mesh(mesh)
        k2_local, k1_sharded = [], []
        real_local, real_sharded = ops._on_local_heads, A.sharded_decode_attention

        def spy_local(*a, **kw):
            k2_local.append(1)
            return real_local(*a, **kw)

        def spy_sharded(*a, **kw):
            k1_sharded.append(1)
            return real_sharded(*a, **kw)

        def serve(c, params, sharded: bool, prompt_list, steps: int, prefixes=None, max_len=SERVE_MAX_LEN,
                  profiled: int = 0) -> dict:
            """Each prompt batch prefilled alone (after its prefix features
            where given), the caches stacked, ``steps`` greedy decode steps:
            the logits and tokens of every step, the launches (and the
            DTensor-path calls) of each prefill and step and in all, ms per
            step, the peak; then ``profiled`` more steps' device time."""
            r = rules if sharded else None
            if sharded:
                params = distribute_tree(params, M.model_specs(c, rules), mesh)
            prefill, step = make_prefill_step(c, run, r, max_len), make_serve_step(c, run, r)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            rec = {"prefill": [], "steps": [], "ms": [], "launches": dict.fromkeys(ops.LAUNCHES, 0)}

            def tally():
                for key, n in ops.LAUNCHES.items():
                    rec["launches"][key] += n

            logits, caches = [], []
            with mock.patch.object(ops, "_on_local_heads", spy_local), \
                    mock.patch.object(A, "sharded_decode_attention", spy_sharded):
                for i, p in enumerate(prompt_list):
                    ops.reset_launches()
                    k2_local.clear()
                    batch = {"tokens": p} if prefixes is None else {"tokens": p, "prefix_features": prefixes[i]}
                    lg, cache = prefill(params, batch)
                    logits.append(_full(lg).float())
                    caches.append(cache)
                    rec["prefill"].append((ops.LAUNCHES["flash_attention"], len(k2_local)))
                    tally()
                cache = stack_caches(caches) if len(caches) > 1 else caches[0]
                del caches
                out_logits = [torch.cat(logits)]
                tokens = []
                for _ in range(steps):
                    tok = out_logits[-1].argmax(-1)
                    tokens.append(tok)
                    ops.reset_launches()
                    k1_sharded.clear()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    lg, cache = step(params, cache, {"tokens": tok})
                    torch.cuda.synchronize()
                    rec["ms"].append((time.perf_counter() - t0) * 1e3)
                    out_logits.append(_full(lg).float())
                    rec["steps"].append((ops.LAUNCHES["decode_attention"], len(k1_sharded)))
                    tally()
                rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
                if profiled:
                    tok = out_logits[-1].argmax(-1)
                    rec["device"] = step_device_ms(lambda: step(params, cache, {"tokens": tok}), profiled)
            rec["logits"], rec["tokens"] = out_logits, tokens
            return rec

        def compare(a, b) -> dict:
            """The first step where the greedy streams part (None: never),
            and the logits' largest gap up to it."""
            part = next((i for i, (x, y) in enumerate(zip(a["tokens"], b["tokens"])) if not torch.equal(x, y)), None)
            upto = len(a["logits"]) if part is None else part + 1
            gap = max(float((x - y).abs().max()) for x, y in zip(a["logits"][:upto], b["logits"][:upto]))
            top = max(float(x.abs().max()) for x in a["logits"][:upto])
            return {"parts_at_step": part, "max_abs_gap": gap, "max_abs_logit": top}

        # -- (a) qwen3-1.7b at full width, bf16 ------------------------------
        L = cfg.num_layers
        toks = [torch.as_tensor(p, device=dev) for p in prompts]
        runs = {}
        for name, sharded in (("unsharded", False), ("sharded", True)):
            # the weights made in the call: held here too, they would sit in
            # the sharded run's peak beside their placed copies
            runs[name] = serve(cfg, M.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dtype=torch.bfloat16),
                               sharded, toks, SERVE_STEPS, profiled=SERVE_PROFILED)
            free_card()
        sh, un = runs["sharded"], runs["unsharded"]
        check(all(kk == (L, L) for kk in sh["prefill"]) and all(kk == (L, L) for kk in sh["steps"]),
              f"sharded: 28 K2 a prefill and 28 K1 a step, each through the DTensor path: {sh['prefill']}, {sh['steps']}")
        check(all(kk == (L, 0) for kk in un["prefill"]) and all(kk == (L, 0) for kk in un["steps"]),
              f"unsharded: 28 K2 a prefill and 28 K1 a step: {un['prefill']}, {un['steps']}")
        # on one rank both sides run the same kernels on the same operands in
        # the same order: every logit bit for bit, the streams never part (a
        # cache slot written out of place shows here at any depth)
        cmp = compare(sh, un)
        check(all(bool(torch.isfinite(x).all()) for x in sh["logits"]) and cmp["parts_at_step"] is None
              and all(torch.equal(x, y) for x, y in zip(sh["logits"], un["logits"])),
              f"qwen3-1.7b bf16 sharded vs unsharded logits, bit for bit: {cmp}")
        out["qwen3"] = {"compare": cmp, "launches_per_prefill": sh["prefill"][0],
                        "launches_per_step": sh["steps"][0],
                        **{f"{n}_{k}": r[k] for n, r in runs.items() for k in ("ms", "peak_gib", "device")}}
        print(f"qwen3-1.7b sharded serve steps on a one-rank NCCL (1, 1) mesh, {len(toks)} prompts "
              f"{SERVE_LENS[0]}-{SERVE_LENS[-1]} prefilled alone, {SERVE_STEPS} decode steps at batch 8: bf16 logits "
              f"vs unsharded bit for bit (largest gap {cmp['max_abs_gap']:.4e}, largest |logit| "
              f"{cmp['max_abs_logit']:.3f}), streams never part; K2 per prefill "
              f"{sh['prefill'][0][0]} (DTensor path {sh['prefill'][0][1]}), K1 per step {sh['steps'][0][0]} "
              f"(sharded_decode_attention {sh['steps'][0][1]})")
        for name, r in runs.items():
            dv, med = r["device"], float(np.median(r["ms"]))
            check(dv["device_ms"] > 0, f"torch.profiler recorded device time in the {name} steps: {dv}")
            print(f"qwen3-1.7b decode step {name}, batch 8: ms per step " + ", ".join(f"{x:.1f}" for x in r["ms"][:8])
                  + f" ... median {med:.2f} (first incl. warm-up); peak {r['peak_gib']:.2f} GiB; over "
                  f"{SERVE_PROFILED} more steps (torch.profiler) {dv['device_ms']:.3f} ms of device time a step "
                  f"(NCCL {dv['nccl_ms']:.3f} ms, {dv['device_ops']:.0f} kernels, copies and fills), "
                  f"{1 - dv['device_ms'] / med:.1%} of the median step the device is idle; "
                  f"{dv['wall_ms_profiled']:.1f} ms a step under the profiler ({card})")

        # K1 and K2 at the sharded path's shapes: K1 over the batch-8 cache
        # of the last step (its rows valid up to their positions), K2 at the
        # longest prefill
        H, KH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
        gen = torch.Generator(device=dev).manual_seed(21)
        q = torch.randn((8, H, D), generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn((8, SERVE_MAX_LEN, KH, D), generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn((8, SERVE_MAX_LEN, KH, D), generator=gen, device=dev).to(torch.bfloat16)
        ends = torch.tensor([n + SERVE_STEPS for n in SERVE_LENS], device=dev)
        valid_b = torch.arange(SERVE_MAX_LEN, device=dev)[None, :] < ends[:, None]
        valid = valid_b.to(torch.int32)
        scale = D**-0.5
        got, exp = decode_attention_cuda(q, k, v, valid, scale=scale)[0], decode_attention_plain(q, k, v, valid,
                                                                                                  scale=scale)[0]
        k1_err = float((got - exp).abs().max())
        check(k1_err < BF16_TOL and scaled_err(got, exp) <= ATTN_SCALED_TOL[torch.float32],
              f"K1 at the sharded serve's shape vs plain: {k1_err}")
        bound = k1_bound(q, k, valid)
        mask = valid_b[:, None, None, :]
        out["k1"] = {"max_abs_err": k1_err, "ms": graph_ms(lambda: decode_attention_cuda(q, k, v, valid, scale=scale)),
                     "plain_ms": timed_ms(lambda: decode_attention_plain(q, k, v, valid, scale=scale)),
                     "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(
                         q[:, :, None], k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask, enable_gqa=True)),
                     "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"], "bytes": bound["bytes"],
                     "launches": sum(n for n, _ in sh["steps"]), "per_step": L}
        sq = max(SERVE_LENS)
        q2 = torch.randn((1, sq, H, D), generator=gen, device=dev).to(torch.bfloat16)
        k2, v2 = (torch.randn((1, sq, KH, D), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
        got, exp = flash_attention_cuda(q2, k2, v2, scale=scale), flash_attention_plain(q2, k2, v2, scale=scale)
        k2_err = float((got.float() - exp.float()).abs().max())
        check(k2_err < BF16_TOL and scaled_err(got, exp) <= ATTN_SCALED_TOL[torch.bfloat16],
              f"K2 at the sharded prefill's shape vs plain: {k2_err}")
        t_b = 2 * (2 * q2.numel() + k2.numel() + v2.numel()) / HBM_BYTES_PER_S * 1e3
        t_o = 4 * H * D * window_pairs(sq, 0) / BF16_FLOPS * 1e3
        out["k2"] = {"max_abs_err": k2_err, "ms": graph_ms(lambda: flash_attention_cuda(q2, k2, v2, scale=scale)),
                     "plain_ms": timed_ms(lambda: flash_attention_plain(q2, k2, v2, scale=scale)),
                     "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(
                         q2.transpose(1, 2), k2.transpose(1, 2), v2.transpose(1, 2), is_causal=True, enable_gqa=True)),
                     "bound_ms": max(t_b, t_o), "bound_by": "bytes" if t_b >= t_o else "operations",
                     "launches": sum(n for n, _ in sh["prefill"]), "per_prefill": L}
        for name, r in (("K1 at the sharded serve's shape (q (8,16,128), k/v (8,2048,8,128))", out["k1"]),
                        ("K2 at the sharded prefill's longest shape (q (1,1024,16,128))", out["k2"])):
            print(f"{name}: {r['ms']:.5f} ms device, bound {r['bound_ms']:.5f} ms by {r['bound_by']}, plain "
                  f"{r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.5f} ms, max abs err {r['max_abs_err']:.3e} ({card})")
        del q, k, v, valid, valid_b, q2, k2, v2, got, exp, runs, sh, un
        free_card()

        # the fp32 cut: identical streams, logits to SERVE_CUT_TOL
        cut = dataclasses.replace(cfg, num_layers=SERVE_CUT_LAYERS, compute_dtype="float32")
        cut_runs = {name: serve(cut, M.init_model(cut, torch.Generator(device=dev).manual_seed(0)), sharded, toks,
                                SERVE_STEPS) for name, sharded in (("unsharded", False), ("sharded", True))}
        ccmp = compare(cut_runs["sharded"], cut_runs["unsharded"])
        check(ccmp["parts_at_step"] is None and ccmp["max_abs_gap"] < SERVE_CUT_TOL,
              f"{SERVE_CUT_LAYERS}-layer fp32 cut, sharded vs unsharded: {ccmp}")
        out["qwen3_cut_fp32"] = ccmp
        print(f"qwen3-1.7b cut to {SERVE_CUT_LAYERS} layers, fp32, sharded vs unsharded serve steps: greedy streams "
              f"identical over {SERVE_STEPS} steps, logits' largest gap {ccmp['max_abs_gap']:.3e} (tol {SERVE_CUT_TOL})")
        del cut_runs
        free_card()

        # -- (b) every arch's -smoke config -----------------------------------
        bs, plen, max_len, steps = SMOKE_SERVE
        smoke = {}
        rng = np.random.default_rng(21)
        for arch in ARCH_IDS:
            base = get_config(f"{arch}-smoke")
            c = dataclasses.replace(base, d_model=SMOKE_D_MODEL, head_dim=max(SMOKE_D_MODEL // max(base.num_heads, 1), 8),
                                    compute_dtype="float32")
            kinds = {c.layer_kind(i) for i in range(c.num_layers)}
            p = torch.as_tensor(rng.integers(0, c.vocab_size, (bs, plen)), device=dev)
            prefix = (torch.as_tensor(rng.standard_normal((bs, SMOKE_PREFIX, FRONTEND_FEATURE_DIM[c.frontend])),
                                      dtype=torch.float32, device=dev) if c.frontend else None)
            pair = {name: serve(c, M.init_model(c, torch.Generator(device=dev).manual_seed(0)), sharded, [p], steps,
                                None if prefix is None else [prefix], max_len)
                    for name, sharded in (("unsharded", False), ("sharded", True))}
            cmp = compare(pair["sharded"], pair["unsharded"])
            tol = SMOKE_TOL * max(1.0, cmp["max_abs_logit"])
            launched = pair["sharded"]["launches"]
            check(cmp["parts_at_step"] is None and cmp["max_abs_gap"] <= tol
                  and (launched["flash_attention"] > 0) == ("attn" in kinds)
                  and (launched["decode_attention"] > 0) == ("attn" in kinds)
                  and (launched["ssm_scan"] > 0) == bool(kinds & {"mlstm", "mamba"}),
                  f"{arch}-smoke sharded vs unsharded serve steps: {cmp}, tol {tol}, launches {launched}")
            smoke[arch] = {**cmp, "launches": launched}
        out["smoke"] = smoke
        print(f"the -smoke configs at d_model {SMOKE_D_MODEL}, fp32, prefill of {bs} x {plen} (frontends after "
              f"{SMOKE_PREFIX} features) + {steps} decode steps, sharded vs unsharded: "
              + "; ".join(f"{a} gap {r['max_abs_gap']:.2e}" for a, r in smoke.items()) + " (streams identical)")
    finally:
        dist.destroy_process_group()
    free_card()

    # -- (c) the dry-run, its fake process group in a process of its own ---------
    out_dir = ROOT / "results" / "dryrun_torch"
    t0 = time.perf_counter()
    args = [a for arch in DRYRUN_ARCHS for a in ("--arch", arch)] + [a for sh in DRYRUN_SHAPES for a in ("--shape", sh)]
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *args, "--out", str(out_dir)],
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), capture_output=True, text=True,
                         timeout=900)
    print(res.stdout, flush=True)
    cells = {}
    hbm_gib = torch.cuda.get_device_properties(0).total_memory / 2**30
    for arch in DRYRUN_ARCHS:
        for sh in DRYRUN_SHAPES:
            rec = json.loads((out_dir / f"{arch}__{sh}__singlepod.json").read_text())
            check(rec["ok"], f"dry-run {arch} {sh}: {rec.get('error')} {rec.get('traceback', '')[-3000:]}")
            cell = f"{arch}:{sh}"
            cells[cell] = {k: rec[k] for k in ("t_compute", "t_memory", "t_memory_analytic", "t_collective",
                                               "dominant", "peak_bytes_per_dev", "hlo_flops_per_dev",
                                               "model_flops_per_dev", "useful_flop_ratio",
                                               "collective_bytes_per_dev", "total_s")}
            peak, earlier = rec["peak_bytes_per_dev"] / 2**30, DRYRUN_EARLIER_PEAK_GIB[cell]
            print(f"dry-run {arch} {sh} on 16 x 16 (predicted from the H100 nameplate peaks, not measured): "
                  f"t_compute {rec['t_compute']:.4e} s, t_memory {rec['t_memory']:.4e} s (analytic "
                  f"{rec['t_memory_analytic']:.4e}), t_collective {rec['t_collective']:.4e} s, dominant "
                  f"{rec['dominant']}, peak {peak:.2f} GiB per device (counted on meta tensors; before each rank's "
                  f"own loss rows and MoE groups {earlier:.2f}; the card holds {hbm_gib:.2f}); counted in "
                  f"{rec['total_s']:.1f} s")
            check(peak < hbm_gib, f"dry-run {cell}: {peak:.2f} GiB a device does not fit the card's {hbm_gib:.2f}")
            if cell not in DRYRUN_REPAIRED:
                check(peak <= DRYRUN_PEAK_GROWTH * earlier, f"dry-run {cell}: peak {peak:.2f} GiB, earlier {earlier}")
    check(res.returncode == 0, f"dry-run exited {res.returncode}: {res.stderr[-2000:]}")
    out["dryrun"] = {"cells": cells, "wall_s": time.perf_counter() - t0}
    out["phase_s"] = time.perf_counter() - t_phase
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
    from repro_torch.kernels.ssm_scan import fold, ssm_scan_cuda, ssm_scan_plain
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
    record = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda, "phase_s": {}}
    t_start = t_lap = time.perf_counter()

    def lap(name):
        """Record and print the seconds since the last lap."""
        nonlocal t_lap
        now = time.perf_counter()
        record["phase_s"][name] = now - t_lap
        print(f"phase {name}: {now - t_lap:.1f} s", flush=True)
        t_lap = now

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    report = _build.build()
    record["build_s"] = time.perf_counter() - t0
    print(f"build: {record['build_s']:.2f} s for {len(report)} kernels (parallel nvcc)")
    lap("2. build")
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
    k1_err, k1_scaled = {}, {}
    rows = [0, 1, 3, 4, 5, 6, 7]  # all but the all-invalid row 2
    k1_invariant = []

    def held(got, exp, idx, normalize, tol, what):
        """The largest absolute and scaled error of a normalised K1 call
        over rows idx, or, for partials, a check of each against its scale
        (acc and l grow with the number of valid keys; the all-invalid row's
        m = -1e30 is checked apart) and (0, 0)."""
        if normalize:
            return err(got[0], exp[0]), scaled_err(got[0], exp[0])
        keep = [i for i, r in enumerate(idx) if r in rows]
        for a, b in zip(got, exp):
            rel = err(a[keep], b[keep]) / max(1.0, float(b[keep].abs().max()))
            check(rel < tol, f"K1 partials vs plain {what}: {rel} >= {tol}")
        return 0.0, 0.0

    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
        worst = scaled = 0.0
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
                ae, se = held(got, exp, range(B), normalize, tol, f"{dtype}, S={S}, B=8")
                worst, scaled = max(worst, ae), max(scaled, se)
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
                    ae, se = held(got2, exp2, range(i, i + 2), normalize, tol, f"{dtype}, S={S}, B=2")
                    worst, scaled = max(worst, ae), max(scaled, se)
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
            scaled = max(scaled, scaled_err(combined[rows], whole[rows]))
        stol = ATTN_SCALED_TOL[torch.float32]  # K1's output is fp32 whatever its inputs' type
        check(worst < tol, f"K1 vs plain {dtype}: {worst} >= {tol}")
        check(scaled <= stol, f"K1 vs plain {dtype}: scaled err {scaled} > {stol}")
        k1_err[str(dtype)], k1_scaled[str(dtype)] = worst, scaled
        print(f"K1 vs plain {dtype}: max abs err {worst:.3e} (tol {tol}), scaled err {scaled:.3e} (tol {stol:.0e})")
    print(f"K1 batch invariance: every row of a batch-8 or batch-2 call bit-identical to the row alone "
          f"({k1_invariant})")
    record["k1_batch_invariant"] = k1_invariant
    lap("3. K1 vs plain")

    # -- 4. K2 vs plain ---------------------------------------------------
    k2_err, k2_scaled = {}, {}
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
        worst = scaled = 0.0
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
            worst, scaled = max(worst, err(got, exp)), max(scaled, scaled_err(got, exp))
        check(worst < tol, f"K2 vs plain {dtype}: {worst} >= {tol}")
        check(scaled <= ATTN_SCALED_TOL[dtype], f"K2 vs plain {dtype}: scaled err {scaled} > {ATTN_SCALED_TOL[dtype]}")
        k2_err[str(dtype)], k2_scaled[str(dtype)] = worst, scaled
        print(f"K2 vs plain {dtype}: max abs err {worst:.3e} (tol {tol}), scaled err {scaled:.3e} "
              f"(tol {ATTN_SCALED_TOL[dtype]:.0e})")

    lap("4. K2 vs plain")
    # the head groupings of the dense and MoE archs (K1 and K2)
    grp = groupings(rnd, gen, card)
    record["groupings"] = grp
    lap("3-4. K1, K2 at G = 1, 6, 16, 8, 7 and head_dim 64")

    # -- 5. K3 vs plain ---------------------------------------------------
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
            inputs = k3_inputs(gen, *shape, dtype=dtype, loga=loga, b_dtype=b_dtype or torch.float32,
                               gate_sd=gate_sd)
            f = fold(*inputs, 256)
            y, h = ssm_scan_cuda(*f, 256)
            ye, he = k3_exact(*f, 256)
            torch.cuda.synchronize()
            sy, sh = scaled_err(y, ye), scaled_err(h, he)
            ty, th = K3_TOL[dtype], K3_TOL[torch.float32]
            held_y = f"scaled err y {sy:.3e} (tol {ty:.3e})"
            if loga == "neg5":  # y against the terms it sums (K3_TERMS_TOL)
                sy_terms, ty = terms_err(y, ye, k3_terms(*f, 256)), K3_TERMS_TOL[dtype]
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
        f = fold(*k3_inputs(gen, 1, 512, 4, 513, 512, dtype=dtype), 256)
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
        f = fold(*k3_inputs(gen, *K3_PATH, dtype=dtype), 256)
        k3_bits[str(dtype)] = k3_bit_checks(f, 1)
    print(f"K3 at the prefill shape {tuple(f[0].shape)}, bit for bit: {k3_bits}")
    check(all(all(v.values()) for v in k3_bits.values()), f"K3 bits: {k3_bits}")
    record["k3_bits"] = k3_bits

    lap("5. K3 vs plain")
    record["k3_mamba"] = k3_mamba(gen, card)
    lap("5. K3 at the Mamba shape")

    # -- 12-16. the large serves, first: each needs the card to itself ----
    record["moonshot"] = serve_moonshot(card)
    lap("12. moonshot-v1-16b-a3b")
    record["mixtral"] = serve_mixtral_cut(card)
    lap("13. mixtral-8x22b cut")
    record["jamba"] = serve_jamba_cut(card)
    lap("14. jamba-1.5-large-398b cut")
    record["musicgen"] = serve_frontend("musicgen-medium", MUSICGEN_LENS, 8, MUSICGEN_MAX_LEN, card)
    lap("15. musicgen-medium")
    record["llava"] = serve_frontend("llava-next-34b", LLAVA_LENS, LLAVA_BATCH, LLAVA_MAX_LEN, card)
    lap("16. llava-next-34b")

    # -- 17. training, right after the large serves: the card holds nothing else
    record["training"] = train_phase(card)
    lap("17. qwen3-1.7b training")
    record["ssm_training"] = ssm_training(card)
    lap("18. SSM training")
    record["family_training"] = family_training(card)
    lap("19. MoE, frontend and remat training")
    record["distribution"] = distribution_phase(card)
    lap("20. distribution")
    record["serve_steps"] = sharded_serve_phase(card)
    lap("21. sharded serve steps and dry-run")

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
    check(stats["decode_graph_replays"] == stats["decode_calls"],
          f"{stats['decode_graph_replays']} of {stats['decode_calls']} decode calls replayed")
    check(all(len(r.tokens) == 32 for r in reqs), "every request got 32 tokens")
    record["serve"] = {**stats, "launches": launches, "peak_bytes": peak}
    print(f"serve qwen3-1.7b arena batch=8 max_len=2048, 16 requests (prompts 128-1024, gen 32) on {card}: "
          f"{stats['tokens_per_s']:.1f} tok/s, mean TTFT {stats['mean_ttft_s'] * 1e3:.1f} ms, "
          f"{stats['decode_calls']} decode calls, occupancy {stats['slot_occupancy']:.3f}, "
          f"wall {stats['wall_s']:.2f} s, peak memory {peak / 2**30:.2f} GiB; launches {launches}")

    lap("6. qwen3-1.7b serve")

    # -- 7. the heterogeneous fleet on qwen3-1.7b ---------------------------
    record["fleet"] = serve_fleet(cfg, kernel_run, params, reqs, card)
    lap("7. fleet")

    # -- 8. logits: kernel path vs plain path -------------------------------
    prompt = torch.as_tensor(np.stack([corpus.grain_tokens(100 + i, 1)[0][:300] for i in range(2)]),
                             dtype=torch.long, device=dev)
    agree = paths_agree(cfg, params, prompt, 512)
    worst, top = agree["max_abs_diff"], agree["max_abs_logit"]
    check(agree["sound"] and worst <= LOGIT_TOL * max(1.0, top),
          f"logits kernel vs plain: {worst} > {LOGIT_TOL} x {top}")
    record["logits"] = {"max_abs_diff": worst, "max_abs_logit": top, "tol": LOGIT_TOL * max(1.0, top)}
    print(f"logits kernel vs plain (prefill 2x300 + 4 decode steps): max abs diff {worst:.4f}, "
          f"largest |logit| {top:.3f}, tol {LOGIT_TOL * max(1.0, top):.4f}")

    lap("8. qwen3 logits")

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

    lap("9. xlstm-1.3b serve")

    # -- 10. xlstm: the first mLSTM block; logits; a parked row -------------
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

    lap("10. xlstm checks")

    # -- 11. times and bounds at the main path's shapes (bf16) --------------
    S = 2048
    q1, k1, v1 = rnd(B, H, D, dtype=torch.bfloat16), rnd(B, S, KH, D, dtype=torch.bfloat16), rnd(B, S, KH, D, dtype=torch.bfloat16)
    valid1 = (torch.rand(B, S, generator=gen, device=dev) > 0.3).to(torch.int32)
    mask1 = valid1.bool()[:, None, None, :]
    qs, ks, vs = q1[:, :, None], k1.transpose(1, 2), v1.transpose(1, 2)
    k1_b = k1_bound(q1, k1, valid1)
    k1_bytes, k1_flops = k1_b["bytes"], k1_b["flops"]
    Sq = 1024
    q2, k2, v2 = rnd(1, Sq, H, D, dtype=torch.bfloat16), rnd(1, Sq, KH, D, dtype=torch.bfloat16), rnd(1, Sq, KH, D, dtype=torch.bfloat16)
    q2s, k2s, v2s = q2.transpose(1, 2), k2.transpose(1, 2), v2.transpose(1, 2)
    k2_bytes = (q2.numel() * 2 + k2.numel() + v2.numel()) * 2
    k2_flops = 4 * H * D * Sq * (Sq + 1) // 2
    # K3 at one 1024-token mLSTM prefill: x = v with the ones column (bf16),
    # loga fp32, b = k * igate (fp32), c = q (bf16); chunk 256
    f3 = fold(*k3_inputs(gen, *K3_PATH, dtype=torch.bfloat16), 256)
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
    # every serve path's own run, its counts set to 0 just before it; and the
    # head groupings of the dense, MoE, hybrid and frontend archs, timed at
    # their serves' shapes
    serves = {"moonshot-v1-16b-a3b": record["moonshot"]["serve"],
              f"mixtral-8x22b ({record['mixtral']['serve']['layers']} layers)": record["mixtral"]["serve"],
              f"jamba-1.5-large-398b ({record['jamba']['serve']['layers']} layers)": record["jamba"]["serve"],
              "musicgen-medium": record["musicgen"]["serve"], "llava-next-34b": record["llava"]["serve"]}
    for kern, key in ((kernels[0], "decode_attention"), (kernels[1], "flash_attention")):
        kern["launches_by_path"] = {"qwen3-1.7b serve": launches[key],
                                    **{f"{name} serve": sv["launches"][key] for name, sv in serves.items()}}
        if key == "flash_attention":
            kern["launches_by_path"]["qwen3-1.7b train"] = record["training"]["train"]["launches"][key]
            fam = record["family_training"]
            kern["launches_by_path"][f"moonshot-v1-16b-a3b ({MOE_TRAIN_LAYERS} layers) train"] = \
                fam["moonshot"]["launches"][key]
            kern["launches_by_path"]["musicgen-medium train"] = fam["musicgen"]["launches"][key]
        check(all(n > 0 for n in kern["launches_by_path"].values()), f"{kern['name']} launched on every path")
        times = grp["k1_times" if key == "decode_attention" else "k2_times"]
        kern["groupings"] = [{k: t[k] for k in ("G", "head_dim", "shape", "ms", "plain_ms", "library_ms", "bound_ms",
                                                "bound_by")} for t in times]
        kern["max_abs_err"] = max(kern["max_abs_err"],
                                  *grp["k1_err" if key == "decode_attention" else "k2_err"].values())
        # each element against its own scale, phases 3-4 and the groupings
        # (K1's output is fp32 whatever its inputs' type)
        scaled_cases = [*(k1_scaled if key == "decode_attention" else k2_scaled).items(),
                        *grp["k1_scaled" if key == "decode_attention" else "k2_scaled"].items()]
        kern["max_scaled_err_by_dtype"] = {str(dt): max(v for k, v in scaled_cases if k.endswith(str(dt)))
                                           for dt in (torch.bfloat16, torch.float32)}
        kern["scaled_tol"] = {str(dt): ATTN_SCALED_TOL[torch.float32 if key == "decode_attention" else dt]
                              for dt in (torch.bfloat16, torch.float32)}
    kernels[0]["launches_per_step"] += "".join(f"; {sv['k1_per_decode_call']:g} per decode step ({name})"
                                               for name, sv in serves.items())
    kernels[1]["launches_per_step"] += "".join(f"; {sv['k2_per_prefill']:g} per prefill ({name})"
                                               for name, sv in serves.items())
    kernels[1]["launches_per_step"] += (f"; {L} per grad microbatch (qwen3-1.7b train; the backward is a recompute)"
                                        f"; {MOE_TRAIN_LAYERS} per grad microbatch (moonshot-v1-16b-a3b, "
                                        f"{MOE_TRAIN_LAYERS} layers, train); 48 per grad microbatch (musicgen-medium "
                                        "train)")
    # K2 at the training shape (qwen3, 2 x 1024, causal): its output held
    # against the plain version in bf16 (the training path's kernel) and
    # fp32, as phase 4 holds it at batch 1; then kernel, plain, SDPA and the
    # bound; beside them the recompute backward of one layer and SDPA's
    # forward and backward together, its yardstick
    from repro_torch.kernels.flash_attention import flash_attention_ref_vjp
    Bt, St, Ht, KHt, Dt = K2_TRAIN_SHAPE
    t_err = {}
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
        qt, kt, vt = rnd(Bt, St, Ht, Dt, dtype=dtype), rnd(Bt, St, KHt, Dt, dtype=dtype), \
            rnd(Bt, St, KHt, Dt, dtype=dtype)
        got = flash_attention_cuda(qt, kt, vt, scale=Dt**-0.5)
        exp = flash_attention_plain(qt, kt, vt, scale=Dt**-0.5)
        torch.cuda.synchronize()
        t_err[str(dtype)] = {"max_abs_err": err(got, exp), "max_scaled_err": scaled_err(got, exp),
                             "tol": tol, "scaled_tol": ATTN_SCALED_TOL[dtype]}
        print(f"K2 vs plain at the training shape {dtype}: max abs err {t_err[str(dtype)]['max_abs_err']:.3e} "
              f"(tol {tol}), scaled err {t_err[str(dtype)]['max_scaled_err']:.3e} (tol {ATTN_SCALED_TOL[dtype]:.0e})")
        check(t_err[str(dtype)]["max_abs_err"] < tol, f"K2 vs plain at the training shape {dtype}: {t_err}")
        check(t_err[str(dtype)]["max_scaled_err"] <= ATTN_SCALED_TOL[dtype],
              f"K2 vs plain at the training shape {dtype}: scaled {t_err}")
        kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"], t_err[str(dtype)]["max_abs_err"])
        kernels[1]["max_scaled_err_by_dtype"][str(dtype)] = max(kernels[1]["max_scaled_err_by_dtype"][str(dtype)],
                                                                t_err[str(dtype)]["max_scaled_err"])
        del qt, kt, vt, got, exp
    qt, gt = rnd(Bt, St, Ht, Dt, dtype=torch.bfloat16), rnd(Bt, St, Ht, Dt, dtype=torch.bfloat16)
    kt, vt = rnd(Bt, St, KHt, Dt, dtype=torch.bfloat16), rnd(Bt, St, KHt, Dt, dtype=torch.bfloat16)
    t_flops = 4 * Bt * Ht * Dt * St * (St + 1) // 2
    t_bytes = (2 * qt.numel() + kt.numel() + vt.numel()) * 2
    t_b, t_o = t_bytes / HBM_BYTES_PER_S * 1e3, t_flops / BF16_FLOPS * 1e3
    lib_in = [t.transpose(1, 2).detach().requires_grad_() for t in (qt, kt, vt)]

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(*lib_in, is_causal=True, enable_gqa=True)
        return torch.autograd.grad(o, lib_in, gt.transpose(1, 2))

    kernels[1]["training_shape"] = {
        "shape": f"q {tuple(qt.shape)}, k/v {tuple(kt.shape)}, causal (qwen3-1.7b train)",
        "err_by_dtype": t_err,
        "ms": graph_ms(lambda: flash_attention_cuda(qt, kt, vt, scale=Dt**-0.5)),
        "plain_ms": timed_ms(lambda: flash_attention_plain(qt, kt, vt, scale=Dt**-0.5)),
        "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(qt.transpose(1, 2), kt.transpose(1, 2),
                                                                      vt.transpose(1, 2), is_causal=True,
                                                                      enable_gqa=True)),
        "bound_ms": max(t_b, t_o), "bound_by": "bytes" if t_b >= t_o else "operations",
        "recompute_backward_ms": timed_ms(lambda: flash_attention_ref_vjp(qt, kt, vt, gt, scale=Dt**-0.5)),
        "library_fwd_bwd_ms": timed_ms(sdpa_fwd_bwd),
    }
    ts = kernels[1]["training_shape"]
    print(f"flash_attention_fwd at the training shape ({ts['shape']}): {ts['ms']:.5f} ms device, bound "
          f"{ts['bound_ms']:.5f} ms by {ts['bound_by']}, plain {ts['plain_ms']:.4f} ms, SDPA {ts['library_ms']:.5f} ms; "
          f"recompute backward {ts['recompute_backward_ms']:.4f} ms, SDPA forward + backward "
          f"{ts['library_fwd_bwd_ms']:.4f} ms ({card})")
    del qt, gt, kt, vt, lib_in
    jamba_name = f"jamba-1.5-large-398b ({record['jamba']['serve']['layers']} layers)"
    kernels[2]["launches_by_path"] = {"xlstm-1.3b serve": xlaunches["ssm_scan"],
                                      f"{jamba_name} serve": serves[jamba_name]["launches"]["ssm_scan"],
                                      "xlstm-1.3b train": record["ssm_training"]["train"]["launches"]["ssm_scan"]}
    check(all(n > 0 for n in kernels[2]["launches_by_path"].values()), "ssd_scan launched on every path")
    kernels[2]["launches_per_step"] += (f"; {serves[jamba_name]['k3_per_prefill']:g} per prefill ({jamba_name})"
                                        f"; {XL} per grad microbatch (xlstm-1.3b train; the backward is a "
                                        "recompute)")
    kernels[2]["training_shape"] = record["ssm_training"]["k3_training_shape"]
    kernels[2]["mamba_shape"] = {k: record["k3_mamba"]["times"][k]
                                 for k in ("shape", "ms", "with_fold_ms", "plain_ms", "library_ms", "bound_ms",
                                           "bound_by")}
    kernels[2]["max_terms_err_mamba_shape"] = max(e["y_over_terms"] for e in record["k3_mamba"]["err"].values())
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
    # K1 on 4 sequence shards of decode_32k plus the combine (phase 20): the
    # distributed path's kernel; its launch is sharded_decode_attention's on
    # the one-rank NCCL mesh
    dd = record["distribution"]
    kernels.append({
        "name": f"flash_decode sharded {DIST_SHARDS} x {DIST_DECODE[1] // DIST_SHARDS}", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu", "replaces": "src/repro/kernels/decode_attention.py:31",
        "tpu_kernel": "src/repro/kernels/decode_attention.py:_decode_kernel, under "
                      "src/repro/parallel/flash_decode.py:sharded_decode_attention",
        "launches": dd["nccl_decode"]["launches"],
        "launches_per_step": f"{DIST_SHARDS} per layer and decode step over {DIST_SHARDS} shards (one per rank); "
                             "1 on the one-rank mesh",
        "max_abs_err": max(dd["k1_sharded_err"][k] for k in ("vs_one_call", "vs_plain")),
        "max_scaled_err": max(dd["k1_sharded_err"][k] for k in ("scaled_vs_one_call", "scaled_vs_plain")),
        **{k: dd["k1_sharded"][k] for k in ("ms", "one_call_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
        "timing": "CUDA graph of 20 x (4 shard calls + combine), replayed 5 times",
    })
    check(kernels[-1]["launches"] > 0, "the sharded decode launched K1")
    # K1 and K2 on the sharded serve path of phase 21 (qwen3-1.7b on the
    # one-rank mesh): K1 through sharded_decode_attention in every decode
    # step, K2 through the wrappers' DTensor path in every prefill
    ss = record["serve_steps"]
    for name, key, source, replaces, per in (
            ("flash_decode sharded serve", "k1", "src/repro_torch/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention.py:31", f"{ss['k1']['per_step']} per decode step (qwen3-1.7b, "
             "through sharded_decode_attention)"),
            ("flash_attention sharded prefill", "k2", "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:28", f"{ss['k2']['per_prefill']} per prefill (qwen3-1.7b, "
             "through the DTensor path)")):
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": ss[key]["launches"], "launches_per_step": per,
                        **{k: ss[key][k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
                                                   "bound_by")},
                        "timing": "CUDA graph of 20 calls, replayed 5 times"})
        check(kernels[-1]["launches"] > 0, f"{name} launched")
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

    step_ms = eager_ms(lambda: M.decode_step(cfg, kernel_run, params, arena, toks, active=act))
    prefill_ms = eager_ms(lambda: M.prefill(cfg, kernel_run, params, prompt, 2048))
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
    x_step_ms = eager_ms(lambda: M.decode_step(xcfg, kernel_run, xparams, xarena, toks, active=act))

    def split_prefill():
        spans = {"ssm_scan": [], "slstm": []}
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with mock.patch.object(ops, "ssm_scan", spanned(spans, "ssm_scan", ops.ssm_scan, training_only=False)), \
                mock.patch.object(ssm, "slstm_apply_full", spanned(spans, "slstm", ssm.slstm_apply_full,
                                                                   training_only=False)):
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

    lap("11. times and bounds")

    # -- 11. the heterogeneous-cluster simulator, on the host ---------------
    record["simulator"] = simulate(card)
    lap("11. simulator")
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in record["phase_s"].items())
          + f"; total {time.perf_counter() - t_start:.1f} s")

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
