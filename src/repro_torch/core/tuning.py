"""Grain/task-count autotuner — the paper's §IV.b.i rules, verbatim:

  R1  "If each task takes less than 30-40 seconds, reduce the number of
       tasks" (bigger grains; JVM-reuse analogue = a persistent compiled
       step).
  R2  "If a job has more than 1TB of input, consider increasing the block
       size … to 256M or even 512M".
  R3  "Increase the number of mapper tasks to some multiple of the number of
       mapper slots … so long as each runs ≥ 30-40 s".
  R4  "Don't schedule too many reduce tasks … equal to or a bit less than
       the number of reduce slots".

For the training runtime: a *grain* is the accumulation microbatch a pod
step processes; *slots* are pods×accumulators; the *reduce phase* is the
cross-pod gradient combine. The tuner takes measured/estimated grain cost
and emits (grain_tokens, grains_per_step, block_bytes, reducers).

Copied from ``repro/core/tuning.py`` (pure Python).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

TB = 1 << 40
MB = 1 << 20


@dataclass(frozen=True)
class TuningInput:
    total_input_bytes: int
    n_slots: int  # parallel execution slots (pods × concurrent grains)
    est_grain_seconds: float  # measured/estimated wall-time of current grain
    grain_tokens: int  # current grain size (tokens)
    n_reduce_slots: int  # cross-pod combine parallelism
    target_seconds: float = 35.0  # paper's 30–40 s midpoint
    setup_overhead_s: float = 3.0  # paper: "setup and scheduling … a few seconds"


@dataclass(frozen=True)
class TuningDecision:
    grain_tokens: int
    grains_per_wave: int  # multiple of slots (R3)
    block_bytes: int  # dataset block size (R2)
    n_reducers: int  # R4
    est_grain_seconds: float
    efficiency: float  # useful time fraction 1 - overhead/(overhead+grain)
    rules_applied: tuple[str, ...]


def tune(inp: TuningInput) -> TuningDecision:
    rules: list[str] = []
    tokens = inp.grain_tokens
    sec = max(inp.est_grain_seconds, 1e-6)
    per_token_s = sec / tokens

    # R1: grow grains until ≥ target wall-time
    if sec < inp.target_seconds:
        scale = inp.target_seconds / sec
        tokens = int(2 ** math.ceil(math.log2(tokens * scale)))
        sec = per_token_s * tokens
        rules.append("R1:grow-grain")
    # R1 converse: very long grains hurt load balance / speculation granularity
    elif sec > 4 * inp.target_seconds:
        scale = sec / (2 * inp.target_seconds)
        tokens = max(1, int(2 ** math.floor(math.log2(tokens / scale))))
        sec = per_token_s * tokens
        rules.append("R1:shrink-grain")

    # R2: block size by input volume
    if inp.total_input_bytes > 10 * TB:
        block = 512 * MB
        rules.append("R2:block-512M")
    elif inp.total_input_bytes > 1 * TB:
        block = 256 * MB
        rules.append("R2:block-256M")
    else:
        block = 128 * MB

    # R3: waves as a multiple of slots (keep every slot busy, aligned)
    grains_per_wave = max(inp.n_slots, 1)
    rules.append("R3:multiple-of-slots")

    # R4: reducers ≤ reduce slots (a bit less: leave one straggler slot free)
    n_reducers = max(1, inp.n_reduce_slots - 1) if inp.n_reduce_slots > 1 else 1
    rules.append("R4:reducers<=slots")

    eff = sec / (sec + inp.setup_overhead_s)
    return TuningDecision(
        grain_tokens=tokens,
        grains_per_wave=grains_per_wave,
        block_bytes=block,
        n_reducers=n_reducers,
        est_grain_seconds=sec,
        efficiency=eff,
        rules_applied=tuple(rules),
    )


def efficiency_curve(
    per_token_s: float, setup_overhead_s: float, token_range: list[int]
) -> list[tuple[int, float]]:
    """Throughput-efficiency vs grain size — the knee the paper predicts at
    the 30–40 s point (benchmarks/bench_tuning.py plots this)."""
    out = []
    for tk in token_range:
        sec = per_token_s * tk
        out.append((tk, sec / (sec + setup_overhead_s)))
    return out


def estimate_grain_seconds(
    grain_tokens: int,
    model_flops_per_token: float,
    pod_flops: float,
    mfu: float = 0.4,
) -> float:
    """Napkin estimate used before any measurement exists."""
    return grain_tokens * model_flops_per_token / max(pod_flops * mfu, 1.0)
