"""The metrics' arithmetic: percentiles and rates over every request and
the whole window (shown on a planted stall), and the FLOP and byte counts
against hand counts."""

from __future__ import annotations

import math
import statistics

import numpy as np
import pytest

from benchlib import counts, spec, stats
from benchlib.counts import BF16_FLOPS, HBM_BYTES_PER_S


def test_percentile_matches_numpy_and_counts_missing():
    rng = np.random.default_rng(3)
    x = rng.exponential(size=137).tolist()
    for q in (50, 90, 99):
        assert stats.percentile(x, q) == pytest.approx(float(np.percentile(x, q)))
    assert stats.percentile([1.0, 2.0, math.inf, math.inf], 90) == math.inf
    assert stats.percentile([1.0] * 19 + [math.inf], 90) == 1.0


def test_spread_is_statistics_quartiles():
    v = [10.0, 10.2, 9.9, 10.4, 10.1, 9.8]
    q1, m, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / m)


def _req(rid, arrival, first, stamps, finished=None, prompt=100, submitted=None):
    return {"rid": rid, "arrival": arrival, "prompt": prompt, "max_new": len(stamps), "tokens": len(stamps),
            "submitted": first if submitted is None else submitted, "first_token": first,
            "finished": stamps[-1] if finished is None else finished, "stamps": stamps}


def _open(reqs, seconds=10.0, t_end=12.0):
    return {"seconds": seconds, "requests": reqs, "t_end": t_end}


def test_ttft_and_itl_tails_see_a_planted_stall():
    """Twenty requests with a 50 ms TTFT and 10 ms gaps; two of them wait
    out a 2 s stall. The p90 TTFT is set by the stalled pair, and the p99
    gap by the one stall that cuts into a stream; a request that arrives
    after the window is not counted, a failed one counts at the run's end."""
    reqs = []
    for i in range(20):
        a = 0.4 * i
        first = a + (2.0 if i in (5, 6) else 0.05)
        st = [first + 0.01 * k for k in range(10)]
        if i == 9:
            st = st[:5] + [s + 2.0 for s in st[5:]]
        reqs.append(_req(i, a, first, st))
    ttft = spec.reader("ttft_p90_ms")(_open(reqs))
    assert ttft == pytest.approx(1e3 * stats.percentile([2.0] * 2 + [0.05] * 18, 90))
    assert ttft > 200
    itl = spec.reader("itl_p99_ms")(_open(reqs))
    gaps = [0.01] * (20 * 9 - 1) + [2.01]
    assert itl == pytest.approx(1e3 * stats.percentile(gaps, 99))
    late = reqs + [_req(99, 10.5, 10.6, [10.6, 10.7])]
    assert spec.reader("ttft_p90_ms")(_open(late)) == pytest.approx(ttft)
    failed = [dict(r, finished=-1.0, first_token=-1.0) if i < 3 else r for i, r in enumerate(reqs)]
    assert spec.reader("ttft_p90_ms")(_open(failed, t_end=12.0)) >= 1e3 * (12.0 - 0.8) * 0.9


def test_queue_wait_reads_submitted_less_arrival():
    reqs = [_req(i, float(i), i + 0.3, [i + 0.3], submitted=i + 0.1) for i in range(10)]
    assert spec.reader("queue_wait_p90_ms.docqa")(_open(reqs)) == pytest.approx(100.0)


def test_out_tok_s_counts_tokens_inside_the_window_over_the_window():
    reqs = [{"stamps": [0.5, 1.0, 3.0, 9.9, 10.1, 10.5], "prompt": 10}, {"stamps": [2.0, 4.0], "prompt": 10}]
    data = {"seconds": 10.0, "t_open": 0.5, "t_close": 10.5, "requests": reqs}
    assert spec.reader("out_tok_s")(data) == pytest.approx(8 / 10.0)


def test_train_tok_s_and_update_share():
    steps = [{"t0": 0.0, "t1": 2.0, "tokens": 24576, "update_s": 0.2},
             {"t0": 2.01, "t1": 4.0, "tokens": 24576, "update_s": 0.3}]
    data = {"steps": steps, "rows": 2, "seq": 2048}
    assert spec.reader("train_tok_s")(data) == pytest.approx(2 * 24576 / 4.0)
    assert spec.reader("update_share.train")(data) == pytest.approx(100 * 0.5 / 4.0)


def _dims():
    c = spec.resolve("qwen3-1.7b.docqa")
    return c.ref.dims(c.cfg)


def test_counts_by_hand():
    d = _dims()  # qwen3-1.7b: D 2048, 16 q and 8 kv heads of 128, F 6144, V 151936, 28 layers
    per_layer = 2048 * 2048 + 2 * 2048 * 1024 + 2048 * 2048 + 3 * 2048 * 6144
    assert counts.layer_params(d) == per_layer == 50_331_648
    assert counts.head_params(d) == 2048 * 151936
    assert counts.window_pairs(4) == 10 and counts.window_pairs(5, 2) == 3 + 3 * 2
    s = 1000
    hand = 28 * (2 * per_layer * s + 4 * 16 * 128 * (s * (s + 1) // 2)) + 2 * 2048 * 151936
    assert counts.prefill_flops(d, s) == hand
    assert counts.decode_flops(d, 300) == 28 * (2 * per_layer + 4 * 16 * 128 * 300) + 2 * 2048 * 151936
    n = 28 * per_layer + 2048 * 151936
    assert counts.train_flops(d, 2, 2048) == 6 * n * 4096 + 3 * 2 * 28 * 4 * 16 * 128 * (2048 * 2049 // 2)


def test_kernel_least_times_by_hand():
    d = _dims()
    s = 4096
    flops = 4 * 16 * 128 * (s * (s + 1) // 2)
    nbytes = 2 * s * 128 * (2 * 16 + 2 * 8)
    assert counts.k2_least_s(d, s) == pytest.approx(max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S))
    # K1 at 128 slots of 4096, 300,000 valid keys: bound by bytes
    b, cap, n = 128, 4096, 300_000
    nbytes = b * 16 * 128 * 2 + b * cap * 4 + b * 16 * 128 * 4 + 2 * n * 8 * 128 * 2
    assert counts.k1_least_s(d, b, cap, n) == pytest.approx(nbytes / HBM_BYTES_PER_S)
    assert nbytes / HBM_BYTES_PER_S > 4 * 16 * 128 * n / BF16_FLOPS
