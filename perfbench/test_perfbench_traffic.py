"""The traffic generator: the same seed gives the same inputs, every seed
the same sizes in another order, and the sizes stay in the stated ranges."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchlib import spec, traffic

SEEDS = (0, 7, 2**31 + 11, 2**33 + 5)


def _mix(cell):
    return spec.resolve(cell).mix


def test_open_loop_is_deterministic_and_in_range():
    mix, lo, hi = _mix("qwen3-1.7b.docqa"), 2048, 16384
    a = traffic.requests(mix, SEEDS[2], 45, 1000)
    b = traffic.requests(mix, SEEDS[2], 45, 1000)
    assert [(r.arrival, r.max_new, r.prompt.tolist()) for r in a] == [(r.arrival, r.max_new, r.prompt.tolist())
                                                                      for r in b]
    lens = [len(r.prompt) for r in a]
    assert min(lens) >= lo and max(lens) <= hi
    assert all(16 <= r.max_new <= 64 for r in a)
    assert all(0 <= r.arrival < 45 for r in a)
    arr = [r.arrival for r in a]
    assert arr == sorted(arr)
    # near the mix's rate, and prompts long enough to fill the stated range
    assert abs(len(a) - mix["rate_per_s"] * 45) <= 2
    assert max(lens) >= 0.8 * hi and min(lens) <= 1.2 * lo
    assert max(r.prompt.max() for r in a) < 1000


def test_every_seed_offers_the_same_sizes_in_another_order():
    mix = _mix("qwen3-1.7b.docqa")
    runs = [traffic.requests(mix, s, 45, 1000) for s in SEEDS]
    sizes = [sorted(len(r.prompt) for r in run) for run in runs]
    outs = [sorted(r.max_new for r in run) for run in runs]
    # a seed may lose an arrival at the window's edge, never its sizes' spread
    n = min(len(x) for x in sizes)
    assert all(abs(len(x) - n) <= 1 for x in sizes)
    assert all(np.allclose(np.mean(x), np.mean(sizes[0]), rtol=0.05) for x in sizes)
    assert all(np.allclose(np.mean(x), np.mean(outs[0]), rtol=0.05) for x in outs)
    orders = [[len(r.prompt) for r in run][:10] for run in runs]
    assert len({tuple(o) for o in orders}) == len(SEEDS)


def test_size_quantiles():
    x = traffic.sizes({"dist": "log_uniform", "min": 1024, "max": 7680}, 100)
    assert x.min() >= 1024 and x.max() <= 7680 and x[0] < 1.05 * 1024 and x[-1] > 0.97 * 7680
    assert list(x) == sorted(x)
    u = traffic.sizes({"dist": "uniform", "min": 256, "max": 512}, 4)
    assert list(u) == [288, 352, 416, 480]


def test_closed_loop_pool():
    import itertools

    mix = _mix("qwen3-1.7b.batch")
    n = mix["pool"]
    a = list(itertools.islice(traffic.pool(mix, SEEDS[3], 500), n + 5))
    b = list(itertools.islice(traffic.pool(mix, SEEDS[3], 500), n + 5))
    assert all(np.array_equal(x.prompt, y.prompt) and x.max_new == y.max_new for x, y in zip(a, b))
    assert all(1024 <= len(r.prompt) <= 3584 and 256 <= r.max_new <= 512 for r in a)
    assert all(len(r.prompt) + r.max_new <= mix["max_len"] for r in a)
    # a round of the pool holds the quantile sizes; the next round goes on
    assert sorted(len(r.prompt) for r in a[:n]) == sorted(traffic.sizes(mix["prompt"], n))
    assert [r.rid for r in a] == list(range(n + 5))


def test_training_microbatches():
    mix = _mix("qwen3-1.7b.train")
    a = traffic.microbatch(mix, SEEDS[2], 3, 500, "cpu")
    b = traffic.microbatch(mix, SEEDS[2], 3, 500, "cpu")
    c = traffic.microbatch(mix, SEEDS[2], 4, 500, "cpu")
    assert a["tokens"].shape == (mix["rows"], mix["seq"])
    assert torch.equal(a["tokens"], b["tokens"]) and not torch.equal(a["tokens"], c["tokens"])
    assert not torch.equal(a["tokens"][0], a["tokens"][1])  # every row differs
    assert torch.equal(a["labels"], a["tokens"]) and bool((a["mask"] == 1).all())


def test_blocks_hold_one_value_of_each_stratum():
    vals = np.arange(96)
    a = traffic.blocked(vals, 8, np.random.default_rng(1))
    b = traffic.blocked(vals, 8, np.random.default_rng(2))
    assert sorted(a) == sorted(b) == list(vals) and list(a) != list(b)
    for blk in a.reshape(12, 8):  # 96 values: 12 blocks of one value of each of the 8 strata
        assert sorted(int(v) // 12 for v in blk) == list(range(8))


def test_open_loop_load_is_even_over_the_window():
    """Every eighth of the window gets about an eighth of the prompt tokens,
    whatever the seed."""
    mix = _mix("qwen3-1.7b.docqa")
    for seed in SEEDS:
        reqs = traffic.requests(mix, seed, 51, 1000)
        tokens = np.zeros(8)
        for r in reqs:
            tokens[min(int(r.arrival / 51 * 8), 7)] += len(r.prompt)
        assert tokens.max() < 1.8 * tokens.mean(), (seed, tokens)
