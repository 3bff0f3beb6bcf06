"""The one traffic generator: it reads a mix's parameters
(``perfbench/traffic/<mix>.json``) and makes the requests or batches of a
run from ``--seed``.

Every seed gets the same set of sizes and of gaps between arrivals, in an
order of its own: sizes are the quantiles ``(i + 1/2) / n`` of the stated
distribution, dealt by the seed so that each block of ``block`` requests
holds one of each stratum (:func:`blocked`). So two seeds offer the same
work, evenly spread over the window, and differ in its order and in the
tokens; the spread of a cell's runs is that of the system, not of the
draw.

Kinds of mix:

* ``open_loop``: requests arrive on a schedule at ``rate_per_s`` over the
  window; ``requests(seed, seconds)`` gives them all. It is not a Poisson
  process: the gaps are the exponential distribution's quantiles, dealt in
  blocks like the sizes, so bursts and runs of long prompts are bounded.
* ``closed_loop``: ``clients`` clients each send their next request when
  the last completes; ``pool(seed)`` gives the requests, without end, in
  the order they are taken.
* ``train``: microbatches of ``rows`` x ``seq`` tokens; ``microbatch(seed,
  i, device)`` gives microbatch ``i`` on the device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass
class Req:
    """One request as the generator makes it: its scheduled arrival in
    seconds from the window's opening (0 for a closed loop), its prompt and
    its output length (tokens, the first one included)."""

    rid: int
    arrival: float
    prompt: np.ndarray
    max_new: int


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def sizes(spec: dict, n: int) -> np.ndarray:
    """``n`` whole sizes at the quantiles of ``spec``'s distribution, in
    ascending order: ``uniform`` or ``log_uniform`` between ``min`` and
    ``max`` inclusive."""
    lo, hi = spec["min"], spec["max"]
    u = _quantiles(n)
    if spec["dist"] == "uniform":
        x = lo + u * (hi - lo)
    elif spec["dist"] == "log_uniform":
        x = np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    else:
        raise ValueError(f"unknown size distribution {spec['dist']!r}")
    return np.clip(np.round(x), lo, hi).astype(np.int64)


def blocked(values: np.ndarray, block: int, rng: np.random.Generator) -> np.ndarray:
    """``values`` (ascending) in an order drawn from ``rng`` that keeps the
    load even: they are cut into ``block`` strata of neighbouring values,
    each stratum deals one value to each of ``ceil(n / block)`` consecutive
    blocks (to a random subset of them where it is short), and each block is
    shuffled. So every block of about ``block`` requests holds one value of
    each stratum, and a seed changes which, and in what order."""
    n = len(values)
    m = -(-n // block)
    slots = [[] for _ in range(m)]
    for stratum in np.array_split(np.asarray(values), block):
        for v, b in zip(rng.permutation(stratum), rng.permutation(m)):
            slots[b].append(v)
    return np.concatenate([rng.permutation(np.asarray(s)) for s in slots if s]).astype(np.asarray(values).dtype)


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, *stream])


def n_open(mix: dict, seconds: float) -> int:
    """Requests of an open-loop mix in a window of ``seconds``."""
    return max(1, round(mix["rate_per_s"] * seconds))


def requests(mix: dict, seed: int, seconds: float, vocab: int) -> list[Req]:
    """An open-loop mix's requests for a window of ``seconds``, by arrival.
    The gaps are the exponential quantiles at ``rate_per_s``, shuffled, and
    the arrivals their running sum; an arrival past the window is dropped."""
    n, b = n_open(mix, seconds), mix["block"]
    rng = _rng(seed, 1)
    gaps = -np.log1p(-_quantiles(n)) / mix["rate_per_s"]
    arrivals = np.cumsum(blocked(gaps, b, rng))
    prompt = blocked(sizes(mix["prompt"], n), b, rng)
    out = blocked(sizes(mix["output"], n), b, rng)
    toks = _rng(seed, 2)
    return [Req(i, float(arrivals[i]), toks.integers(0, vocab, size=int(prompt[i]), dtype=np.int64), int(out[i]))
            for i in range(n) if arrivals[i] < seconds]


def pool(mix: dict, seed: int, vocab: int):
    """A closed-loop mix's requests in the order the clients take them, without
    end: each round of ``pool`` requests takes the quantile sizes in an order
    of its own, drawn from the seed; each request's tokens are made when it
    is taken."""
    n, b = mix["pool"], mix["block"]
    rng = _rng(seed, 1)
    prompt, out = sizes(mix["prompt"], n), sizes(mix["output"], n)
    i = 0
    while True:
        p, o = blocked(prompt, b, rng), blocked(out, b, rng)
        for j in range(n):
            toks = _rng(seed, 2, i).integers(0, vocab, size=int(p[j]), dtype=np.int64)
            yield Req(i, 0.0, toks, int(o[j]))
            i += 1


def microbatch(mix: dict, seed: int, i: int, vocab: int, device):
    """Training microbatch ``i``: ``rows`` x ``seq`` uniform token ids made
    on ``device`` from (seed, i), every row different; the program's batch
    dict (tokens, labels = tokens, mask of ones)."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1_000_003 + i) % (1 << 63))
    toks = torch.randint(0, vocab, (mix["rows"], mix["seq"]), generator=gen, device=device)
    return {"tokens": toks, "labels": toks, "mask": torch.ones(toks.shape, device=device)}
