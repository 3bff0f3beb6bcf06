"""Synthetic corpus: deterministic token streams from (seed, grain_id).

A copy of ``repro.data.dataset.SyntheticCorpus``; the rest of that module
(the block/grain metadata and the training batch iterator) is not on the
serving path and is not ported yet.
"""

from __future__ import annotations

import numpy as np


class SyntheticCorpus:
    """Deterministic structured token streams.

    Sequence family: tokens follow x_{t+1} = (a·x_t + b) mod V with per-
    sequence (a, b) drawn from a small set, plus ε-noise — learnable by a
    causal LM but not trivially constant.
    """

    def __init__(self, vocab_size: int, seq_len: int, seed: int = 0, noise: float = 0.02):
        self.vocab = vocab_size
        self.seq_len = seq_len
        self.seed = seed
        self.noise = noise

    def grain_tokens(self, gid: int, batch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed << 20) ^ gid)
        v = self.vocab
        # arithmetic progressions (a=1): next = prev + b mod V, b per sequence
        # from a small set — learnable by a 2-layer model, non-trivial prior
        a = np.ones((batch, 1), np.int64)
        b = rng.integers(1, min(16, v), size=(batch, 1))
        x0 = rng.integers(0, v, size=(batch, 1))
        toks = np.zeros((batch, self.seq_len), np.int64)
        toks[:, :1] = x0
        for t in range(1, self.seq_len):
            toks[:, t : t + 1] = (a * toks[:, t - 1 : t] + b) % v
        flip = rng.random((batch, self.seq_len)) < self.noise
        toks[flip] = rng.integers(0, v, size=int(flip.sum()))
        return toks.astype(np.int32)

    def batch(self, gid: int, batch: int) -> dict:
        toks = self.grain_tokens(gid, batch)
        return {
            "tokens": toks,
            "labels": toks.copy(),
            "mask": np.ones_like(toks, np.float32),
        }
