"""Block-structured dataset: the HDFS data model for the training pipeline.

Port of ``repro/data/dataset.py``. A corpus is split into fixed-size
*blocks* (default 128 MB, tunable per the paper's R2 rule); blocks
subdivide into *grains*, the microbatch shards the scheduler places and
the coordinator accumulates. Synthetic corpora generate tokens
deterministically from (seed, grain_id) with numpy, so any replica holder
can materialise a grain locally, and the port's batches equal the JAX
package's bit for bit.

The synthetic LM task is structured (affine-progression sequences with
noise) rather than uniform noise, so a real model trained on it shows a
genuinely decreasing loss.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.placement import Grain

BYTES_PER_TOKEN = 4  # int32 storage


@dataclass(frozen=True)
class BlockDataset:
    """Metadata view: total tokens → blocks → grains."""

    total_tokens: int
    block_bytes: int = 128 << 20
    grain_tokens: int = 1 << 18  # tokens per grain (scheduler unit)

    @property
    def total_bytes(self) -> int:
        return self.total_tokens * BYTES_PER_TOKEN

    @property
    def num_blocks(self) -> int:
        return max(1, -(-self.total_bytes // self.block_bytes))

    @property
    def grains_per_block(self) -> int:
        return max(1, self.block_bytes // (self.grain_tokens * BYTES_PER_TOKEN))

    def grains(self) -> list[Grain]:
        n = self.num_blocks * self.grains_per_block
        return [
            Grain(gid=i, nbytes=self.grain_tokens * BYTES_PER_TOKEN, work=float(self.grain_tokens))
            for i in range(n)
        ]


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


def batch_iterator(
    cfg: ModelConfig,
    seq_len: int,
    batch: int,
    seed: int = 0,
    start_gid: int = 0,
    frontend_prefix: int = 0,
) -> Iterator[dict]:
    """Endless iterator of training batches (numpy arrays; gid increments
    per batch). For a frontend arch with ``frontend_prefix``, seeded
    ``prefix_features`` (batch, frontend_prefix, feature dim) come first
    and the tokens are cut to ``seq_len - frontend_prefix``."""
    from repro_torch.models.model import FRONTEND_FEATURE_DIM

    corpus = SyntheticCorpus(cfg.vocab_size, seq_len, seed)
    gid = start_gid
    while True:
        b = corpus.batch(gid, batch)
        if cfg.frontend and frontend_prefix:
            rng = np.random.default_rng(gid ^ 0xF00D)
            feat = FRONTEND_FEATURE_DIM[cfg.frontend]
            b["prefix_features"] = rng.standard_normal((batch, frontend_prefix, feat)).astype(np.float32)
            b["tokens"] = b["tokens"][:, : seq_len - frontend_prefix]
        gid += 1
        yield b
