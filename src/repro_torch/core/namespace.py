"""Metadata service with the paper's name-node accounting (paper §IV.d.i).

Copied from ``repro/core/namespace.py`` (pure Python).

Faithful arithmetic (validated in tests/test_namespace.py):
  * < 200 bytes per metadata object (file inode or block);
  * 1.5 blocks/file average ⇒ 600 B per average file (1 inode + 2 blocks);
  * 100 M files (200 M blocks) ⇒ ≥ 60 GB of coordinator RAM;
  * 1 GB of name-node memory per 1 M blocks rule of thumb (§IV.a);
  * the name-node "can use 70% of its time processing external client
    requests" — the saturation model exposes requests/s headroom.

Beyond-paper: ``ShardedNamespace`` hash-partitions the namespace over S
metadata servers — the scaling fix for the single-RAM ceiling the paper
identifies. In the training framework this same store tracks grains,
replicas and checkpoint shards (the "files" of our workload).
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Iterable, Optional

BYTES_PER_OBJECT = 200  # paper: "less than 200 bytes" per object — use the bound
BLOCKS_PER_FILE_AVG = 1.5
CLIENT_TIME_FRACTION = 0.70  # paper: 70% of time serving client requests


@dataclass
class FileEntry:
    name: str
    blocks: list[int] = field(default_factory=list)
    replication: int = 3


@dataclass
class BlockEntry:
    bid: int
    length: int
    generation: int = 0
    locations: tuple = ()


class Namespace:
    """Single-server namespace (the paper's name-node model)."""

    def __init__(self, ram_bytes: int = 64 << 30, ops_per_s: float = 120_000.0):
        self.ram_bytes = ram_bytes
        self.ops_per_s = ops_per_s
        self.files: dict[str, FileEntry] = {}
        self.blocks: dict[int, BlockEntry] = {}
        self._next_bid = 0

    # ---- capacity model ---------------------------------------------------
    @property
    def objects(self) -> int:
        return len(self.files) + len(self.blocks)

    def memory_bytes(self) -> int:
        return self.objects * BYTES_PER_OBJECT

    def memory_headroom(self) -> float:
        return 1.0 - self.memory_bytes() / self.ram_bytes

    @staticmethod
    def ram_needed(num_files: int, blocks_per_file: float = BLOCKS_PER_FILE_AVG) -> int:
        """The paper's estimate: 100 M files (×1.5 blocks) → ~60 GB."""
        objects = num_files * (1 + blocks_per_file)
        return int(objects * BYTES_PER_OBJECT)

    @staticmethod
    def gb_per_million_blocks() -> float:
        """§IV.a rule of thumb: 1 GB name-node RAM per 1 M blocks stored.
        (The rule budgets headroom above the raw 200 B/object cost.)"""
        return 1.0

    def max_client_rps(self, internal_load_frac: float = 0.0) -> float:
        """Saturation model: client requests get at most the 70% share the
        paper cites, minus internal load (re-replication etc.). Client
        bursts beyond this make the name-node 'unresponsive'."""
        frac = max(0.0, CLIENT_TIME_FRACTION - internal_load_frac)
        return self.ops_per_s * frac

    # ---- namespace ops ------------------------------------------------------
    def create_file(self, name: str, nbytes: int, block_size: int, replication: int = 3) -> FileEntry:
        if name in self.files:
            raise FileExistsError(name)
        nblocks = max(1, -(-nbytes // block_size))
        f = FileEntry(name, replication=replication)
        last = nbytes - (nblocks - 1) * block_size
        for i in range(nblocks):
            bid = self._next_bid
            self._next_bid += 1
            # HDFS: a half-full block occupies only its actual length
            self.blocks[bid] = BlockEntry(bid, block_size if i < nblocks - 1 else last)
            f.blocks.append(bid)
        self.files[name] = f
        if self.memory_bytes() > self.ram_bytes:
            raise MemoryError(
                f"namespace overflow: {self.objects} objects × {BYTES_PER_OBJECT} B "
                f"> {self.ram_bytes} B RAM (paper §IV.d.i limit)"
            )
        return f

    def delete_file(self, name: str) -> None:
        f = self.files.pop(name)
        for b in f.blocks:
            self.blocks.pop(b, None)

    def block_report(self, worker: str, held: Iterable[tuple[int, int, int]]) -> list[int]:
        """Apply a block report [(bid, length, generation)]; return unknown
        block ids (to be deleted by the worker) — §IV.c.ii semantics."""
        unknown = []
        for bid, length, gen in held:
            b = self.blocks.get(bid)
            if b is None:
                unknown.append(bid)
                continue
            if gen >= b.generation:
                b.generation = gen
                b.length = length
                if worker not in b.locations:
                    b.locations = tuple(b.locations) + (worker,)
        return unknown


class ShardedNamespace:
    """Hash-partitioned namespace: the beyond-paper fix for the RAM ceiling."""

    def __init__(self, shards: int, ram_bytes_per_shard: int = 64 << 30, ops_per_s: float = 120_000.0):
        self.shards = [Namespace(ram_bytes_per_shard, ops_per_s) for _ in range(shards)]

    def _shard(self, name: str) -> Namespace:
        return self.shards[zlib.crc32(name.encode()) % len(self.shards)]

    def create_file(self, name: str, nbytes: int, block_size: int, replication: int = 3):
        return self._shard(name).create_file(name, nbytes, block_size, replication)

    def delete_file(self, name: str) -> None:
        self._shard(name).delete_file(name)

    @property
    def objects(self) -> int:
        return sum(s.objects for s in self.shards)

    def memory_bytes(self) -> int:
        return sum(s.memory_bytes() for s in self.shards)

    def max_client_rps(self, internal_load_frac: float = 0.0) -> float:
        return sum(s.max_client_rps(internal_load_frac) for s in self.shards)

    def imbalance(self) -> float:
        """max/mean shard occupancy (hash partitioning keeps this ≈ 1)."""
        counts = [s.objects for s in self.shards]
        mean = sum(counts) / len(counts) if counts else 1.0
        return max(counts) / mean if mean else 1.0
