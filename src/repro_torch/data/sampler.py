"""Locality-aware grain sampling: each pod consumes the grains placed on it.

Copied from ``repro/data/sampler.py`` (pure Python).

Bridges core/placement.py (where grains live) and data/dataset.py (what they
contain). The per-pod iterator serves grain ids in placement order; a fetch
from a pod that holds no replica is recorded as moved bytes — the quantity
capacity-proportional placement minimizes (benchmarks/bench_placement.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, Optional

from repro_torch.core.placement import Grain, PlacementPlan
from repro_torch.core.topology import Location, Topology


@dataclass
class FetchStats:
    local: int = 0
    in_pod: int = 0
    cross_pod: int = 0
    moved_bytes: float = 0.0
    cross_bytes: float = 0.0


class GrainSampler:
    def __init__(
        self,
        grains: list[Grain],
        plan: PlacementPlan,
        topology: Topology,
    ):
        self.gmap = {g.gid: g for g in grains}
        self.plan = plan
        self.topo = topology
        self.stats = FetchStats()
        self._cursor: dict[Location, int] = {}

    def local_gids(self, worker: Location) -> list[int]:
        """All grains with a replica on this worker."""
        return [
            gid for gid, reps in self.plan.replicas.items() if worker in reps
        ]

    def fetch(self, gid: int, worker: Location) -> Grain:
        """Account the fetch cost of reading ``gid`` at ``worker``."""
        g = self.gmap[gid]
        d = min(self.topo.distance(r, worker) for r in self.plan.replicas[gid])
        if d == 0:
            self.stats.local += 1
        elif d == 1:
            self.stats.in_pod += 1
            self.stats.moved_bytes += g.nbytes
        else:
            self.stats.cross_pod += 1
            self.stats.moved_bytes += g.nbytes
            self.stats.cross_bytes += g.nbytes
        return g

    def pod_iterator(self, worker: Location) -> Iterator[Grain]:
        """Endless iterator over the worker's primary grains (placement order),
        wrapping around — the data-parallel shard stream for that pod."""
        own = self.plan.per_worker.get(worker, [])
        if not own:
            own = self.local_gids(worker) or sorted(self.gmap)
        i = self._cursor.get(worker, 0)
        while True:
            gid = own[i % len(own)]
            i += 1
            self._cursor[worker] = i
            yield self.fetch(gid, worker)

    def locality_fraction(self) -> float:
        total = self.stats.local + self.stats.in_pod + self.stats.cross_pod
        return self.stats.local / total if total else 1.0
