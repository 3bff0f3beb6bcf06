"""Replica maintenance + the replication-vs-striping trade-off (paper §IV.c.i).

Copied from ``repro/core/replication.py`` (pure Python); the default
source rate of ``creation_cost_s`` is the H100's HBM rate.

Faithful pieces:
  * default replication factor 3, configurable per grain (paper: "can either
    be configured or specified per file at creation time");
  * the system *maintains* replication automatically: when a node dies the
    under-replicated grains are re-copied from surviving replicas to new
    targets chosen rack-aware (never two replicas on one node; spread pods);
  * recovery-read accounting: replication reads ONE surviving copy; striping
    (erasure coding) must read ≥ k remaining segments — the paper's stated
    trade-off, which benchmarks/bench_replication.py quantifies;
  * "low-overhead replication": replica creation is *pipelined* (HDFS write
    pipeline: src → r1 → r2), so creating r replicas of B bytes costs
    ≈ B·(1 + (r−1)·ε) source time rather than B·r (ε = pipeline stage
    overhead) — the Shen-&-Zhu-style low-overhead mechanism the paper asks
    for, adapted to the write path we actually control.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Sequence

from repro_torch.configs.hadoop_cluster import H100_HBM_BPS
from repro_torch.core.placement import PlacementPlan
from repro_torch.core.topology import Location, Topology


@dataclass
class ReplicationEvent:
    gid: int
    src: Location
    dst: Location
    nbytes: int
    reason: str


@dataclass
class RecoveryCost:
    bytes_read: float
    bytes_written: float
    transfer_s: float
    events: list[ReplicationEvent]


class ReplicaManager:
    def __init__(
        self,
        plan: PlacementPlan,
        grains_bytes: dict[int, int],
        topology: Topology,
        replication: int = 3,
        pipeline_overhead: float = 0.05,
        capacities: Optional[dict[Location, float]] = None,
    ):
        self.plan = plan
        self.nbytes = grains_bytes
        self.topo = topology
        self.r = replication
        self.pipeline_overhead = pipeline_overhead
        # optional worker speeds: recovery targets are then chosen so the
        # re-replicated fragments land ∝ capacity (paper §IV.b.ii lifted to
        # the recovery path), instead of plain copy-count balancing
        self.capacities = capacities
        self.failed: set[Location] = set()

    # ------------------------------------------------------------------
    def live_replicas(self, gid: int) -> list[Location]:
        return [w for w in self.plan.replicas[gid] if w not in self.failed]

    def under_replicated(self) -> list[int]:
        return [
            gid
            for gid in self.plan.replicas
            if 0 < len(self.live_replicas(gid)) < min(self.r, self._n_live_workers())
        ]

    def lost(self) -> list[int]:
        return [gid for gid in self.plan.replicas if not self.live_replicas(gid)]

    def _n_live_workers(self) -> int:
        return len(set(self.plan.per_worker) - self.failed)

    # ------------------------------------------------------------------
    def fail_worker(self, loc: Location) -> list[int]:
        """Mark dead (heartbeat timeout); return grains needing re-copy."""
        self.failed.add(loc)
        return self.under_replicated()

    def recover(self) -> RecoveryCost:
        """Restore replication for every under-replicated grain.

        Target choice is rack-aware: prefer a pod NOT already holding a
        replica; never a node that already has one. Source = nearest
        replica. With ``capacities`` set, ties are arbitrated by the
        smallest post-copy load/capacity ratio, so fast survivors absorb
        proportionally more of the re-replicated data (capacity
        re-proportioning after a shrink).
        """
        events: list[ReplicationEvent] = []
        read = written = t_total = 0.0
        workers = [w for w in self.plan.per_worker if w not in self.failed]
        by_pod: dict[int, list[Location]] = {}
        for w in workers:
            by_pod.setdefault(w.pod, []).append(w)
        load = {w: 0 for w in workers}  # balance re-replication targets

        for gid in self.under_replicated():
            live = self.live_replicas(gid)
            need = min(self.r, len(workers)) - len(live)
            for _ in range(need):
                held_pods = {w.pod for w in live}
                cands = [w for w in workers if w not in live and w.pod not in held_pods]
                if not cands:
                    cands = [w for w in workers if w not in live]
                if not cands:
                    break
                if self.capacities:
                    dst = min(
                        cands,
                        key=lambda w: (
                            (load[w] + 1) / max(self.capacities.get(w, 1.0), 1e-9),
                            w.pod,
                            w.node,
                        ),
                    )
                else:
                    dst = min(cands, key=lambda w: load[w])
                src = min(live, key=lambda s: self.topo.distance(s, dst))
                b = self.nbytes[gid]
                events.append(ReplicationEvent(gid, src, dst, b, "re-replication"))
                read += b
                written += b
                t_total += self.topo.transfer_s(b, src, dst)
                live.append(dst)
                load[dst] += 1
                self.plan.replicas[gid] = live
        return RecoveryCost(read, written, t_total, events)

    # ------------------------------------------------------------------
    def creation_cost_s(self, gid: int, src_bw: float = H100_HBM_BPS) -> float:
        """Pipelined r-replica write: ≈ B·(1 + (r−1)·ε)/bw at the source
        (vs B·r/bw if the client wrote each replica itself)."""
        b = self.nbytes[gid]
        return b * (1.0 + (self.r - 1) * self.pipeline_overhead) / src_bw

    def storage_overhead(self) -> float:
        return float(self.r)


# ---------------------------------------------------------------------------
# Striping / erasure-coding alternative (the paper's comparison point)
# ---------------------------------------------------------------------------


@dataclass
class StripingScheme:
    """k data segments + m parity (Reed-Solomon-like accounting).

    The paper: "with striping … the system may need to read two or more of
    the remaining data segments … replication always needs only one copy",
    but striping is more space-efficient: overhead (k+m)/k vs r.
    """

    k: int = 4
    m: int = 2

    def storage_overhead(self) -> float:
        return (self.k + self.m) / self.k

    def recovery_bytes(self, nbytes: int, lost_segments: int = 1) -> float:
        # reconstructing any lost segment reads k surviving segments
        seg = nbytes / self.k
        return self.k * seg * lost_segments

    def tolerable_failures(self) -> int:
        return self.m


def replication_recovery_bytes(nbytes: int) -> float:
    """Replication reads exactly one surviving copy (paper §IV.c.i)."""
    return float(nbytes)
