"""Capacity-proportional data placement (paper §IV.b.ii, after [11]).

Copied from ``repro/core/placement.py`` (pure Python), decision for
decision: ``tests/test_torch_core_runtime.py`` holds it against it.

    "Data movement can be reduced if the number of file fragments placed on
     the disk of each node is proportional to the node's data processing
     speed."

Grains (the HDFS-block analogue: fixed-size microbatch shards) are placed so
each worker's primary share is proportional to its *measured* capacity, with
rack-aware replicas (1 local pod + r−1 spread, HDFS-style). The locality-
aware assignment then lets every worker consume local grains first; whatever
a straggler cannot finish is served to fast workers *from their own replicas*
where possible (P2+P3 interplay), and the residual cross-node bytes are the
quantity the paper says to minimize.

``het_accumulation_schedule`` is the SPMD adaptation: per-pod microbatch
counts ∝ capacity with sample-weighted gradient combine (unbiased — see
docstring) — the form the "fragments ∝ speed" rule takes for bulk-synchronous
training (DESIGN.md §2).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Sequence

from repro_torch.core.topology import Location, Topology


@dataclass(frozen=True)
class Grain:
    """Unit of placement & scheduling: a fixed token-count shard."""

    gid: int
    nbytes: int
    work: float = 1.0  # relative compute cost (≈ tokens)
    # shuffle-like input: must be fetched over the cross-pod pipe regardless
    # of placement (the reduce-phase pattern that congests the network)
    remote_input: bool = False


@dataclass
class PlacementPlan:
    primary: dict[int, Location]  # gid → primary replica location
    replicas: dict[int, list[Location]]  # gid → all replica locations
    per_worker: dict[Location, list[int]]  # location → primary gids

    def replica_workers(self, gid: int) -> list[Location]:
        return self.replicas[gid]


def proportional_counts(capacities: Sequence[float], total: int) -> list[int]:
    """Largest-remainder apportionment of ``total`` items ∝ capacities.

    Guarantees: sum == total; count_i == 0 only if capacity_i == 0 or the
    fleet is larger than the item count; monotone in capacity.
    """
    csum = sum(capacities)
    if csum <= 0 or total == 0:
        return [0] * len(capacities)
    quotas = [c / csum * total for c in capacities]
    counts = [math.floor(q) for q in quotas]
    short = total - sum(counts)
    order = sorted(
        range(len(capacities)), key=lambda i: (quotas[i] - counts[i], capacities[i]), reverse=True
    )
    for i in order[:short]:
        counts[i] += 1
    return counts


def uniform_counts(n_workers: int, total: int) -> list[int]:
    """The stock-Hadoop homogeneity assumption (baseline)."""
    base = total // n_workers
    counts = [base] * n_workers
    for i in range(total - base * n_workers):
        counts[i] += 1
    return counts


def plan_placement(
    grains: Sequence[Grain],
    workers: Sequence[Location],
    capacities: Sequence[float],
    topology: Topology,
    replication: int = 3,
    proportional: bool = True,
) -> PlacementPlan:
    """Place primaries ∝ capacity; replicas rack-aware (HDFS §IV.c.i policy:
    2nd replica off-node same pod, 3rd replica off-pod, further round-robin).
    """
    assert len(workers) == len(capacities)
    n = len(grains)
    counts = (
        proportional_counts(capacities, n)
        if proportional
        else uniform_counts(len(workers), n)
    )

    primary: dict[int, Location] = {}
    replicas: dict[int, list[Location]] = {}
    per_worker: dict[Location, list[int]] = {w: [] for w in workers}

    # deal grains to workers in capacity order (deterministic)
    gi = 0
    for w, c in zip(workers, counts):
        for _ in range(c):
            g = grains[gi]
            primary[g.gid] = w
            per_worker[w].append(g.gid)
            gi += 1

    # rack-aware replica spread
    by_pod: dict[int, list[Location]] = {}
    for w in workers:
        by_pod.setdefault(w.pod, []).append(w)
    pods = sorted(by_pod)

    for g in grains:
        p = primary[g.gid]
        reps = [p]
        # 2nd: same pod, different node
        same = [w for w in by_pod[p.pod] if w != p]
        if same and replication >= 2:
            reps.append(same[g.gid % len(same)])
        # 3rd+: other pods, round-robin
        others = [w for q in pods if q != p.pod for w in by_pod[q]]
        k = 0
        while len(reps) < min(replication, len(workers)):
            cand = others[(g.gid + k) % len(others)] if others else None
            k += 1
            if cand is None:
                break
            if cand not in reps:
                reps.append(cand)
        replicas[g.gid] = reps
    return PlacementPlan(primary, replicas, per_worker)


@dataclass
class AssignmentResult:
    assignment: dict[Location, list[int]]  # worker → gids to process
    moved_bytes: float  # bytes fetched from non-local replicas
    cross_pod_bytes: float
    est_finish_s: dict[Location, float]  # per-worker estimated finish time

    @property
    def makespan_s(self) -> float:
        return max(self.est_finish_s.values()) if self.est_finish_s else 0.0


def locality_aware_assignment(
    grains: Sequence[Grain],
    plan: PlacementPlan,
    workers: Sequence[Location],
    capacities: Sequence[float],
    topology: Topology,
    work_rate_per_capacity: float = 1.0,
) -> AssignmentResult:
    """Assign grains to workers ∝ capacity, preferring local replicas.

    Greedy in two passes (this is the scheduler the jobtracker analogue
    runs): (1) every worker takes its capacity share from grains it holds a
    replica of; (2) leftovers go to the worker with the most spare capacity,
    charged with the replica-fetch transfer cost.
    """
    gmap = {g.gid: g for g in grains}
    cap = dict(zip(workers, capacities))
    share = dict(zip(workers, proportional_counts(capacities, len(grains))))
    holders: dict[int, list[Location]] = {g.gid: plan.replicas[g.gid] for g in grains}

    assignment: dict[Location, list[int]] = {w: [] for w in workers}
    moved = 0.0
    cross = 0.0
    unassigned: list[int] = []

    # pass 1: local replicas, up to the proportional share
    for g in grains:
        placed = False
        for w in holders[g.gid]:
            if len(assignment[w]) < share[w]:
                assignment[w].append(g.gid)
                placed = True
                break
        if not placed:
            unassigned.append(g.gid)

    # pass 2: spill to spare capacity, pay the transfer
    for gid in unassigned:
        spare = sorted(workers, key=lambda w: len(assignment[w]) - share[w])
        w = spare[0]
        src = holders[gid][0]
        assignment[w].append(gid)
        if topology.distance(src, w) > 0:
            moved += gmap[gid].nbytes
            if topology.distance(src, w) == 2:
                cross += gmap[gid].nbytes

    finish = {}
    for w in workers:
        work = sum(gmap[g].work for g in assignment[w])
        rate = max(cap[w] * work_rate_per_capacity, 1e-9)
        finish[w] = work / rate
    return AssignmentResult(assignment, moved, cross, finish)


# ---------------------------------------------------------------------------
# SPMD adaptation: heterogeneity-aware gradient accumulation
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HetSchedule:
    microbatches: tuple[int, ...]  # k_i per pod
    weights: tuple[float, ...]  # w_i for the cross-pod gradient combine

    @property
    def total(self) -> int:
        return sum(self.microbatches)


def het_accumulation_schedule(
    capacities: Sequence[float], total_microbatches: int, min_per_pod: int = 1
) -> HetSchedule:
    """Per-pod microbatch counts ∝ capacity + unbiased combine weights.

    Unbiasedness: pod i averages gradients of k_i iid microbatches
    (ḡ_i = 1/k_i Σ g_ij). The combine Σ_i w_i ḡ_i with w_i = k_i/Σk equals
    the flat average over all Σk microbatches — identical in expectation to
    the homogeneous schedule, so convergence behaviour is unchanged while
    wall-clock per step equalizes across unequal pods.
    """
    k = proportional_counts(capacities, total_microbatches)
    k = [max(v, min_per_pod) for v in k]
    # re-trim if the minimum pushed us over
    while sum(k) > total_microbatches:
        j = max(range(len(k)), key=lambda i: (k[i] - capacities[i] / sum(capacities) * total_microbatches, k[i]))
        if k[j] <= min_per_pod:
            break
        k[j] -= 1
    tot = sum(k)
    return HetSchedule(tuple(k), tuple(v / tot for v in k))
