"""Node/pod capacity model — the paper's §IV.a hardware table, made live.

Copied from ``repro/core/capacity.py`` (pure Python); the nameplate
defaults are the H100's (``configs/hadoop_cluster.py``), and no simulator
path reads them.

The paper's Table 1 maps hardware parameters to their performance impact
(cores → processing speed, RAM → trips to disk, NIC → communication
overhead). Here each worker/pod carries a :class:`NodeProfile`, and a
:class:`CapacityEstimator` maintains *measured* throughput per worker from
heartbeat telemetry (EWMA over reported step times) — this measured capacity,
not the nameplate, drives data placement (core/placement.py), speculation
(core/speculation.py) and grain-size tuning (core/tuning.py), exactly the
"distribute ∝ computing capacity" prescription of §IV.b.ii.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.configs.hadoop_cluster import (
    H100_HBM_BPS,
    H100_NVLINK_BPS,
    H100_PEAK_FLOPS_BF16,
)


@dataclass
class NodeProfile:
    """Static (nameplate) capability of one worker (host + its chips)."""

    name: str
    flops: float = H100_PEAK_FLOPS_BF16  # per-chip peak
    hbm_bw: float = H100_HBM_BPS
    link_bw: float = H100_NVLINK_BPS
    chips: int = 4  # chips per host
    speed_factor: float = 1.0  # degradation (thermal, generation, preemption)

    @property
    def effective_flops(self) -> float:
        return self.flops * self.chips * self.speed_factor


@dataclass
class PodProfile:
    """A pod (= Hadoop rack): workers + intra/cross-pod bandwidth."""

    name: str
    nodes: list[NodeProfile]
    ici_bw: float = H100_NVLINK_BPS  # in-pod (the paper's 1 Gbps in-rack)
    dcn_bw: float = 25e9  # cross-pod (the paper's 8 Gbps cross-rack)

    @property
    def effective_flops(self) -> float:
        return sum(n.effective_flops for n in self.nodes)


def heterogeneous_fleet(
    pod_speeds: list[float], nodes_per_pod: int = 64, chips_per_node: int = 4
) -> list[PodProfile]:
    """Convenience builder: one PodProfile per relative speed factor."""
    pods = []
    for i, s in enumerate(pod_speeds):
        nodes = [
            NodeProfile(name=f"pod{i}/node{j}", chips=chips_per_node, speed_factor=s)
            for j in range(nodes_per_pod)
        ]
        pods.append(PodProfile(name=f"pod{i}", nodes=nodes))
    return pods


@dataclass
class CapacityEstimator:
    """EWMA throughput estimator fed by heartbeat-reported grain times.

    ``update(worker, grains_done, elapsed_s)`` → new estimate. Workers that
    have never reported fall back to nameplate × speed_factor so placement
    has something to start from (the paper: "starting with machines that are
    not perfect for your workload will not be a waste").
    """

    alpha: float = 0.3  # EWMA weight for new observations
    nameplate: dict[str, float] = field(default_factory=dict)
    measured: dict[str, float] = field(default_factory=dict)

    def register(self, worker: str, nameplate_capacity: float) -> None:
        self.nameplate[worker] = nameplate_capacity

    def update(self, worker: str, grains_done: float, elapsed_s: float) -> float:
        if elapsed_s <= 0:
            return self.capacity(worker)
        obs = grains_done / elapsed_s
        prev = self.measured.get(worker)
        new = obs if prev is None else (1 - self.alpha) * prev + self.alpha * obs
        self.measured[worker] = new
        return new

    def capacity(self, worker: str) -> float:
        if worker in self.measured:
            return self.measured[worker]
        return self.nameplate.get(worker, 1.0)

    def capacities(self, workers: list[str]) -> list[float]:
        return [self.capacity(w) for w in workers]

    def relative(self, workers: list[str]) -> list[float]:
        caps = self.capacities(workers)
        total = sum(caps) or 1.0
        return [c / total for c in caps]

    def drop(self, worker: str) -> None:
        self.measured.pop(worker, None)
        self.nameplate.pop(worker, None)
