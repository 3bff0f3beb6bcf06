"""Cluster topology + transfer-cost model (paper §III / §IV.a).

The paper's cluster: 40 nodes/rack, 1 Gbps in-rack, 8 Gbps out-of-rack.
The accelerator analogue: N workers/pod, a fast link in-pod, a slower
network across pods. The transfer cost model quantifies the §IV.b.ii
observation that "migrating huge amounts of data leads to excessive network
congestion": moving a grain off-node costs in-pod bandwidth, off-pod costs
the (scarcer) cross-pod hop.

Copied from ``repro/core/topology.py`` (pure Python); the same-node rate
defaults to the H100's HBM rate, which no simulator path reads.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.configs.hadoop_cluster import H100_HBM_BPS


@dataclass(frozen=True)
class Location:
    pod: int
    node: int

    def __str__(self) -> str:
        return f"pod{self.pod}/node{self.node}"


@dataclass
class Topology:
    num_pods: int
    nodes_per_pod: int
    in_pod_bw: float = 50e9  # bytes/s between nodes in a pod
    cross_pod_bw: float = 25e9  # bytes/s between pods
    local_bw: float = H100_HBM_BPS  # same-node (HBM-speed, effectively free)

    def workers(self) -> list[Location]:
        return [
            Location(p, n)
            for p in range(self.num_pods)
            for n in range(self.nodes_per_pod)
        ]

    def bandwidth(self, src: Location, dst: Location) -> float:
        if src == dst:
            return self.local_bw
        if src.pod == dst.pod:
            return self.in_pod_bw
        return self.cross_pod_bw

    def transfer_s(self, nbytes: float, src: Location, dst: Location) -> float:
        return nbytes / self.bandwidth(src, dst)

    def distance(self, src: Location, dst: Location) -> int:
        """0 = local, 1 = same pod, 2 = cross-pod (HDFS locality levels)."""
        if src == dst:
            return 0
        return 1 if src.pod == dst.pod else 2
