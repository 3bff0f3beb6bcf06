"""The paper's own configuration: §IV.a hardware profiles for Hadoop nodes.

Copied from ``repro/configs/hadoop_cluster.py``, less its TPU block.

These are the four workload-specific node configurations the paper lists,
plus the Yahoo terasort node and the recommended balanced datanode. They seed
`repro_torch.core.capacity` profiles for the heterogeneous-cluster
simulations, and the H100 nameplate gives those profiles their defaults.
"""

from dataclasses import dataclass


@dataclass(frozen=True)
class HadoopNodeConfig:
    name: str
    cores: int
    core_ghz: float
    ram_gb: int
    disks: int
    disk_tb: float
    nic_gbps: float

    @property
    def relative_compute(self) -> float:
        return self.cores * self.core_ghz

    @property
    def disk_bw_mbps(self) -> float:  # ~120 MB/s per spinning disk (2012)
        return self.disks * 120.0


# paper §IV.a list of configurations
LIGHT = HadoopNodeConfig("light", cores=8, core_ghz=2.25, ram_gb=8, disks=4, disk_tb=1, nic_gbps=1)
BALANCED = HadoopNodeConfig("balanced", cores=8, core_ghz=2.25, ram_gb=20, disks=4, disk_tb=1, nic_gbps=1)
STORAGE_HEAVY = HadoopNodeConfig("storage", cores=8, core_ghz=2.25, ram_gb=20, disks=12, disk_tb=2, nic_gbps=1)
COMPUTE_INTENSIVE = HadoopNodeConfig("compute", cores=8, core_ghz=2.5, ram_gb=60, disks=8, disk_tb=1, nic_gbps=1)
YAHOO_TERASORT = HadoopNodeConfig("yahoo", cores=8, core_ghz=2.0, ram_gb=8, disks=4, disk_tb=1, nic_gbps=1)

NODE_CONFIGS = {c.name: c for c in (LIGHT, BALANCED, STORAGE_HEAVY, COMPUTE_INTENSIVE, YAHOO_TERASORT)}

# paper §III: cluster-scale constants
NODES_PER_RACK = 40
IN_RACK_GBPS = 1.0
CROSS_RACK_GBPS = 8.0
HDFS_BLOCK_MB = 128
REPLICATION_FACTOR = 3

# paper §IV.c.ii / §IV.d
HEARTBEAT_INTERVAL_S = 3.0
DEAD_NODE_TIMEOUT_S = 600.0
BLOCK_REPORT_INTERVAL_S = 3600.0
NAMENODE_BYTES_PER_OBJECT = 200
BLOCKS_PER_FILE_AVG = 1.5

# NVIDIA H100 SXM nameplate (NVIDIA H100 Tensor Core GPU data sheet): the
# defaults of the capacity profiles, and the peaks a roofline reads
H100_PEAK_FLOPS_BF16 = 989e12  # dense tensor-core bf16, FLOP/s
H100_HBM_BPS = 3.35e12  # HBM3, bytes/s
H100_NVLINK_BPS = 900e9  # NVLink, bytes/s per card (both directions)
H100_HBM_GB = 80
