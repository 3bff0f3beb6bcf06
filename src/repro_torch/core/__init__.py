"""The paper's contribution, as composable modules, copied from
``repro.core`` (pure Python):

capacity    — §IV.a hardware/capacity model + measured-throughput estimator
topology    — §III cluster topology, transfer cost (racks → pods)
placement   — §IV.b.ii capacity-proportional placement + het-DP schedule
speculation — §III.b naive-vs-LATE speculative execution (in simulator)
simulator   — event-driven het-cluster simulator (policy validation layer)
heartbeat   — §IV.c.ii heartbeats, piggybacked commands, liveness
replication — §IV.c.i replica maintenance + erasure-striping trade-off
namespace   — §IV.d.i name-node byte-accounting + sharded scaling fix
tuning      — §IV.b.i task-count / block-size rules of thumb
scheduler   — inter-job slot schedulers (fifo | fair | fair_capacity |
              capacity-weighted)
workload    — seeded multi-job scenario generator + canonical presets,
              plus the serving fleet simulator (FleetSpec / run_fleet)
admission   — SLO-aware admission control (admit/reject/defer at the door),
              shared by the simulator and launch/serve.py
router      — cross-replica request routing (round_robin | capacity_weighted
              | shortest_backlog) + LATE-style re-dispatch planning, shared
              by run_fleet and launch/fleet.py
autoscale   — replica-pool autoscaling, shared by run_fleet and
              launch/fleet.py

The het-DP training coordinator (``HetCoordinator``, ``PodRuntime``) is not
ported yet.
"""

from repro_torch.core.capacity import CapacityEstimator, NodeProfile, PodProfile  # noqa: F401
from repro_torch.core.heartbeat import Command, Heartbeat, HeartbeatMonitor  # noqa: F401
from repro_torch.core.namespace import Namespace, ShardedNamespace  # noqa: F401
from repro_torch.core.placement import (  # noqa: F401
    Grain,
    HetSchedule,
    het_accumulation_schedule,
    locality_aware_assignment,
    plan_placement,
    proportional_counts,
    uniform_counts,
)
from repro_torch.core.admission import (  # noqa: F401
    ADMISSION,
    AdmissionPolicy,
    ClusterView,
    JobRequest,
    get_policy,
)
from repro_torch.core.replication import ReplicaManager, StripingScheme  # noqa: F401
from repro_torch.core.router import (  # noqa: F401
    ROUTER,
    InflightView,
    ReplicaView,
    Router,
    get_router,
    plan_redispatch,
)
from repro_torch.core.scheduler import SCHEDULERS, JobScheduler, JobView  # noqa: F401
from repro_torch.core.simulator import (  # noqa: F401
    POLICIES,
    ChurnEvent,
    SimCluster,
    SimJob,
    SimWorker,
    WorkloadResult,
)
from repro_torch.core.workload import (  # noqa: F401
    FLEET_PRESETS,
    PRESETS,
    ClusterSpec,
    FleetResult,
    FleetSpec,
    WorkloadSpec,
    build_cluster,
    build_scenario,
    build_sim,
    generate_fleet_requests,
    generate_workload,
    run_fleet,
)
from repro_torch.core.topology import Location, Topology  # noqa: F401
from repro_torch.core.tuning import TuningInput, tune  # noqa: F401
