"""Seeded multi-job workload generation for the het-cluster simulator.

Copied from ``repro/core/workload.py`` (pure Python), with every sum a
plain left fold (``simulator.left_sum``), which the stored golden hashes
and the ``check_views`` equality assume; the random streams
(``random.Random`` and numpy's ``PCG64``) are the reference's own.

The paper's regime — many MapReduce jobs sharing one heterogeneous cluster —
needs reproducible *scenarios*: an arrival process, a job-size mix, a
locality profile, and optional fault injection. Everything here is driven by
``random.Random(seed)`` so the same spec + seed produces a bit-identical job
list (and therefore, with a deterministic scheduler, a bit-identical
``WorkloadResult``); benchmarks and property tests sweep dozens of scenarios
by just varying the seed.

Layout:
  ClusterSpec  — pods, per-pod speed ratio, bandwidths, fault injection
                 (per-node stragglers/failures, whole-pod death/recovery,
                 heartbeat cadence + pronounce-dead timeout)
  WorkloadSpec — arrivals (burst | uniform | poisson), size mix, shuffle frac
  build_cluster / generate_workload / build_scenario — the factory functions
  build_sim    — (SimCluster, jobs) honouring the spec's heartbeat timing,
                 for churn presets whose pronounce window matters
  PRESETS      — canonical named scenarios used by benchmarks and tests
                 ("hetero_2pod" is the paper's slow/fast pod mix;
                 "churny_3pod" kills a pod mid-queue under straggler churn;
                 "overload_2pod" offers ~3x capacity with SLO classes for
                 admission control; "churny_3pod_slo" adds deadlines to the
                 churn preset)

Jobs carry SLO classes when the spec sets ``slo_mix``: per-job
(class, deadline) draws feed core/admission.py policies through
``run_workload(..., admission=...)``.

The serving-side mirror of all of the above, one layer up:
  FleetSpec     — N replicas of mixed capacity + a seeded request stream
                  (+ deterministic straggler/death injection)
  run_fleet     — event loop driving the fleet through one shared admission
                  policy (ADMISSION registry) and one Router (ROUTER
                  registry, core/router.py) with LATE-style re-dispatch
  FLEET_PRESETS — canonical fleets ("fleet_straggler" is the claim-10
                  regime: the fastest replica degrades 10x mid-run)

The fleet itself is elastic: ``run_fleet(autoscale=...)`` attaches
an ``AUTOSCALE`` policy (core/autoscale.py: fixed | backlog_threshold |
deadline_aware) that grows/shrinks the replica pool from the same
measured-capacity + backlog-seconds views the router consumes. Spawn is a
cold replica with a ``warmup_s`` lag before it becomes routable; retire is
drain-then-remove; both surface in the churn trace (``scale_up`` /
``replica_warm`` / ``scale_down`` / ``replica_retired``) so routing,
re-dispatch, and admission see scaling as ordinary capacity change.
``fleet_bursty`` (tight bursts, long idle gaps) is the claim-11 regime
(benchmarks/bench_autoscale.py); ``fleet_diurnal`` is the slow sinusoid.
``FleetResult.replica_seconds`` is the cost currency autoscaling is judged
in. The registry contract for all four policy layers is documented in
docs/architecture.md.

Hedging closes the chain proactively: ``run_fleet(hedge=True)`` races every
deadline-critical (class-0, finite-deadline) request on two replicas at
once — the router's pick plus the fastest idle reserve replica
(``core/router.plan_hedge``; reserve share = ``FleetSpec.reserve_frac``).
First completion wins, the loser is cancelled through the re-dispatch
cancel path with its progress booked to ``FleetResult.duplicate_work``
(the hedge tax, in the same work units as ``wasted_work``), and the trace
gains ``hedge_dispatch`` / ``hedge_win`` / ``hedge_cancel``. The
``class_reserved`` router keeps best-effort work off the fast replicas so
a hedge target is standing idle when critical work arrives.
``fleet_straggler`` is the claim-12 regime (benchmarks/bench_hedge.py):
hedging + reservation must cut class-0 p99 below the claim-10
re-dispatch baseline at a duplicate-work tax ≤ 15%.

The engine itself is a measured artifact: decision views are
assembled from per-replica accumulators patched at
enqueue/dispatch/complete/re-rate time (deque FIFOs, incremental
backlog-work, lazy-deletion oldest-dispatch heap, event-dirty view
memo) instead of rebuilt by re-summation — O(replicas) per decision,
bit-identical to the old loop, which survives as
``run_fleet(legacy_views=True)`` (the golden-trace oracle;
``check_views=True`` re-derives every accumulator by brute force and
asserts agreement). Arrival streams of ≥4096 requests generate through
numpy. ``fleet_million`` (10^6 diurnal requests, 120 replicas) is the
claim-13 regime: benchmarks/bench_simperf.py asserts the incremental
engine clears ≥10× the legacy loop's events/sec. The accumulator
contract — which events must touch which bookkeeping — is documented in
docs/architecture.md ("The incremental view contract").
"""

from __future__ import annotations

import heapq
import math
import random
from collections import deque
from dataclasses import dataclass, field, replace
from typing import Optional, Union

try:  # vectorized arrival generation for large-n fleet streams
    import numpy as _np
except Exception:  # pragma: no cover - numpy ships with the toolchain
    _np = None

from repro_torch.core.admission import (
    ADMIT,
    DEFER,
    AdmissionPolicy,
    ClassP99Window,
    ClusterView,
    JobRequest,
    get_policy,
    quantile as _quantile,
)
from repro_torch.core.autoscale import (
    GROW,
    SHRINK,
    Autoscaler,
    PoolView,
    default_shrink_victim,
    get_autoscaler,
    get_replica_type,
)
from repro_torch.core.placement import Grain, plan_placement
from repro_torch.core.router import (
    InflightView,
    ReplicaView,
    Router,
    get_router,
    plan_hedge,
    plan_redispatch,
    service_estimate_s,
)
from repro_torch.core.simulator import ChurnEvent, SimCluster, SimJob, SimWorker, left_sum
from repro_torch.core.topology import Location, Topology


@dataclass(frozen=True)
class ClusterSpec:
    """A pod-structured fleet; rate per pod models mixed hardware
    generations (the paper's heterogeneous cloud cluster)."""

    nodes_per_pod: int = 8
    pod_rates: tuple[float, ...] = (1.0, 0.4)  # one entry per pod
    in_pod_bw: float = 50e9
    cross_pod_bw: float = 2e9
    # fault injection (seeded): fraction of nodes that degrade / die
    straggler_frac: float = 0.0
    straggler_factor: float = 0.1
    straggler_window_s: tuple[float, float] = (10.0, 300.0)
    fail_frac: float = 0.0
    fail_window_s: tuple[float, float] = (30.0, 600.0)
    # churn extensions: flapping stragglers, whole-pod death/regrow,
    # and the heartbeat timing that turns silence into a pronouncement
    straggler_duration_s: Optional[tuple[float, float]] = None  # recover window
    pod_fail: Optional[tuple[int, float]] = None  # (pod index, failure time)
    pod_recover_s: Optional[float] = None  # pod re-registers this much later
    heartbeat_s: float = 3.0
    dead_after_s: float = 600.0  # the paper's 10-minute timeout

    @property
    def num_pods(self) -> int:
        return len(self.pod_rates)


@dataclass(frozen=True)
class WorkloadSpec:
    """A job mix: how many, when they arrive, how big, how shuffle-heavy."""

    n_jobs: int = 20
    arrival: str = "poisson"  # burst | uniform | poisson
    mean_interarrival_s: float = 40.0
    # (weight, min_tasks, max_tasks) job-size classes, Facebook-trace style:
    # mostly small jobs plus a heavy tail of big ones
    size_mix: tuple[tuple[float, int, int], ...] = (
        (0.6, 4, 8),
        (0.3, 10, 24),
        (0.1, 32, 64),
    )
    work_per_task: tuple[float, float] = (10.0, 30.0)
    nbytes_per_task: int = 2 << 30
    remote_input_frac: float = 0.25  # shuffle-like tasks (cross-pod pipe)
    replication: int = 3
    proportional_placement: bool = True  # paper §IV.b.ii vs stock-uniform
    # per-job SLO classes: (weight, slo_class, deadline_s) draws.
    # None keeps the pre-SLO rng sequence bit-identical (class 0, no
    # deadline) — existing presets and their golden pins are untouched.
    slo_mix: Optional[tuple[tuple[float, int, float], ...]] = None


def build_cluster(
    spec: ClusterSpec, seed: int = 0
) -> tuple[Topology, list[SimWorker]]:
    """Topology + workers, with seeded straggler/failure injection."""
    topo = Topology(
        num_pods=spec.num_pods,
        nodes_per_pod=spec.nodes_per_pod,
        in_pod_bw=spec.in_pod_bw,
        cross_pod_bw=spec.cross_pod_bw,
    )
    workers = [SimWorker(loc, spec.pod_rates[loc.pod]) for loc in topo.workers()]
    rng = random.Random(seed)
    for w in workers:
        if spec.straggler_frac > 0 and rng.random() < spec.straggler_frac:
            w.slow_at = rng.uniform(*spec.straggler_window_s)
            w.slow_factor = spec.straggler_factor
            if spec.straggler_duration_s is not None:
                w.slow_until = w.slow_at + rng.uniform(*spec.straggler_duration_s)
        if spec.fail_frac > 0 and rng.random() < spec.fail_frac:
            w.fail_at = rng.uniform(*spec.fail_window_s)
    # deterministic whole-pod death (the paper's §IV.c failure chain): every
    # node in the pod goes silent together, optionally re-registering later
    if spec.pod_fail is not None:
        pod, fail_t = spec.pod_fail
        for w in workers:
            if w.loc.pod == pod:
                w.fail_at = fail_t
                if spec.pod_recover_s is not None:
                    w.recover_at = fail_t + spec.pod_recover_s
    return topo, workers


def _arrival_times(spec: WorkloadSpec, rng: random.Random) -> list[float]:
    if spec.arrival == "burst":
        return [0.0] * spec.n_jobs
    if spec.arrival == "uniform":
        span = spec.mean_interarrival_s * max(spec.n_jobs - 1, 1)
        return sorted(rng.uniform(0.0, span) for _ in range(spec.n_jobs))
    if spec.arrival == "poisson":
        t, out = 0.0, []
        for _ in range(spec.n_jobs):
            out.append(t)
            t += rng.expovariate(1.0 / spec.mean_interarrival_s)
        return out
    raise ValueError(f"unknown arrival process {spec.arrival!r}")


def _job_sizes(spec: WorkloadSpec, rng: random.Random) -> list[int]:
    weights = [w for w, _, _ in spec.size_mix]
    out = []
    for _ in range(spec.n_jobs):
        _, lo, hi = rng.choices(spec.size_mix, weights=weights, k=1)[0]
        out.append(rng.randint(lo, hi))
    return out


def generate_workload(
    spec: WorkloadSpec,
    topo: Topology,
    workers: list[SimWorker],
    seed: int = 0,
) -> list[SimJob]:
    """Jobs with seeded arrivals/sizes/shuffle flags, each placed on the
    cluster by the capacity-proportional (or stock-uniform) planner."""
    rng = random.Random(seed)
    arrivals = _arrival_times(spec, rng)
    sizes = _job_sizes(spec, rng)
    locs = [w.loc for w in workers]
    caps = [w.rate for w in workers]
    slo_weights = (
        [w for w, _, _ in spec.slo_mix] if spec.slo_mix is not None else None
    )
    jobs: list[SimJob] = []
    for jid, (submit_t, n_tasks) in enumerate(zip(arrivals, sizes)):
        lo, hi = spec.work_per_task
        grains = tuple(
            Grain(
                gid,
                nbytes=spec.nbytes_per_task,
                work=rng.uniform(lo, hi),
                remote_input=rng.random() < spec.remote_input_frac,
            )
            for gid in range(n_tasks)
        )
        slo_class, deadline_s = 0, float("inf")
        if spec.slo_mix is not None:
            _, slo_class, deadline_s = rng.choices(
                spec.slo_mix, weights=slo_weights, k=1
            )[0]
        plan = plan_placement(
            grains, locs, caps, topo,
            replication=spec.replication,
            proportional=spec.proportional_placement,
        )
        jobs.append(
            SimJob(
                job_id=jid, grains=grains, plan=plan, submit_t=submit_t,
                slo_class=slo_class, deadline_s=deadline_s,
            )
        )
    return jobs


@dataclass(frozen=True)
class Scenario:
    name: str
    cluster: ClusterSpec
    workload: WorkloadSpec
    description: str = ""


PRESETS: dict[str, Scenario] = {
    # The paper's canonical regime: one fast pod, one 0.4× pod (mixed
    # generations), a bursty queue with a heavy-tailed size mix. This is the
    # preset the acceptance benchmark sweeps — capacity-weighted scheduling
    # must not lose to FIFO on makespan here.
    "hetero_2pod": Scenario(
        name="hetero_2pod",
        cluster=ClusterSpec(nodes_per_pod=8, pod_rates=(1.0, 0.4), cross_pod_bw=2e9),
        workload=WorkloadSpec(
            n_jobs=24, arrival="poisson", mean_interarrival_s=10.0,
            remote_input_frac=0.25,
        ),
        description="slow/fast pod mix, contended poisson queue, heavy-tailed sizes",
    ),
    "homogeneous": Scenario(
        name="homogeneous",
        cluster=ClusterSpec(nodes_per_pod=8, pod_rates=(1.0, 1.0), cross_pod_bw=2e9),
        workload=WorkloadSpec(n_jobs=24, arrival="poisson", mean_interarrival_s=25.0),
        description="the homogeneity assumption stock Hadoop makes",
    ),
    "shuffle_heavy": Scenario(
        name="shuffle_heavy",
        cluster=ClusterSpec(nodes_per_pod=8, pod_rates=(1.0, 0.4), cross_pod_bw=1e9),
        workload=WorkloadSpec(
            n_jobs=16, arrival="uniform", mean_interarrival_s=30.0,
            remote_input_frac=1.0,
        ),
        description="reduce-phase regime: every task crosses the shared pipe",
    ),
    "faulty": Scenario(
        name="faulty",
        cluster=ClusterSpec(
            nodes_per_pod=8, pod_rates=(1.0, 0.4),
            straggler_frac=0.2, fail_frac=0.1,
        ),
        workload=WorkloadSpec(n_jobs=16, arrival="poisson", mean_interarrival_s=40.0),
        description="seeded stragglers + node deaths on the het mix",
    ),
    # The elastic-churn regime (paper §IV.c): a whole pod dies while
    # the queue is contended and re-registers near the tail; stragglers flap
    # on and off under load. The 60 s pronounce timeout makes the failure
    # chain land mid-workload; benchmarks/bench_elastic.py (claim 8) gates
    # capacity-aware re-proportioning vs static allocation on this preset.
    "churny_3pod": Scenario(
        name="churny_3pod",
        cluster=ClusterSpec(
            nodes_per_pod=4, pod_rates=(1.0, 0.7, 0.4), cross_pod_bw=0.8e9,
            straggler_frac=0.25, straggler_factor=0.15,
            straggler_window_s=(30.0, 240.0), straggler_duration_s=(60.0, 180.0),
            pod_fail=(1, 120.0), pod_recover_s=420.0,
            heartbeat_s=3.0, dead_after_s=60.0,
        ),
        workload=WorkloadSpec(
            n_jobs=18, arrival="poisson", mean_interarrival_s=15.0,
            nbytes_per_task=8 << 30, remote_input_frac=0.1,
        ),
        description="pod1 dies mid-queue (60s heartbeat timeout) and re-registers; stragglers flap under load",
    ),
    # The overload regime admission control exists for: offered load
    # ~3× the fleet's aggregate rate (total capacity 11.2 work/s, arrivals
    # ~34 work/s), so without admission every class's sojourn grows without
    # bound as the queue deepens. Class 0 alone is ~60% of capacity — a
    # policy that protects it has the headroom to, if it sheds the
    # best-effort classes. benchmarks/bench_admission.py (claim 9) gates
    # slo_classes vs admit_all on this preset.
    "overload_2pod": Scenario(
        name="overload_2pod",
        cluster=ClusterSpec(nodes_per_pod=8, pod_rates=(1.0, 0.4), cross_pod_bw=2e9),
        workload=WorkloadSpec(
            n_jobs=36, arrival="poisson", mean_interarrival_s=8.0,
            remote_input_frac=0.25,
            slo_mix=((0.2, 0, 600.0), (0.4, 1, 1200.0), (0.4, 2, 2700.0)),
        ),
        description="arrival rate ~3x total capacity; 3 SLO classes (600s/1200s/2700s budgets)",
    ),
    # churny_3pod with SLO classes: the churn preset's failure chain (pod death,
    # 60s pronounce, re-registration, flapping stragglers) now hits a queue
    # whose jobs carry deadlines — the regime where token_bucket must
    # re-rate off the pronounce/re-register capacity signal and slo_classes
    # must keep class 0 inside budget *through* the outage.
    "churny_3pod_slo": Scenario(
        name="churny_3pod_slo",
        cluster=ClusterSpec(
            nodes_per_pod=4, pod_rates=(1.0, 0.7, 0.4), cross_pod_bw=0.8e9,
            straggler_frac=0.25, straggler_factor=0.15,
            straggler_window_s=(30.0, 240.0), straggler_duration_s=(60.0, 180.0),
            pod_fail=(1, 120.0), pod_recover_s=420.0,
            heartbeat_s=3.0, dead_after_s=60.0,
        ),
        workload=WorkloadSpec(
            n_jobs=18, arrival="poisson", mean_interarrival_s=15.0,
            nbytes_per_task=8 << 30, remote_input_frac=0.1,
            slo_mix=((0.25, 0, 420.0), (0.45, 1, 1200.0), (0.3, 2, 3600.0)),
        ),
        description="the churn preset with SLO classes: pod death + deadlines",
    ),
}


def build_scenario(
    name_or_scenario, seed: int = 0, n_jobs: Optional[int] = None
):
    """(topology, workers, jobs) for a named preset or a Scenario object.

    ``n_jobs`` overrides the preset's job count (benchmark smoke paths)."""
    sc = PRESETS[name_or_scenario] if isinstance(name_or_scenario, str) else name_or_scenario
    wspec = sc.workload if n_jobs is None else replace(sc.workload, n_jobs=n_jobs)
    topo, workers = build_cluster(sc.cluster, seed=seed)
    jobs = generate_workload(wspec, topo, workers, seed=seed)
    return topo, workers, jobs


def build_sim(
    name_or_scenario, seed: int = 0, n_jobs: Optional[int] = None
) -> tuple[SimCluster, list[SimJob]]:
    """(SimCluster, jobs) for a preset, honouring its heartbeat timing.

    ``build_scenario`` callers construct ``SimCluster(workers, topo)`` with
    the default 10-minute pronounce timeout; churn presets carry their own
    ``heartbeat_s``/``dead_after_s`` so the failure chain lands mid-workload
    — use this builder whenever the preset injects faults."""
    sc = PRESETS[name_or_scenario] if isinstance(name_or_scenario, str) else name_or_scenario
    topo, workers, jobs = build_scenario(sc, seed=seed, n_jobs=n_jobs)
    sim = SimCluster(
        workers, topo,
        heartbeat_s=sc.cluster.heartbeat_s,
        dead_after_s=sc.cluster.dead_after_s,
    )
    return sim, jobs


# ---------------------------------------------------------------------------
# Cross-replica serving fleet: N sim-replicas behind one admission
# policy and one Router, with LATE-style re-dispatch of stuck requests.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FleetSpec:
    """N serving replicas of mixed capacity plus a seeded request stream.

    The serving-side analogue of ``ClusterSpec``/``WorkloadSpec`` in one
    object: ``replica_rates`` model mixed hardware generations (the paper's
    heterogeneous cloud fleet, one layer up), a request is a tiny job whose
    work is its token budget, and fault injection is deterministic — a
    mid-run straggler and/or a replica death/re-registration at fixed times
    — so every routing/re-dispatch claim replays bit-identically.
    """

    replica_rates: tuple[float, ...] = (1.0, 0.7, 0.4)
    n_requests: int = 48
    arrival: str = "poisson"  # burst | uniform | poisson | bursty | diurnal
    mean_interarrival_s: float = 7.0
    work_per_request: tuple[float, float] = (4.0, 16.0)  # token budgets
    # "bursty" arrivals: tight clumps of `burst_len` requests (intra-burst
    # spacing = mean_interarrival_s) separated by `burst_gap_s` of silence
    # — the autoscaling regime (claim 11)
    burst_len: int = 16
    burst_gap_s: float = 240.0
    # "diurnal" arrivals: poisson whose rate swings sinusoidally, peak:trough
    # = (1+amp):(1-amp) around 1/mean_interarrival_s over one period
    period_s: float = 600.0
    diurnal_amp: float = 0.8
    # per-request (weight, slo_class, deadline_s) draws; None = no SLOs
    slo_mix: Optional[tuple[tuple[float, int, float], ...]] = None
    # deterministic fault injection:
    # straggler = (replica, slow_at, factor, slow_until | None = forever)
    straggler: Optional[tuple[int, float, float, Optional[float]]] = None
    replica_fail: Optional[tuple[int, float]] = None  # (replica, fail time)
    replica_recover_s: Optional[float] = None  # re-registers this much later
    # re-dispatch + liveness knobs
    late_factor: float = 2.0  # stuck = age > late_factor × est service time
    probe_s: float = 5.0  # re-dispatch monitor cadence
    dead_after_s: float = 30.0  # silence → pronounced dead (routing stops)
    # autoscaling pool knobs: consumed only when run_fleet is given
    # an AUTOSCALE policy
    spawn_rate: float = 1.0  # capacity of a newly spawned replica
    warmup_s: float = 15.0  # cold-start lag: spawn decision → routable
    scale_check_s: float = 5.0  # autoscaler decision cadence
    # class-0 reserve share: consumed by the class_reserved router/
    # scheduler and by hedged duplicate dispatch (run_fleet(hedge=True))
    reserve_frac: float = 0.5
    # typed replica pool: per-replica type names from
    # core.autoscale.REPLICA_TYPES, parallel to replica_rates. None means
    # every replica is "default" (price 1.0, never preempted) — the
    # pre-typed pool, bit-identical. Preemptible replicas (type "spot")
    # live ~Exp(spot_mean_life_s) from birth, get spot_notice_s of notice
    # (routing stops), then are killed: queued + in-service work is
    # re-dispatched through the cancel/route rescue path.
    replica_types: Optional[tuple[str, ...]] = None
    spot_mean_life_s: float = 600.0
    spot_notice_s: float = 5.0
    # provisioning + data-gravity layer — all inert at defaults.
    # stage_data > 0 turns on the replica lifecycle for *elastic* spawns
    # (base replicas are pre-staged before t=0): boot (warmup_s) →
    # stage_in (stage_data / REPLICA_TYPES[rtype].stage_bw seconds; the
    # replica is NOT routable yet) → serve → stage_out (same pipe, billed)
    # → retire. Preempted/dead replicas lose their scratch data and skip
    # stage_out. session_turns > 1 groups the request stream into
    # multi-turn sessions: the arrival process draws session starts, each
    # session runs session_turns turns separated by uniform think-time
    # gaps, and every turn carries the session_id. A turn dispatched to a
    # replica that does not hold the session's KV cache pays
    # session_prefill extra attempt-work — the re-prefill tax the
    # ``affinity`` router exists to avoid.
    stage_data: float = 0.0
    session_turns: int = 1
    session_think_s: tuple[float, float] = (20.0, 40.0)
    session_prefill: float = 0.0
    description: str = ""

    @property
    def n_replicas(self) -> int:
        return len(self.replica_rates)


# Streams below this length keep the scalar ``random.Random`` path so
# every existing preset replays its original rng sequence bit-identically;
# longer bursty/diurnal streams (fleet_million) use the vectorized numpy
# generator, a distinct-but-deterministic stream seeded the same way.
_VECTOR_MIN = 4096


def _generate_fleet_requests_np(spec: FleetSpec, seed: int) -> list[JobRequest]:
    """Vectorized (numpy) request generation for large bursty/diurnal
    streams: one ``PCG64(seed)`` stream end to end, deterministic for a
    given (spec, seed). Burst heads land exactly on their
    ``b × burst_gap_s`` epoch (the segmented cumsum subtracts the head's
    own prefix, so the offset is exactly zero there)."""
    n = spec.n_requests
    rng = _np.random.Generator(_np.random.PCG64(seed))
    if spec.arrival == "bursty":
        bl = max(spec.burst_len, 1)
        gaps = rng.exponential(spec.mean_interarrival_s, n)
        rids = _np.arange(n)
        heads = rids % bl == 0
        gaps[heads] = 0.0
        cs = _np.cumsum(gaps)
        b = rids // bl
        arrivals = b * spec.burst_gap_s + (cs - cs[heads][b])
    else:  # diurnal: rate at t depends on t, so only the draws vectorize
        unit = rng.exponential(1.0, n).tolist()
        arrivals = []
        t = 0.0
        two_pi = 2.0 * math.pi
        amp, period = spec.diurnal_amp, spec.period_s
        base = spec.mean_interarrival_s
        for u in unit:
            arrivals.append(t)
            swing = 1.0 + amp * math.sin(two_pi * t / period)
            t += u * (base / max(swing, 1e-6))
    lo, hi = spec.work_per_request
    works = rng.uniform(lo, hi, n).tolist()
    if spec.slo_mix is not None:
        w = _np.array([x for x, _, _ in spec.slo_mix], dtype=float)
        cum = _np.cumsum(w / w.sum())
        picks = _np.minimum(
            _np.searchsorted(cum, rng.random(n), side="right"),
            len(spec.slo_mix) - 1,
        ).tolist()
        classes = [spec.slo_mix[k][1] for k in picks]
        deadlines = [spec.slo_mix[k][2] for k in picks]
    else:
        classes = [0] * n
        deadlines = [math.inf] * n
    at = arrivals if isinstance(arrivals, list) else arrivals.tolist()
    return [
        JobRequest(
            job_id=rid, arrive_t=at[rid], n_tasks=1, total_work=works[rid],
            slo_class=classes[rid], deadline_s=deadlines[rid],
        )
        for rid in range(n)
    ]


def _generate_session_requests(spec: FleetSpec, seed: int) -> list[JobRequest]:
    """Multi-turn session stream (``session_turns > 1``): the spec's
    arrival process draws *session* start times (burst/uniform/poisson —
    the scalar processes), then each session runs ``session_turns`` turns
    whose gaps are ``uniform(*session_think_s)`` think-time draws, every
    turn carrying the session id and the session's single SLO draw (a
    conversation has one owner). Turns are re-sorted into global arrival
    order and rid-numbered in that order, so the engine consumes the
    stream exactly like any single-turn one — ``random.Random(seed)`` end
    to end, bit-identical per (spec, seed)."""
    rng = random.Random(seed)
    turns = spec.session_turns
    n_sessions = max(spec.n_requests // turns, 1)
    starts = _arrival_times(
        WorkloadSpec(
            n_jobs=n_sessions,
            arrival=spec.arrival,
            mean_interarrival_s=spec.mean_interarrival_s,
        ),
        rng,
    )
    slo_weights = (
        [w for w, _, _ in spec.slo_mix] if spec.slo_mix is not None else None
    )
    lo, hi = spec.work_per_request
    tlo, thi = spec.session_think_s
    raw: list[tuple[float, int, float, int, float]] = []
    for sid, t0 in enumerate(starts):
        slo_class, deadline_s = 0, math.inf
        if spec.slo_mix is not None:
            _, slo_class, deadline_s = rng.choices(
                spec.slo_mix, weights=slo_weights, k=1
            )[0]
        t = t0
        for k in range(turns):
            if k:
                t += rng.uniform(tlo, thi)
            raw.append((t, sid, rng.uniform(lo, hi), slo_class, deadline_s))
    raw.sort(key=lambda x: (x[0], x[1]))
    return [
        JobRequest(
            job_id=rid, arrive_t=at, n_tasks=1, total_work=work,
            slo_class=cls, deadline_s=dl, session_id=sid,
        )
        for rid, (at, sid, work, cls, dl) in enumerate(raw)
    ]


def generate_fleet_requests(spec: FleetSpec, seed: int = 0) -> list[JobRequest]:
    """Seeded request stream: arrivals, token budgets, optional SLO draws —
    ``random.Random(seed)`` end to end, so the same (spec, seed) pair is a
    bit-identical stream (the fleet-level mirror of
    :func:`generate_workload`). Bursty/diurnal streams of
    ``_VECTOR_MIN``-plus requests switch to the vectorized numpy generator
    (same determinism contract, different — but fixed — stream); every
    stream short enough to have a stored golden keeps the scalar path.
    Specs with ``session_turns > 1`` take the multi-turn session path
    (:func:`_generate_session_requests`) — a distinct stream, so no
    single-turn preset's rng sequence moves."""
    if spec.session_turns > 1:
        return _generate_session_requests(spec, seed)
    if (
        _np is not None
        and spec.n_requests >= _VECTOR_MIN
        and spec.arrival in ("bursty", "diurnal")
    ):
        return _generate_fleet_requests_np(spec, seed)
    rng = random.Random(seed)
    if spec.arrival == "bursty":
        # clumps of burst_len requests, burst_gap_s apart: each burst
        # arrives with tight exponential spacing from its epoch — the
        # overload/idle alternation autoscaling exists for (claim 11)
        arrivals = []
        t = 0.0
        for rid in range(spec.n_requests):
            b, k = divmod(rid, max(spec.burst_len, 1))
            if k == 0:
                t = b * spec.burst_gap_s
            else:
                t += rng.expovariate(1.0 / spec.mean_interarrival_s)
            arrivals.append(t)
    elif spec.arrival == "diurnal":
        # inhomogeneous poisson: the instantaneous arrival rate swings
        # sinusoidally around 1/mean over one period (peak:trough
        # = (1+amp):(1-amp)) — the slow load cycle a shrink policy must
        # track without flapping
        arrivals, t = [], 0.0
        for _ in range(spec.n_requests):
            arrivals.append(t)
            swing = 1.0 + spec.diurnal_amp * math.sin(
                2.0 * math.pi * t / spec.period_s
            )
            mean = spec.mean_interarrival_s / max(swing, 1e-6)
            t += rng.expovariate(1.0 / mean)
    else:
        arrivals = _arrival_times(
            WorkloadSpec(
                n_jobs=spec.n_requests,
                arrival=spec.arrival,
                mean_interarrival_s=spec.mean_interarrival_s,
            ),
            rng,
        )
    slo_weights = (
        [w for w, _, _ in spec.slo_mix] if spec.slo_mix is not None else None
    )
    lo, hi = spec.work_per_request
    out: list[JobRequest] = []
    for rid, arrive_t in enumerate(arrivals):
        work = rng.uniform(lo, hi)
        slo_class, deadline_s = 0, math.inf
        if spec.slo_mix is not None:
            _, slo_class, deadline_s = rng.choices(
                spec.slo_mix, weights=slo_weights, k=1
            )[0]
        out.append(
            JobRequest(
                job_id=rid, arrive_t=arrive_t, n_tasks=1, total_work=work,
                slo_class=slo_class, deadline_s=deadline_s,
            )
        )
    return out


@dataclass(frozen=True)
class Dispatch:
    """One attempt to serve a request on one replica. Re-dispatch cancels
    the open attempt and opens a new one — both stay recorded; a hedged
    request holds *two* open attempts at once, and the one that
    loses the race closes as ``hedge_loss``. ``progress`` is the work this
    attempt had completed when it closed (always 0.0 for ``done`` — the
    work is counted as served, not discarded): Σ progress over
    ``hedge_loss`` attempts is exactly ``duplicate_work``, and Σ over
    ``cancelled`` attempts is ``wasted_work`` — same currency, split by
    cause. (On a replica death+recovery, ``wasted_work`` additionally
    counts progress an attempt lost *without closing* — the restart keeps
    the same Dispatch record — so the cancelled-sum equality is exact only
    on runs without recoveries.)"""

    replica: int
    t: float
    end_t: float = -1.0
    outcome: str = "open"  # done | cancelled | stranded | hedge_loss
    progress: float = 0.0  # work completed by this attempt when it closed


@dataclass(frozen=True)
class RequestResult:
    """Per-request outcome of a fleet run (the serving-side ``JobResult``)."""

    rid: int
    arrive_t: float
    work: float
    slo_class: int
    deadline_s: float
    decision: str  # admitted | rejected | deferred (never released)
    admit_t: float
    finish_t: float
    served_by: int  # replica that completed it (-1 if it never finished)
    dispatches: tuple[Dispatch, ...]
    session_id: int = -1  # multi-turn session this turn belongs to

    @property
    def latency(self) -> float:
        """Arrival-to-finish sojourn (queueing + routing + every attempt)."""
        return self.finish_t - self.arrive_t

    @property
    def on_time(self) -> bool:
        return self.finish_t >= 0 and self.latency <= self.deadline_s + 1e-9

    @property
    def n_redispatched(self) -> int:
        return left_sum(1 for d in self.dispatches if d.outcome == "cancelled")


@dataclass
class FleetResult:
    """What a fleet run did: per-request outcomes plus the deterministic
    trace (routing decisions, re-dispatches, replica churn, completions)
    that the replay-determinism tests pin bit-identically."""

    router: str
    admission: str
    redispatch: bool
    late_factor: float
    makespan: float  # last completion time
    requests: list[RequestResult]
    trace: list[ChurnEvent]
    completed: int
    n_rejected: int
    n_deferred: int  # deferred at least once (admitted later or not)
    n_redispatched: int  # re-dispatch moves executed
    stranded: int  # admitted but never completed (degraded replica held them)
    wasted_work: float  # progress discarded by cancellations/restarts
    served_by: dict[int, int]  # replica → completions
    # hedged duplicate dispatch; with hedge=False all four stay at
    # their defaults and the result is bit-identical to pre-hedge runs
    hedge: bool = False
    n_hedged: int = 0  # requests dispatched to two replicas
    n_hedge_wins: int = 0  # races the hedge attempt won
    duplicate_work: float = 0.0  # losing attempts' progress (the hedge tax)
    # autoscaling outcome; with autoscale=None the pool is static,
    # so spawned/retired are 0 and replica_seconds = n_replicas × makespan
    # — minus any replica that dies for good or is spot-preempted, which
    # stops billing at its death/kill time (the billing fix)
    autoscaler: str = "none"
    n_spawned: int = 0  # replicas added by scale_up decisions
    n_retired: int = 0  # replicas drained and removed by scale_down
    pool_peak: int = 0  # max simultaneously-online replicas
    replica_seconds: float = 0.0  # Σ per-replica online time (cost currency)
    # typed-pool billing: Σ billed-seconds × the replica type's
    # $/replica-second price. With an untyped pool every price is 1.0, so
    # cost == replica_seconds and cost_by_type == {"default": cost}.
    cost: float = 0.0
    cost_by_type: Optional[dict[str, float]] = None
    n_preempted: int = 0  # spot replicas killed mid-run
    # data-gravity sessions + provisioning lifecycle; every one of
    # these stays at its default on single-turn / unstaged specs
    n_sessions: int = 0  # distinct multi-turn sessions in the stream
    n_cache_hits: int = 0  # dispatches that found the session cache resident
    prefill_work: float = 0.0  # re-prefill work paid by cold-routed turns
    prefill_saved: float = 0.0  # re-prefill work skipped by cache hits
    n_staged: int = 0  # elastic replicas that completed stage_in
    # simulator-throughput accounting: loop events processed, and —
    # when per-request records are skipped (collect_requests=False) — the
    # per-class sojourn lists that keep latency_quantile working anyway
    n_events: int = 0
    sojourns_by_class: Optional[dict[int, list[float]]] = None

    def latencies(self, slo_class: Optional[int] = None) -> list[float]:
        if not self.requests and self.sojourns_by_class is not None:
            if slo_class is None:
                out = [
                    x for xs in self.sojourns_by_class.values() for x in xs
                ]
            else:
                out = list(self.sojourns_by_class.get(slo_class, []))
            return sorted(out)
        return sorted(
            r.latency
            for r in self.requests
            if r.finish_t >= 0 and (slo_class is None or r.slo_class == slo_class)
        )

    def latency_quantile(self, q: float, slo_class: Optional[int] = None) -> float:
        return _quantile(self.latencies(slo_class), q)

    @property
    def mean_latency(self) -> float:
        lats = self.latencies()
        return left_sum(lats) / len(lats) if lats else float("nan")

    def on_time_work(self, slo_class: Optional[int] = None) -> float:
        """Σ work of requests finishing within their own deadline — the
        goodput currency benchmarks/bench_router.py gates on (same
        definition as ``WorkloadResult.class_stats``'s ``on_time_work``)."""
        return left_sum(
            r.work
            for r in self.requests
            if r.on_time and (slo_class is None or r.slo_class == slo_class)
        )


FLEET_PRESETS: dict[str, FleetSpec] = {
    # Routing-only regime: mixed-generation replicas, no faults. The
    # capacity-proportional vs equal-shares gap in its purest form.
    "fleet_hetero": FleetSpec(
        replica_rates=(1.0, 0.7, 0.4), n_requests=48,
        arrival="poisson", mean_interarrival_s=7.0,
        slo_mix=((1.0, 0, 90.0),),
        description="slow/fast replica mix, no faults: routing policy only",
    ),
    # The claim-10 regime: the fastest replica degrades to 0.1× mid-run
    # (t=60..300) while the queue is contended. Equal-shares routing keeps
    # feeding it a third of the stream; capacity-proportional routing
    # shrinks its share the moment the rate drop is reported, and LATE-style
    # re-dispatch rescues the requests already stuck behind it.
    "fleet_straggler": FleetSpec(
        replica_rates=(1.0, 0.7, 0.4), n_requests=64,
        arrival="poisson", mean_interarrival_s=8.0,
        straggler=(0, 60.0, 0.1, 300.0),
        slo_mix=((1.0, 0, 90.0),),
        description="fastest replica degrades 10x mid-run under load",
    ),
    # The churny_3pod_slo-style fleet: a straggler flaps on the fast
    # replica while replica 1 goes silent mid-queue, is pronounced dead
    # 30 s later, and re-registers — with two SLO classes in the stream.
    # The determinism and conservation tests replay this preset.
    "fleet_churny": FleetSpec(
        replica_rates=(1.0, 0.7, 0.4), n_requests=48,
        arrival="poisson", mean_interarrival_s=6.0,
        straggler=(0, 40.0, 0.15, 160.0),
        replica_fail=(1, 60.0), replica_recover_s=150.0,
        slo_mix=((0.3, 0, 120.0), (0.7, 1, 600.0)),
        description="straggler flap + replica death/re-registration + SLO mix",
    ),
    # The claim-11 regime (benchmarks/bench_autoscale.py): four tight
    # 16-request bursts separated by four minutes of silence. A pool sized
    # for the mean (2×1.0) blows the burst tail; a pool sized for the peak
    # idles between bursts, paying replica-seconds for nothing.
    # backlog_threshold autoscaling grows into each burst (15 s cold-start
    # lag) and drains back down in the gaps.
    "fleet_bursty": FleetSpec(
        replica_rates=(1.0, 1.0), n_requests=64,
        arrival="bursty", mean_interarrival_s=1.0,
        burst_len=16, burst_gap_s=240.0,
        work_per_request=(4.0, 16.0),
        slo_mix=((1.0, 0, 120.0),),
        spawn_rate=1.0, warmup_s=15.0, scale_check_s=5.0,
        description="4 tight bursts, 240s idle gaps: the autoscaling regime",
    ),
    # The slow cycle: a sinusoidal arrival rate (peak ~9x trough) over a
    # 10-minute period. The shrink side of the policy does the work here —
    # tracking the trough without flapping, then re-growing into the crest.
    "fleet_diurnal": FleetSpec(
        replica_rates=(1.0, 1.0), n_requests=96,
        arrival="diurnal", mean_interarrival_s=6.0,
        period_s=600.0, diurnal_amp=0.8,
        work_per_request=(4.0, 16.0),
        slo_mix=((1.0, 0, 150.0),),
        spawn_rate=1.0, warmup_s=15.0, scale_check_s=5.0,
        description="sinusoidal offered load over a 10-minute period",
    ),
    # The typed-pool preemption regime: half the fleet is cheap
    # preemptible capacity that dies mid-run with short notice. Each kill
    # evicts a queue through the cancel/route rescue path while the
    # stream is still arriving — the conservation + typed-replay tests
    # (tests/test_pool.py) and the fleet_spot goldens replay this preset.
    "fleet_spot": FleetSpec(
        replica_rates=(1.0, 1.0, 1.0, 1.0),
        replica_types=("fast", "fast", "spot", "spot"),
        n_requests=64,
        arrival="poisson", mean_interarrival_s=4.0,
        work_per_request=(4.0, 16.0),
        slo_mix=((1.0, 0, 150.0),),
        spot_mean_life_s=120.0, spot_notice_s=5.0,
        description="two fast + two spot replicas; spots preempt mid-run",
    ),
    # The claim-13 scale regime (benchmarks/bench_simperf.py): a million
    # diurnal requests over 120 mixed-generation replicas (Σ nameplate
    # 84 work/s), offered slightly above capacity at the mean so the
    # above-capacity half of each one-hour cycle ratchets a deep fleet-wide
    # backlog — exactly the regime where per-decision O(R×queue) view
    # re-summation dominated the legacy loop. No faults: this preset
    # measures the loop itself, not the churn chain. bench_simperf's smoke
    # tier runs a 10⁵-request slice of the same stream in both engines and
    # asserts the incremental loop clears ≥10× the legacy events/sec.
    "fleet_million": FleetSpec(
        replica_rates=tuple(
            (1.0, 0.7, 0.4)[i % 3] for i in range(120)
        ),
        n_requests=1_000_000,
        arrival="diurnal", mean_interarrival_s=0.105,
        period_s=3600.0, diurnal_amp=0.7,
        work_per_request=(4.0, 16.0),
        slo_mix=((0.2, 0, 600.0), (0.5, 1, 1800.0), (0.3, 2, math.inf)),
        description="10^6 diurnal requests over 120 replicas: the simulator-throughput regime",
    ),
    # The claim-16 data-gravity regime (benchmarks/bench_affinity.py):
    # sixty four-turn sessions over four equal replicas. Every follow-up
    # turn routed away from the replica holding its session's KV cache
    # pays session_prefill extra work (about 2× a turn's own budget), so
    # capacity_weighted — blind to residency — re-prefills ~3/4 of all
    # follow-ups while `affinity` pays the tax once per session. The
    # offered load is tuned so the re-prefill tax is the difference
    # between a comfortable fleet and a contended one.
    "fleet_sessions": FleetSpec(
        replica_rates=(1.0, 1.0, 1.0, 1.0),
        n_requests=240,  # 60 sessions × 4 turns
        arrival="poisson", mean_interarrival_s=14.0,
        work_per_request=(3.0, 6.0),
        session_turns=4, session_think_s=(25.0, 45.0),
        session_prefill=9.0,
        slo_mix=((1.0, 0, 240.0),),
        description="60 four-turn sessions; cold-routed follow-ups pay re-prefill",
    ),
}

# The staged fleet_spot variant: same preemption regime, but the
# provisioning lifecycle is on — an elastic spawn boots (warmup_s), then
# stages 40 data units through its type's pipe before it becomes routable,
# and a drained replica stages its scratch data back out (billed) before
# release. Preempted spots lose the data and skip stage_out. The golden
# replay pins boot → stage_in → serve → stage_out bit-for-bit.
FLEET_PRESETS["fleet_spot_staged"] = replace(
    FLEET_PRESETS["fleet_spot"],
    stage_data=40.0,
    description="fleet_spot with the provisioning lifecycle on: spawns "
                "stage 40 data units in before routing",
)


# Queues at or below this depth re-sum their work accumulator exactly
# (left-to-right, the same order as the brute-force sum), so every preset
# whose queues stay shallow — all the golden-pinned ones — replays
# bit-identically under the incremental engine; only queues deeper than
# this (fleet_million's ratcheted backlog) carry the running value, where
# ulp drift is tolerated because no golden covers that regime.
_EXACT_RESUM_LEN = 128

# Shared empty resident-session view value: replicas holding no
# session caches — every replica of a sessionless run — all point at this
# one frozenset, so the pooled-view hot loop allocates nothing for it.
_EMPTY_SESSIONS: frozenset = frozenset()


class _ListQueue(list):
    """Pre-refactor queue shim for ``run_fleet(legacy_views=True)``: a
    plain list whose ``popleft``/``appendleft`` are the O(n) ``pop(0)`` /
    ``insert(0, ·)`` the loop shipped with, so the legacy arm of
    bench_simperf pays the real legacy drain cost while sharing one
    call-site API with the deque the incremental engine uses."""

    def popleft(self):
        return self.pop(0)

    def appendleft(self, rid) -> None:
        self.insert(0, rid)


class _NullTrace:
    """``collect_trace=False`` sink: rare churn sites keep their plain
    ``trace.append(...)`` calls and this swallows them; the hot per-request
    sites guard on the flag explicitly so they skip even building the
    event."""

    __slots__ = ()

    def append(self, ev) -> None:
        pass


class _ReplicaState:
    """Mutable per-replica engine state for :func:`run_fleet`.

    The pool-lifecycle flags track the autoscaling state machine:
    a spawned replica is ``online=False`` until its warmup lag elapses
    (``replica_warm``), a ``scale_down`` sets ``draining`` (routing stops:
    its view reports ``alive=False``, but it keeps serving its queue), and
    an empty drained replica retires (``retired``; it leaves the views and
    stops accruing replica-seconds).

    ``queued_work`` and ``age_heap`` are the incremental-view
    accumulators (see docs/architecture.md, "incremental view contract"):
    Σ work of the queued (unstarted) requests, and a lazy-deletion min-heap
    of ``(dispatch_t, rid)`` entries over this replica's open attempts.
    Every queue mutation must go through the engine's ``q_*`` helpers to
    keep them in sync.
    """

    __slots__ = (
        "worker", "queue", "serving", "done_work", "seg_start", "cur_rate",
        "version", "observed", "pronounced",
        "online", "draining", "retired", "online_t", "offline_t",
        "queued_work", "age_heap", "oldest_rid", "oldest_t0", "nameplate",
        "rtype", "price", "view", "sessions",
    )

    def __init__(self, worker: SimWorker, online: bool = True,
                 online_t: float = 0.0, legacy: bool = False):
        self.worker = worker
        self.nameplate = worker.rate  # static; cached off the view hot loop
        self.rtype = "default"  # catalog type name (REPLICA_TYPES)
        self.price = 1.0  # $/replica-second while billed
        # per-replica pooled ReplicaView: the incremental engine
        # rebuilds views by overwriting this one object's __dict__ in
        # place instead of allocating ~R fresh frozen dataclasses per
        # decision — the fleet_million allocation hotspot. Safe because
        # every consumer reads views synchronously within one event
        # handler and nothing retains them across rebuilds.
        self.view = None
        # rids waiting, FIFO (deque; the legacy engine keeps the old list)
        self.queue = _ListQueue() if legacy else deque()
        self.queued_work = 0.0  # Σ total_work over self.queue
        self.age_heap: list[tuple[float, int]] = []
        # memo of the last *validated* heap top (rid, dispatch_t): spares
        # the per-view validity probe; close_attempt clears it when that
        # attempt closes. New dispatches never beat it (sim time is
        # monotone, so a new entry's t is >= the cached minimum).
        self.oldest_rid = -1
        self.oldest_t0 = 0.0
        self.serving: Optional[int] = None
        self.done_work = 0.0  # work done on the in-service request
        self.seg_start = 0.0  # when the current rate segment began
        self.cur_rate = worker.rate  # service rate of the current segment
        self.version = 0  # invalidates stale svc_done events
        self.observed = worker.rate  # last *reported* rate (the view signal)
        self.pronounced = False
        self.online = online  # in the pool and past warmup
        self.draining = False  # scale_down received: no new routes
        self.retired = False  # drained dry and removed
        self.online_t = online_t  # when billing started (spawn decision)
        self.offline_t = math.inf  # when it retired (billing stops)
        # data gravity: the session ids whose KV cache lives here
        # (the view's resident_sessions). Emptied when the cache is lost —
        # failure, preemption, retirement — or when the session ends.
        self.sessions: set = set()


class _ReqState:
    """Mutable per-request engine state for :func:`run_fleet`.

    A hedged request holds two live attempts at once: the primary
    slot (``replica``/``dispatch_t``/``est_s``) and the hedge slot
    (``hedge_replica``/…). The slots are symmetric in the engine — either
    attempt may win the race; the loser's slot is cleared when its attempt
    is cancelled. Invariant: the two slots never point at the same replica
    (``plan_hedge`` excludes the primary, and re-dispatch can never move an
    attempt onto the sibling's replica because that replica is not idle).
    """

    __slots__ = (
        "req", "decision", "admit_t", "finish_t", "served_by", "dispatches",
        "replica", "dispatch_t", "est_s", "work",
        "hedge_replica", "hedge_dispatch_t", "hedge_est_s", "hedge_work",
    )

    def __init__(self, req: JobRequest):
        self.req = req
        self.decision = "pending"  # admitted | rejected | deferred | pending
        self.admit_t = -1.0
        self.finish_t = -1.0
        self.served_by = -1
        self.dispatches: list[Dispatch] = []
        self.replica: Optional[int] = None  # current assignment
        self.dispatch_t = -1.0
        self.est_s = 0.0
        # per-attempt effective work: the request's own budget plus
        # the re-prefill tax *this attempt* pays on its replica (cache
        # miss). Without sessions both stay == req.total_work — the same
        # float — so every accumulator and estimate is bit-identical to
        # the pre-lifecycle engine.
        self.work = req.total_work
        self.hedge_replica: Optional[int] = None  # live duplicate attempt
        self.hedge_dispatch_t = -1.0
        self.hedge_est_s = 0.0
        self.hedge_work = req.total_work


def run_fleet(
    spec_or_name: Union[str, FleetSpec],
    seed: int = 0,
    router: Union[str, Router] = "capacity_weighted",
    admission: Union[str, AdmissionPolicy, None] = None,
    redispatch: bool = True,
    late_factor: Optional[float] = None,
    autoscale: Union[str, Autoscaler, None] = None,
    hedge: bool = False,
    legacy_views: bool = False,
    check_views: bool = False,
    collect_trace: bool = True,
    collect_requests: bool = True,
) -> FleetResult:
    """Replay a request stream through N heterogeneous sim-replicas.

    The serving counterpart of :meth:`SimCluster.run_workload`, at replica
    granularity: each replica is a :class:`SimWorker` serving its FIFO
    queue serially at ``rate_at(t)`` token-budget-units per second; one
    ``admission`` policy (the same ``ADMISSION`` registry the simulator and
    ``launch/serve.py`` share) fronts the whole fleet; one ``router`` (the
    ``ROUTER`` registry, shared with ``launch/fleet.py``) picks a replica
    for every admitted request from :class:`~repro_torch.core.router.ReplicaView`
    snapshots.

    Observability follows the churn discipline: a straggler boundary
    is *reported* (it re-rates the view capacity and the in-service
    request); a failure is *silent* — the view keeps the stale rate until
    the fleet pronounces the replica dead ``dead_after_s`` later, at which
    point routing stops but the replica's requests stay stuck. Rescuing
    them is re-dispatch's job: every ``probe_s`` the monitor asks
    :func:`~repro_torch.core.router.plan_redispatch` for requests stuck past
    ``late_factor ×`` their dispatch-time estimate on a degraded replica,
    cancels the original attempt (progress discarded into
    ``wasted_work``), and re-enqueues on the fastest idle replica — both
    attempts recorded. With ``redispatch=False`` a degraded replica holds
    its requests forever (the motivating failure mode; they are reported
    as ``stranded``).

    With ``autoscale`` set (a name or instance from the ``AUTOSCALE``
    registry, core/autoscale.py) the replica pool itself becomes elastic:
    every ``scale_check_s`` the policy sees a
    :class:`~repro_torch.core.autoscale.PoolView` built from the same replica
    views the router reads and may grow (spawn a ``spawn_rate`` replica
    that becomes routable after ``warmup_s`` — the cold-start lag) or
    shrink (the victim drains: routing stops immediately, it finishes its
    queue, then retires). Scaling surfaces in the churn trace
    (``scale_up`` / ``replica_warm`` / ``scale_down`` /
    ``replica_retired``) and feeds the same capacity signal admission
    re-rates on, so the rest of the chain sees it as ordinary churn.
    ``FleetResult.replica_seconds`` bills each replica from its spawn
    decision (warmup included — cold starts are not free) to its
    retirement or the end of the run.

    With ``hedge=True``, every class-0 request with a finite
    deadline may be dispatched to **two** replicas at once: the router's
    pick plus the fastest idle reserve replica
    (:func:`~repro_torch.core.router.plan_hedge` over the same pre-dispatch
    views, reserve share = ``spec.reserve_frac``). First completion wins;
    the losing attempt is cancelled through the same cancel path
    re-dispatch uses, its progress booked to ``duplicate_work`` (the hedge
    tax — *not* ``wasted_work``, which remains the re-dispatch cost), and
    exactly one completion is recorded: one ``request_done`` event, one
    sojourn into the admission layer's class-p99 window, one
    ``served_by`` credit. The race surfaces in the trace as
    ``hedge_dispatch`` (duplicate opened), then ``hedge_win`` (the
    duplicate finished first) and/or ``hedge_cancel`` (the losing attempt
    closed). While both attempts are live the request is invisible to the
    re-dispatch monitor — the hedge *is* its backup; if one attempt's
    replica degrades, the monitor sees the surviving single attempt again
    once the race resolves, and a stuck hedged pair still resolves through
    whichever sibling finishes.

    Everything is pure arithmetic over a seeded stream, so the full
    :class:`FleetResult` — routing decisions, re-dispatches, completions,
    the trace — is bit-identical across replays of the same arguments,
    autoscaling and hedging included.

    The loop itself is a measured hot path. The default engine
    keeps *incremental* decision views — per-replica queued-work
    accumulators, a lazy-deletion oldest-dispatch heap, an event-dirtied
    view cache, an O(1) outstanding counter — so ``replica_views`` is O(R)
    assembly instead of O(R×queue) re-summation (the contract, and which
    events must touch which accumulators, is documented in
    docs/architecture.md). ``legacy_views=True`` runs the pre-refactor
    rebuild-on-demand arithmetic (brute-force sums, list-backed ``pop(0)``
    queues, full inflight rebuilds per probe) — the measured baseline
    bench_simperf's ≥10× events/sec floor is asserted against.
    ``check_views=True`` cross-checks every incremental view against the
    brute force at build time (the property-test hook). At bench scale,
    ``collect_trace=False`` / ``collect_requests=False`` skip building the
    churn trace / per-request records; summary counters, ``n_events`` and
    ``latency_quantile`` (via ``sojourns_by_class``) still work.
    """
    spec = (
        FLEET_PRESETS[spec_or_name]
        if isinstance(spec_or_name, str)
        else spec_or_name
    )
    late_f = spec.late_factor if late_factor is None else late_factor
    reqs = generate_fleet_requests(spec, seed=seed)
    rtr = get_router(router)
    adm = get_policy(admission)
    asc = get_autoscaler(autoscale)

    workers = [
        SimWorker(Location(0, i), r) for i, r in enumerate(spec.replica_rates)
    ]
    if spec.straggler is not None:
        i, at, factor, until = spec.straggler
        workers[i].slow_at = at
        workers[i].slow_factor = factor
        workers[i].slow_until = until
    if spec.replica_fail is not None:
        i, fail_t = spec.replica_fail
        workers[i].fail_at = fail_t
        if spec.replica_recover_s is not None:
            workers[i].recover_at = fail_t + spec.replica_recover_s

    legacy = legacy_views
    repl = [_ReplicaState(w, legacy=legacy) for w in workers]
    if spec.replica_types is not None:
        if len(spec.replica_types) != len(spec.replica_rates):
            raise ValueError(
                "replica_types must parallel replica_rates: "
                f"{len(spec.replica_types)} != {len(spec.replica_rates)}"
            )
        for st, name in zip(repl, spec.replica_types):
            rt = get_replica_type(name)
            st.rtype = rt.name
            st.price = rt.price
    # preemption lifetimes draw from their own stream, so typed pools with
    # preemption off — and every untyped pool — never perturb the main
    # rng sequence the goldens pin
    spot_rng = random.Random(seed ^ 0x5EED5)
    rs = {r.job_id: _ReqState(r) for r in reqs}
    # ---- data-gravity sessions + provisioning lifecycle ---------
    # Both features gate on their spec knobs so unstaged / single-turn
    # presets (every pre-existing golden) take zero new branches with
    # observable effects: sessions_on=False keeps every attempt's work ==
    # req.total_work, staging_on=False keeps replica_warm the single
    # routability boundary.
    sessions_on = spec.session_turns > 1
    staging_on = spec.stage_data > 0.0
    turns_left: dict[int, int] = {}
    session_holder: dict[int, int] = {}  # session → replica with its cache
    if sessions_on:
        for rq in reqs:
            if rq.session_id >= 0:
                turns_left[rq.session_id] = turns_left.get(rq.session_id, 0) + 1
    n_sessions = len(turns_left)
    n_cache_hits = [0]
    prefill_paid = [0.0]
    prefill_saved = [0.0]
    n_staged = [0]
    trace_out: list[ChurnEvent] = []
    trace = trace_out if collect_trace else _NullTrace()
    parked: list[int] = []  # admitted but unroutable (no live replica)
    deferred_ids: set[int] = set()
    p99win = ClassP99Window()
    # per-class sojourns kept only when per-request records are skipped,
    # so latency_quantile stays available at bench scale
    sojourns: dict[int, list[float]] = {}
    n_events = [0]
    n_outstanding = [0]  # admitted, unfinished (the ClusterView depth)
    completed = [0]
    n_rejected = [0]
    n_deferred = [0]
    n_moves = [0]
    wasted = [0.0]
    n_hedged = [0]
    n_hedge_wins = [0]
    duplicate = [0.0]
    makespan = [0.0]
    served_by = {i: 0 for i in range(len(workers))}
    n_spawned = [0]
    n_retired = [0]
    n_preempted = [0]
    pool_peak = [len(workers)]
    last_arrival_t = max((r.arrive_t for r in reqs), default=0.0)

    def total_nameplate() -> float:
        return left_sum(
            st.worker.rate for st in repl if st.online and not st.retired
        )

    heap: list[tuple[float, int, str, object]] = []
    # arrivals stream into the heap lazily: each popped arrival
    # pushes the next, so the heap holds dozens of events instead of the
    # full 10⁶ front-loaded stream (the fleet_million cache-residency
    # tax). Sequence numbers are pre-assigned in rid order (arrival rid →
    # seq rid+1, dynamic events start at n_requests+1) — exactly the seqs
    # the eager push-all loop handed out, so same-t tie-breaking and
    # every replay stay bit-identical.
    seq = [len(reqs)]
    arr_order = sorted(range(len(reqs)), key=lambda k: (reqs[k].arrive_t, k))
    arr_next = [0]

    def push(t: float, kind: str, payload) -> None:
        seq[0] += 1
        heapq.heappush(heap, (t, seq[0], kind, payload))

    def push_next_arrival() -> None:
        k = arr_next[0]
        if k < len(arr_order):
            arr_next[0] = k + 1
            rid = arr_order[k]
            heapq.heappush(
                heap, (reqs[rid].arrive_t, rid + 1, "arrival", rid)
            )

    def arm_preemption(i: int, birth_t: float) -> None:
        """Draw a preemptible replica's lifetime and schedule its notice +
        kill. Called at birth (setup for base replicas, spawn for elastic
        ones), so the draw order — and the replay — is deterministic."""
        life = spot_rng.expovariate(1.0 / max(spec.spot_mean_life_s, 1e-9))
        kill_t = birth_t + life
        push(max(birth_t, kill_t - spec.spot_notice_s), "spot_notice", i)
        push(kill_t, "spot_kill", i)

    # ---- incremental view bookkeeping ---------------------------
    # The "incremental view contract" (docs/architecture.md): every queue
    # mutation flows through q_push/q_pushleft/q_pop/q_remove so the
    # per-replica queued-work accumulator stays in sync, every dispatch
    # registers on the oldest-dispatch heap, and every state change that a
    # view could observe bumps the dirty counter that invalidates the view
    # cache. At shallow depth the accumulator is re-summed exactly
    # (left-to-right, the brute-force order), so golden-pinned presets
    # replay bit-identically; deeper queues carry the running value.
    dirty = [0]

    def touch() -> None:
        dirty[0] += 1

    def attempt_work(rid: int, i: int) -> float:
        """Effective work of ``rid``'s attempt on replica ``i`` — the
        request's budget plus the re-prefill tax that attempt pays.
        Every accumulator, estimate, and service schedule reads attempt
        work through here (or its inlined twin in ``replica_views``) so
        queue bookkeeping and the brute-force cross-check stay in exact
        agreement; without sessions it is ``req.total_work`` bit-for-bit."""
        r = rs[rid]
        return r.hedge_work if r.hedge_replica == i else r.work

    def _resum(i: int, st: _ReplicaState) -> None:
        if len(st.queue) <= _EXACT_RESUM_LEN:
            acc = 0.0
            for r in st.queue:
                acc += attempt_work(r, i)
            st.queued_work = acc

    def q_push(i: int, rid: int) -> None:
        # no re-sum needed on a tail append: if the accumulator equals the
        # exact left-to-right queue sum before the push, then acc + w IS
        # the left-to-right sum of the longer queue — exactness is
        # preserved by construction. Only head/middle removals and head
        # inserts (pop/remove/pushleft) can de-align the float order.
        st = repl[i]
        st.queue.append(rid)
        st.queued_work += attempt_work(rid, i)
        touch()

    def q_pushleft(i: int, rid: int) -> None:
        st = repl[i]
        st.queue.appendleft(rid)
        st.queued_work += attempt_work(rid, i)
        _resum(i, st)
        touch()

    def q_pop(i: int) -> int:
        st = repl[i]
        rid = st.queue.popleft()
        st.queued_work -= attempt_work(rid, i)
        _resum(i, st)
        touch()
        return rid

    def q_remove(i: int, rid: int) -> None:
        st = repl[i]
        st.queue.remove(rid)
        st.queued_work -= attempt_work(rid, i)
        _resum(i, st)
        touch()

    def note_dispatch(i: int, rid: int, t: float) -> None:
        heapq.heappush(repl[i].age_heap, (t, rid))

    def oldest_dispatch_t(i: int) -> Optional[float]:
        """Exact min dispatch-t over the open attempts on replica ``i``:
        lazy deletion — an entry whose attempt slot has since closed or
        moved no longer matches the request's live slot state and is
        discarded on read. No arithmetic, so the min equals the brute
        ``min(attempt_dispatch_t(r, i) for r in outstanding)`` bit for
        bit."""
        h = repl[i].age_heap
        while h:
            t0, rid = h[0]
            r = rs[rid]
            if (r.replica == i and r.dispatch_t == t0) or (
                r.hedge_replica == i and r.hedge_dispatch_t == t0
            ):
                return t0
            heapq.heappop(h)
        return None

    # ---- replica service mechanics ------------------------------------
    def done_est(i: int, t: float) -> float:
        st = repl[i]
        if st.serving is None:
            return 0.0
        work = attempt_work(st.serving, i)
        return min(work, st.done_work + (t - st.seg_start) * st.cur_rate)

    def outstanding_on(i: int) -> list[int]:
        st = repl[i]
        return ([st.serving] if st.serving is not None else []) + list(st.queue)

    def start_service(i: int, t: float) -> None:
        st = repl[i]
        if st.serving is not None or not st.queue or not st.worker.alive(t):
            return
        rid = q_pop(i)
        st.serving = rid
        st.done_work = 0.0
        st.seg_start = t
        st.cur_rate = st.worker.rate_at(t)
        st.version += 1
        remaining = attempt_work(rid, i)
        push(t + remaining / max(st.cur_rate, 1e-9), "svc_done", (i, st.version))

    # ---- per-attempt bookkeeping (hedging makes these two-valued) -------
    def is_hedged(rid: int) -> bool:
        """Both attempt slots live: the request is racing two replicas."""
        r = rs[rid]
        return r.replica is not None and r.hedge_replica is not None

    def attempt_dispatch_t(rid: int, i: int) -> float:
        r = rs[rid]
        return r.hedge_dispatch_t if r.hedge_replica == i else r.dispatch_t

    def attempt_est_s(rid: int, i: int) -> float:
        r = rs[rid]
        return r.hedge_est_s if r.hedge_replica == i else r.est_s

    def close_attempt(rid: int, i: int, t: float, outcome: str,
                      progress: float = 0.0) -> None:
        """Close the open Dispatch record for ``rid``'s attempt on replica
        ``i`` and clear that attempt slot. With hedging a request can hold
        two open records at once, so the close must match on replica —
        blindly closing ``dispatches[-1]`` would stamp the sibling."""
        r = rs[rid]
        for k in range(len(r.dispatches) - 1, -1, -1):
            d = r.dispatches[k]
            if d.outcome == "open" and d.replica == i:
                r.dispatches[k] = replace(
                    d, end_t=t, outcome=outcome, progress=progress
                )
                break
        if r.hedge_replica == i:
            r.hedge_replica = None
        elif r.replica == i:
            r.replica = None
        st_i = repl[i]
        if st_i.oldest_rid == rid:
            st_i.oldest_rid = -1  # memoized oldest just closed: re-derive

    # ---- views ---------------------------------------------------------
    def backlog_work_of(i: int, t: float) -> float:
        st = repl[i]
        if legacy:
            backlog = left_sum(attempt_work(r, i) for r in st.queue)
        else:
            backlog = st.queued_work
        if st.serving is not None:
            backlog += attempt_work(st.serving, i) - done_est(i, t)
        return backlog

    def check_view(i: int, st: _ReplicaState, t: float,
                   depth: int, t0: Optional[float]) -> None:
        """check_views=True: the incremental accumulators must equal the
        brute-force recomputation at this event boundary — exactly inside
        the re-sum regime, to float tolerance beyond it."""
        rids = outstanding_on(i)
        assert depth == len(rids), (i, depth, len(rids))
        brute_t0 = (
            min(attempt_dispatch_t(r, i) for r in rids) if rids else None
        )
        assert t0 == brute_t0, (i, t0, brute_t0)
        brute_q = left_sum(attempt_work(r, i) for r in st.queue)
        if len(st.queue) <= _EXACT_RESUM_LEN:
            assert st.queued_work == brute_q, (i, st.queued_work, brute_q)
        else:
            assert math.isclose(
                st.queued_work, brute_q, rel_tol=1e-9, abs_tol=1e-6
            ), (i, st.queued_work, brute_q)

    views_cache: list = [-1.0, -1, None]  # [t, dirty stamp, views]

    def replica_views(t: float) -> list[ReplicaView]:
        if legacy:
            # pre-refactor arithmetic: re-sum every queue, re-min every
            # attempt age, rebuild every snapshot — the measured baseline
            # bench_simperf's events/sec floor is asserted against
            out = []
            for i, st in enumerate(repl):
                if not st.online or st.retired:
                    continue  # warming or retired: not in the fleet yet
                rids = outstanding_on(i)
                backlog = backlog_work_of(i, t)
                oldest = (
                    max(t - min(attempt_dispatch_t(r, i) for r in rids), 0.0)
                    if rids
                    else 0.0
                )
                out.append(
                    ReplicaView(
                        replica_id=i,
                        capacity=st.observed,
                        nameplate=st.worker.rate,
                        backlog_work=backlog,
                        queue_depth=len(rids),
                        oldest_age_s=oldest,
                        alive=not st.pronounced and not st.draining,
                        rtype=st.rtype,
                        price=st.price,
                        resident_sessions=(
                            frozenset(st.sessions)
                            if st.sessions
                            else _EMPTY_SESSIONS
                        ),
                    )
                )
            return out
        if views_cache[0] == t and views_cache[1] == dirty[0]:
            return views_cache[2]  # no event since: the snapshot stands
        # O(R) assembly, and a hot one (once per routing decision at 100+
        # replicas), so the loop is hand-flattened: done_est and
        # oldest_dispatch_t are inlined with their float ops in the
        # original order (the min/max idioms below reproduce the builtins
        # branch for branch), and each replica's view is one *pooled*
        # frozen ReplicaView whose __dict__ is overwritten in place
        # — the static fields (id, nameplate, type, price) are written
        # once at pool time, the dynamic ones per rebuild. Rebuilding used
        # to allocate ~R objects + dicts per decision, the dominant
        # fleet_million allocator hotspot; pooling is safe because every
        # consumer reads views synchronously inside one event handler
        # (routers cache by value, never by view identity) and no handler
        # holds a views list across a rebuild.
        out = []
        out_append = out.append
        rv_new = ReplicaView.__new__
        heappop = heapq.heappop
        for i, st in enumerate(repl):
            if not st.online or st.retired:
                continue  # warming or retired: not part of the fleet yet
            serving = st.serving
            if serving is None:
                depth = len(st.queue)
                backlog = st.queued_work
            else:
                depth = len(st.queue) + 1
                r0 = rs[serving]
                # inlined attempt_work: the serving attempt's effective work
                work = r0.hedge_work if r0.hedge_replica == i else r0.work
                done = st.done_work + (t - st.seg_start) * st.cur_rate
                if work < done:  # = min(work, done): service can't overrun
                    done = work
                backlog = st.queued_work + (work - done)
            oldest = 0.0
            if st.oldest_rid >= 0:  # memoized validated heap top
                t0 = st.oldest_t0
                if t > t0:  # = max(t - t0, 0.0)
                    oldest = t - t0
            else:
                h = st.age_heap
                while h:  # lazy-deletion min (see oldest_dispatch_t)
                    t0, rid0 = h[0]
                    r0 = rs[rid0]
                    if (r0.replica == i and r0.dispatch_t == t0) or (
                        r0.hedge_replica == i and r0.hedge_dispatch_t == t0
                    ):
                        st.oldest_rid = rid0
                        st.oldest_t0 = t0
                        if t > t0:  # = max(t - t0, 0.0)
                            oldest = t - t0
                        break
                    heappop(h)
            if check_views:
                check_view(i, st, t, depth, oldest_dispatch_t(i))
            v = st.view
            if v is None:
                v = rv_new(ReplicaView)
                d = v.__dict__
                d["replica_id"] = i
                d["nameplate"] = st.nameplate
                d["rtype"] = st.rtype
                d["price"] = st.price
                # static for the sim: a staging replica is offline, so it
                # never appears in views at all (the serving fleet, whose
                # replicas surface mid-provisioning, sets this per build)
                d["staging"] = False
                d["resident_sessions"] = _EMPTY_SESSIONS
                st.view = v
            else:
                d = v.__dict__
            if sessions_on:
                d["resident_sessions"] = (
                    frozenset(st.sessions) if st.sessions else _EMPTY_SESSIONS
                )
            d["capacity"] = st.observed
            d["backlog_work"] = backlog
            d["queue_depth"] = depth
            d["oldest_age_s"] = oldest
            # draining reads as not-alive: the router stops picking it
            # (and re-dispatch may rescue off it) while it finishes its
            # own queue
            d["alive"] = not st.pronounced and not st.draining
            out_append(v)
        views_cache[0] = t
        views_cache[1] = dirty[0]
        views_cache[2] = out
        return out

    def cluster_view(t: float) -> ClusterView:
        views = replica_views(t)
        live_cap = left_sum(v.capacity for v in views if v.alive)
        if legacy:
            outstanding = [
                r for r in rs.values()
                if r.decision == "admitted" and r.finish_t < 0
            ]
            depth = len(outstanding)
        else:
            depth = n_outstanding[0]
            if check_views:
                assert depth == left_sum(
                    1 for r in rs.values()
                    if r.decision == "admitted" and r.finish_t < 0
                )
        backlog = left_sum(v.backlog_work for v in views)
        return ClusterView(
            time=t,
            live_capacity=live_cap,
            total_capacity=total_nameplate(),
            free_slots=left_sum(1 for v in views if v.alive and v.idle),
            queue_depth=depth,
            backlog_work=backlog,
            deferred_depth=adm.n_deferred if adm is not None else 0,
            deferred_work=adm.deferred_work if adm is not None else 0.0,
            class_p99=p99win.snapshot(),
        )

    def signal_capacity(t: float) -> None:
        if adm is not None:
            views = replica_views(t)
            adm.on_capacity(t, left_sum(v.capacity for v in views if v.alive))

    # ---- routing -------------------------------------------------------
    next_probe = [math.inf]

    def arm_probe(t: float) -> None:
        if next_probe[0] <= t or math.isinf(next_probe[0]):
            next_probe[0] = t + spec.probe_s
            push(next_probe[0], "probe", None)

    def dispatch(rid: int, dst: int, t: float, slot: str = "primary") -> None:
        r = rs[rid]
        w = r.req.total_work
        if sessions_on:
            # data gravity, decided per attempt at dispatch time: a turn
            # landing on the replica that holds its session's cache skips
            # re-prefill; anywhere else it pays session_prefill extra
            # attempt-work. Re-dispatches re-decide at their new replica.
            sid = r.req.session_id
            if sid >= 0:
                if session_holder.get(sid) == dst:
                    n_cache_hits[0] += 1
                    prefill_saved[0] += spec.session_prefill
                else:
                    w = w + spec.session_prefill
                    prefill_paid[0] += spec.session_prefill
        est = service_estimate_s(w, workers[dst].rate)
        if slot == "primary":
            r.replica = dst
            r.dispatch_t = t
            r.est_s = est
            r.work = w
        else:  # the duplicate attempt of a hedged pair
            r.hedge_replica = dst
            r.hedge_dispatch_t = t
            r.hedge_est_s = est
            r.hedge_work = w
        r.dispatches.append(Dispatch(replica=dst, t=t))
        q_push(dst, rid)
        note_dispatch(dst, rid, t)
        start_service(dst, t)
        arm_probe(t)

    def route(rid: int, t: float) -> None:
        views = replica_views(t)
        choice = rtr.pick(rs[rid].req, views)
        if choice is None:  # every replica pronounced dead: park + retry
            parked.append(rid)
            trace.append(ChurnEvent(t, "route_parked", {"request": rid}))
            return
        if collect_trace:
            trace.append(
                ChurnEvent(t, "route", {"request": rid, "replica": choice})
            )
        dispatch(rid, choice, t)
        if not hedge:
            return
        # hedge plan over the same pre-dispatch snapshot the router saw:
        # both decisions are arithmetic over one consistent fleet state
        target = plan_hedge(
            rs[rid].req, choice, views, spec.reserve_frac
        )
        if target is not None:
            n_hedged[0] += 1
            trace.append(
                ChurnEvent(t, "hedge_dispatch", {
                    "request": rid, "primary": choice, "replica": target,
                })
            )
            dispatch(rid, target, t, slot="hedge")

    def retry_parked(t: float) -> None:
        if parked and any(
            st.online and not st.retired and not st.pronounced
            and not st.draining
            for st in repl
        ):
            waiting, parked[:] = parked[:], []
            for rid in waiting:
                route(rid, t)

    # ---- admission front door (shared ADMISSION registry) --------------
    def admit(rid: int, t: float) -> None:
        r = rs[rid]
        r.decision = "admitted"
        r.admit_t = t
        n_outstanding[0] += 1
        if adm is not None and collect_trace:
            trace.append(
                ChurnEvent(t, "request_admitted", {
                    "request": rid,
                    "slo_class": r.req.slo_class,
                    "waited_s": t - r.req.arrive_t,
                })
            )
        route(rid, t)

    def reject(rid: int, t: float) -> None:
        rs[rid].decision = "rejected"
        n_rejected[0] += 1
        trace.append(
            ChurnEvent(t, "request_rejected",
                       {"request": rid, "slo_class": rs[rid].req.slo_class})
        )

    next_adm_check = [math.inf]

    def drain_admission(t: float) -> None:
        if adm is None or not deferred_ids:
            return
        for req, decision in adm.poll(cluster_view(t)):
            deferred_ids.discard(req.job_id)
            if decision == ADMIT:
                admit(req.job_id, t)
            else:
                reject(req.job_id, t)
        nxt = adm.next_event_t()
        if nxt is not None and nxt > t and (
            nxt < next_adm_check[0] - 1e-12 or next_adm_check[0] <= t
        ):
            next_adm_check[0] = nxt
            push(nxt, "admission_check", None)

    # ---- re-dispatch (LATE-style rescue) + hedge-loser cancellation ----
    def cancel(rid: int, i: int, t: float, outcome: str = "cancelled") -> None:
        """Pull ``rid``'s attempt off replica ``i``. A re-dispatch cancel
        books the discarded progress to ``wasted_work``; a ``hedge_loss``
        cancel books it to ``duplicate_work`` — the losing attempt's work
        was *duplicated*, not wasted by a rescue decision."""
        st = repl[i]
        progress = 0.0
        if st.serving == rid:
            progress = done_est(i, t)
            st.serving = None
            st.version += 1
            touch()
            start_service(i, t)
        else:
            q_remove(i, rid)
        if outcome == "hedge_loss":
            duplicate[0] += progress
        else:
            wasted[0] += progress
        close_attempt(rid, i, t, outcome, progress)
        if st.draining:  # a rescue can drain a degraded replica dry
            maybe_retire(i, t)

    def _probe_rearm(t: float) -> bool:
        # re-arm only while probing can still change something: with
        # re-dispatch off, a request stranded on a dead replica must not
        # keep the monitor (and the run) alive forever
        if legacy:
            outstanding = any(outstanding_on(i) for i in range(len(repl)))
        else:
            outstanding = any(
                st.serving is not None or st.queue for st in repl
            )
        # retired replicas are *gone* — a drained or preempted replica's
        # worker still reads alive(t), but it can never serve again, so it
        # must not keep the monitor chain (and the run) alive. Without the
        # retired check an all-preempted pool with parked work re-arms the
        # probe forever (the scale chain below already guards this way).
        can_progress = any(
            not st.retired
            and (
                st.worker.alive(t)
                or (
                    st.worker.recover_at is not None
                    and st.worker.recover_at > t
                )
            )
            for st in repl
        )
        return bool(((redispatch and outstanding) or parked) and can_progress)

    def rescue_possible(views: list[ReplicaView]) -> bool:
        """Mirror of :func:`plan_redispatch`'s two early-outs: no eligible
        idle target, or no degraded replica to be stuck on, means the plan
        is ``[]`` — so the probe can skip building the inflight snapshot
        entirely. Must stay in lockstep with the router's filters."""
        if not any(v.degraded for v in views):
            return False
        return any(
            v.alive and v.idle and not v.degraded and not v.staging
            and v.capacity > 1e-9
            for v in views
        )

    def probe(t: float) -> None:
        next_probe[0] = math.inf
        if redispatch:
            views = replica_views(t)
            if not legacy and not rescue_possible(views):
                retry_parked(t)
                if _probe_rearm(t):
                    arm_probe(t)
                return
            inflight = []
            for i in range(len(repl)):
                for rid in outstanding_on(i):
                    if is_hedged(rid):
                        # a racing pair is its own backup: the monitor
                        # never rescues either sibling — first completion
                        # resolves the race and cancels the loser
                        continue
                    remaining = attempt_work(rid, i)
                    if repl[i].serving == rid:
                        remaining -= done_est(i, t)
                    inflight.append(
                        InflightView(
                            request_id=rid, replica_id=i,
                            age_s=t - attempt_dispatch_t(rid, i),
                            est_s=attempt_est_s(rid, i),
                            remaining_work=remaining,
                        )
                    )
            for rid, src, dst in plan_redispatch(inflight, views, late_f):
                age = t - attempt_dispatch_t(rid, src)
                cancel(rid, src, t)
                n_moves[0] += 1
                trace.append(
                    ChurnEvent(t, "redispatch", {
                        "request": rid, "from": src, "to": dst,
                        "age_s": age,
                    })
                )
                dispatch(rid, dst, t)
        retry_parked(t)
        if _probe_rearm(t):
            arm_probe(t)

    # ---- pool lifecycle (autoscaling) ------------------------------
    def pool_view(t: float) -> PoolView:
        return PoolView(
            time=t,
            replicas=tuple(replica_views(t)),
            n_warming=left_sum(
                1 for st in repl if not st.online and not st.retired
            ),
            class_p99=p99win.snapshot(),
        )

    def evict_sessions(i: int) -> None:
        """The replica's KV caches are gone (failure, preemption,
        retirement): later turns of its resident sessions must degrade to
        cold routes, so the holder map forgets it ever held them."""
        st = repl[i]
        if st.sessions:
            for sid in st.sessions:
                if session_holder.get(sid) == i:
                    del session_holder[sid]
            st.sessions.clear()
            touch()

    def maybe_retire(i: int, t: float) -> None:
        st = repl[i]
        if legacy:
            busy = bool(outstanding_on(i))
        else:
            busy = st.serving is not None or bool(st.queue)
        if st.draining and not st.retired and not busy:
            st.retired = True
            st.online = False
            evict_sessions(i)
            if staging_on:
                # stage_out: scratch data drains back through the type's
                # pipe before the instance is released — billed, like the
                # GCE teardown copy. Preempted/dead replicas skip this
                # (their data is simply lost).
                out_s = get_replica_type(st.rtype).stage_s(spec.stage_data)
                st.offline_t = t + out_s
                trace.append(
                    ChurnEvent(t, "stage_out", {
                        "replica": i, "data": spec.stage_data,
                        "done_at": t + out_s,
                    })
                )
            else:
                st.offline_t = t
            n_retired[0] += 1
            touch()
            trace.append(ChurnEvent(t, "replica_retired", {"replica": i}))
            signal_capacity(t)

    def spawn(t: float, reason: str, rtype: Optional[str] = None) -> None:
        i = len(repl)
        # a typed GROW (ScaleDecision.rtype) spawns at the catalog type's
        # nameplate rate and price; an untyped one keeps the legacy
        # spec.spawn_rate replica — bit-identical pre-typed replays
        rt = get_replica_type(rtype) if rtype is not None else None
        w = SimWorker(Location(0, i), rt.rate if rt else spec.spawn_rate)
        workers.append(w)
        # billed from the decision (online_t=t): the warmup lag is paid
        # capacity, which is exactly why scaling policies need cooldowns
        st = _ReplicaState(w, online=False, online_t=t, legacy=legacy)
        if rt is not None:
            st.rtype = rt.name
            st.price = rt.price
        repl.append(st)
        served_by[i] = 0
        n_spawned[0] += 1
        touch()
        warm_at = t + spec.warmup_s
        detail = {"replica": i, "warm_at": warm_at, "reason": reason}
        if rt is not None:
            detail["rtype"] = rt.name
        trace.append(ChurnEvent(t, "scale_up", detail))
        push(warm_at, "replica_warm", i)
        if rt is not None and rt.preemptible:
            arm_preemption(i, t)

    def go_online(i: int, t: float) -> None:
        """A provisioned replica joins the routable fleet — the end of
        warmup for unstaged pools, the end of ``stage_in`` for staged ones
       . Until this fires the replica is invisible to views, so no
        router or rescue can hand it work."""
        st = repl[i]
        st.online = True
        st.observed = st.worker.rate
        touch()
        trace.append(ChurnEvent(t, "replica_warm", {"replica": i}))
        pool_peak[0] = max(
            pool_peak[0],
            left_sum(1 for s in repl if s.online and not s.retired),
        )
        signal_capacity(t)
        retry_parked(t)
        rebalance_to(i, t)

    def rebalance_to(i: int, t: float) -> None:
        """Pull *queued* (unstarted) requests from the deepest
        backlog-seconds queues onto a freshly-warm replica.

        Dispatch happens at admission, so by the time a spawned replica
        warms, a burst's requests are already sitting in the old replicas'
        queues — and LATE re-dispatch will not touch them (their replicas
        are busy, not degraded). Moving a queued request costs nothing (no
        progress exists to discard; the old attempt is recorded cancelled
        at zero work), and each move happens only while it strictly
        shortens that request's wait — so new capacity is absorbed by the
        backlog that motivated the spawn, not just by future arrivals.
        """
        me = repl[i]

        def movable(j: int) -> Optional[int]:
            # last in FIFO (longest current wait) that may land here: a
            # hedged attempt must never join its racing sibling's replica
            for rid in reversed(repl[j].queue):
                r = rs[rid]
                sibling = r.hedge_replica if r.replica == j else r.replica
                if not (is_hedged(rid) and sibling == i):
                    return rid
            return None

        while True:
            donor, donor_bs, donor_rid = None, 0.0, None
            for j, stj in enumerate(repl):
                if j == i or not stj.online or stj.retired or not stj.queue:
                    continue
                cand = movable(j)
                if cand is None:
                    continue
                bs = backlog_work_of(j, t) / max(stj.observed, 1e-9)
                if bs > donor_bs:
                    donor, donor_bs, donor_rid = j, bs, cand
            if donor is None:
                break
            rid = donor_rid
            w = attempt_work(rid, donor)
            my_rate = max(me.observed, 1e-9)
            finish_here = (backlog_work_of(i, t) + w) / my_rate
            if finish_here >= donor_bs:
                break  # the move no longer helps anyone: queues are even
            q_remove(donor, rid)
            slot = "hedge" if rs[rid].hedge_replica == donor else "primary"
            close_attempt(rid, donor, t, "cancelled")
            trace.append(
                ChurnEvent(t, "rebalance", {
                    "request": rid, "from": donor, "to": i,
                })
            )
            dispatch(rid, i, t, slot=slot)
            if repl[donor].draining:
                maybe_retire(donor, t)

    def drain(i: int, t: float, reason: str) -> None:
        repl[i].draining = True
        touch()
        trace.append(
            ChurnEvent(t, "scale_down", {"replica": i, "reason": reason})
        )
        signal_capacity(t)  # its capacity left the routable fleet
        maybe_retire(i, t)  # an idle victim retires on the spot

    def shrink_target(t: float, want: Optional[int]) -> Optional[int]:
        """Validate the policy's victim, else fall back to the shared
        :func:`~repro_torch.core.autoscale.default_shrink_victim` rule (slowest
        observed, newest on ties). Never drains the last routable replica
        — whatever the policy asked, an admitted request must always have
        somewhere to land, or the whole stream parks forever."""
        views = replica_views(t)
        routable = [v.replica_id for v in views if v.alive]
        if len(routable) <= 1:
            return None
        if want in routable:
            return want
        return default_shrink_victim(PoolView(time=t, replicas=tuple(views)))

    next_scale = [math.inf]

    def arm_scale(t: float) -> None:
        # dedupe like arm_probe: a recover must not start a second chain
        # next to a live one (that would silently double the cadence).
        # Strictly `<`: a check still pending at this same instant counts
        # as armed — the recover fires before it in same-t event order
        if next_scale[0] < t or math.isinf(next_scale[0]):
            next_scale[0] = t + spec.scale_check_s
            push(next_scale[0], "scale_check", None)

    def scale_tick(t: float) -> None:
        next_scale[0] = math.inf
        d = asc.decide(pool_view(t))
        if d.action == GROW:
            spawn(t, d.reason, d.rtype)
            asc.note_action_done(t)  # instantaneous in sim-time
        elif d.action == SHRINK:
            victim = shrink_target(t, d.replica_id)
            if victim is not None:
                drain(victim, t, d.reason)
                asc.note_action_done(t)
            else:
                asc.veto(d)  # roll back the cooldown: nothing happened
        # re-arm while a decision could still matter: arrivals ahead, live
        # work outstanding, or waiting requests (parked / behind the door)
        # that some replica could still serve. The last clause needs the
        # probe's can-progress guard: with every replica dead for good the
        # policies can never act (no measured capacity → HOLD), so parked
        # work must not keep the scale-check chain — and the run — alive.
        if legacy:
            live_work = any(
                st.online and not st.retired and st.worker.alive(t)
                and outstanding_on(i)
                for i, st in enumerate(repl)
            )
        else:
            live_work = any(
                st.online and not st.retired
                and (st.serving is not None or st.queue)
                and st.worker.alive(t)
                for st in repl
            )
        can_progress = any(
            not st.retired and (
                st.worker.alive(t)
                or (
                    st.worker.recover_at is not None
                    and st.worker.recover_at > t
                )
            )
            for st in repl
        )
        waiting = parked or (adm is not None and adm.n_deferred > 0)
        if t < last_arrival_t or live_work or (waiting and can_progress):
            arm_scale(t)

    # ---- event timers ---------------------------------------------------
    push_next_arrival()  # the rest of the stream feeds lazily, pop by pop
    for i, w in enumerate(workers):
        if w.slow_at is not None:
            push(w.slow_at, "rate_change", i)
            if w.slow_until is not None and w.slow_until > w.slow_at:
                push(w.slow_until, "rate_change", i)
        if w.fail_at is not None:
            push(w.fail_at, "replica_fail", i)
            pronounce_t = w.fail_at + spec.dead_after_s
            if w.recover_at is None or w.recover_at > pronounce_t:
                push(pronounce_t, "pronounce", i)
            if w.recover_at is not None:
                push(max(w.recover_at, w.fail_at), "recover", i)
    for i, st in enumerate(repl):
        if get_replica_type(st.rtype).preemptible:
            arm_preemption(i, 0.0)
    if asc is not None:
        next_scale[0] = 0.0
        push(0.0, "scale_check", None)

    # ---- the event loop -------------------------------------------------
    while heap and completed[0] + n_rejected[0] < len(reqs):
        t, _, kind, payload = heapq.heappop(heap)
        n_events[0] += 1
        if kind == "arrival":
            rid = payload
            push_next_arrival()
            if collect_trace:
                trace.append(
                    ChurnEvent(t, "request_arrival", {"request": rid})
                )
            if asc is not None:
                asc.note_request(rs[rid].req)  # deadline/budget learning
            if adm is None:
                admit(rid, t)
            else:
                decision = adm.offer(rs[rid].req, cluster_view(t))
                if decision == ADMIT:
                    admit(rid, t)
                elif decision == DEFER:
                    n_deferred[0] += 1
                    rs[rid].decision = "deferred"
                    deferred_ids.add(rid)
                    trace.append(
                        ChurnEvent(t, "request_deferred", {
                            "request": rid,
                            "slo_class": rs[rid].req.slo_class,
                        })
                    )
                else:
                    reject(rid, t)
        elif kind == "svc_done":
            i, version = payload
            st = repl[i]
            if st.version != version or st.serving is None:
                continue  # re-rated, cancelled, or failed since scheduled
            rid = st.serving
            st.serving = None
            st.version += 1
            touch()
            r = rs[rid]
            # resolve a hedge race first: identify the losing sibling (if
            # any) before the winner's close clears the attempt slots
            hedge_won = r.hedge_replica == i
            loser = r.replica if hedge_won else r.hedge_replica
            r.finish_t = t
            r.served_by = i
            close_attempt(rid, i, t, "done")
            if loser is not None:
                # first completion wins: cancel the losing attempt through
                # the same path re-dispatch uses; its progress is the
                # duplicate-work tax, and nothing else is recorded — one
                # completion, one sojourn into the class-p99 window
                cancel(rid, loser, t, outcome="hedge_loss")
                trace.append(
                    ChurnEvent(t, "hedge_cancel", {
                        "request": rid, "replica": loser, "winner": i,
                    })
                )
                if hedge_won:
                    n_hedge_wins[0] += 1
                    trace.append(
                        ChurnEvent(t, "hedge_win", {
                            "request": rid, "replica": i, "primary": loser,
                        })
                    )
            completed[0] += 1
            n_outstanding[0] -= 1
            served_by[i] += 1
            makespan[0] = max(makespan[0], t)
            sojourn = t - r.req.arrive_t
            p99win.note(r.req.slo_class, sojourn)
            sojourns.setdefault(r.req.slo_class, []).append(sojourn)
            if collect_trace:
                trace.append(
                    ChurnEvent(t, "request_done", {
                        "request": rid, "replica": i, "latency_s": sojourn,
                    })
                )
            if adm is not None:
                adm.on_job_done(t, r.req, sojourn)
            if sessions_on:
                # the completing replica now holds this session's freshest
                # KV cache: residency is single-holder (the stale copy on
                # a previous holder is forgotten), and a finished session
                # frees its slot everywhere
                sid = r.req.session_id
                if sid >= 0:
                    left = turns_left[sid] - 1
                    turns_left[sid] = left
                    prev = session_holder.get(sid)
                    if left <= 0:
                        if prev is not None:
                            repl[prev].sessions.discard(sid)
                            del session_holder[sid]
                    elif prev != i:
                        if prev is not None:
                            repl[prev].sessions.discard(sid)
                        session_holder[sid] = i
                        st.sessions.add(sid)
            start_service(i, t)
            maybe_retire(i, t)  # a draining replica retires once drained dry
        elif kind == "rate_change":
            i = payload
            st = repl[i]
            w = st.worker
            if not w.alive(t) or st.pronounced:
                continue  # silent replica: boundary is unobservable
            new_rate = w.rate_at(t)
            slowed = new_rate < w.rate
            st.observed = new_rate
            touch()
            trace.append(
                ChurnEvent(t, "straggler_on" if slowed else "straggler_off",
                           {"replica": i, "factor": new_rate / w.rate})
            )
            signal_capacity(t)
            if st.serving is not None:
                st.done_work = done_est(i, t)
                st.seg_start = t
                st.cur_rate = max(new_rate, 1e-9)
                st.version += 1
                touch()
                remaining = attempt_work(st.serving, i) - st.done_work
                push(t + remaining / st.cur_rate, "svc_done", (i, st.version))
        elif kind == "replica_fail":
            i = payload
            st = repl[i]
            trace.append(ChurnEvent(t, "replica_fail", {"replica": i}))
            if st.worker.recover_at is None:
                # billing fix: a replica dead for good stops
                # accruing replica-seconds at its death, not at makespan —
                # the instance is gone, nobody pays for the corpse. A
                # failure with a recovery ahead keeps billing through the
                # outage: the instance is still held.
                st.offline_t = min(st.offline_t, t)
            if st.serving is not None:
                # progress freezes with the replica; the request stays
                # assigned (stuck) until re-dispatch or recovery
                st.done_work = done_est(i, t)
                st.seg_start = t
                st.cur_rate = 0.0
            # the crash loses the KV caches even if the replica later
            # recovers (serving state restarts from scratch there too):
            # follow-up turns must go cold, not chase a wiped cache
            evict_sessions(i)
            st.version += 1  # invalidate any scheduled completion
            touch()
        elif kind == "pronounce":
            i = payload
            st = repl[i]
            if not st.worker.alive(t) and not st.pronounced:
                st.pronounced = True
                touch()
                trace.append(ChurnEvent(t, "replica_dead", {"replica": i}))
                signal_capacity(t)
        elif kind == "recover":
            i = payload
            st = repl[i]
            was_pronounced = st.pronounced
            st.pronounced = False
            st.observed = st.worker.rate_at(t)
            touch()
            trace.append(
                ChurnEvent(
                    t,
                    "re_registered" if was_pronounced else "replica_recover",
                    {"replica": i},
                )
            )
            if st.observed < st.worker.rate:
                trace.append(
                    ChurnEvent(t, "straggler_on", {
                        "replica": i,
                        "factor": st.observed / st.worker.rate,
                    })
                )
            if st.serving is not None:
                # serving state died with the replica: restart from scratch
                wasted[0] += st.done_work
                rid = st.serving
                st.serving = None
                q_pushleft(i, rid)
            st.version += 1
            start_service(i, t)
            signal_capacity(t)
            retry_parked(t)
            if asc is not None:
                # a re-registration may revive a run whose scale-check
                # chain ended while the pool was dead: resume the cadence
                # (deduped — a live chain is left alone)
                arm_scale(t)
        elif kind == "replica_warm":
            # boot finished. Unstaged pools become routable right here —
            # the pre-lifecycle single warmup constant, bit-identical.
            # Staged pools enter stage_in instead: the replica
            # stays offline (invisible to views) until its data pipe
            # drains at stage_done.
            i = payload
            st = repl[i]
            if not st.retired:
                if staging_on:
                    ready_at = t + get_replica_type(st.rtype).stage_s(
                        spec.stage_data
                    )
                    trace.append(
                        ChurnEvent(t, "stage_in", {
                            "replica": i, "data": spec.stage_data,
                            "ready_at": ready_at,
                        })
                    )
                    push(ready_at, "stage_done", i)
                else:
                    go_online(i, t)
        elif kind == "stage_done":
            i = payload
            if not repl[i].retired:  # a preempted spot never finishes staging
                n_staged[0] += 1
                go_online(i, t)
        elif kind == "spot_notice":
            # the cloud's heads-up: routing stops (the view reads
            # alive=False, like a scale_down drain) but the replica keeps
            # serving through the notice window — work it finishes before
            # the kill is work the rescue never has to move
            i = payload
            st = repl[i]
            if not st.retired:
                st.draining = True
                touch()
                trace.append(ChurnEvent(t, "spot_notice", {"replica": i}))
                signal_capacity(t)
        elif kind == "spot_kill":
            i = payload
            st = repl[i]
            if st.retired:
                continue  # drained dry inside the notice window: released
            evicted = list(st.queue)
            serving = st.serving
            # retire first so the eviction cancels below cannot restart
            # service or double-retire through maybe_retire
            st.retired = True
            st.online = False
            st.offline_t = min(st.offline_t, t)  # billing stops at the kill
            evict_sessions(i)  # preemption wipes the caches: no stage_out
            n_preempted[0] += 1
            for rid in evicted:
                cancel(rid, i, t)  # queued: zero progress discarded
            if serving is not None:
                cancel(serving, i, t)  # in-service progress → wasted_work
            st.version += 1  # invalidate any scheduled completion
            touch()
            trace.append(
                ChurnEvent(t, "spot_preempt", {
                    "replica": i,
                    "evicted": len(evicted) + (1 if serving is not None else 0),
                })
            )
            signal_capacity(t)
            # re-dispatch the in-flight work through the rescue path: a
            # hedged request whose sibling attempt is still racing keeps
            # that attempt and is NOT re-routed (the sibling is its
            # backup; a preempted attempt is never resurrected)
            if serving is not None:
                evicted.append(serving)
            for rid in evicted:
                r = rs[rid]
                if (
                    r.replica is None and r.hedge_replica is None
                    and r.finish_t < 0
                ):
                    route(rid, t)
        elif kind == "scale_check":
            if asc is not None:
                scale_tick(t)
        elif kind == "probe":
            probe(t)
        elif kind == "admission_check":
            pass  # drain below does the work
        drain_admission(t)

    # ---- wrap up --------------------------------------------------------
    stranded = 0
    results = []
    if not collect_requests:
        stranded = left_sum(
            1 for r in rs.values()
            if r.decision == "admitted" and r.finish_t < 0
        )
        rid_iter = ()
    else:
        rid_iter = sorted(rs)
    for rid in rid_iter:
        r = rs[rid]
        dispatches = [
            replace(d, outcome="stranded")
            if r.finish_t < 0 and d.outcome == "open"
            else d
            for d in r.dispatches
        ]
        if r.decision == "admitted" and r.finish_t < 0:
            stranded += 1
        results.append(
            RequestResult(
                rid=rid,
                arrive_t=r.req.arrive_t,
                work=r.req.total_work,
                slo_class=r.req.slo_class,
                deadline_s=r.req.deadline_s,
                decision=r.decision,
                admit_t=r.admit_t,
                finish_t=r.finish_t,
                served_by=r.served_by,
                dispatches=tuple(dispatches),
                session_id=r.req.session_id,
            )
        )
    # replica-seconds: each replica is billed from its spawn decision
    # (warmup included) until it retires, dies for good, is preempted, or
    # the last completion lands — the cost side of the claim-11 trade (a
    # peak-sized fixed pool pays this for every idle trough). Dollars are
    # the same seconds × the replica type's $/replica-second price.
    end_t = makespan[0]
    replica_seconds = 0.0
    cost = 0.0
    cost_by_type: dict[str, float] = {}
    for st in repl:
        sec = max(0.0, min(st.offline_t, end_t) - st.online_t)
        replica_seconds += sec
        c = sec * st.price
        cost += c
        cost_by_type[st.rtype] = cost_by_type.get(st.rtype, 0.0) + c
    return FleetResult(
        router=rtr.name,
        admission=adm.name if adm is not None else "none",
        redispatch=redispatch,
        late_factor=late_f,
        makespan=makespan[0],
        requests=results,
        trace=trace_out,
        completed=completed[0],
        n_rejected=n_rejected[0],
        n_deferred=n_deferred[0],
        n_redispatched=n_moves[0],
        stranded=stranded,
        wasted_work=wasted[0],
        served_by=served_by,
        hedge=hedge,
        n_hedged=n_hedged[0],
        n_hedge_wins=n_hedge_wins[0],
        duplicate_work=duplicate[0],
        autoscaler=asc.name if asc is not None else "none",
        n_spawned=n_spawned[0],
        n_retired=n_retired[0],
        pool_peak=pool_peak[0],
        replica_seconds=replica_seconds,
        cost=cost,
        cost_by_type=cost_by_type,
        n_preempted=n_preempted[0],
        n_sessions=n_sessions,
        n_cache_hits=n_cache_hits[0],
        prefill_work=prefill_paid[0],
        prefill_saved=prefill_saved[0],
        n_staged=n_staged[0],
        n_events=n_events[0],
        sojourns_by_class=sojourns,
    )
