"""Discrete-event heterogeneous-cluster simulator.

Copied from ``repro/core/simulator.py`` (pure Python), with every sum a
plain left fold (:func:`left_sum`), which the stored golden hashes assume.

The container has one CPU, so cluster-level *policy* claims (speculation,
placement, replication, failure recovery) are validated on an event-driven
simulator whose cost model comes from core/topology.py — the same layer the
paper's guidelines operate at. Compute-level claims use the dry-run/roofline
machinery instead (roofline/).

Model:
  * workers with heterogeneous rates (+ optional slowdown/failure at time t)
  * two-phase tasks: input fetch (when non-local / shuffle-like) then compute.
    Cross-pod fetches share one processor-sharing pipe per direction — adding
    a transfer slows every in-flight transfer (the paper's "excessive network
    congestion"), which is precisely how wrong speculative backups make a job
    *slower than speculation-off* (paper §III.b / LATE [12]).
  * Hadoop-style phase progress (fetch ≈ first third, compute the rest) —
    the coarse progress signal is what misleads the naive heuristic.
  * speculative execution policies: off | naive (stock Hadoop) | late
  * heartbeat-derived liveness (§IV.c.ii): worker silence is noticed by a
    :class:`~repro_torch.core.heartbeat.HeartbeatMonitor` ``dead_after_s`` after
    the worker's *last heartbeat* — not after the (unobservable) failure
    instant — then its tasks re-queue and, in elastic mode, its grains
    re-replicate (core/replication.py) with capacity-proportional targets.
  * worker-rate changes are first-class events: a straggler turning on
    (``slow_at``) or off (``slow_until``) re-rates the attempt currently
    running on that worker, so a mid-task slowdown delays the attempt —
    the signal LATE [12] exists to detect. A failed worker can re-register
    (``recover_at``) and re-grow the schedulable fleet.
  * **multi-job workloads**: ``run_workload`` replays a queue of jobs with
    arrival times through a pluggable inter-job slot scheduler
    (core/scheduler.py: fifo | fair | capacity); ``run_job`` is the
    single-job special case. All engine state is keyed by
    ``(job_id, task_id)`` so jobs contend for the same slots and the same
    cross-pod pipe — the regime the paper's jobtracker critique is about.

Outputs per job: makespan/latency, wasted (killed-backup) work, bytes moved,
per-worker utilization, plus a **churn trace** (``WorkloadResult.churn``):
every arrival / failure / straggler / pronounce-dead / re-replication /
re-registration transition, in event order — the feed launch/elastic.py
replays against the training-side ElasticController.
"""

from __future__ import annotations

import functools
import heapq
import math
import operator
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence, Union

from repro_torch.core.admission import (
    ADMIT,
    DEFER,
    AdmissionPolicy,
    ClusterView,
    JobRequest,
    get_policy,
    quantile as _quantile,
    ClassP99Window,
)
from repro_torch.core.heartbeat import Heartbeat, HeartbeatMonitor
from repro_torch.core.placement import Grain, PlacementPlan
from repro_torch.core.replication import ReplicaManager
from repro_torch.core.scheduler import SCHEDULERS, JobScheduler, JobView
from repro_torch.core.topology import Location, Topology


def left_sum(xs):
    """``sum`` as a plain left fold: ``((0 + x0) + x1) + ...``.

    Since Python 3.12 the built-in ``sum`` adds floats with compensated
    summation, which can move the last bit of a total. The engine's golden
    hashes and its ``==`` accumulator checks hold the plain fold, so every
    sum in this module and in ``workload.py`` goes through here."""
    return functools.reduce(operator.add, xs, 0)

FETCH_PHASE_FRACTION = 1.0 / 3.0  # Hadoop copy-phase share of task progress


@dataclass
class SimWorker:
    loc: Location
    rate: float  # unit-work items per second
    fail_at: Optional[float] = None  # hard failure time (None = healthy)
    slow_at: Optional[float] = None  # becomes a straggler at this time
    slow_factor: float = 0.1
    slow_until: Optional[float] = None  # straggler recovers at this time
    recover_at: Optional[float] = None  # failed worker re-registers here

    def rate_at(self, t: float) -> float:
        if (
            self.slow_at is not None
            and t >= self.slow_at
            and (self.slow_until is None or t < self.slow_until)
        ):
            return self.rate * self.slow_factor
        return self.rate

    def alive(self, t: float) -> bool:
        if self.fail_at is None or t < self.fail_at:
            return True
        return self.recover_at is not None and t >= self.recover_at


@dataclass(frozen=True)
class SimJob:
    """One job in a workload: its grains, their placement, and arrival time.

    ``slo_class``/``deadline_s`` are the admission-control handles:
    class 0 is the strictest SLO; the deadline is a sojourn budget relative
    to ``submit_t``. Both default to "no SLO" so pre-admission workloads
    replay unchanged.
    """

    job_id: int
    grains: tuple[Grain, ...]
    plan: PlacementPlan
    submit_t: float = 0.0
    slo_class: int = 0
    deadline_s: float = math.inf

    @property
    def total_work(self) -> float:
        return left_sum(g.work for g in self.grains)

    @property
    def total_bytes(self) -> int:
        return left_sum(g.nbytes for g in self.grains)


@dataclass
class Attempt:
    task: int
    worker: Location
    start: float
    fetch_bytes: float  # cross-pipe bytes still to fetch (0 = local)
    compute_s: float  # compute duration once fetch completes
    work: float = 0.0  # unit work (re-rated when compute actually starts)
    speculative: bool = False
    job: int = 0
    # runtime state
    fetched: float = 0.0
    compute_start: Optional[float] = None
    done: bool = False
    killed: bool = False
    finish_t: Optional[float] = None

    @property
    def key(self) -> tuple[int, int]:
        return (self.job, self.task)

    def progress(self, t: float) -> float:
        if self.done:
            return 1.0
        if self.fetch_bytes > 0 and self.compute_start is None:
            return FETCH_PHASE_FRACTION * min(1.0, self.fetched / self.fetch_bytes)
        base = FETCH_PHASE_FRACTION if self.fetch_bytes > 0 else 0.0
        if self.compute_start is None:
            return 0.0
        frac = min(1.0, (t - self.compute_start) / max(self.compute_s, 1e-9))
        return base + (1.0 - base) * frac

    def rate(self, t: float) -> float:
        return self.progress(t) / max(t - self.start, 1e-9)


@dataclass(frozen=True)
class ChurnEvent:
    """One liveness/rate/arrival transition observed by the engine.

    Kinds: ``job_arrival`` | ``worker_fail`` | ``straggler_on`` |
    ``straggler_off`` | ``pronounce_dead`` | ``re_replicated`` |
    ``re_registered`` | ``pod_dead`` | ``pod_alive``. The trace is in
    event order and deterministic for a fixed (jobs, seed, flags) tuple,
    so it can be replayed elsewhere (launch/elastic.py ``apply_churn``).

    Only *observable* transitions are recorded: a silent (failed or
    pronounced) worker emits no rate changes. ``re_registered`` resets the
    worker's observed rate to nominal; a worker that rejoins still
    degraded emits ``straggler_on`` at the same instant, so the rate state
    implied by any trace prefix is consistent.
    """

    time: float
    kind: str
    detail: dict = field(default_factory=dict)


@dataclass
class SimResult:
    makespan: float
    wasted_work: float
    moved_bytes: float
    cross_pod_bytes: float
    n_speculative: int
    n_spec_won: int
    completed: int
    reassigned_after_failure: int
    util: dict[str, float]


@dataclass
class JobResult:
    """Per-job outcome inside a workload run.

    ``decision`` is the admission outcome (``admitted`` | ``rejected`` |
    ``deferred`` — the last only when the run ended before the policy ever
    released the job); ``admit_t`` is when the job entered the runnable
    queue (== ``submit_t`` without an admission policy), so
    ``admit_t - submit_t`` is the admission-deferral component of the
    sojourn. ``latency`` stays submit-to-finish: admission control is
    meaningless if the wait it imposes is invisible.
    """

    job_id: int
    submit_t: float
    first_launch_t: float
    finish_t: float
    n_tasks: int
    completed: int
    slo_class: int = 0
    deadline_s: float = math.inf
    work: float = 0.0
    decision: str = "admitted"
    admit_t: float = -1.0

    @property
    def latency(self) -> float:
        """Submit-to-finish sojourn (the user-visible job completion time)."""
        return self.finish_t - self.submit_t

    @property
    def queue_delay(self) -> float:
        return self.first_launch_t - self.submit_t

    @property
    def on_time(self) -> bool:
        """Completed within its SLO budget (vacuously needs completion)."""
        return self.finish_t >= 0 and self.latency <= self.deadline_s + 1e-9


@dataclass
class WorkloadResult:
    scheduler: str
    policy: str
    makespan: float  # last task completion over the whole workload
    jobs: list[JobResult]
    wasted_work: float
    moved_bytes: float
    cross_pod_bytes: float
    n_speculative: int
    n_spec_won: int
    completed: int
    reassigned_after_failure: int
    util: dict[str, float]
    # elastic-churn accounting: the recovery chain's observable cost
    elastic: str = "static"  # failure-recovery mode the run used
    churn: list[ChurnEvent] = field(default_factory=list)
    re_replicated_bytes: float = 0.0  # bytes written restoring replication
    re_replication_s: float = 0.0  # summed (throttled, off-pipe) copy time
    n_re_replicated: int = 0  # replica copies made
    # admission accounting: what the policy did at the door
    admission: str = "none"  # admission policy the run used
    n_admitted: int = 0
    n_rejected: int = 0
    n_deferred: int = 0  # jobs deferred at least once (admitted later or not)

    def latencies(self, slo_class: Optional[int] = None) -> list[float]:
        return sorted(
            j.latency
            for j in self.jobs
            if j.finish_t >= 0 and (slo_class is None or j.slo_class == slo_class)
        )

    def latency_quantile(self, q: float, slo_class: Optional[int] = None) -> float:
        return _quantile(self.latencies(slo_class), q)

    @property
    def mean_latency(self) -> float:
        lats = self.latencies()
        return left_sum(lats) / len(lats) if lats else float("nan")

    def class_stats(self) -> dict[int, dict[str, float]]:
        """Per-SLO-class sojourn/goodput summary: job counts by admission
        outcome, p50/p99 sojourn over completed jobs, and ``on_time_work``
        (Σ work of jobs finishing within their own deadline — the goodput
        currency benchmarks/bench_admission.py gates on)."""
        out: dict[int, dict[str, float]] = {}
        for cls in sorted({j.slo_class for j in self.jobs}):
            jobs = [j for j in self.jobs if j.slo_class == cls]
            out[cls] = {
                "n": len(jobs),
                "n_completed": left_sum(1 for j in jobs if j.finish_t >= 0),
                "n_rejected": left_sum(1 for j in jobs if j.decision == "rejected"),
                "p50": self.latency_quantile(0.5, cls),
                "p99": self.latency_quantile(0.99, cls),
                "on_time_work": left_sum(j.work for j in jobs if j.on_time),
                "total_work": left_sum(j.work for j in jobs),
            }
        return out


class SpeculationPolicy:
    name = "off"

    def pick(
        self, t, running: list[Attempt], free_worker: SimWorker, sim
    ) -> Optional[tuple[int, int]]:
        """Return the (job_id, task_id) to back up, or None."""
        return None

    def observable(self, t: float, a: Attempt, sim) -> bool:
        """Hadoop's speculative lag, scaled to the model: the jobtracker
        only sees progress via heartbeats, so an attempt is not judgeable
        until a couple of reports have arrived. Also guards the degenerate
        rate≈0 of an attempt launched earlier in the same scheduling wave,
        which would otherwise rank as the slowest task in the cluster."""
        return t - a.start >= 2.0 * sim.heartbeat_s


class NaiveSpeculation(SpeculationPolicy):
    """Stock-Hadoop heuristic (paper §III.b / [12]): back up any task whose
    progress is >20 points under the mean over ALL attempts — completed tasks
    (progress 1.0) drag the mean up, so in a heterogeneous cluster everything
    on a slow node triggers; node speed is never consulted."""

    name = "naive"
    threshold = 0.2

    def pick(self, t, running, free_worker, sim):
        if not running:
            return None
        # the published heuristic is per-job: mean progress over all of THE
        # JOB's attempts (completed ones at 1.0 drag it up — the misfire)
        mean_by_job: dict[int, float] = {}
        for a in running:
            if a.job in mean_by_job:
                continue
            # per-job attempt index in launch order — the same subsequence
            # (and float summation order) the full-history scan produced
            ps = [
                x.progress(t)
                for x in sim._attempts_by_job.get(a.job, ())
                if not x.killed
            ]
            mean_by_job[a.job] = left_sum(ps) / max(len(ps), 1)
        for a in running:
            if (
                self.observable(t, a, sim)
                and a.progress(t) < mean_by_job[a.job] - self.threshold
                and not sim.has_backup(a.job, a.task)
            ):
                return a.key
        return None


class LateSpeculation(SpeculationPolicy):
    """LATE [Zaharia et al., OSDI'08]: longest estimated time-to-end first,
    backups only on fast nodes, count cap, slowest-quartile rate filter."""

    name = "late"
    spec_cap_fraction = 0.1
    slow_task_quantile = 0.25

    def pick(self, t, running, free_worker, sim):
        if not running:
            return None
        if sim.active_backups() >= max(1, int(self.spec_cap_fraction * len(sim.workers))):
            return None
        rates = sorted(w.rate_at(t) for w in sim.workers.values() if w.alive(t))
        if free_worker.rate_at(t) < rates[len(rates) // 2]:
            return None
        cands = [
            a for a in running
            if self.observable(t, a, sim)
            and a.progress(t) < 1.0 - 1e-12  # done-but-unreported ≠ straggler
            and not sim.has_backup(a.job, a.task)
            and (a.fetch_bytes == 0 or a.compute_start is not None)
        ]
        if not cands:
            return None
        cands.sort(key=lambda a: a.rate(t))
        cands = cands[: max(1, int(len(cands) * self.slow_task_quantile))]
        best = max(cands, key=lambda a: (1 - a.progress(t)) / max(a.rate(t), 1e-9))
        return best.key


POLICIES: dict[str, Callable[[], SpeculationPolicy]] = {
    "off": SpeculationPolicy,
    "naive": NaiveSpeculation,
    "late": LateSpeculation,
}


class _SharedPipe:
    """Processor-sharing link: n active transfers each get bw/n."""

    def __init__(self, bw: float):
        self.bw = bw
        self.active: dict[int, Attempt] = {}
        self.last_t = 0.0

    def advance(self, t: float) -> list[Attempt]:
        """Drain bytes up to time t; return transfers that completed."""
        if t > self.last_t and self.active:
            share = self.bw / len(self.active)
            dt = t - self.last_t
            for a in self.active.values():
                a.fetched = min(a.fetch_bytes, a.fetched + share * dt)
        self.last_t = max(self.last_t, t)
        done = [a for a in self.active.values() if a.fetched >= a.fetch_bytes - 1e-3]
        for a in done:
            del self.active[id(a)]
        return done

    def add(self, a: Attempt, t: float):
        self.advance(t)
        self.active[id(a)] = a

    def remove(self, a: Attempt, t: float):
        self.advance(t)
        self.active.pop(id(a), None)

    def next_finish(self) -> Optional[float]:
        if not self.active:
            return None
        share = self.bw / len(self.active)
        rem = min(a.fetch_bytes - a.fetched for a in self.active.values())
        # strictly-advancing epsilon prevents zero-progress event loops
        return self.last_t + max(rem, 0.0) / share + 1e-9


class _JobRun:
    """Mutable per-job engine state (pending/done/attempt bookkeeping)."""

    __slots__ = (
        "job", "gmap", "plan", "pending", "done", "attempts_of", "total_work",
        "done_work", "first_launch_t", "finish_t", "arrived", "admit_t",
        "decision",
    )

    def __init__(self, job: SimJob):
        self.job = job
        self.gmap = {g.gid: g for g in job.grains}
        # private copy of the replica map: elastic recovery mutates it
        # (re-replication re-points replicas), and the same SimJob must be
        # replayable bit-identically across runs
        self.plan = PlacementPlan(
            primary=job.plan.primary,
            replicas={gid: list(reps) for gid, reps in job.plan.replicas.items()},
            per_worker=job.plan.per_worker,
        )
        self.pending: list[int] = [g.gid for g in job.grains]
        self.done: set[int] = set()
        self.attempts_of: dict[int, list[Attempt]] = {}
        self.total_work = job.total_work  # cached: read per free worker per event
        self.done_work = 0.0
        self.first_launch_t = -1.0
        self.finish_t = -1.0
        self.arrived = False
        self.admit_t = -1.0
        self.decision = "pending"  # admitted | rejected | deferred | pending

    @property
    def remaining_work(self) -> float:
        return self.total_work - self.done_work

    def finished(self) -> bool:
        return len(self.done) == len(self.gmap)


class SimCluster:
    def __init__(
        self,
        workers: list[SimWorker],
        topology: Topology,
        heartbeat_s: float = 3.0,
        dead_after_s: float = 600.0,
        seed: int = 0,
    ):
        self.workers: dict[Location, SimWorker] = {w.loc: w for w in workers}
        self.topo = topology
        self.heartbeat_s = heartbeat_s
        self.dead_after_s = dead_after_s
        self._attempts: list[Attempt] = []
        # incremental attempt indices (same discipline as the incremental
        # fleet accumulators): run_workload maintains these at every
        # launch / kill / finish transition so policy queries stop scanning
        # the full attempt history per heartbeat. Append order everywhere
        # mirrors ``self._attempts`` (launch order), so any float summation
        # over a filtered view reproduces the old full-scan order exactly.
        self._attempts_by_job: dict[int, list[Attempt]] = {}
        self._backup_count: dict[tuple[int, int], int] = {}  # live backups per key
        self._n_live_backups = 0

    # ------------------------------------------------------------------
    def has_backup(self, job: int, task: int) -> bool:
        return self._backup_count.get((job, task), 0) > 0

    def active_backups(self) -> int:
        return self._n_live_backups

    # ------------------------------------------------------------------
    def run_job(
        self,
        grains: list[Grain],
        plan: PlacementPlan,
        policy: str = "late",
        congestion: bool = True,
        elastic: Union[bool, str] = False,
    ) -> SimResult:
        """Single-job replay — thin wrapper over :meth:`run_workload`."""
        job = SimJob(job_id=0, grains=tuple(grains), plan=plan, submit_t=0.0)
        wr = self.run_workload(
            [job], scheduler="fifo", policy=policy, congestion=congestion,
            elastic=elastic,
        )
        return SimResult(
            makespan=wr.makespan,
            wasted_work=wr.wasted_work,
            moved_bytes=wr.moved_bytes,
            cross_pod_bytes=wr.cross_pod_bytes,
            n_speculative=wr.n_speculative,
            n_spec_won=wr.n_spec_won,
            completed=wr.completed,
            reassigned_after_failure=wr.reassigned_after_failure,
            util=wr.util,
        )

    # ------------------------------------------------------------------
    def run_workload(
        self,
        jobs: Sequence[SimJob],
        scheduler: Union[str, JobScheduler] = "fifo",
        policy: str = "late",
        congestion: bool = True,
        elastic: Union[bool, str] = False,
        admission: Union[str, AdmissionPolicy, None] = None,
    ) -> WorkloadResult:
        """Replay a multi-job workload through a pluggable slot scheduler.

        Every time a worker frees, the ``scheduler`` decides which *job* the
        slot serves next (core/scheduler.py); within that job the locality-
        first rule picks the grain. Speculation (``policy``) kicks in only
        when no arrived job has pending work — exactly Hadoop's behaviour of
        backing up stragglers with otherwise-idle slots.

        ``elastic`` selects the failure-recovery mode (paper §IV.c):

        * ``False`` / ``"static"`` — pronounce-dead only re-queues the dead
          worker's tasks; data placement stays as submitted, so every later
          read of that worker's grains detours to the nearest *surviving*
          replica (often cross-pod, on the contended pipe).
        * ``True`` / ``"reproportion"`` — the paper's full chain: on
          pronounce-dead a per-job :class:`ReplicaManager` re-replicates the
          under-replicated grains onto survivors chosen ∝ capacity, so the
          queue behind the failure regains locality; jobs arriving after a
          death are re-proportioned on arrival. Copy bytes/seconds accrue in
          ``re_replicated_bytes`` / ``re_replication_s`` (modelled as a
          throttled background transfer, HDFS-style, not on the job fetch
          pipe — the availability of new replicas is instant, the cost is
          reported).

        Either way the run emits a churn trace: heartbeat-derived pronounce
        events (timeout counts from the worker's last heartbeat, via
        :class:`HeartbeatMonitor`), straggler on/off boundaries, job
        arrivals, re-replications, and re-registrations of recovered
        workers. Trace collection stops when the last task completes.

        ``admission`` routes every arrival through an
        :class:`~repro_torch.core.admission.AdmissionPolicy` (name from the
        ``ADMISSION`` registry, a policy instance, or ``None`` for the
        legacy admit-everything path). Admitted jobs enter the runnable
        queue (``job_admitted`` churn event); rejected jobs never launch an
        attempt and appear in no churn event beyond their own
        ``job_arrival``/``job_rejected`` pair; deferred jobs are held by
        the policy and released on later ``job_admitted`` events (their
        sojourn still counts from ``submit_t``). The policy sees the same
        capacity signal the elastic chain emits — pronounce-dead,
        re-registration, and straggler boundaries re-rate it mid-run.
        """
        mode = {False: "static", True: "reproportion"}.get(elastic, elastic)
        if mode not in ("static", "reproportion"):
            raise ValueError(f"unknown elastic mode {elastic!r}")
        sched = SCHEDULERS[scheduler]() if isinstance(scheduler, str) else scheduler
        pol = POLICIES[policy]()
        adm = get_policy(admission)
        self._attempts = []
        self._attempts_by_job = {}
        self._backup_count = {}
        self._n_live_backups = 0
        # live-attempt view: exactly the not-done-not-killed subset of
        # ``self._attempts`` in launch order (dict removal keeps the order of
        # the survivors), so the speculation scan per free worker is O(live)
        # instead of O(every attempt ever launched). ``attempts_on`` is the
        # per-worker index of the same history (append-only, launch order)
        # for the requeue/kill sweeps that fire on failure and pronounce.
        live_attempts: dict[int, Attempt] = {}
        attempts_on: dict[Location, list[Attempt]] = {w: [] for w in self.workers}
        jrs: dict[int, _JobRun] = {}
        for job in jobs:
            if job.job_id in jrs:
                raise ValueError(f"duplicate job_id {job.job_id}")
            jrs[job.job_id] = _JobRun(job)
        # incremental-view bookkeeping: jobs still carrying work, in
        # jrs insertion order, popped at the completion that finishes them —
        # cluster_view walks this instead of re-testing every job per
        # snapshot. A zero-grain job is born finished and never launches,
        # so it is excluded here exactly as the per-snapshot test did.
        unfinished: dict[int, _JobRun] = {
            jid: jr for jid, jr in jrs.items() if not jr.finished()
        }
        total_tasks = left_sum(len(jr.gmap) for jr in jrs.values())
        # tasks the run must complete before it can stop; rejections shrink it
        expected_tasks = [total_tasks]
        pipe = _SharedPipe(self.topo.cross_pod_bw)
        moved = cross = wasted = 0.0
        re_bytes = re_seconds = 0.0
        n_re_copies = 0
        n_spec = n_spec_won = reassigned = 0
        busy: dict[Location, Optional[Attempt]] = {w: None for w in self.workers}
        busy_time: dict[Location, float] = {w: 0.0 for w in self.workers}
        dead: set[Location] = set()
        churn: list[ChurnEvent] = []
        pods_down: set[int] = set()
        name_of = {loc: str(loc) for loc in self.workers}
        loc_of = {n: loc for loc, n in name_of.items()}
        capacities = {loc: w.rate for loc, w in self.workers.items()}
        monitor = HeartbeatMonitor(
            interval_s=self.heartbeat_s, dead_after_s=self.dead_after_s
        )
        for loc, w in self.workers.items():
            monitor.register(name_of[loc], 0.0, nameplate=w.rate)
        managers: dict[int, ReplicaManager] = {}
        # -- admission-control state ---------------------------------
        adm_name = adm.name if adm is not None else "none"
        n_admitted = n_rejected = n_deferred = 0
        adm_reqs: dict[int, JobRequest] = {}
        deferred_ids: set[int] = set()
        p99win = ClassP99Window()  # completed-sojourn window per class
        total_nameplate = left_sum(w.rate for w in self.workers.values())
        heap: list[tuple[float, int, str, object]] = []
        seq = [0]

        def push(t: float, kind: str, payload) -> None:
            seq[0] += 1
            heapq.heappush(heap, (t, seq[0], kind, payload))

        next_check = [float("inf")]

        def reschedule_pipe() -> None:
            nf = pipe.next_finish()
            if nf is None:
                next_check[0] = float("inf")
                return
            # only push when the pipe's next finish moved earlier or the old
            # check already fired — bounds heap growth
            if nf < next_check[0] - 1e-12 or next_check[0] <= pipe.last_t:
                next_check[0] = nf
                push(nf, "pipe_check", None)

        def live_replicas(jr: _JobRun, gid: int) -> list[Location]:
            """Replicas not on pronounced-dead workers (the coordinator's
            observable state; silent-but-unpronounced nodes still count).
            Falls back to the full set when everything is down."""
            reps = [r for r in jr.plan.replicas[gid] if r not in dead]
            return reps or jr.plan.replicas[gid]

        def fetch_plan(jr: _JobRun, w: SimWorker, gid: int) -> tuple[float, float, int]:
            """(pipe_bytes, fixed_fetch_s, distance) for gid on w."""
            g = jr.gmap[gid]
            reps = live_replicas(jr, gid)
            src = min(reps, key=lambda r: self.topo.distance(r, w.loc))
            dist = self.topo.distance(src, w.loc)
            if g.remote_input:
                dist = 2
            if dist == 0:
                return 0.0, 0.0, 0
            if dist == 1:
                return 0.0, g.nbytes / self.topo.in_pod_bw, 1
            return (g.nbytes, 0.0, 2) if congestion else (0.0, g.nbytes / self.topo.cross_pod_bw, 2)

        def pick_local_first(jr: _JobRun, wloc: Location) -> int:
            """HDFS data-awareness: node-local > pod-local > any (paper
            §III.a). A ``remote_input`` (shuffle-like) grain is distance 2
            no matter where its replicas sit — ``fetch_plan`` forces it over
            the cross-pod pipe — and dead workers' replicas don't count."""
            best, best_d = jr.pending[0], 3
            for gid in jr.pending:
                if jr.gmap[gid].remote_input:
                    d = 2
                else:
                    d = min(
                        self.topo.distance(r, wloc) for r in live_replicas(jr, gid)
                    )
                if d < best_d:
                    best, best_d = gid, d
                    if d == 0:
                        break
            return best

        # -- elastic recovery + heartbeat-derived liveness helpers ---------
        def last_beat(t: float) -> float:
            """Latest heartbeat boundary at or before t."""
            return math.floor(t / self.heartbeat_s) * self.heartbeat_s

        def observed_beat(w: SimWorker, t: float) -> float:
            """When the coordinator last heard from w (silent since failure
            unless recovered)."""
            if w.fail_at is None or t < w.fail_at:
                return last_beat(t)
            if w.recover_at is not None and t >= w.recover_at:
                return last_beat(t)
            return last_beat(w.fail_at)

        def manager_for(jr: _JobRun) -> ReplicaManager:
            rm = managers.get(jr.job.job_id)
            if rm is None:
                rm = ReplicaManager(
                    jr.plan,
                    {g.gid: g.nbytes for g in jr.job.grains},
                    self.topo,
                    replication=max(
                        (len(v) for v in jr.plan.replicas.values()), default=3
                    ),
                    capacities=capacities,
                )
                managers[jr.job.job_id] = rm
            return rm

        def recover_job(jr: _JobRun, t: float, reason: str) -> None:
            """Restore the job's replication level onto survivors ∝ capacity
            and charge the copy cost (paper §IV.c.i re-replication)."""
            nonlocal re_bytes, re_seconds, n_re_copies
            rm = manager_for(jr)
            rm.failed |= dead
            cost = rm.recover()
            if cost.events:
                re_bytes += cost.bytes_written
                re_seconds += cost.transfer_s
                n_re_copies += len(cost.events)
                churn.append(
                    ChurnEvent(t, "re_replicated", {
                        "job": jr.job.job_id,
                        "copies": len(cost.events),
                        "bytes": cost.bytes_written,
                        "reason": reason,
                    })
                )

        def requeue_lost(loc: Location, t: float) -> None:
            """Re-queue every task whose only attempts ran on ``loc`` and
            died with it (conservation: completed + requeued == total)."""
            nonlocal reassigned
            for a in attempts_on[loc]:
                jr = jrs[a.job]
                if a.task in jr.done or a.task in jr.pending:
                    continue
                alive_attempts = [
                    x
                    for x in jr.attempts_of.get(a.task, [])
                    if not x.killed and not x.done
                ]
                if not alive_attempts:
                    jr.pending.append(a.task)
                    reassigned += 1

        def mark_dead(loc: Location, t: float) -> None:
            """Record one pronouncement (no recovery yet: a sweep can expire
            a whole pod at once, and recovery must see the full death set —
            otherwise it re-replicates onto workers dying the same instant
            and double-charges the copy accounting)."""
            dead.add(loc)
            churn.append(ChurnEvent(t, "pronounce_dead", {"worker": name_of[loc]}))
            requeue_lost(loc, t)
            pod = loc.pod
            if pod not in pods_down and all(
                l in dead for l in self.workers if l.pod == pod
            ):
                pods_down.add(pod)
                churn.append(ChurnEvent(t, "pod_dead", {"pod": pod}))

        def launch(wloc: Location, jid: int, gid: int, t: float, speculative: bool) -> None:
            nonlocal moved, cross, n_spec
            jr = jrs[jid]
            w = self.workers[wloc]
            pipe_bytes, fixed_s, dist = fetch_plan(jr, w, gid)
            compute_s = jr.gmap[gid].work / max(w.rate_at(t), 1e-9)
            a = Attempt(gid, wloc, t, pipe_bytes, compute_s,
                        work=jr.gmap[gid].work, speculative=speculative, job=jid)
            self._attempts.append(a)
            self._attempts_by_job.setdefault(jid, []).append(a)
            live_attempts[id(a)] = a
            attempts_on[wloc].append(a)
            jr.attempts_of.setdefault(gid, []).append(a)
            if jr.first_launch_t < 0:
                jr.first_launch_t = t
            busy[wloc] = a
            if speculative:
                n_spec += 1
                self._n_live_backups += 1
                self._backup_count[a.key] = self._backup_count.get(a.key, 0) + 1
            if dist > 0:
                moved += jr.gmap[gid].nbytes
            if dist == 2:
                cross += jr.gmap[gid].nbytes
            if pipe_bytes > 0:
                pipe.add(a, t)
                reschedule_pipe()
            else:
                a.compute_start = t + fixed_s
                a.finish_t = a.compute_start + compute_s
                push(a.finish_t, "finish", a)

        def retire(a: Attempt) -> None:
            """Drop a from the live view (it just became done or killed)."""
            live_attempts.pop(id(a), None)
            if a.speculative:
                self._n_live_backups -= 1
                n = self._backup_count[a.key] - 1
                if n:
                    self._backup_count[a.key] = n
                else:
                    del self._backup_count[a.key]

        def kill(a: Attempt, t: float) -> None:
            nonlocal wasted
            if a.done or a.killed:
                return
            a.killed = True
            retire(a)
            # work units (fraction × task work), same currency as done_work —
            # comparable across policies and presets
            wasted += a.progress(t) * a.work
            if a.fetch_bytes > 0 and a.compute_start is None:
                pipe.remove(a, t)
                reschedule_pipe()
            if busy.get(a.worker) is a:
                # the slot was occupied from launch to kill: killed backups
                # and failed workers' attempts are real occupancy, not idle
                busy_time[a.worker] += t - a.start
                busy[a.worker] = None

        def job_views(t: float) -> list[JobView]:
            """Snapshot of arrived, unfinished jobs with pending work, plus
            the slot/capacity allocation the schedulers arbitrate over."""
            n_running: dict[int, int] = {}
            alloc_cap: dict[int, float] = {}
            for wloc, a in busy.items():
                if a is not None and not a.done and not a.killed:
                    n_running[a.job] = n_running.get(a.job, 0) + 1
                    alloc_cap[a.job] = alloc_cap.get(a.job, 0.0) + self.workers[wloc].rate_at(t)
            return [
                JobView(
                    job_id=jid,
                    submit_t=jr.job.submit_t,
                    n_pending=len(jr.pending),
                    n_running=n_running.get(jid, 0),
                    remaining_work=jr.remaining_work,
                    alloc_capacity=alloc_cap.get(jid, 0.0),
                    slo_class=jr.job.slo_class,
                    deadline_t=jr.job.submit_t + jr.job.deadline_s,
                )
                # unfinished preserves jrs insertion order; a finished job
                # has empty pending, so the filtered view is identical
                for jid, jr in unfinished.items()
                if jr.arrived and jr.pending
            ]

        # -- admission-control helpers ------------------------------
        def live_capacity(t: float) -> float:
            """Observed work rate: Σ rate over workers not pronounced dead.
            A silently-failed worker still counts until its pronouncement —
            the coordinator cannot see the failure, only the silence."""
            return left_sum(
                w.rate_at(t)
                for loc, w in self.workers.items()
                if loc not in dead
            )

        def cluster_view(t: float) -> ClusterView:
            running = [jr for jr in unfinished.values() if jr.arrived]
            free = left_sum(
                1
                for loc, w in self.workers.items()
                if busy[loc] is None and w.alive(t) and loc not in dead
            )
            return ClusterView(
                time=t,
                live_capacity=live_capacity(t),
                total_capacity=total_nameplate,
                free_slots=free,
                queue_depth=len(running),
                backlog_work=left_sum(jr.remaining_work for jr in running),
                deferred_depth=len(deferred_ids),
                deferred_work=left_sum(adm_reqs[j].total_work for j in deferred_ids),
                class_p99=p99win.snapshot(),
            )

        def admit_job(jid: int, t: float) -> None:
            nonlocal n_admitted
            jr = jrs[jid]
            jr.arrived = True
            jr.admit_t = t
            jr.decision = "admitted"
            n_admitted += 1
            if adm is not None:
                churn.append(
                    ChurnEvent(t, "job_admitted", {
                        "job": jid,
                        "slo_class": jr.job.slo_class,
                        "waited_s": t - jr.job.submit_t,
                    })
                )
            # a job admitted after a death was placed against the full
            # fleet: re-proportion its replicas when it becomes runnable
            if mode == "reproportion" and dead:
                recover_job(jr, t, "job_arrival")

        def reject_job(jid: int, t: float) -> None:
            nonlocal n_rejected
            jr = jrs[jid]
            jr.decision = "rejected"
            n_rejected += 1
            expected_tasks[0] -= len(jr.gmap)
            churn.append(
                ChurnEvent(t, "job_rejected",
                           {"job": jid, "slo_class": jr.job.slo_class})
            )

        next_adm_check = [float("inf")]

        def drain_admission(t: float) -> None:
            """Resolve deferred arrivals the policy can release now, and arm
            a timer for the earliest purely-time-driven release (token
            refill) so deferral can never strand the run."""
            if adm is None or not deferred_ids:
                return
            for req, decision in adm.poll(cluster_view(t)):
                deferred_ids.discard(req.job_id)
                if decision == ADMIT:
                    admit_job(req.job_id, t)
                else:
                    reject_job(req.job_id, t)
            nxt = adm.next_event_t()
            if nxt is not None and nxt > t and (
                nxt < next_adm_check[0] - 1e-12 or next_adm_check[0] <= t
            ):
                next_adm_check[0] = nxt
                push(nxt, "admission_check", None)

        def signal_capacity(t: float) -> None:
            if adm is not None:
                adm.on_capacity(t, live_capacity(t))

        def schedule_wave(t: float) -> None:
            free = [
                w
                for w in self.workers
                if busy[w] is None and self.workers[w].alive(t) and w not in dead
            ]
            for wloc in sorted(free, key=lambda l: -self.workers[l].rate_at(t)):
                views = job_views(t)
                if views:
                    jid = sched.select(t, views, self.workers[wloc])
                    jr = jrs[jid]
                    gid = pick_local_first(jr, wloc)
                    jr.pending.remove(gid)
                    launch(wloc, jid, gid, t, False)
                else:
                    # live_attempts is already the not-done-not-killed set in
                    # launch order, and only arrived jobs ever launch — the
                    # remaining filter is done-but-unreported duplicates
                    live = [
                        a
                        for a in live_attempts.values()
                        if a.task not in jrs[a.job].done
                    ]
                    if not live:
                        continue
                    pick = pol.pick(t, live, self.workers[wloc], self)
                    if pick is not None:
                        launch(wloc, pick[0], pick[1], t, True)

        # arrival + failure + rate-boundary timers
        for jid, jr in sorted(jrs.items()):
            push(jr.job.submit_t, "job_arrival", jid)
        for w in self.workers.values():
            if w.slow_at is not None:
                push(w.slow_at, "rate_change", w.loc)
                if w.slow_until is not None and w.slow_until > w.slow_at:
                    push(w.slow_until, "rate_change", w.loc)
            if w.fail_at is not None:
                push(w.fail_at, "worker_fail", w.loc)
                # the timeout runs from the last heartbeat the coordinator
                # actually received, not from the failure instant (+ε so the
                # float sum can never land a hair before the expiry check)
                pronounce_t = last_beat(w.fail_at) + self.dead_after_s + 1e-9
                if w.recover_at is None or w.recover_at > pronounce_t:
                    push(pronounce_t, "pronounce_check", w.loc)
                if w.recover_at is not None:
                    push(max(w.recover_at, w.fail_at), "worker_recover", w.loc)

        makespan = 0.0
        total_done = 0
        while heap and total_done < expected_tasks[0]:
            t, _, kind, payload = heapq.heappop(heap)
            finished_fetches = pipe.advance(t)
            for a in finished_fetches:
                if not a.killed and not a.done:
                    a.compute_start = t
                    a.compute_s = a.work / max(self.workers[a.worker].rate_at(t), 1e-9)
                    a.finish_t = t + a.compute_s
                    push(a.finish_t, "finish", a)
            reschedule_pipe()  # unconditional: joins can stale prior checks

            if kind == "pipe_check":
                pass  # advance above did the work
            elif kind == "job_arrival":

                def arrive(jid: int) -> None:
                    nonlocal n_deferred
                    jr = jrs[jid]
                    churn.append(ChurnEvent(t, "job_arrival", {"job": jid}))
                    if adm is None:
                        admit_job(jid, t)
                        return
                    req = JobRequest(
                        job_id=jid,
                        arrive_t=jr.job.submit_t,
                        n_tasks=len(jr.gmap),
                        total_work=jr.total_work,
                        slo_class=jr.job.slo_class,
                        deadline_s=jr.job.deadline_s,
                    )
                    adm_reqs[jid] = req
                    decision = adm.offer(req, cluster_view(t))
                    if decision == ADMIT:
                        admit_job(jid, t)
                    elif decision == DEFER:
                        n_deferred += 1
                        jr.decision = "deferred"
                        deferred_ids.add(jid)
                        churn.append(
                            ChurnEvent(t, "job_deferred",
                                       {"job": jid, "slo_class": jr.job.slo_class})
                        )
                    else:
                        reject_job(jid, t)

                arrive(payload)
                # drain same-instant arrivals before scheduling: a burst must
                # be arbitrated as one queue (fair splitting slots max-min),
                # not serialized job-by-job with the first seizing every slot
                while heap and heap[0][0] == t and heap[0][2] == "job_arrival":
                    _, _, _, jid2 = heapq.heappop(heap)
                    arrive(jid2)
            elif kind == "rate_change":
                w = self.workers[payload]
                # a silent (failed or pronounced) worker reports no rate
                # change, and it has no running attempt to re-rate — its
                # boundary is unobservable and must not enter the trace
                if not w.alive(t) or payload in dead:
                    schedule_wave(t)
                    continue
                slowed = w.rate_at(t) < w.rate
                churn.append(
                    ChurnEvent(t, "straggler_on" if slowed else "straggler_off",
                               {"worker": name_of[payload],
                                "factor": w.rate_at(t) / w.rate})
                )
                signal_capacity(t)
                # re-rate the attempt currently computing on this worker:
                # keep progress continuous at t, finish at t + remaining
                # work over the new rate (the mid-task straggler LATE [12]
                # was built to detect — previously in-flight attempts kept
                # their launch-time rate, so this signal could never occur)
                a = busy.get(payload)
                if (
                    a is not None
                    and not a.done
                    and not a.killed
                    and a.compute_start is not None
                ):
                    r_new = max(w.rate_at(t), 1e-9)
                    if t < a.compute_start:
                        # fixed-delay fetch still in progress: the whole
                        # compute window now runs at the new rate
                        a.compute_s = a.work / r_new
                        a.finish_t = a.compute_start + a.compute_s
                        push(a.finish_t, "finish", a)
                    else:
                        frac = (t - a.compute_start) / a.compute_s
                        if frac < 1.0 - 1e-12:
                            rem_s = a.work * (1.0 - frac) / r_new
                            a.compute_s = rem_s / (1.0 - frac)
                            a.compute_start = t - frac * a.compute_s
                            a.finish_t = t + rem_s
                            push(a.finish_t, "finish", a)
            elif kind == "worker_fail":
                churn.append(
                    ChurnEvent(t, "worker_fail", {"worker": name_of[payload]})
                )
                for a in attempts_on[payload]:
                    if not a.done and not a.killed:
                        kill(a, t)  # work lost immediately; requeue on pronounce
            elif kind == "pronounce_check":
                if payload not in dead:
                    # freshen the beats the coordinator would have seen so
                    # the sweep expires exactly the silent workers
                    for loc2, w2 in self.workers.items():
                        if loc2 in dead:
                            continue
                        st = monitor.workers.get(name_of[loc2])
                        beat_t = observed_beat(w2, t)
                        if st is not None and not st.dead and beat_t >= st.last_seen:
                            monitor.beat(Heartbeat(name_of[loc2], time=beat_t))
                    newly_dead = monitor.sweep(t)
                    for name in newly_dead:
                        mark_dead(loc_of[name], t)
                    # one recovery pass over the complete death set
                    if newly_dead and mode == "reproportion":
                        for _, jr in sorted(jrs.items()):
                            if jr.arrived and not jr.finished():
                                recover_job(jr, t, "pronounce_dead")
                    if newly_dead:
                        signal_capacity(t)  # admission sees the shrink
            elif kind == "worker_recover":
                w = self.workers[payload]
                name = name_of[payload]
                if payload in dead:
                    # paper: an expired node's next heartbeat is answered
                    # with RE_REGISTER; it rejoins with fresh liveness state
                    monitor.revive(name, t, nameplate=w.rate)
                    dead.discard(payload)
                    for rm in managers.values():
                        rm.failed.discard(payload)
                    churn.append(ChurnEvent(t, "re_registered", {"worker": name}))
                    # re_registered resets the observed rate to nominal; if
                    # the worker rejoins still inside a slow window, report
                    # it immediately so every trace prefix has a consistent
                    # rate state (its boundaries during the silence were
                    # unobservable and never emitted)
                    if w.rate_at(t) < w.rate:
                        churn.append(
                            ChurnEvent(t, "straggler_on",
                                       {"worker": name,
                                        "factor": w.rate_at(t) / w.rate})
                        )
                    if payload.pod in pods_down:
                        pods_down.discard(payload.pod)
                        churn.append(
                            ChurnEvent(t, "pod_alive", {"pod": payload.pod})
                        )
                    signal_capacity(t)  # admission sees the re-grow
                else:
                    monitor.beat(Heartbeat(name, time=t))
                requeue_lost(payload, t)
            elif kind == "finish":
                a = payload
                if a.killed or a.done or a.finish_t != t:
                    continue  # stale entry: the attempt was re-rated since
                w = self.workers[a.worker]
                if not w.alive(t):
                    continue
                a.done = True
                retire(a)
                makespan = max(makespan, t)
                busy_time[a.worker] += t - a.start
                busy[a.worker] = None
                jr = jrs[a.job]
                if a.task in jr.done:
                    continue
                jr.done.add(a.task)
                jr.done_work += a.work
                total_done += 1
                if a.speculative:
                    n_spec_won += 1
                if jr.finished():
                    jr.finish_t = t
                    unfinished.pop(a.job, None)
                    if adm is not None:
                        sojourn = t - jr.job.submit_t
                        p99win.note(jr.job.slo_class, sojourn)
                        adm.on_job_done(t, adm_reqs[a.job], sojourn)
                for other in jr.attempts_of.get(a.task, []):
                    if other is not a:
                        kill(other, t)
            drain_admission(t)
            schedule_wave(t)

        util = {
            str(w): (busy_time[w] / makespan if makespan > 0 else 0.0)
            for w in self.workers
        }
        job_results = [
            JobResult(
                job_id=jid,
                submit_t=jr.job.submit_t,
                first_launch_t=jr.first_launch_t,
                finish_t=jr.finish_t,
                n_tasks=len(jr.gmap),
                completed=len(jr.done),
                slo_class=jr.job.slo_class,
                deadline_s=jr.job.deadline_s,
                work=jr.total_work,
                decision=jr.decision,
                admit_t=jr.admit_t,
            )
            for jid, jr in sorted(jrs.items())
        ]
        return WorkloadResult(
            scheduler=sched.name,
            policy=pol.name,
            makespan=makespan,
            jobs=job_results,
            wasted_work=wasted,
            moved_bytes=moved,
            cross_pod_bytes=cross,
            n_speculative=n_spec,
            n_spec_won=n_spec_won,
            completed=total_done,
            reassigned_after_failure=reassigned,
            util=util,
            elastic=mode,
            churn=churn,
            re_replicated_bytes=re_bytes,
            re_replication_s=re_seconds,
            n_re_replicated=n_re_copies,
            admission=adm_name,
            n_admitted=n_admitted,
            n_rejected=n_rejected,
            n_deferred=n_deferred,
        )
