"""Inter-job slot schedulers for the multi-job simulator (paper §III / [13]).

Copied from ``repro/core/scheduler.py`` (pure Python).

Hadoop's jobtracker hands a freed tasktracker slot to some job's task queue;
*which* job gets the slot is the scheduling policy the related survey
(arXiv:1207.0780) catalogues. Three are modelled here:

fifo      — stock Hadoop: oldest submitted job with pending tasks wins. Big
            head-of-line jobs starve everything behind them, and every job
            pays its own straggler tail serially.
fair      — max-min fair share over *slots* (the Facebook fair scheduler):
            the freed slot goes to the job currently holding the fewest
            slots. Note this counts slots, not speed — on a heterogeneous
            cluster two jobs with equal slot counts can hold very unequal
            compute, the same homogeneity assumption the paper critiques.
fair_capacity — max-min fair share over *measured capacity*: the freed slot
            goes to the job holding the least aggregate rate, so fairness
            is in the currency that actually finishes work on a slow/fast
            pod mix (the het-aware repair of `fair`).
capacity  — the paper's §IV.b.ii "fragments ∝ speed" rule lifted to the job
            level: the currency is *measured capacity* (sum of the rates of
            the workers a job occupies), not slot count, and each freed
            worker goes to the job with the largest remaining-work-per-
            allocated-capacity deficit. This approximates largest-remaining-
            processing-time sharing, which shrinks workload makespan on
            slow/fast pod mixes (no giant job is left to tail out alone on
            the slow pod).
class_reserved — class-aware slot reservation (the scheduler-layer
            twin of the ``class_reserved`` router in core/router.py): slots
            on the fastest workers — rate at least ``reserve_frac`` of the
            fastest rate yet offered — are reserved for class-0 jobs,
            earliest deadline first; slower slots feed best-effort classes
            by capacity deficit. Either side spills to the other rather
            than idle a slot, so the reservation shapes placement without
            ever wasting capacity.

The engine (simulator.run_workload) calls ``select`` every time a worker
frees, passing a snapshot of all arrived jobs that still have pending tasks.
Schedulers carry no per-decision queue state — everything they need is in
the views, which keeps replays bit-deterministic (``class_reserved`` keeps
only a monotone high-water mark of the fastest rate seen, itself a pure
function of the offer sequence; the registry constructs a fresh instance
per run, so no mark leaks across replays).

Under churn this snapshot protocol is what makes the schedulers
elastic for free: ``alloc_capacity`` is summed from ``rate_at(t)`` and dead
workers never free, so when a pod is pronounced dead (or a straggler
re-rates, or a worker re-registers) the very next ``select`` call sees the
shrunken/re-grown capacity and re-proportions its decisions — no explicit
re-planning step.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable


@dataclass(frozen=True)
class JobView:
    """What a scheduler may see about one runnable job at decision time.

    ``slo_class``/``deadline_t`` surface the admission-layer SLO
    handles to class-aware schedulers; both default to "no SLO" so every
    pre-existing scheduler and replay sees the exact views it always did.
    ``deadline_t`` is absolute (submit time + budget) so earliest-deadline
    ordering needs no per-job arithmetic at decision time.
    """

    job_id: int
    submit_t: float
    n_pending: int  # tasks not yet launched (excl. running/done)
    n_running: int  # live (non-killed, non-done) attempts holding slots
    remaining_work: float  # total work minus completed tasks' work
    alloc_capacity: float  # Σ rate of the workers this job occupies now
    slo_class: int = 0  # admission-layer class (0 = strictest SLO)
    deadline_t: float = math.inf  # absolute deadline (submit_t + budget)


class JobScheduler:
    """Pick which job's queue a freed worker pulls from."""

    name = "base"

    def select(self, t: float, jobs: list[JobView], worker) -> int:
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover
        return f"<{type(self).__name__} {self.name}>"


class FifoScheduler(JobScheduler):
    """Stock Hadoop: strict arrival order (ties broken by job id)."""

    name = "fifo"

    def select(self, t, jobs, worker):
        return min(jobs, key=lambda j: (j.submit_t, j.job_id)).job_id


class FairScheduler(JobScheduler):
    """Max-min fair share over slots: feed the job holding the fewest."""

    name = "fair"

    def select(self, t, jobs, worker):
        return min(jobs, key=lambda j: (j.n_running, j.submit_t, j.job_id)).job_id


class CapacityWeightedScheduler(JobScheduler):
    """Capacity-weighted deficit: feed the job whose remaining work is
    largest relative to the measured capacity already serving it (counting
    the candidate worker's own rate, so a fast slot prefers the job it can
    help most). Heterogeneity-aware by construction — a slot on a 0.4×
    node counts for 0.4, not 1."""

    name = "capacity"

    def select(self, t, jobs, worker):
        wrate = worker.rate_at(t)

        def deficit(j: JobView) -> float:
            return j.remaining_work / max(j.alloc_capacity + wrate, 1e-9)

        # max deficit; ties go to the earliest-submitted job
        return max(jobs, key=lambda j: (deficit(j), -j.submit_t, -j.job_id)).job_id


class FairCapacityScheduler(JobScheduler):
    """Max-min fairness over *measured capacity*: feed the job currently
    holding the least aggregate rate, not the fewest slots. The slot-fair
    scheduler repeats the paper's homogeneity assumption — two jobs with
    equal slot counts can hold very unequal compute on a slow/fast pod mix;
    equalising ``alloc_capacity`` (Σ ``rate_at(t)`` of occupied workers) is
    the same fix capacity-proportional placement (§IV.b.ii) applies to
    data: the currency is measured speed, not node count."""

    name = "fair_capacity"

    def select(self, t, jobs, worker):
        return min(
            jobs, key=lambda j: (j.alloc_capacity, j.submit_t, j.job_id)
        ).job_id


class ClassReservedScheduler(JobScheduler):
    """Class-aware slot reservation: fast slots serve class 0 first.

    A freed worker counts as a **reserve slot** when its current rate is at
    least ``reserve_frac`` of the fastest rate this run has offered so far
    (a monotone high-water mark — on a heterogeneous cluster the fast pod
    sets it within the first scheduling wave, since the engine offers freed
    workers fastest-first). A reserve slot goes to the class-0 job with the
    earliest absolute deadline (ties: submit order); a general slot goes to
    the best-effort job with the largest capacity deficit (the ``capacity``
    rule). Neither side idles a slot: a reserve slot with no class-0 work
    spills to the deficit rule, and a general slot with only class-0 work
    serves it rather than wait.
    """

    name = "class_reserved"

    def __init__(self, reserve_frac: float = 0.5) -> None:
        self.reserve_frac = reserve_frac
        self._peak_rate = 0.0

    def _deficit_pick(self, jobs: list[JobView], wrate: float) -> int:
        def deficit(j: JobView) -> float:
            return j.remaining_work / max(j.alloc_capacity + wrate, 1e-9)

        return max(jobs, key=lambda j: (deficit(j), -j.submit_t, -j.job_id)).job_id

    def select(self, t, jobs, worker):
        wrate = worker.rate_at(t)
        self._peak_rate = max(self._peak_rate, wrate)
        critical = [j for j in jobs if j.slo_class == 0]
        best_effort = [j for j in jobs if j.slo_class != 0]
        if wrate >= self.reserve_frac * self._peak_rate - 1e-12:
            if critical:  # reserve slot: earliest deadline first
                return min(
                    critical,
                    key=lambda j: (j.deadline_t, j.submit_t, j.job_id),
                ).job_id
            return self._deficit_pick(best_effort, wrate)
        if best_effort:  # general slot: keep best-effort off the reserve
            return self._deficit_pick(best_effort, wrate)
        return self._deficit_pick(critical, wrate)


SCHEDULERS: dict[str, Callable[[], JobScheduler]] = {
    "fifo": FifoScheduler,
    "fair": FairScheduler,
    "fair_capacity": FairCapacityScheduler,
    "capacity": CapacityWeightedScheduler,
    "class_reserved": ClassReservedScheduler,
}
