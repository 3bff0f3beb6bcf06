"""SLO-aware admission control — one policy layer for simulator and serving.

The paper's heterogeneity bottlenecks bite hardest under overload: when the
queue is contended and a pod dies (§IV.c), every admitted job worsens every
other job's tail, and stock Hadoop has no notion of rejecting or deferring
work. This module is the missing subsystem: an :class:`AdmissionPolicy`
decides **admit / reject / defer** at arrival time from a
:class:`ClusterView` snapshot (live capacity, queue depth, per-class latency
history). The same policy objects drive both consumers:

* ``core/simulator.run_workload(..., admission=...)`` — jobs arriving on the
  discrete-event cluster;
* ``launch/serve.ServeLoop`` — requests arriving on the real decode loop
  (a request is just a tiny job whose work is its token budget).

A policy validated against the simulator's churn presets drops into the
serving path unchanged — that is the point of sharing the layer.

Policies, and the paper §IV guideline each one operationalizes:

``admit_all``
    The stock-Hadoop baseline the paper critiques throughout §III: the
    jobtracker queues everything, so overload converts directly into
    unbounded sojourn time for every job class.
``threshold``
    §IV.a (know your measured capacity): admission is gated on *seconds of
    backlog per unit of live capacity*, not on slot counts — the same
    measured-rate currency as capacity-proportional placement (§IV.b.ii).
    Work is shed at the door once the backlog bound is exceeded.
``token_bucket``
    §IV.c (failure is a capacity event, not an anomaly): the bucket's fill
    rate tracks the *observed* live capacity the churn trace reports, so a
    pod death (pronounce-dead) immediately re-rates admission downward and
    a re-registration re-grows it — the elastic chain's capacity signal,
    consumed at the door instead of after the queue has already formed.
``slo_classes``
    §IV.b/§IV.c applied per service class (the D-SPACE4Cloud framing,
    arXiv:1605.07083): per-class queues with earliest-deadline-first
    dequeue; under overload the lowest class is shed first, so the strict
    class keeps its p99 inside budget while best-effort work absorbs the
    loss. Deadline-infeasible stragglers are shed from any class — work
    that cannot meet its SLO only poisons everyone else's tail.

Protocol (both consumers follow it):

* ``offer(req, view)`` — called once per arrival; returns ``ADMIT``,
  ``REJECT``, or ``DEFER``. A deferring policy stores the request itself.
* ``poll(view)`` — called whenever capacity may have freed (job completion,
  re-registration, a timer); returns ``(req, decision)`` pairs resolving
  previously deferred requests.
* ``next_event_t()`` — optional timer: the earliest time a deferred request
  could be released without any other event happening (token refill).
* ``on_capacity(t, live_capacity)`` — the churn-trace capacity signal
  (pronounce-dead / re-register / straggler boundaries).
* ``on_job_done(t, req, sojourn_s)`` — completion feed for latency history.

Every policy is pure arithmetic over the event sequence it is shown, so a
replayed trace (same jobs, same churn) reproduces bit-identical decisions —
the property tests/test_admission.py pins.

Registry contract (``ADMISSION`` / :func:`get_policy` — one of the four
policy registries documented in docs/architecture.md, alongside
``SCHEDULERS``, ``ROUTER``, and ``AUTOSCALE``): policies are stateful
(deferred queues, token levels, clocks), so :func:`get_policy`
clones-and-resets instances per run — tuning carries over, runtime state
never does — and ``None`` means "no door" (every arrival admitted with
zero overhead). The per-class latency window this module maintains
(:func:`trailing_class_p99`) also feeds the autoscaler's
``deadline_aware`` policy (core/autoscale.py) — one latency definition
for the whole chain.
"""

from __future__ import annotations

import copy
import math
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Mapping, Optional, Union

ADMIT = "admit"
REJECT = "reject"
DEFER = "defer"

# trailing completions per class feeding ClusterView.class_p99 — a window,
# not a cumulative history, so an early budget blow-out stops dominating the
# signal once recent completions are back inside budget (a cumulative p99
# would latch slo_classes' shed trigger for the rest of the run)
CLASS_P99_WINDOW = 16


def quantile(xs, q: float) -> float:
    """Order-statistic quantile (ceil rule), NaN on empty input — the one
    definition every latency report in the repo shares."""
    if not xs:
        return float("nan")
    s = sorted(xs)
    idx = min(len(s) - 1, max(0, math.ceil(q * len(s)) - 1))
    return s[idx]


def trailing_class_p99(hist: Mapping[int, "list[float]"]) -> dict[int, float]:
    """Per-class trailing-window p99 for :attr:`ClusterView.class_p99` —
    the one definition both consumers build their views with, so the shed
    trigger slo_classes validates on the simulator is the trigger serving
    runs."""
    return {
        cls: quantile(h[-CLASS_P99_WINDOW:], 0.99) for cls, h in hist.items()
    }


class ClassP99Window:
    """Incremental producer of the :func:`trailing_class_p99` signal:
    per-class ``deque(maxlen=CLASS_P99_WINDOW)`` instead of an
    unbounded sojourn history re-sliced per snapshot. ``snapshot()``
    recomputes only after a :meth:`note` and always hands out a **new**
    dict, so a view built earlier keeps the numbers it was built with.
    Values and class insertion order match the brute-force path exactly
    (a maxlen deque *is* the trailing window)."""

    __slots__ = ("_hist", "_dirty", "_snap")

    def __init__(self) -> None:
        self._hist: dict[int, deque] = {}
        self._dirty = False
        self._snap: dict[int, float] = {}

    def note(self, slo_class: int, sojourn_s: float) -> None:
        h = self._hist.get(slo_class)
        if h is None:
            h = self._hist[slo_class] = deque(maxlen=CLASS_P99_WINDOW)
        h.append(sojourn_s)
        self._dirty = True

    def snapshot(self) -> dict[int, float]:
        if self._dirty:
            self._snap = {
                cls: quantile(list(h), 0.99) for cls, h in self._hist.items()
            }
            self._dirty = False
        return self._snap


@dataclass(frozen=True)
class JobRequest:
    """What a policy may see about one arriving job (or serving request)."""

    job_id: int
    arrive_t: float
    n_tasks: int
    total_work: float  # unit-work items (simulator) / token budget (serving)
    slo_class: int = 0  # 0 = strictest class
    deadline_s: float = math.inf  # sojourn budget, relative to arrive_t
    session_id: int = -1  # multi-turn session this request belongs to (-1: none)

    @property
    def deadline_t(self) -> float:
        return self.arrive_t + self.deadline_s


@dataclass(frozen=True)
class ClusterView:
    """Snapshot of live capacity + queue state at decision time.

    ``live_capacity`` is the *observed* work rate — Σ ``rate_at(t)`` over
    workers that are alive and not pronounced dead (simulator), or the
    measured decode throughput (serving). Backlogs are in the same work
    currency, so ``backlog_s`` is seconds-of-queue on today's fleet, which
    is what shrinks when a pod dies and re-grows when it re-registers.
    """

    time: float
    live_capacity: float
    total_capacity: float  # nameplate Σ rate (the fleet at full strength)
    free_slots: int
    queue_depth: int  # admitted jobs still running/pending
    backlog_work: float  # Σ remaining work of admitted, unfinished jobs
    deferred_depth: int = 0
    deferred_work: float = 0.0
    class_p99: Mapping[int, float] = field(default_factory=dict)

    @property
    def backlog_s(self) -> float:
        """Seconds of admitted backlog per unit of live capacity."""
        return self.backlog_work / max(self.live_capacity, 1e-9)


class AdmissionPolicy:
    """Decide admit / reject / defer at arrival time (see module docstring)."""

    name = "base"

    def __init__(self) -> None:
        # deque, not list: TokenBucket drains strictly FIFO and paid O(n)
        # per release as a list (the serve loop's earlier fix, applied
        # to the policy layer); SloClasses' EDF removals stay O(n) either
        # way but are bounded by the deferred depth, not the run length
        self._deferred: deque = deque()

    # -- per-run lifecycle ----------------------------------------------
    def reset(self) -> None:
        """Clear per-run runtime state (subclasses extend; tuning stays)."""
        self._deferred = deque()

    def fresh(self) -> "AdmissionPolicy":
        """A reset copy with the same tuning. Policies are stateful
        (deferred queues, token levels, clocks): every run must start from
        a clean one, or a leftover deferral/clock from a previous run
        leaks into the next (``get_policy`` calls this for instances)."""
        clone = copy.deepcopy(self)
        clone.reset()
        return clone

    # -- arrival-time decision ------------------------------------------
    def offer(self, req: JobRequest, view: ClusterView) -> str:
        raise NotImplementedError

    # -- deferred-queue resolution --------------------------------------
    def poll(self, view: ClusterView) -> list[tuple[JobRequest, str]]:
        return []

    def next_event_t(self) -> Optional[float]:
        return None

    @property
    def n_deferred(self) -> int:
        return len(self._deferred)

    @property
    def deferred_work(self) -> float:
        return sum(r.total_work for r in self._deferred)

    # -- feedback signals ------------------------------------------------
    def on_capacity(self, t: float, live_capacity: float) -> None:
        pass

    def on_job_done(self, t: float, req: JobRequest, sojourn_s: float) -> None:
        pass

    def __repr__(self) -> str:  # pragma: no cover
        return f"<{type(self).__name__} {self.name}>"


class AdmitAll(AdmissionPolicy):
    """Stock Hadoop: every arrival is admitted unconditionally."""

    name = "admit_all"

    def offer(self, req, view):
        return ADMIT


class ThresholdPolicy(AdmissionPolicy):
    """Load-shed at the door once backlog/capacity exceeds a bound.

    The bound is in *seconds of backlog on the live fleet* — measured
    capacity, not slot count, so a pod death halves the acceptable queue
    automatically (the paper's §IV.a measured-rate discipline).
    """

    name = "threshold"

    def __init__(self, max_backlog_s: float = 240.0) -> None:
        super().__init__()
        self.max_backlog_s = max_backlog_s

    def offer(self, req, view):
        cap = max(view.live_capacity, 1e-9)
        if (view.backlog_work + req.total_work) / cap <= self.max_backlog_s:
            return ADMIT
        return REJECT


class TokenBucketPolicy(AdmissionPolicy):
    """Capacity-rated token bucket: admission spends work-unit tokens that
    accrue at ``fill_ratio × live_capacity``.

    The fill rate re-rates on every capacity signal the churn trace emits
    (pronounce-dead, re-registration, straggler boundaries), so the bucket
    *is* the elastic chain seen from the front door: a shrunken fleet
    admits proportionally less, a re-grown fleet catches back up. Arrivals
    that outrun the tokens defer (FIFO) and release as tokens accrue; a job
    larger than the bucket can ever hold is rejected outright.
    """

    name = "token_bucket"

    def __init__(self, fill_ratio: float = 0.9, burst_s: float = 120.0) -> None:
        super().__init__()
        self.fill_ratio = fill_ratio
        self.burst_s = burst_s
        self._rate: Optional[float] = None  # tokens/s; set from first view
        self._burst: float = 0.0  # bucket size in tokens
        self._tokens: float = 0.0
        self._last_t: float = 0.0

    def reset(self) -> None:
        super().reset()
        self._rate, self._burst, self._tokens, self._last_t = None, 0.0, 0.0, 0.0

    def _sync(self, t: float) -> None:
        if self._rate is not None and t > self._last_t:
            self._tokens = min(
                self._burst, self._tokens + self._rate * (t - self._last_t)
            )
        self._last_t = max(self._last_t, t)

    def _rerate(self, t: float, live_capacity: float) -> None:
        first = self._rate is None
        self._sync(t)
        self._rate = self.fill_ratio * live_capacity
        self._burst = self._rate * self.burst_s
        if first:
            self._tokens = self._burst  # start full: an idle cluster admits
        self._tokens = min(self._tokens, self._burst)

    def on_capacity(self, t, live_capacity):
        self._rerate(t, live_capacity)

    def offer(self, req, view):
        if self._rate is None:
            self._rerate(view.time, view.live_capacity)
        self._sync(view.time)
        if req.total_work > self._burst:
            return REJECT
        if not self._deferred and self._tokens >= req.total_work:
            self._tokens -= req.total_work
            return ADMIT
        self._deferred.append(req)  # FIFO behind earlier deferrals
        return DEFER

    def poll(self, view):
        self._sync(view.time)
        out: list[tuple[JobRequest, str]] = []
        while self._deferred:
            head = self._deferred[0]
            if head.total_work > self._burst:  # fleet shrank under the job
                out.append((self._deferred.popleft(), REJECT))
            elif self._tokens >= head.total_work:
                self._tokens -= head.total_work
                out.append((self._deferred.popleft(), ADMIT))
            else:
                break
        return out

    def next_event_t(self):
        if not self._deferred or not self._rate:
            return None
        head = self._deferred[0]
        if head.total_work > self._burst:
            return self._last_t  # sheddable right now
        deficit = head.total_work - self._tokens
        if deficit <= 0:
            return self._last_t
        return self._last_t + deficit / self._rate


class SloClassesPolicy(AdmissionPolicy):
    """Per-class queues, earliest-deadline-first dequeue, shed lowest class
    first under overload.

    Class 0 is the strictest SLO. Arrivals enter their class queue unless
    the cluster has headroom (admitted backlog under ``target_backlog_s``)
    and nothing is waiting ahead of them. On every poll:

    1. while the total committed load (admitted + deferred) exceeds
       ``shed_backlog_s`` of live capacity, reject from the *lowest* class
       (largest class number), latest deadline first — never class 0; and
       if the strict class's observed trailing p99 has blown its budget,
       shed one more job (lowest class first; class 0 itself only when
       nothing else remains) — bounded to one per poll so a transient
       window blip cannot dump the whole best-effort queue;
    2. reject deferred jobs whose deadline is infeasible even on the whole
       live fleet (they cannot meet their SLO; running them only poisons
       other tails);
    3. admit earliest-deadline-first across all class queues while the
       admitted backlog stays under target (always at least one when the
       cluster is idle, so deferral can never deadlock a drained queue).
    """

    name = "slo_classes"

    def __init__(
        self, target_backlog_s: float = 60.0, shed_backlog_s: float = 240.0
    ) -> None:
        super().__init__()
        self.target_backlog_s = target_backlog_s
        self.shed_backlog_s = shed_backlog_s
        self._budget_seen: dict[int, float] = {}  # min deadline budget per class

    def reset(self) -> None:
        super().reset()
        self._budget_seen = {}

    def _note_budget(self, req: JobRequest) -> None:
        b = self._budget_seen.get(req.slo_class, math.inf)
        self._budget_seen[req.slo_class] = min(b, req.deadline_s)

    def offer(self, req, view):
        self._note_budget(req)
        if not self._deferred and view.backlog_s <= self.target_backlog_s:
            return ADMIT
        self._deferred.append(req)
        return DEFER

    def _strict_p99_over_budget(self, view: ClusterView) -> bool:
        budget = self._budget_seen.get(0, math.inf)
        return view.class_p99.get(0, 0.0) > budget

    def _shed_one(self, committed: float, out) -> float:
        """Reject the latest-deadline job of the lowest deferred class."""
        lowest = max(r.slo_class for r in self._deferred)
        victims = [r for r in self._deferred if r.slo_class == lowest]
        victim = max(victims, key=lambda r: (r.deadline_t, r.job_id))
        self._deferred.remove(victim)
        out.append((victim, REJECT))
        return committed - victim.total_work

    def poll(self, view):
        out: list[tuple[JobRequest, str]] = []
        cap = max(view.live_capacity, 1e-9)
        committed = view.backlog_work + sum(r.total_work for r in self._deferred)
        # 1a. backlog shedding: lowest class first, never the strict class
        while self._deferred and committed / cap > self.shed_backlog_s:
            if max(r.slo_class for r in self._deferred) == 0:
                break  # never shed the strict class on backlog alone
            committed = self._shed_one(committed, out)
        # 1b. latency shedding: the strict class's trailing p99 blew its
        # budget — shed exactly ONE job per poll (lowest class first, the
        # strict class itself only when nothing else is left), so a
        # transient window blip cannot dump the whole best-effort queue
        if self._deferred and self._strict_p99_over_budget(view):
            committed = self._shed_one(committed, out)
        # 2. shed deadline-infeasible stragglers from any class: a job that
        # could not finish by its deadline even given the whole live fleet
        # (optimistic bound, so only the truly doomed are shed) must not be
        # admitted — EDF would otherwise pick these near-expired jobs FIRST
        # and burn capacity on work guaranteed to finish uselessly late
        for r in list(self._deferred):
            if view.time + r.total_work / cap > r.deadline_t:
                self._deferred.remove(r)
                committed -= r.total_work
                out.append((r, REJECT))
        # 3. EDF admission while the admitted backlog has headroom
        admitted_work = 0.0
        while self._deferred:
            backlog_now = view.backlog_work + admitted_work
            idle = backlog_now <= 1e-9
            if not idle and backlog_now / cap > self.target_backlog_s:
                break
            nxt = min(
                self._deferred,
                key=lambda r: (r.deadline_t, r.slo_class, r.arrive_t, r.job_id),
            )
            self._deferred.remove(nxt)
            admitted_work += nxt.total_work
            out.append((nxt, ADMIT))
        return out


ADMISSION: dict[str, Callable[[], AdmissionPolicy]] = {
    "admit_all": AdmitAll,
    "threshold": ThresholdPolicy,
    "token_bucket": TokenBucketPolicy,
    "slo_classes": SloClassesPolicy,
}


def get_policy(
    spec: Union[str, AdmissionPolicy, None],
) -> Optional[AdmissionPolicy]:
    """Resolve a policy name / instance / None to a **fresh** policy object.

    Policies are stateful (deferred queues, token levels, clocks), so an
    instance is cloned-and-reset (:meth:`AdmissionPolicy.fresh`) — its
    tuning carries over, its runtime state never does; reusing one object
    across runs is therefore safe. Both ``run_workload`` and ``ServeLoop``
    construct through here — the acceptance criterion that no consumer
    grows its own admit logic.
    """
    if spec is None:
        return None
    if isinstance(spec, AdmissionPolicy):
        return spec.fresh()
    try:
        return ADMISSION[spec]()
    except KeyError:
        raise ValueError(
            f"unknown admission policy {spec!r}; known: {sorted(ADMISSION)}"
        ) from None
