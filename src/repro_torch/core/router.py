"""Cross-replica request routing — one policy layer for simulator and fleet.

Copied from ``repro/core/router.py`` (pure Python), decision for decision:
``tests/test_torch_fleet.py`` holds every router against it.

The paper's core finding is that stock Hadoop degrades on heterogeneous
clusters because it hands **equal work shares to unequal nodes** (§III).
Our serving path reproduced that mistake one layer up: with a single
``ServeLoop`` nothing routes *between* replicas of different measured
capacity, and a degraded replica holds its requests forever. This module is
the missing layer: a :class:`Router` picks a replica for each admitted
request from a per-replica snapshot (:class:`ReplicaView`: measured
capacity, backlog-seconds, stuck-request age), and
:func:`plan_redispatch` is the LATE-style rescue [Zaharia et al., OSDI'08]
— a request stuck past ``late_factor ×`` its estimated service time on a
degraded replica is re-enqueued on the fastest *idle* replica, the original
attempt cancelled, both attempts recorded by the caller.

The same router objects drive both consumers (the admission layer's
pattern, applied to routing):

* ``core/workload.run_fleet`` — N heterogeneous sim-replicas on a
  deterministic event loop (the fast-tier test surface);
* ``launch/fleet.FleetLoop`` — N real ``ServeLoop`` replicas interleaved on
  the hardware path.

Policies, and the paper §IV guideline each one operationalizes:

``round_robin``
    The stock baseline the paper critiques: equal request shares to unequal
    replicas. A 0.4× replica receives the same stream as a 1.0× one, so its
    queue grows 2.5× faster — the het-cluster failure mode, one layer up.
``capacity_weighted``
    §IV.b.ii ("fragments ∝ speed") lifted to request routing: replicas
    receive requests in proportion to their *measured* capacity (the tok/s
    EMA each replica already maintains), via smooth weighted round-robin —
    deterministic, and exactly proportional over any window. A straggling
    replica's reported rate drop immediately shrinks its share.
``shortest_backlog``
    §IV.a (decide in measured currency): join-shortest-backlog-**seconds**
    — queue depth divided by measured rate, not slot count, so a short
    queue on a slow replica is correctly seen as a long wait.
``class_reserved``
    The paper's "fragments ∝ speed" rule applied to SLO classes: a
    ``reserve_frac`` share of measured capacity — the *fastest* replicas —
    is reserved for class-0 (deadline-critical) work. Class 0 joins the
    shortest backlog-seconds queue fleet-wide; best-effort classes keep off
    the reserve unless a reserve replica is idle (spill-when-idle), so fast
    capacity is standing by when critical work arrives instead of buried
    under best-effort backlog.

Alongside the reactive rescue, :func:`plan_hedge` plans **hedged duplicate
dispatch**: a deadline-critical request is dispatched to *two*
replicas up front — the router's pick plus either the fastest idle reserve
replica (free insurance) or, when the pick itself is already degraded, the
shortest backlog-seconds healthy reserve replica (paid insurance, bought
exactly when risk is visible) — first completion wins and the loser is
cancelled. This is the paper's speculative-execution model without the
stuck-task precondition: the duplicate races from dispatch, so the tail is
bounded before ``late_factor`` detection could even trigger.

Registry contract (``ROUTER`` / :func:`get_router` — one of the four
policy registries documented in docs/architecture.md, alongside
``ADMISSION``, ``SCHEDULERS``, and ``AUTOSCALE``): routers are stateful
(round-robin cursors, weighting credit), so every run must start from a
fresh one — :func:`get_router` clones-and-resets instances, mirroring
``core.admission.get_policy``. A router sees only :class:`ReplicaView`
snapshots and returns a replica id (or ``None`` when nothing is
routable); it never touches engine state. All decisions are pure
arithmetic over the views they are shown, so a replayed trace reproduces
bit-identical routing (the property tests/test_router.py pins).
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Union

from repro_torch.core.admission import JobRequest

_EPS = 1e-9


@dataclass(frozen=True)
class ReplicaView:
    """What a router may see about one replica at decision time.

    ``capacity`` is the *measured* work rate (tok/s EMA on the serving
    path; the heartbeat-reported rate in the simulator) — the §IV.a
    discipline that decisions are made in observed currency. A silent
    (failed-but-unpronounced) replica keeps its stale last measurement;
    ``alive`` flips only when the fleet pronounces it dead. ``backlog_s``
    is therefore seconds-of-queue *at the observed rate* — what
    ``shortest_backlog`` joins on. ``oldest_age_s`` is the age of the
    oldest outstanding request dispatched to this replica (0.0 when
    drained) — the per-replica summary of the stuck signal, available to
    custom routers; the re-dispatch monitor itself judges per-request ages
    via :class:`InflightView`.
    """

    replica_id: int
    capacity: float  # measured work rate (tok/s EMA / observed sim rate)
    nameplate: float  # registered full-strength rate
    backlog_work: float  # Σ remaining work of requests queued + in service
    queue_depth: int  # outstanding requests (queued + in service)
    oldest_age_s: float  # age of the oldest outstanding dispatch
    alive: bool = True  # not pronounced dead
    rtype: str = "default"  # replica type name (core.autoscale.REPLICA_TYPES)
    price: float = 1.0  # $/replica-second while online
    # data gravity: the sessions whose KV/prefix cache this replica
    # currently holds — what ``affinity`` routes follow-up turns by — and
    # whether the replica is still staging data in (booted but not yet
    # routable; excluded from rescue targets like an unmeasured cold spawn).
    resident_sessions: frozenset = frozenset()
    staging: bool = False

    @property
    def backlog_s(self) -> float:
        """Seconds of backlog at the measured rate."""
        return self.backlog_work / max(self.capacity, _EPS)

    @property
    def idle(self) -> bool:
        return self.queue_depth == 0 and self.backlog_work <= _EPS

    @property
    def degraded(self) -> bool:
        """Observably below strength: pronounced dead, or measured capacity
        under nameplate (a straggler's reported rate drop; a dead-but-
        unpronounced replica looks healthy here — its requests' growing age
        is what betrays it, which is why re-dispatch keys on both)."""
        return (not self.alive) or self.capacity < self.nameplate * (1.0 - 1e-6)


@dataclass(frozen=True)
class InflightView:
    """One outstanding dispatch, as the re-dispatch monitor sees it.

    ``est_s`` is the service estimate made at dispatch time —
    ``work / nameplate`` of the assigned replica, so a healthy slow replica
    is *not* flagged for merely being slow (its estimate already priced
    that in); only requests running past ``late_factor ×`` their own
    estimate qualify. ``age_s`` counts from dispatch, so a request buried
    behind a straggler's backlog qualifies without ever starting.
    """

    request_id: int
    replica_id: int
    age_s: float
    est_s: float
    remaining_work: float


class Router:
    """Pick a replica for an admitted request (see module docstring)."""

    name = "base"

    # -- per-run lifecycle ----------------------------------------------
    def reset(self) -> None:
        """Clear per-run runtime state (cursors, credit); tuning stays."""

    def fresh(self) -> "Router":
        """A reset copy with the same tuning — one per run, so a leftover
        cursor from a previous run cannot leak into the next replay
        (:func:`get_router` calls this for instances)."""
        clone = copy.deepcopy(self)
        clone.reset()
        return clone

    # -- per-request decision -------------------------------------------
    def pick(
        self, req: JobRequest, views: Sequence[ReplicaView]
    ) -> Optional[int]:
        """Replica id for ``req``, or ``None`` when no replica is routable
        (every replica pronounced dead — the caller parks the request and
        retries when one re-registers)."""
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover
        return f"<{type(self).__name__} {self.name}>"


def _routable(views: Sequence[ReplicaView]) -> list[ReplicaView]:
    return [v for v in views if v.alive]


class RoundRobinRouter(Router):
    """Stock baseline: cycle over live replicas, blind to capacity — the
    equal-shares-to-unequal-nodes mistake the paper critiques, one layer
    up. A 0.4× replica receives the same request stream as a 1.0× one."""

    name = "round_robin"

    def __init__(self) -> None:
        self._next = 0

    def reset(self) -> None:
        self._next = 0

    def pick(self, req, views):
        live = _routable(views)
        if not live:
            return None
        choice = live[self._next % len(live)].replica_id
        self._next += 1
        return choice


class CapacityWeightedRouter(Router):
    """Requests ∝ measured capacity, via smooth weighted round-robin.

    Every decision credits each live replica by its current measured
    capacity, picks the largest accumulated credit, and debits the winner
    by the total — deterministic, and over any window each replica's share
    of requests converges to its share of measured capacity (the §IV.b.ii
    proportional rule in routing currency). Because the credit step reads
    *current* views, a straggler's reported rate drop shrinks its share on
    the very next decision; credit for vanished replicas is dropped so a
    re-registered replica rejoins at parity rather than with a stale debt.
    """

    name = "capacity_weighted"

    def __init__(self) -> None:
        # credit balances in a flat list aligned to the live-id roster:
        # the steady state — same fleet membership pick after
        # pick — runs one fused credit/total/argmax loop over the views
        # with no per-pick set, dict, or key-lambda allocation. The float
        # arithmetic is the original's, op for op (credit then total in
        # view order, first-max tie to the lower id, debit by the total),
        # so replayed traces are bit-identical. Membership change (spawn,
        # retire, death, re-registration) remaps balances by id: survivors
        # keep theirs, vanished ids are dropped — a re-registered replica
        # rejoins at parity rather than with a stale debt.
        self._ids: list[int] = []
        self._bal: list[float] = []

    def reset(self) -> None:
        self._ids = []
        self._bal = []

    def pick(self, req, views):
        live = [v for v in views if v.alive and v.capacity > _EPS]
        if not live:
            # nothing measured yet (a real fleet before its first decode):
            # no proportions to weight by — spread by least-loaded so the
            # whole opening burst doesn't pile onto one replica
            any_live = _routable(views)
            if not any_live:
                return None
            return min(
                any_live,
                key=lambda v: (v.queue_depth, v.backlog_work, v.replica_id),
            ).replica_id
        ids, bal = self._ids, self._bal
        if len(live) != len(ids) or any(
            v.replica_id != ids[k] for k, v in enumerate(live)
        ):
            old = dict(zip(ids, bal))
            ids = self._ids = [v.replica_id for v in live]
            bal = self._bal = [old.get(r, 0.0) for r in ids]
        total = 0.0
        best_k = 0
        best_c = -math.inf
        best_id = -1
        for k, v in enumerate(live):
            c = bal[k] + v.capacity
            bal[k] = c
            total += v.capacity
            if c > best_c or (c == best_c and v.replica_id < best_id):
                best_k, best_c, best_id = k, c, v.replica_id
        bal[best_k] = best_c - total
        return best_id


class ShortestBacklogRouter(Router):
    """Join-shortest-backlog-seconds: the queue is measured in *time on
    this replica* (backlog work / measured rate), not request count — a
    3-deep queue on a 0.4× replica is longer than a 6-deep queue on a 1.0×
    one. Ties go to the faster replica, then the lower id."""

    name = "shortest_backlog"

    def pick(self, req, views):
        live = _routable(views)
        if not live:
            return None
        best = min(live, key=lambda v: (v.backlog_s, -v.capacity, v.replica_id))
        return best.replica_id


def reserve_ids(
    views: Sequence[ReplicaView], reserve_frac: float
) -> set[int]:
    """The class-0 reserve: the smallest prefix of the fastest *measured*
    live replicas whose cumulative measured capacity covers
    ``reserve_frac`` of the fleet total (at least one replica whenever
    anything is measured). Ranking is by measured capacity with ties to the
    lower replica id, so the set is deterministic for a given snapshot —
    the "fragments ∝ speed" rule (§IV.b.ii) applied to SLO classes:
    reserve fast *capacity*, not a fast replica-count."""
    measured = sorted(
        (v for v in views if v.alive and v.capacity > _EPS),
        key=lambda v: (-v.capacity, v.replica_id),
    )
    if not measured or reserve_frac <= 0.0:
        return set()
    want = reserve_frac * sum(v.capacity for v in measured)
    out: set[int] = set()
    got = 0.0
    for v in measured:
        out.add(v.replica_id)
        got += v.capacity
        if got >= want - _EPS:
            break
    return out


class ClassReservedRouter(Router):
    """Class-aware placement: reserve the fastest replicas for class 0.

    Class-0 requests join the shortest backlog-seconds queue over the whole
    live fleet (the reservation protects them by keeping best-effort work
    *off* the fast replicas, not by fencing them in). Best-effort classes
    are routed over the non-reserve replicas, spilling onto a reserve
    replica only while it is idle — reserved capacity is never wasted, but
    a queued best-effort request never sits between critical work and the
    fast replica it was reserved for. Before anything has measured there is
    no reserve to draw (no proportions exist): fall back to least-loaded,
    exactly like ``capacity_weighted``'s opening-burst rule."""

    name = "class_reserved"

    def __init__(self, reserve_frac: float = 0.5) -> None:
        self.reserve_frac = reserve_frac
        # reserve-prefix cache: the reserve set is pure arithmetic
        # over (id, measured capacity) of the live fleet, which only moves
        # on churn — re-sorting the fleet per request is waste. Keyed on
        # the full (id, capacity) roster, so any membership or re-rate
        # change rebuilds; same snapshot, same set, recomputed or not.
        self._reserve_key: Optional[tuple] = None
        self._reserve: set[int] = set()

    def reset(self) -> None:
        self._reserve_key = None
        self._reserve = set()

    def pick(self, req, views):
        live = _routable(views)
        if not live:
            return None
        if not any(v.capacity > _EPS for v in live):
            return min(
                live,
                key=lambda v: (v.queue_depth, v.backlog_work, v.replica_id),
            ).replica_id
        key = tuple((v.replica_id, v.capacity) for v in live)
        if key != self._reserve_key:
            self._reserve_key = key
            self._reserve = reserve_ids(live, self.reserve_frac)
        reserve = self._reserve
        if req.slo_class == 0:
            pool = live
        else:
            pool = [
                v for v in live
                if v.replica_id not in reserve or v.idle
            ] or live
        best = min(pool, key=lambda v: (v.backlog_s, -v.capacity, v.replica_id))
        return best.replica_id


class AffinityRouter(Router):
    """Data-gravity routing: follow-up turns chase the session's cache.

    The paper's locality rule — ship the task to the node that holds the
    block — applied to serving: a multi-turn session's follow-up belongs on
    the replica whose KV/prefix cache already holds the conversation
    (:attr:`ReplicaView.resident_sessions`), where it skips re-prefill.
    The affinity hit is taken **only while the holder is routable**: if the
    holder is drained/pronounced dead (``not alive``), still staging data
    in, unmeasured, or its backlog exceeds ``backlog_ceiling_s`` seconds,
    the turn degrades to a cold route through an internal
    :class:`CapacityWeightedRouter` — cache affinity must never strand a
    request behind a dead holder nor pile a hot session onto an overloaded
    one past the point where re-prefill elsewhere is cheaper. First turns
    (and session-less requests) always take the capacity-weighted path, so
    sessions spread ∝ measured capacity before gravity pins them.
    """

    name = "affinity"

    def __init__(self, backlog_ceiling_s: float = 60.0) -> None:
        self.backlog_ceiling_s = backlog_ceiling_s
        self._fallback = CapacityWeightedRouter()

    def reset(self) -> None:
        self._fallback.reset()

    def pick(self, req, views):
        sid = getattr(req, "session_id", -1)
        if sid is not None and sid >= 0:
            for v in views:
                if sid in v.resident_sessions:
                    if (
                        v.alive
                        and not v.staging
                        and v.capacity > _EPS
                        and v.backlog_s <= self.backlog_ceiling_s + _EPS
                    ):
                        return v.replica_id
                    break  # holder exists but is unroutable: go cold
        return self._fallback.pick(req, views)


def plan_hedge(
    req: JobRequest,
    primary_id: Optional[int],
    views: Sequence[ReplicaView],
    reserve_frac: float = 0.5,
) -> Optional[int]:
    """Hedge target for a deadline-critical request, or ``None``.

    Speculative execution without the stuck-task precondition: instead of
    waiting for a request to run ``late_factor ×`` past its estimate on a
    degraded replica, a class-0 request with a finite deadline is
    duplicated onto a second replica at dispatch time — first completion
    wins, the loser is cancelled by the caller. Two triggers, checked in
    order:

    1. **Idle-reserve hedge** — the fastest idle, healthy, measured
       reserve replica races the primary (LATE's backups-on-fast-nodes
       rule: a free fast node duplicates at zero displacement). Skipped
       when the primary itself is idle, healthy, and at least as fast —
       that duplicate could only lose, and its progress would be pure
       duplicate-work tax. Under backlog-seconds routing
       (``class_reserved``) an idle replica is always the primary's own
       pick, so this branch mainly fires under weight-based routers.
    2. **Degraded-primary hedge** — when the router was forced to place
       the request on an observably *degraded* replica (every healthier
       choice carried more backlog-seconds), the duplicate joins the
       shortest backlog-seconds healthy reserve queue even though it is
       busy. Risk is already visible here, so insurance is bought at
       dispatch instead of waiting ``late_factor ×`` the estimate for the
       re-dispatch monitor; if the primary recovers and wins anyway, the
       still-queued duplicate cancels at zero progress lost.

    The target always differs from the primary; ties break by replica id
    (deterministic). ``views`` is the same snapshot the router's ``pick``
    saw (pre-dispatch: the primary's own queue does not yet contain the
    request), so both decisions are arithmetic over one consistent fleet
    state.
    """
    if req.slo_class != 0 or math.isinf(req.deadline_s):
        return None
    reserve = reserve_ids(views, reserve_frac)
    by_id = {v.replica_id: v for v in views}
    primary = by_id.get(primary_id)
    candidates = [
        v
        for v in views
        if v.replica_id in reserve
        and v.replica_id != primary_id
        and v.alive
        and not v.degraded
        and v.capacity > _EPS
    ]
    if not candidates:
        return None
    idle = [v for v in candidates if v.idle]
    if idle:
        target = min(idle, key=lambda v: (-v.capacity, v.replica_id))
        if not (
            primary is not None
            and primary.alive
            and primary.idle
            and not primary.degraded
            and primary.capacity >= target.capacity - _EPS
        ):
            return target.replica_id
    if primary is not None and primary.degraded:
        return min(
            candidates, key=lambda v: (v.backlog_s, -v.capacity, v.replica_id)
        ).replica_id
    return None


def plan_redispatch(
    inflight: Sequence[InflightView],
    views: Sequence[ReplicaView],
    late_factor: float = 2.0,
) -> list[tuple[int, int, int]]:
    """LATE-style rescue plan: ``(request_id, from_replica, to_replica)``.

    A request qualifies when it is **stuck** — ``age_s`` past
    ``late_factor ×`` its dispatch-time service estimate — *and* its
    replica is observably :attr:`~ReplicaView.degraded` (pronounced dead,
    or measured capacity under nameplate). Both conditions matter: age
    alone would rescue requests that are merely queued on a busy healthy
    fleet (wasting the cancelled progress), degradation alone would rescue
    requests that are doing fine.

    Targets are the **fastest idle live replicas** (LATE's "backups only on
    fast nodes", with idleness standing in for the free-slot condition):
    rescued work must never displace healthy work, so a pass plans at most
    one move per idle replica and never moves a request onto another
    degraded-but-idle replica — nor onto a replica with **no measured
    capacity** (a just-spawned, still-warming replica on the serving path
    reports rate 0 until its first decode completes; it is idle and not
    degraded by the nameplate test, but handing rescued work to a replica
    that has never demonstrated a rate re-strands it behind a cold start)
    — nor onto a replica still in ``stage_in`` (booted but its data pipe is
    not yet full: the same not-routable-yet gate, keyed on the lifecycle
    flag rather than the rate measurement). Candidates are ranked by estimated
    time-to-end on their current replica, longest first (LATE's ordering),
    so the worst-off request gets the fastest target. Deterministic: pure
    arithmetic over the views, ties broken by request id.
    """
    by_id = {v.replica_id: v for v in views}
    idle = sorted(
        (
            v
            for v in views
            if v.alive
            and v.idle
            and not v.degraded
            and not v.staging
            and v.capacity > _EPS
        ),
        key=lambda v: (-v.capacity, v.replica_id),
    )
    if not idle:
        return []
    stuck = [
        f
        for f in inflight
        if f.age_s > late_factor * f.est_s + _EPS
        and f.replica_id in by_id
        and by_id[f.replica_id].degraded
    ]
    # longest estimated time-to-end on the current replica first; a dead
    # replica's stale measured rate still orders the candidates sensibly
    # (same denominator for everything stranded on it)
    stuck.sort(
        key=lambda f: (
            -f.remaining_work / max(by_id[f.replica_id].capacity, _EPS),
            f.request_id,
        )
    )
    moves: list[tuple[int, int, int]] = []
    taken: set[int] = set()
    for f in stuck:
        target = next(
            (
                v
                for v in idle
                if v.replica_id != f.replica_id and v.replica_id not in taken
            ),
            None,
        )
        if target is None:
            break  # every idle replica claimed this pass; next probe retries
        taken.add(target.replica_id)
        moves.append((f.request_id, f.replica_id, target.replica_id))
    return moves


ROUTER: dict[str, Callable[[], Router]] = {
    "round_robin": RoundRobinRouter,
    "capacity_weighted": CapacityWeightedRouter,
    "shortest_backlog": ShortestBacklogRouter,
    "class_reserved": ClassReservedRouter,
    "affinity": AffinityRouter,
}


def get_router(spec: Union[str, Router]) -> Router:
    """Resolve a router name / instance to a **fresh** router object.

    Routers are stateful (cursors, weighting credit), so an instance is
    cloned-and-reset — its tuning carries over, its runtime state never
    does. Both ``run_fleet`` and ``launch/fleet.FleetLoop`` construct
    through here: the acceptance criterion that no consumer grows a
    fleet-private routing path.
    """
    if isinstance(spec, Router):
        return spec.fresh()
    try:
        return ROUTER[spec]()
    except KeyError:
        raise ValueError(
            f"unknown router {spec!r}; known: {sorted(ROUTER)}"
        ) from None


def service_estimate_s(work: float, nameplate_rate: float) -> float:
    """Dispatch-time service estimate feeding :class:`InflightView.est_s`
    — one definition for both consumers, so the stuck threshold validated
    on the simulator is the threshold the serving fleet runs. Estimating
    against the *nameplate* (not the live measurement) means a healthy slow
    replica is never flagged for being slow, only for being slower than
    itself."""
    return work / max(nameplate_rate, _EPS)
