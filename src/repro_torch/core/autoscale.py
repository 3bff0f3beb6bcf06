"""Replica autoscaling — one policy layer for simulator and serving fleet.

Copied from ``repro/core/autoscale.py`` (pure Python), decision for
decision: ``tests/test_torch_fleet.py`` holds every policy against it.

The elastic re-mesh, admission and routing layers built the dynamic chain
the paper says heterogeneous clusters need, but the serving fleet itself was
still a *fixed-size* resource: a burst had to be absorbed by the replicas
provisioned at start, and an idle trough kept paying for all of them.
D-SPACE4Cloud (arXiv:1605.07083) frames right-sizing cluster capacity
against deadlines as *the* central cloud-design problem, and Ivanov et
al.'s virtualized-Hadoop evaluation shows capacity must be **measured, not
assumed** — exactly the signal our :class:`~repro_torch.core.router.ReplicaView`
snapshots already carry for the router. This module closes the loop: an
:class:`Autoscaler` decides **grow / shrink / hold** for the replica pool
from the same measured-capacity + backlog-seconds views the router
consumes, behind an ``AUTOSCALE`` registry with the exact lifecycle
contract of ``ADMISSION`` (core/admission.py) and ``ROUTER``
(core/router.py).

The same policy objects drive both consumers (the shared-registry rule —
see docs/architecture.md, "no private paths"):

* ``core/workload.run_fleet(..., autoscale=...)`` — the deterministic
  fleet engine grows/shrinks its sim-replica pool (spawn = cold replica
  with a ``warmup_s`` lag before it becomes routable; retire = drain, then
  remove), emitting ``scale_up`` / ``replica_warm`` / ``scale_down`` /
  ``replica_retired`` churn events so the router and re-dispatch see
  scaling as ordinary capacity change;
* ``launch/fleet.FleetLoop`` — the real serving fleet spawns replicas via
  ``replica_factory`` (``add_replica``: the cold start *is* the warmup
  lag) and drains them (``drain_replica``) off the same decisions.

Policies, and the design rule each one operationalizes:

``fixed``
    The baseline every claim is measured against: the pool you provisioned
    is the pool you run. Sized for mean load it blows the burst tail;
    sized for peak it pays replica-seconds for idle troughs — claim 11
    (benchmarks/bench_autoscale.py) quantifies both ends.
``backlog_threshold``
    Reactive scaling in measured currency (§IV.a): grow on *sustained*
    backlog-seconds-per-live-capacity above a bound, drain-and-retire the
    slowest replica on sustained near-idle. Sustain windows reject
    transient blips; cooldowns prevent oscillation; min/max bound the
    pool. All thresholds are in seconds-of-work on the live measured rate,
    so a straggler's reported rate drop *raises* effective backlog and can
    trigger a grow — degradation is a capacity event, not an anomaly
    (§IV.c).
``deadline_aware``
    The D-SPACE4Cloud framing: hold the *strict class's* estimated sojourn
    inside its deadline budget. The budget is learned from the class-0
    requests themselves (min deadline seen, mirroring
    ``slo_classes``' ``_budget_seen``) or pinned by the caller; the signal
    is fleet backlog-seconds (the sojourn a new arrival would inherit)
    plus the trailing per-class p99 window admission control already
    maintains (:func:`~repro_torch.core.admission.trailing_class_p99`). Grow
    when the estimate leaves the budget's target band, shrink only when it
    is comfortably inside.
``cost_aware``
    The D-SPACE4Cloud cost axis: backlog-threshold *timing* with a
    typed spawn decision — grow with the catalog type
    (:data:`REPLICA_TYPES`: ``fast`` / ``slow`` / ``spot``, each a
    nameplate rate and a $/replica-second price) that delivers the most
    capacity per dollar, capped on the pool's preemptible-capacity share;
    shrink victims via the shared price-aware rule.
``predictive``
    Fit the arrival trace's period (autocorrelation over binned arrivals
    fed through ``note_request``) and spawn *before* the crest, hiding
    the warmup lag reactive policies pay at every cycle's upswing;
    reactive backlog-threshold behavior until a period is learned.

Protocol (both consumers follow it):

* ``decide(view)`` — called on a fixed cadence with a :class:`PoolView`;
  returns a :class:`ScaleDecision` (``GROW`` | ``SHRINK`` | ``HOLD``,
  plus an optional shrink victim). The caller executes it: policies never
  touch the pool.
* ``note_request(req)`` — arrival feed, so budget-learning policies see
  deadlines without a private path to the workload.
* Policies are stateful (sustain clocks, cooldowns, learned budgets):
  :func:`get_autoscaler` clones-and-resets instances per run, mirroring
  ``get_policy`` / ``get_router``. Decisions are pure arithmetic over the
  views shown, so replays are bit-identical (tests/test_autoscale.py
  pins).
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass, field, replace
from functools import cached_property
from typing import Callable, Mapping, Optional, Sequence, Union

from repro_torch.core.admission import JobRequest
from repro_torch.core.router import ReplicaView

GROW = "grow"
SHRINK = "shrink"
HOLD = "hold"

_EPS = 1e-9


@dataclass(frozen=True)
class ReplicaType:
    """One entry in the replica-type catalog: a nameplate work rate, a
    ``$ / replica-second`` price while online, and whether the cloud may
    preempt it. ``price / rate`` is the $-per-unit-of-work a healthy
    replica of this type delivers — the value metric ``cost_aware`` spawns
    by and :func:`default_shrink_victim` sheds by."""

    name: str
    rate: float  # nameplate work rate (sim units / relative tok-s)
    price: float  # $ per replica-second while online
    preemptible: bool = False
    stage_bw: float = math.inf  # data units/s staged at boot (inf: instant)

    @property
    def value(self) -> float:
        """Nameplate capacity per dollar-second — higher is cheaper work."""
        return self.rate / max(self.price, _EPS)

    def stage_s(self, data: float) -> float:
        """Seconds to stage ``data`` units through this type's pipe.
        0.0 when the spec stages nothing — the pre-lifecycle behaviour."""
        if data <= 0.0:
            return 0.0
        return data / max(self.stage_bw, _EPS)


REPLICA_TYPES: dict[str, ReplicaType] = {
    # "default" keeps untyped pools bit-identical: price 1.0 makes
    # FleetResult.cost == replica_seconds, exactly the pre-typed currency.
    # stage_bw only matters when a FleetSpec sets stage_data > 0 (the
    # provisioning lifecycle); with stage_data == 0 every stage takes 0 s.
    "default": ReplicaType("default", rate=1.0, price=1.0, stage_bw=4.0),
    "fast": ReplicaType("fast", rate=1.0, price=1.0, stage_bw=8.0),
    "slow": ReplicaType("slow", rate=0.5, price=0.4, stage_bw=2.0),
    "spot": ReplicaType(
        "spot", rate=1.0, price=0.35, preemptible=True, stage_bw=4.0
    ),
}


def get_replica_type(name: Optional[str]) -> ReplicaType:
    """Resolve a type name (``None`` → ``default``) from the catalog."""
    if name is None:
        return REPLICA_TYPES["default"]
    try:
        return REPLICA_TYPES[name]
    except KeyError:
        raise ValueError(
            f"unknown replica type {name!r}; known: {sorted(REPLICA_TYPES)}"
        ) from None


@dataclass(frozen=True)
class PoolView:
    """What an autoscaler may see about the replica pool at decision time.

    ``replicas`` are the same :class:`~repro_torch.core.router.ReplicaView`
    snapshots the router consumes — measured capacity, backlog-work,
    queue depth — for every replica that is online (routable *or*
    draining; a draining replica carries ``alive=False``, exactly as the
    router sees it). ``n_warming`` counts spawned replicas still inside
    their warmup lag: they are committed capacity, so sizing decisions
    must include them or the pool overshoots during every cold start.
    ``class_p99`` is the trailing per-class sojourn window admission
    control maintains (:func:`~repro_torch.core.admission.trailing_class_p99`)
    — the observed-latency signal ``deadline_aware`` sizes against.
    """

    time: float
    replicas: tuple[ReplicaView, ...]
    n_warming: int = 0
    class_p99: Mapping[int, float] = field(default_factory=dict)

    # cached_property, not property: a PoolView is an immutable snapshot,
    # but decide() implementations read these aggregates several times per
    # tick — each re-walk of ``replicas`` is pure waste at 100+ replicas.
    # (functools.cached_property stores into the instance ``__dict__``, so
    # it coexists with ``frozen=True``; the values are identical floats —
    # same sum, same order — just computed once.)
    @cached_property
    def routable(self) -> list[ReplicaView]:
        """Replicas a router would currently consider (alive, not draining)."""
        return [v for v in self.replicas if v.alive]

    @cached_property
    def pool_size(self) -> int:
        """Committed serving capacity in replicas: routable + warming.
        Draining/pronounced replicas are on their way out and don't count."""
        return len(self.routable) + self.n_warming

    @cached_property
    def live_capacity(self) -> float:
        return sum(v.capacity for v in self.routable)

    @cached_property
    def backlog_work(self) -> float:
        """All outstanding work, including what draining replicas still
        hold — it occupies the fleet either way."""
        return sum(v.backlog_work for v in self.replicas)

    @cached_property
    def backlog_s(self) -> float:
        """Seconds of fleet backlog at the live measured rate — the same
        currency admission's ``threshold`` gates on and the router's
        ``shortest_backlog`` joins on."""
        return self.backlog_work / max(self.live_capacity, _EPS)

    # -- typed aggregates: what a cost-aware policy sizes against --
    @cached_property
    def count_by_type(self) -> dict[str, int]:
        """Routable replica count per type name."""
        out: dict[str, int] = {}
        for v in self.routable:
            out[v.rtype] = out.get(v.rtype, 0) + 1
        return out

    @cached_property
    def capacity_by_type(self) -> dict[str, float]:
        """Measured routable capacity per type name."""
        out: dict[str, float] = {}
        for v in self.routable:
            out[v.rtype] = out.get(v.rtype, 0.0) + v.capacity
        return out

    @cached_property
    def price_per_s(self) -> float:
        """$/s the pool burns right now — every online replica bills while
        it is up, draining or not, so this sums ``replicas``, not
        ``routable``."""
        return sum(v.price for v in self.replicas)

    @cached_property
    def preemptible_frac(self) -> float:
        """Share of routable *nameplate* capacity on preemptible types —
        nameplate, not measured, so a degraded spot still counts toward
        the risk budget ``cost_aware`` caps."""
        total = sum(v.nameplate for v in self.routable)
        if total <= _EPS:
            return 0.0
        at_risk = sum(
            v.nameplate for v in self.routable
            if REPLICA_TYPES.get(v.rtype, REPLICA_TYPES["default"]).preemptible
        )
        return at_risk / total


@dataclass(frozen=True)
class ScaleDecision:
    """One autoscaler verdict. ``replica_id`` names the shrink victim
    (``None`` lets the caller pick its default: slowest measured, newest
    on ties); ``reason`` is recorded in the churn trace so a scaling event
    can be attributed when reading a replay."""

    action: str  # GROW | SHRINK | HOLD
    replica_id: Optional[int] = None
    reason: str = ""
    # Which catalog type a GROW should spawn. ``None`` keeps the legacy
    # untyped spawn (FleetSpec.spawn_rate / the plain replica_factory), so
    # pre-typed policies and replays are bit-identical.
    rtype: Optional[str] = None


class Autoscaler:
    """Decide grow / shrink / hold for the replica pool (see module
    docstring for the registry contract)."""

    name = "base"

    # -- per-run lifecycle ----------------------------------------------
    def reset(self) -> None:
        """Clear per-run runtime state (sustain clocks, cooldowns, learned
        budgets); tuning stays."""

    def fresh(self) -> "Autoscaler":
        """A reset copy with the same tuning — one per run, so a leftover
        cooldown clock from a previous run cannot suppress (or trigger)
        scaling in the next replay (:func:`get_autoscaler` calls this for
        instances)."""
        clone = copy.deepcopy(self)
        clone.reset()
        return clone

    # -- feeds ------------------------------------------------------------
    def note_request(self, req: JobRequest) -> None:
        """Arrival feed (deadline/budget learning); default no-op."""

    # -- the decision -----------------------------------------------------
    def decide(self, view: PoolView) -> ScaleDecision:
        raise NotImplementedError

    def veto(self, decision: ScaleDecision) -> None:
        """The engine could not execute the immediately-preceding decision
        (no replica factory; the victim was the last routable replica).
        Default no-op; stateful policies roll back the cooldown/sustain
        state they committed when returning it — otherwise a phantom
        action suppresses real scaling for a whole cooldown window."""

    def note_action_done(self, t: float) -> None:
        """The engine finished *executing* the last decision at ``t``. In
        the simulator that is the decision instant, but a real spawn
        compiles synchronously (launch/fleet.add_replica) and can outlast
        the cooldown — the clock must restart from completion, or the
        backlog that piled up during the stall immediately re-triggers
        another fleet-freezing spawn. Default no-op."""

    def __repr__(self) -> str:  # pragma: no cover
        return f"<{type(self).__name__} {self.name}>"


def default_shrink_victim(view: PoolView) -> Optional[int]:
    """The one drain-target rule every consumer shares: the routable
    replica delivering the least *measured capacity per dollar-second*
    (``capacity / price``) — shedding it trims the bill the most per unit
    of throughput lost. Ties (including every all-default-price pool,
    where the value key degenerates to capacity and the ordering is
    bit-identical to the pre-typed rule) go to the slowest measured, then
    to the *newest* (highest id), so an elastic pool sheds its spawned
    replicas before the provisioned base. Policies use it to name a
    victim; the engines (``run_fleet``/``FleetLoop``) fall back to it when
    a policy names none (or an invalid one) — one rule, three call sites,
    zero drift."""
    cands = view.routable
    if not cands:
        return None
    return min(
        cands,
        key=lambda v: (
            v.capacity / max(v.price, _EPS), v.capacity, -v.replica_id,
        ),
    ).replica_id


class FixedPool(Autoscaler):
    """Baseline: the pool never changes. ``run_fleet(autoscale=None)`` and
    ``autoscale="fixed"`` are behaviorally identical; the named form exists
    so sweeps can treat "no scaling" as one more policy."""

    name = "fixed"

    def decide(self, view):
        return ScaleDecision(HOLD, reason="fixed pool")


class BacklogThresholdScaler(Autoscaler):
    """Grow on sustained backlog-seconds, drain-and-retire on sustained
    near-idle — with cooldowns and min/max pool bounds.

    The signal is :attr:`PoolView.backlog_s`: seconds of outstanding work
    per unit of *live measured* capacity, the fleet-level analogue of the
    backlog currency admission's ``threshold`` policy gates on. Crossing
    ``grow_backlog_s`` must persist for ``sustain_s`` before a spawn (a
    single burst arrival is not a trend), and any action starts a
    ``cooldown_s`` clock during which the policy holds — a spawned
    replica's warmup lag means acting again before the last action landed
    would size the pool on stale evidence. Shrink symmetrically requires
    ``backlog_s`` under ``shrink_backlog_s`` for ``sustain_s``; the victim
    is the slowest measured replica (newest on ties, so the provisioned
    base outlives the elastic overflow).
    """

    name = "backlog_threshold"

    def __init__(
        self,
        grow_backlog_s: float = 30.0,
        shrink_backlog_s: float = 4.0,
        sustain_s: float = 10.0,
        cooldown_s: float = 30.0,
        min_replicas: int = 1,
        max_replicas: int = 8,
    ) -> None:
        self.grow_backlog_s = grow_backlog_s
        self.shrink_backlog_s = shrink_backlog_s
        self.sustain_s = sustain_s
        self.cooldown_s = cooldown_s
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.reset()

    def reset(self) -> None:
        self._above_since: Optional[float] = None
        self._below_since: Optional[float] = None
        self._last_action_t: float = -math.inf
        self._undo = None  # state to restore if the engine vetoes

    def _cooled(self, t: float) -> bool:
        return t - self._last_action_t >= self.cooldown_s - _EPS

    def veto(self, decision):
        if self._undo is not None:
            (self._last_action_t, self._above_since,
             self._below_since) = self._undo
            self._undo = None

    def note_action_done(self, t):
        self._last_action_t = max(self._last_action_t, t)
        self._undo = None  # the action landed: no longer vetoable

    def decide(self, view):
        t = view.time
        self._undo = None  # a veto only applies to the decision below
        if not view.routable or view.live_capacity <= _EPS:
            # nothing measured (a real fleet before its first decode):
            # backlog-seconds is undefined, so no evidence to act on
            return ScaleDecision(HOLD, reason="no measured capacity")
        b = view.backlog_s
        if b > self.grow_backlog_s:
            self._below_since = None
            if self._above_since is None:
                self._above_since = t
            if (
                t - self._above_since >= self.sustain_s - _EPS
                and self._cooled(t)
                and view.pool_size < self.max_replicas
            ):
                self._undo = (self._last_action_t, self._above_since,
                              self._below_since)
                self._last_action_t = t
                self._above_since = None
                return ScaleDecision(
                    GROW, reason=f"backlog {b:.1f}s > {self.grow_backlog_s:.0f}s"
                )
        elif b < self.shrink_backlog_s:
            self._above_since = None
            if self._below_since is None:
                self._below_since = t
            if (
                t - self._below_since >= self.sustain_s - _EPS
                and self._cooled(t)
                and view.pool_size > self.min_replicas
            ):
                victim = default_shrink_victim(view)
                if victim is not None:
                    self._undo = (self._last_action_t, self._above_since,
                                  self._below_since)
                    self._last_action_t = t
                    self._below_since = None
                    return ScaleDecision(
                        SHRINK, replica_id=victim,
                        reason=f"backlog {b:.1f}s < {self.shrink_backlog_s:.0f}s",
                    )
        else:
            # inside the dead band: neither trend is building
            self._above_since = None
            self._below_since = None
        return ScaleDecision(HOLD)


class DeadlineAwareScaler(Autoscaler):
    """Size the pool to keep the strict class's estimated sojourn inside
    its deadline budget (the D-SPACE4Cloud deadline-driven framing).

    The budget is ``budget_s`` when pinned, else the minimum class-0
    deadline seen on the arrival feed (``note_request``), exactly how
    ``slo_classes`` admission learns its budgets. Two signals feed the
    verdict, both ones the serving chain already maintains:

    * **forward-looking** — :attr:`PoolView.backlog_s`, the queueing delay
      a class-0 arrival would inherit right now;
    * **observed** — the trailing class-0 p99 from the admission window
      (:attr:`PoolView.class_p99`), which catches sojourn blow-ups the
      backlog estimate misses (e.g. a straggler serving slowly without a
      deep queue).

    Grow when the backlog estimate exceeds ``target_frac × budget`` — or
    when the observed p99 has blown the budget outright *while work is
    still queued* — sustained for ``sustain_s``. The while-loaded guard
    matters: the p99 window only advances when completions land, so in an
    idle trough it is stale history, not a signal; shrink therefore keys
    purely on the forward-looking backlog sitting under
    ``relax_frac × budget`` for ``sustain_s``. Cooldown and min/max
    bounds as in :class:`BacklogThresholdScaler`. With no budget known
    (no class-0 deadline ever seen and none pinned) the policy holds:
    sizing against an unknown SLO would be a guess.
    """

    name = "deadline_aware"

    def __init__(
        self,
        budget_s: Optional[float] = None,
        target_frac: float = 0.4,
        relax_frac: float = 0.1,
        sustain_s: float = 10.0,
        cooldown_s: float = 30.0,
        min_replicas: int = 1,
        max_replicas: int = 8,
    ) -> None:
        self.budget_s = budget_s
        self.target_frac = target_frac
        self.relax_frac = relax_frac
        self.sustain_s = sustain_s
        self.cooldown_s = cooldown_s
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.reset()

    def reset(self) -> None:
        self._learned: float = math.inf
        self._over_since: Optional[float] = None
        self._under_since: Optional[float] = None
        self._last_action_t: float = -math.inf
        self._undo = None  # state to restore if the engine vetoes

    def veto(self, decision):
        if self._undo is not None:
            (self._last_action_t, self._over_since,
             self._under_since) = self._undo
            self._undo = None

    def note_action_done(self, t):
        self._last_action_t = max(self._last_action_t, t)
        self._undo = None  # the action landed: no longer vetoable

    def note_request(self, req: JobRequest) -> None:
        if req.slo_class == 0:
            self._learned = min(self._learned, req.deadline_s)

    def _budget(self) -> float:
        return self.budget_s if self.budget_s is not None else self._learned

    def decide(self, view):
        t = view.time
        self._undo = None  # a veto only applies to the decision below
        budget = self._budget()
        if not math.isfinite(budget):
            return ScaleDecision(HOLD, reason="no class-0 budget known")
        if not view.routable or view.live_capacity <= _EPS:
            return ScaleDecision(HOLD, reason="no measured capacity")
        p99 = view.class_p99.get(0, 0.0)
        p99_over = (
            not math.isnan(p99)
            and p99 > budget
            and view.backlog_work > _EPS  # stale-window guard: loaded only
        )
        est = view.backlog_s
        cooled = t - self._last_action_t >= self.cooldown_s - _EPS
        if est > self.target_frac * budget or p99_over:
            self._under_since = None
            if self._over_since is None:
                self._over_since = t
            if (
                t - self._over_since >= self.sustain_s - _EPS
                and cooled
                and view.pool_size < self.max_replicas
            ):
                self._undo = (self._last_action_t, self._over_since,
                              self._under_since)
                self._last_action_t = t
                self._over_since = None
                # attribute the grow to the signal that actually tripped
                # it — a replay auditor reads this out of the churn trace
                if est > self.target_frac * budget:
                    reason = (
                        f"est class-0 sojourn {est:.1f}s > "
                        f"{self.target_frac:.0%} of {budget:.0f}s budget"
                    )
                else:
                    reason = (
                        f"class-0 trailing p99 {p99:.1f}s > {budget:.0f}s "
                        "budget with work queued"
                    )
                return ScaleDecision(GROW, reason=reason)
        elif view.backlog_s < self.relax_frac * budget:
            self._over_since = None
            if self._under_since is None:
                self._under_since = t
            if (
                t - self._under_since >= self.sustain_s - _EPS
                and cooled
                and view.pool_size > self.min_replicas
            ):
                victim = default_shrink_victim(view)
                if victim is not None:
                    self._undo = (self._last_action_t, self._over_since,
                                  self._under_since)
                    self._last_action_t = t
                    self._under_since = None
                    return ScaleDecision(
                        SHRINK, replica_id=victim,
                        reason=(
                            f"backlog {view.backlog_s:.1f}s < "
                            f"{self.relax_frac:.0%} of {budget:.0f}s budget"
                        ),
                    )
        else:
            self._over_since = None
            self._under_since = None
        return ScaleDecision(HOLD)


class CostAwareScaler(BacklogThresholdScaler):
    """Backlog-threshold timing, cost-aware *type* choice: when the pool
    must grow, spawn the catalog type with the best nameplate-capacity per
    dollar-second (``ReplicaType.value``), capped on preemption risk.

    The D-SPACE4Cloud objective — meet the deadline at minimum cost —
    splits into *when* and *what*. The *when* is inherited unchanged from
    :class:`BacklogThresholdScaler` (sustained backlog-seconds, cooldowns,
    pool bounds), so head-to-head comparisons against an all-``fast``
    backlog-threshold pool isolate the type decision. The *what* ranks
    ``types`` by value (``spot`` at 1.0 work/s for $0.35/s beats ``fast``
    at $1.00/s); preemptible types are skipped while the pool's
    preemptible nameplate share (:attr:`PoolView.preemptible_frac`) is at
    or above ``spot_frac_max`` — the risk budget that keeps a preemption
    wave from taking out the whole elastic tier at once.

    Shrink follows the price-aware :func:`default_shrink_victim` rule —
    with one reliability override: the last ``keep_nonpreemptible``
    non-preemptible replicas are never named as victims while a
    preemptible one exists. The raw $-per-capacity ordering would shed
    the expensive on-demand base *first* and leave an all-spot pool; one
    preemption wave later the fleet is gone with work still parked. The
    floor is the on-demand base every spot deployment keeps.
    """

    name = "cost_aware"

    def __init__(
        self,
        types: Sequence[str] = ("spot", "slow", "fast"),
        spot_frac_max: float = 0.6,
        keep_nonpreemptible: int = 1,
        **kwargs,
    ) -> None:
        self.types = tuple(types)
        self.spot_frac_max = spot_frac_max
        self.keep_nonpreemptible = keep_nonpreemptible
        super().__init__(**kwargs)

    def _pick_type(self, view: PoolView) -> str:
        cands = [get_replica_type(n) for n in self.types]
        if view.preemptible_frac >= self.spot_frac_max - _EPS:
            safe = [rt for rt in cands if not rt.preemptible]
            cands = safe or cands  # all-preemptible catalog: spawn anyway
        best = max(cands, key=lambda rt: (rt.value, -rt.price, rt.name))
        return best.name

    def _pick_victim(self, view: PoolView) -> Optional[int]:
        cands = view.routable
        if not cands:
            return None
        pre = [
            v for v in cands if get_replica_type(v.rtype).preemptible
        ]
        nonpre_left = len(cands) - len(pre)
        pool = cands
        if pre and nonpre_left <= self.keep_nonpreemptible:
            pool = pre  # protect the on-demand floor: shed spots instead
        return min(
            pool,
            key=lambda v: (
                v.capacity / max(v.price, _EPS), v.capacity, -v.replica_id,
            ),
        ).replica_id

    def decide(self, view):
        d = super().decide(view)
        if d.action == SHRINK:
            victim = self._pick_victim(view)
            if victim is not None:
                return replace(d, replica_id=victim)
            return d
        if d.action != GROW:
            return d
        rtype = self._pick_type(view)
        return replace(d, rtype=rtype, reason=f"{d.reason} → spawn {rtype}")


class PredictiveScaler(BacklogThresholdScaler):
    """Fit the arrival trace's period and spawn *before* the crest, so
    the warmup lag is paid while the pool is still quiet instead of while
    the backlog it was meant to absorb piles up (the crest-warmup p99
    penalty claim 11 measures on reactive scaling).

    ``note_request`` bins arrivals (``bin_s`` buckets); once enough
    history exists the period is fit by autocorrelation over the
    mean-centered bin counts (or pinned via ``period_s``). ``decide``
    then forecasts seasonal-naively — the predicted arrival-work rate over
    the next ``lead_s`` is last cycle's observed rate at the same phase —
    and grows whenever committed capacity (live + warming) cannot carry
    that rate at ``util_target`` utilization. ``lead_s`` must exceed the
    consumer's warmup lag for the spawn to land before the crest does.
    Until a period is known the policy behaves exactly like its
    :class:`BacklogThresholdScaler` base (reactive), so the first cycle
    is served no worse while it is being learned; shrink stays reactive
    (shedding late costs replica-seconds, not tail latency).

    ``rtype`` optionally types every spawn; ``None`` keeps the untyped
    legacy spawn so the policy drops into pre-typed fleets unchanged.
    """

    name = "predictive"

    def __init__(
        self,
        period_s: Optional[float] = None,
        bin_s: float = 20.0,
        lead_s: float = 30.0,
        util_target: float = 0.7,
        min_period_s: float = 120.0,
        max_period_s: float = 7200.0,
        min_corr: float = 0.2,
        rtype: Optional[str] = None,
        **kwargs,
    ) -> None:
        self.period_s = period_s
        self.bin_s = bin_s
        self.lead_s = lead_s
        self.util_target = util_target
        self.min_period_s = min_period_s
        self.max_period_s = max_period_s
        self.min_corr = min_corr
        self.rtype = rtype
        super().__init__(**kwargs)

    def reset(self) -> None:
        super().reset()
        self._bins: list[int] = []
        self._work_sum: float = 0.0
        self._n_seen: int = 0
        self._fit_period: Optional[int] = None  # period in bins
        self._fit_at: int = 0  # len(_bins) when last fit ran

    def note_request(self, req: JobRequest) -> None:
        i = int(req.arrive_t / self.bin_s)
        bins = self._bins
        if i >= len(bins):
            bins.extend([0] * (i + 1 - len(bins)))
        bins[i] += 1
        self._work_sum += req.total_work
        self._n_seen += 1

    def _autocorr_fit(self) -> Optional[int]:
        """Argmax-autocovariance lag over the candidate period range, or
        ``None`` when no lag clears ``min_corr`` (normalized)."""
        x = self._bins
        n = len(x)
        lo = max(2, int(round(self.min_period_s / self.bin_s)))
        hi = min(int(round(self.max_period_s / self.bin_s)), n // 2)
        if hi < lo:
            return None
        mean = sum(x) / n
        xc = [v - mean for v in x]
        var = sum(v * v for v in xc) / n
        if var <= _EPS:
            return None
        best, best_score = None, self.min_corr
        for lag in range(lo, hi + 1):
            m = n - lag
            score = sum(xc[i] * xc[i + lag] for i in range(m)) / (m * var)
            if score > best_score:
                best, best_score = lag, score
        return best

    def _period_bins(self) -> Optional[int]:
        if self.period_s is not None:
            return max(1, int(round(self.period_s / self.bin_s)))
        # refit only when the history grew ≥25% since the last fit — the
        # fit is O(bins²) and decide() runs on the scale cadence
        if self._fit_period is None or len(self._bins) >= self._fit_at * 5 // 4:
            self._fit_period = self._autocorr_fit()
            self._fit_at = len(self._bins)
        return self._fit_period

    def _forecast_grow(self, view: PoolView) -> Optional[ScaleDecision]:
        t = view.time
        if not self._cooled(t) or view.pool_size >= self.max_replicas:
            return None
        period = self._period_bins()
        if period is None or self._n_seen == 0:
            return None
        bins = self._bins
        j0 = int(t / self.bin_s) - period
        j1 = int((t + self.lead_s) / self.bin_s) - period
        window = [bins[j] for j in range(j0, j1 + 1) if 0 <= j < len(bins)]
        if not window:
            return None  # first cycle: no same-phase history yet
        mean_work = self._work_sum / self._n_seen
        pred_rate = max(window) * mean_work / self.bin_s
        spawn_cap = get_replica_type(self.rtype).rate
        committed = view.live_capacity + view.n_warming * spawn_cap
        needed = pred_rate / max(self.util_target, _EPS)
        if committed + _EPS >= needed:
            return None
        self._undo = (self._last_action_t, self._above_since,
                      self._below_since)
        self._last_action_t = t
        self._above_since = None
        return ScaleDecision(
            GROW, rtype=self.rtype,
            reason=(
                f"predicted {pred_rate:.2f} work/s within {self.lead_s:.0f}s "
                f"> {committed:.2f} committed @ {self.util_target:.0%} util "
                f"(period {period * self.bin_s:.0f}s)"
            ),
        )

    def decide(self, view):
        self._undo = None  # a veto only applies to the decision below
        d = self._forecast_grow(view)
        if d is not None:
            return d
        d = super().decide(view)
        if d.action == GROW and self.rtype is not None and d.rtype is None:
            d = replace(d, rtype=self.rtype)
        return d


AUTOSCALE: dict[str, Callable[[], Autoscaler]] = {
    "fixed": FixedPool,
    "backlog_threshold": BacklogThresholdScaler,
    "deadline_aware": DeadlineAwareScaler,
    "cost_aware": CostAwareScaler,
    "predictive": PredictiveScaler,
}


def get_autoscaler(
    spec: Union[str, Autoscaler, None],
) -> Optional[Autoscaler]:
    """Resolve a policy name / instance / None to a **fresh** autoscaler.

    ``None`` means a fixed fleet with zero scaling overhead (no decision
    cadence at all) — the behavior before autoscaling existed, bit-identical. Instances are
    cloned-and-reset (:meth:`Autoscaler.fresh`): tuning carries over,
    runtime state (sustain clocks, cooldowns, learned budgets) never does.
    Both ``run_fleet`` and ``launch/fleet.FleetLoop`` construct through
    here — the same no-private-path rule as ``get_policy``/``get_router``.
    """
    if spec is None:
        return None
    if isinstance(spec, Autoscaler):
        return spec.fresh()
    try:
        return AUTOSCALE[spec]()
    except KeyError:
        raise ValueError(
            f"unknown autoscaler {spec!r}; known: {sorted(AUTOSCALE)}"
        ) from None
