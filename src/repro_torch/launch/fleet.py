"""Cross-replica serving: N ``ServeLoop`` replicas behind one router.

Port of ``repro/launch/fleet.py``: the same loop over the port's
``ServeLoop`` replicas, with the policy layers copied into
``repro_torch.core``. Only :func:`main` differs (it takes ``--device``
and runs the CUDA kernels on the card), and :func:`build_fleet` takes the
device its replicas serve on.

The hardware-path counterpart of ``core/workload.run_fleet``: a
:class:`FleetLoop` fronts N replicas with **one** admission policy (the
``ADMISSION`` registry — the fleet door admits, replicas
never re-judge) and routes every admitted request through a
:class:`~repro_torch.core.router.Router` resolved from the **same** ``ROUTER``
registry the simulator uses — there is no fleet-private routing path, which
is the acceptance criterion that lets a policy validated on the
deterministic fleet presets drop into real serving unchanged.

Replicas are interleaved cooperatively on one host: each scheduler pass
ticks every busy replica once (one decode cycle), so wall-clock is shared
the way a real multi-replica deployment shares traffic. Views are built
from each replica's **measured** tok/s EMA (``ServeLoop.tok_rate``) — the
paper's §IV.a discipline of deciding in observed currency — with the
session peak standing in for a nameplate (real replicas register no spec
sheet; ``headroom`` sets how far below peak counts as *degraded* rather
than noise).

LATE-style re-dispatch runs on the same monitor cadence as the simulator:
a request stuck past ``late_factor ×`` its dispatch-time estimate on a
degraded replica is cancelled there (:meth:`ServeLoop.cancel`, generated
tokens discarded) and re-enqueued on the fastest idle replica; both
attempts are counted in the stats.

Hedged duplicate dispatch is the proactive counterpart: with
``hedge=True``, a deadline-critical request whose
:func:`~repro_torch.core.router.plan_hedge` trigger fires is enqueued on *two*
replicas at admission — the router's pick plus a reserve replica — each
holding its own :meth:`Request.clone_for_hedge` attempt. First completion
wins; the loop cancels the loser through the same :meth:`ServeLoop.cancel`
path re-dispatch uses, books its generated tokens as ``duplicate_tokens``
(the hedging tax, same currency as ``cancelled_tokens``), and — when the
hedge attempt won — copies the winner's tokens/timestamps onto the
canonical request so fleet stats count exactly one completion. A racing
pair is its own backup: hedged requests are invisible to the re-dispatch
monitor and to spawn-time rebalancing, so no third attempt can exist.

The pool is elastic: an ``AUTOSCALE`` policy (core/autoscale.py —
the same registry the simulator's ``run_fleet`` resolves, see
docs/architecture.md) is consulted on a ``scale_check_s`` cadence with a
:class:`~repro_torch.core.autoscale.PoolView` built from the router's own
replica views. Grow calls :meth:`FleetLoop.add_replica` — the
``replica_factory`` builds a cold replica and its compile/warmup happens
right there, which *is* the warmup lag the simulator models; shrink calls
:meth:`FleetLoop.drain_replica` — the victim leaves the routable views
immediately (``alive=False``), finishes its queue, and retires once idle.

The replica interface is duck-typed (``start/tick/enqueue/cancel/
tok_rate/peak_rate/backlog_tokens/outstanding_rids/idle/stats``), so the
CPU tests drive :class:`FleetLoop` with stub replicas — every routing,
re-dispatch, and autoscaling behavior is testable without a model.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.fleet --arch qwen3-1.7b-smoke \
      --replicas 3 --requests 12 --router capacity_weighted --device cpu
"""

from __future__ import annotations

import argparse
import time
from typing import Mapping, Optional, Sequence, Union

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.core.admission import (
    ADMIT,
    DEFER,
    AdmissionPolicy,
    ClusterView,
    get_policy,
    trailing_class_p99,
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
from repro_torch.core.router import (
    InflightView,
    ReplicaView,
    Router,
    get_router,
    plan_hedge,
    plan_redispatch,
    service_estimate_s,
)
from repro_torch.data.dataset import SyntheticCorpus
from repro_torch.launch.serve import Request, ServeLoop
from repro_torch.models import model as M


class FleetLoop:
    """N serving replicas, one admission door, one shared-registry router."""

    def __init__(
        self,
        replicas: Sequence,  # ServeLoop-compatible (see module docstring)
        router: Union[str, Router] = "capacity_weighted",
        admission: Union[str, AdmissionPolicy, None] = "admit_all",
        redispatch: bool = True,
        late_factor: float = 3.0,
        probe_s: float = 0.25,
        headroom: float = 0.85,
        autoscale: Union[str, Autoscaler, None] = None,
        # () -> ServeLoop-compatible, for grow — or a typed registry
        # {type name: factory} so a GROW decision's ``rtype`` picks which
        # kind of replica to spawn (the typed-pool contract)
        replica_factory=None,
        scale_check_s: float = 0.5,
        hedge: bool = False,
        reserve_frac: float = 0.5,
        # catalog type names (core.autoscale.REPLICA_TYPES) for the
        # *initial* replicas, parallel to ``replicas``; None = all default
        replica_types: Optional[Sequence[str]] = None,
    ):
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        self.replicas = list(replicas)
        if replica_types is not None and len(replica_types) != len(
            self.replicas
        ):
            raise ValueError(
                "replica_types must parallel replicas: "
                f"{len(replica_types)} != {len(self.replicas)}"
            )
        self._rtype: dict[int, str] = {
            i: get_replica_type(
                replica_types[i] if replica_types is not None else None
            ).name
            for i in range(len(self.replicas))
        }
        self._online_t: dict[int, float] = {}
        self._offline_t: dict[int, float] = {}
        self.router = router
        self.admission = admission
        self.redispatch = redispatch
        self.late_factor = late_factor
        self.probe_s = probe_s
        self.headroom = headroom
        self.autoscale = autoscale
        self.replica_factory = replica_factory
        self.scale_check_s = scale_check_s
        self.hedge = hedge
        self.reserve_frac = reserve_frac
        self._draining: set[int] = set()
        self._retired: set[int] = set()
        self._running = False
        self._prompt_len = 0
        self._t0 = 0.0

    # -- pool lifecycle (autoscaling) -------------------------------------

    def add_replica(self, rtype: Optional[str] = None):
        """Spawn a replica via ``replica_factory`` and register it.

        Called mid-run by the autoscaler's GROW decision (or by the owner
        before a run). With a typed factory registry (``replica_factory``
        a mapping of type name → factory), ``rtype`` selects which kind
        of replica to build — a typed ``ScaleDecision`` picks cheap spot
        capacity the same way it does in the simulator; ``rtype=None``
        against a registry uses the first registered type. The cold start
        — compile + warmup — happens here, synchronously: on the hardware
        path that *is* the warmup lag the simulator's ``warmup_s`` models
        — and while it runs, no replica ticks, so every in-flight request
        pauses with it (the single-host cooperative-interleaving trade; a
        multi-host deployment would spawn out-of-band). The run loop
        compensates: the policy's cooldown restarts from *completion*
        (``note_action_done``) and the next scale check is a full cadence
        after the stall, so a compile longer than ``cooldown_s`` cannot
        cascade into repeated fleet-freezing spawns. Returns the new
        replica index.
        """
        factory = self.replica_factory
        if isinstance(factory, Mapping):
            if rtype is None:
                rtype = next(iter(factory), None)
            factory = factory.get(rtype)
        if factory is None:
            raise ValueError(
                "add_replica needs a replica_factory"
                + (f" for type {rtype!r}" if rtype is not None else "")
            )
        rep = factory()
        i = len(self.replicas)
        self.replicas.append(rep)
        self._rtype[i] = get_replica_type(rtype).name
        self._online_t[i] = (
            time.perf_counter() - self._t0 if self._running else 0.0
        )
        if self._running:
            if self._prompt_len and hasattr(rep, "warm"):
                rep.warm(self._prompt_len)
            rep.start([], prompt_len=self._prompt_len, t0=self._t0)
        return i

    def drain_replica(self, i: int) -> bool:
        """Stop routing to replica ``i``; it finishes its queue, then
        retires (SHRINK decision). Returns False for an index that cannot
        drain (already draining/retired, or out of range)."""
        if not (0 <= i < len(self.replicas)):
            return False
        if i in self._draining or i in self._retired:
            return False
        self._draining.add(i)
        return True

    def _live_indices(self) -> list[int]:
        return [
            i for i in range(len(self.replicas)) if i not in self._retired
        ]

    # -- views ------------------------------------------------------------

    def _views(self, t: float) -> list[ReplicaView]:
        out = []
        for i in self._live_indices():
            rep = self.replicas[i]
            rids = rep.outstanding_rids()
            # peak EMA stands in for nameplate, derated by `headroom` so
            # ordinary measurement noise never reads as degradation — only
            # a sustained rate drop (a real straggler) crosses the margin
            nameplate = rep.peak_rate * self.headroom

            def attempt_t(rid: int) -> float:
                # a hedge attempt ages from its own enqueue, not from the
                # primary's dispatch stamp
                if self._hedge_where.get(rid) == i:
                    return self._hedge_dispatch_t[rid]
                return self._dispatch_t[rid]

            oldest = (
                max(
                    (t - attempt_t(r) for r in rids if r in self._dispatch_t),
                    default=0.0,
                )
                if rids
                else 0.0
            )
            rt = self._rtype.get(i, "default")
            # session residency is duck-typed like the rest of the replica
            # surface: a replica that parks KV slots between turns exposes
            # resident_sessions() and the affinity router keys on it; stubs
            # without it simply advertise an empty set. In-process replicas
            # are never mid-stage-in (add_replica warms synchronously), so
            # staging is always False on the hardware path.
            resident = getattr(rep, "resident_sessions", None)
            out.append(
                ReplicaView(
                    replica_id=i,
                    capacity=rep.tok_rate,
                    nameplate=nameplate,
                    backlog_work=rep.backlog_tokens(),
                    queue_depth=len(rids),
                    oldest_age_s=oldest,
                    # in-process replicas do not silently die; not-alive
                    # here means *draining* (scale-down in progress)
                    alive=i not in self._draining,
                    rtype=rt,
                    price=get_replica_type(rt).price,
                    resident_sessions=(
                        frozenset(resident()) if resident is not None else frozenset()
                    ),
                    staging=False,
                )
            )
        return out

    def _cluster_view(self, t: float, policy) -> ClusterView:
        views = self._views(t)
        cap = sum(v.capacity for v in views)
        cap = cap if cap > 0 else float("inf")  # pre-measurement: optimistic
        return ClusterView(
            time=t,
            live_capacity=cap,
            total_capacity=cap,
            free_slots=sum(1 for v in views if v.idle),
            queue_depth=sum(v.queue_depth for v in views),
            backlog_work=sum(v.backlog_work for v in views),
            deferred_depth=policy.n_deferred if policy else 0,
            deferred_work=policy.deferred_work if policy else 0.0,
            class_p99=trailing_class_p99(self._done_hist),
        )

    # -- the fleet loop ----------------------------------------------------

    def run_requests(self, requests: list[Request]) -> dict:
        rtr = get_router(self.router)  # fresh cursors/credit per run
        policy = get_policy(self.admission)
        asc = get_autoscaler(self.autoscale)  # fresh clocks/budgets per run
        by_id = {r.rid: r for r in requests}
        self._dispatch_t: dict[int, float] = {}
        self._est_s: dict[int, float] = {}
        self._where: dict[int, int] = {}
        self._done_hist: dict[int, list[float]] = {}
        # hedged-pair books: rid -> hedge replica / enqueue stamp / the
        # clone attempt racing there (a rid in _hedge_clone is mid-race)
        self._hedge_where: dict[int, int] = {}
        self._hedge_dispatch_t: dict[int, float] = {}
        self._hedge_clone: dict[int, Request] = {}
        self._draining = set()
        self._retired = set()
        # billing meters: base replicas bill from t0; elastic spawns stamp
        # their own online time, retirees stop the meter in the tick sweep
        self._online_t = {i: 0.0 for i in range(len(self.replicas))}
        self._offline_t = {}
        n_moves = 0
        cancelled_tokens = 0
        n_hedged = 0
        n_hedge_wins = 0
        duplicate_tokens = 0
        n_spawned = 0
        n_drained = 0
        n_rebalanced = 0
        rejected: list[Request] = []
        routed_of: dict[int, int] = {}  # first-dispatch counts per replica

        prompt_len = int(requests[0].prompt.shape[0]) if requests else 0
        # warm every replica BEFORE opening the clock (compile time stays
        # outside the measured window), then hand all sessions one shared
        # origin: arrival stamps (fleet door) and finish stamps (replica
        # sessions) must subtract on the same timeline, or every sojourn
        # inflates by later replicas' warm-up
        for rep in self.replicas:
            if prompt_len and hasattr(rep, "warm"):
                rep.warm(prompt_len)
        t0 = time.perf_counter()
        for rep in self.replicas:
            rep.start([], prompt_len=prompt_len, t0=t0)
        # mid-run spawns (add_replica) warm + start against the same origin
        self._running = True
        self._prompt_len = prompt_len
        self._t0 = t0

        def now() -> float:
            return time.perf_counter() - t0

        for r in requests:
            if r.arrived < 0:
                r.arrived = now()

        pending = list(requests)  # not yet offered to the fleet door

        def dispatch(r: Request, dst: int, t: float) -> None:
            self._dispatch_t[r.rid] = t
            self._where[r.rid] = dst
            rep = self.replicas[dst]
            # estimate against the replica's learned nameplate; before any
            # measurement exists the estimate is unknowable and the stuck
            # judgement simply skips the request (est stays None)
            base = rep.peak_rate * self.headroom
            self._est_s[r.rid] = (
                service_estimate_s(float(r.max_new), base) if base > 0 else None
            )
            rep.enqueue(r)

        def route(r: Request, t: float) -> None:
            nonlocal n_hedged
            if asc is not None:
                asc.note_request(ServeLoop.as_job_request(r))
            jr = ServeLoop.as_job_request(r)
            views = self._views(t)  # one snapshot for pick AND hedge plan
            choice = rtr.pick(jr, views)
            if choice is None:
                # every replica draining (all-dead cannot occur in-process):
                # fall back to the least-backlogged live one — it still
                # serves its queue while it drains
                choice = min(
                    self._live_indices(),
                    key=lambda i: self.replicas[i].backlog_tokens(),
                )
            routed_of[choice] = routed_of.get(choice, 0) + 1
            dispatch(r, choice, t)
            if self.hedge:
                target = plan_hedge(jr, choice, views, self.reserve_frac)
                if target is not None:
                    clone = r.clone_for_hedge()
                    n_hedged += 1
                    self._hedge_where[r.rid] = target
                    self._hedge_dispatch_t[r.rid] = t
                    self._hedge_clone[r.rid] = clone
                    self.replicas[target].enqueue(clone)

        def resolve(r: Request, decision: str, t: float) -> None:
            if decision == ADMIT:
                route(r, t)
            else:
                r.rejected = True
                rejected.append(r)

        offered = [0]
        # until any replica has a *measured* rate, judge at most one fleet
        # batch against the optimistic unbounded view (ServeLoop's own
        # rule, fleet-wide): enough to start decoding everywhere without
        # shedding the whole queue on a guess
        offer_bound = sum(getattr(rep, "batch", 1) for rep in self.replicas)

        def measured() -> bool:
            return any(rep.tok_rate > 0 for rep in self.replicas)

        def pump(t: float, force: bool = False) -> None:
            """The fleet front door: one admission policy for N replicas —
            the exact protocol ServeLoop speaks single-replica."""
            if policy is None:
                while pending:
                    route(pending.pop(0), t)
                return
            while pending:
                if not measured() and not force and offered[0] >= offer_bound:
                    break
                r = pending.pop(0)
                offered[0] += 1
                decision = policy.offer(
                    ServeLoop.as_job_request(r), self._cluster_view(t, policy)
                )
                if decision != DEFER:
                    resolve(r, decision, t)
            for req, decision in policy.poll(self._cluster_view(t, policy)):
                resolve(by_id[req.job_id], decision, t)

        # Best nameplate seen, tracked *per replica type*. A fleet-wide
        # floor made every cold slow/spot replica look perpetually stuck:
        # backfilled estimates assumed fast-replica throughput, so the
        # stuck monitor fired spurious re-dispatch storms against healthy
        # but slower hardware. The fallback for a type with no measurement
        # yet scales the fleet-best peak by the catalog rate ratio, which
        # degenerates to the old behaviour for single-type fleets.
        type_peak: dict[str, float] = {}
        fleet_best = [0.0, "default"]  # (peak, rtype) — cross-type fallback

        def peak_floor(rt: str) -> float:
            got = type_peak.get(rt, 0.0)
            if got > 0.0:
                return got
            best, best_rt = fleet_best
            if best <= 0.0:
                return 0.0
            ratio = get_replica_type(rt).rate / max(
                get_replica_type(best_rt).rate, 1e-9
            )
            return best * ratio

        def probe(t: float) -> None:
            nonlocal n_moves, cancelled_tokens
            views = self._views(t)
            for j, rep_j in enumerate(self.replicas):
                rt_j = self._rtype.get(j, "default")
                p = rep_j.peak_rate * self.headroom
                if p > type_peak.get(rt_j, 0.0):
                    type_peak[rt_j] = p
                if p > fleet_best[0]:
                    fleet_best[0], fleet_best[1] = p, rt_j
            inflight = []
            for i in self._live_indices():
                rep = self.replicas[i]
                for rid in rep.outstanding_rids():
                    if rid not in self._dispatch_t:
                        continue
                    if rid in self._hedge_clone:
                        # a racing hedged pair is its own backup: neither
                        # attempt may be re-dispatched (a third attempt
                        # would break first-completion-wins bookkeeping)
                        continue
                    r = by_id[rid]
                    est = self._est_s.get(rid)
                    if est is None:
                        # dispatched before any measurement existed: backfill
                        # from the replica's learned nameplate, floored at
                        # the fleet-best. The old `a or b` fallback only
                        # fired on *exactly* 0.0 — a stalled replica's
                        # epsilon EMA (e.g. 1e-12 tok/s) slipped through as
                        # a "measurement" and blew the estimate up to ~1e13
                        # seconds, blinding the stuck monitor on precisely
                        # the replica most likely to need a rescue
                        base = max(
                            rep.peak_rate * self.headroom,
                            peak_floor(self._rtype.get(i, "default")),
                        )
                        if base <= 0:
                            continue  # nothing measured fleet-wide yet
                        est = service_estimate_s(float(r.max_new), base)
                        self._est_s[rid] = est
                    inflight.append(
                        InflightView(
                            request_id=rid,
                            replica_id=i,
                            age_s=t - self._dispatch_t[rid],
                            est_s=est,
                            remaining_work=float(r.max_new - len(r.tokens)),
                        )
                    )
            for rid, src, dst in plan_redispatch(inflight, views, self.late_factor):
                r = by_id[rid]
                if not self.replicas[src].cancel(rid):
                    continue  # it finished in the race: nothing to move
                # the original attempt's progress is discarded (new prefill
                # on the target) — the re-dispatch cost, reported below
                cancelled_tokens += len(r.tokens)
                r.tokens.clear()
                r.first_token = -1.0
                r.finished = -1.0
                n_moves += 1
                dispatch(r, dst, t)

        def rebalance_to(dst: int, t: float) -> None:
            """Pull queued (not-yet-decoding) requests from the deepest
            backlog-seconds queues onto a freshly spawned replica — the
            serving-path mirror of run_fleet's warm-time rebalance.
            Dispatch happens at admission, so without this a replica
            spawned mid-burst would only ever see *future* arrivals.
            Moving a ready request costs nothing (no tokens generated);
            replicas that don't expose ``queued_rids`` are skipped."""
            nonlocal n_rebalanced
            me = self.replicas[dst]
            est_rate = me.tok_rate or max(
                (self.replicas[j].tok_rate for j in self._live_indices()),
                default=0.0,
            )
            if est_rate <= 0:
                return
            def movable(j: int) -> list[int]:
                # hedged pairs stay put: pulling either attempt onto
                # another replica would desync the pair's books (and could
                # co-locate both attempts on one replica)
                queued = getattr(self.replicas[j], "queued_rids", None)
                if queued is None:
                    return []
                return [q for q in queued() if q not in self._hedge_clone]

            while True:
                donor, donor_bs = None, 0.0
                for j in self._live_indices():
                    oj = self.replicas[j]
                    if j == dst or oj.tok_rate <= 0:
                        continue
                    if not movable(j):
                        continue
                    bs = oj.backlog_tokens() / oj.tok_rate
                    if bs > donor_bs:
                        donor, donor_bs = j, bs
                if donor is None:
                    break
                rid = movable(donor)[-1]
                r = by_id[rid]
                # move only while the request finishes sooner on the fresh
                # replica than its current queue position promises
                if (me.backlog_tokens() + float(r.max_new)) / est_rate >= donor_bs:
                    break
                if not self.replicas[donor].cancel(rid):
                    continue  # finished in the race
                n_rebalanced += 1
                dispatch(r, dst, t)

        def scale(t: float) -> None:
            """One autoscaler consultation — the same PoolView protocol the
            simulator speaks, then add_replica/drain_replica executes it."""
            nonlocal n_spawned, n_drained
            views = self._views(t)
            d = asc.decide(
                PoolView(
                    time=t,
                    replicas=tuple(views),
                    n_warming=0,  # add_replica warms synchronously
                    class_p99=trailing_class_p99(self._done_hist),
                )
            )
            if d.action == GROW:
                if self.replica_factory is None:
                    # a drain-only controller: the grow cannot happen, and
                    # the policy must not burn a cooldown believing it did
                    asc.veto(d)
                    return
                if (
                    d.rtype is not None
                    and isinstance(self.replica_factory, Mapping)
                    and d.rtype not in self.replica_factory
                ):
                    # typed grow the registry cannot satisfy: same veto
                    # contract as a missing factory
                    asc.veto(d)
                    return
                i = self.add_replica(d.rtype)
                n_spawned += 1
                # the spawn's compile/warmup just ran synchronously: the
                # cooldown restarts from completion, or a compile longer
                # than cooldown_s cascades into back-to-back fleet freezes
                t_done = now()
                asc.note_action_done(t_done)
                rebalance_to(i, t_done)
            elif d.action == SHRINK:
                # never drain the last routable replica, whatever the
                # policy asked: admitted requests need somewhere to land
                routable = [v.replica_id for v in views if v.alive]
                if len(routable) <= 1:
                    asc.veto(d)
                    return
                victim = d.replica_id
                if victim not in routable:
                    victim = default_shrink_victim(
                        PoolView(time=t, replicas=tuple(views))
                    )
                if victim is None or not self.drain_replica(victim):
                    asc.veto(d)
                    return
                n_drained += 1

        pump(now())
        last_probe = now()
        last_scale = now()
        last_progress = time.perf_counter()
        while True:
            progressed = False
            for i in self._live_indices():
                rep = self.replicas[i]
                if not rep.idle and rep.tick() == "step":
                    progressed = True
            t = now()
            # a drained-dry replica retires: out of the views, out of the
            # tick loop (its completed stats stay on the books)
            for i in list(self._draining):
                if self.replicas[i].idle:
                    self._draining.discard(i)
                    self._retired.add(i)
                    # the meter stops at retirement, not run end
                    self._offline_t.setdefault(i, t)
            # resolve hedge races BEFORE the completion scan: the first
            # attempt to finish wins, the loser is cancelled through the
            # same ServeLoop.cancel path re-dispatch uses, and its tokens
            # are booked as duplicate work — so by the time the scan runs,
            # the canonical Request carries exactly the winner's state
            for rid in list(self._hedge_clone):
                r = by_id[rid]
                clone = self._hedge_clone[rid]
                if r.finished >= 0:
                    # primary won (photo-finishes resolve to the primary:
                    # its completion is already on the canonical request)
                    h = self._hedge_where.pop(rid)
                    del self._hedge_clone[rid]
                    self._hedge_dispatch_t.pop(rid, None)
                    self.replicas[h].cancel(rid)
                    # whether the cancel landed or the clone finished in
                    # the race, its generated tokens are duplicate work
                    duplicate_tokens += len(clone.tokens)
                elif clone.finished >= 0:
                    # hedge won: discard the primary attempt and graft the
                    # winner's tokens/timestamps onto the canonical request
                    h = self._hedge_where.pop(rid)
                    del self._hedge_clone[rid]
                    self._hedge_dispatch_t.pop(rid, None)
                    p = self._where.get(rid)
                    if p is not None:
                        self.replicas[p].cancel(rid)
                    duplicate_tokens += len(r.tokens)
                    n_hedge_wins += 1
                    r.tokens = clone.tokens
                    r.submitted = clone.submitted
                    r.first_token = clone.first_token
                    r.finished = clone.finished
            # completions feed the fleet-level latency history + policy
            for r in requests:
                if r.finished >= 0 and r.rid in self._where:
                    self._done_hist.setdefault(r.slo_class, []).append(
                        r.finished - r.arrived
                    )
                    if policy is not None:
                        policy.on_job_done(
                            t, ServeLoop.as_job_request(r), r.finished - r.arrived
                        )
                    del self._where[r.rid]
            pump(t)
            if self.redispatch and t - last_probe >= self.probe_s:
                probe(t)
                last_probe = t
            if asc is not None and t - last_scale >= self.scale_check_s:
                scale(t)
                last_scale = now()  # post-compile: a slow spawn already ate
                # the cadence, don't re-check (and re-freeze) immediately
            outstanding = any(
                not self.replicas[i].idle for i in self._live_indices()
            )
            deferred = policy.n_deferred if policy is not None else 0
            if not outstanding and not deferred and pending:
                # endgame: requests never offered (pre-measurement bound)
                # and nothing will ever run again — the guess is all there is
                pump(now(), force=True)
                continue
            if not outstanding and not pending and not deferred:
                break
            if progressed:
                last_progress = time.perf_counter()
            elif deferred and not outstanding:
                nxt = policy.next_event_t()
                wait = 0.01 if nxt is None else max(0.0, min(nxt - now(), 0.25))
                time.sleep(wait)
                if time.perf_counter() - last_progress > 60.0:
                    break  # a policy that never releases: report, don't hang

        self._running = False
        wall = time.perf_counter() - t0
        done = [r for r in requests if r.finished >= 0]
        per_replica = [rep.stats() for rep in self.replicas]
        replica_seconds = 0.0
        cost = 0.0
        cost_by_type: dict[str, float] = {}
        for i in range(len(self.replicas)):
            sec = max(
                0.0, self._offline_t.get(i, wall) - self._online_t.get(i, 0.0)
            )
            replica_seconds += sec
            name = self._rtype.get(i, "default")
            c = sec * get_replica_type(name).price
            cost += c
            cost_by_type[name] = cost_by_type.get(name, 0.0) + c
        return {
            "autoscaler": asc.name if asc else "none",
            "spawned": n_spawned,
            "drained": n_drained,
            "rebalanced": n_rebalanced,
            "pool_final": len(self._live_indices()),
            "completed": len(done),
            "rejected": len(rejected),
            "deferred_unserved": policy.n_deferred if policy else 0,
            "admission": policy.name if policy else "none",
            "router": rtr.name,
            "redispatched": n_moves,
            "cancelled_tokens": cancelled_tokens,
            "hedged": n_hedged,
            "hedge_wins": n_hedge_wins,
            "duplicate_tokens": duplicate_tokens,
            # fleet-wide re-prefills skipped via parked session slots
            # (replicas without session residency report nothing)
            "prefill_skipped": sum(
                s.get("prefill_skipped", 0) for s in per_replica
            ),
            "routed_per_replica": [
                routed_of.get(i, 0) for i in range(len(self.replicas))
            ],
            "completed_per_replica": [s["completed"] for s in per_replica],
            "tok_rate_per_replica": [rep.tok_rate for rep in self.replicas],
            "replica_types": [
                self._rtype.get(i, "default") for i in range(len(self.replicas))
            ],
            "replica_seconds": replica_seconds,
            "cost": cost,
            "cost_by_type": cost_by_type,
            "wall_s": wall,
            "tokens_per_s": sum(len(r.tokens) for r in done) / wall if wall else 0.0,
            "mean_latency_s": (
                float(sum(r.finished - r.arrived for r in done) / len(done))
                if done
                else -1
            ),
        }


def build_fleet(
    cfg,
    run,
    params,
    n_replicas: int,
    batch: int,
    max_len: int,
    router: Union[str, Router] = "capacity_weighted",
    admission: Union[str, AdmissionPolicy, None] = "admit_all",
    batched: bool = True,
    autoscale: Union[str, Autoscaler, None] = None,
    mode: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
    **kw,
) -> FleetLoop:
    """N identical ``ServeLoop`` replicas behind one :class:`FleetLoop`.

    Replica-level admission is ``None`` by construction: the fleet door is
    the only place a request is judged (the same no-private-path rule the
    admission layer enforces single-replica). The ``replica_factory``
    builds the same ``ServeLoop`` shape on demand, so a GROW decision
    spawns an identical replica (its kernel build/warmup is the cold-start
    lag). ``mode`` selects the replica's decode batching (arena /
    cohort / serial) — the fleet consumes whatever tok/s the replica
    measures, so a faster decode path re-prices every capacity-gated
    policy with no fleet-side change. Every replica serves from the same
    ``params`` tensors: N replicas hold one copy of the weights and one
    KV arena each. ``device="cuda"`` raises where no card is present."""

    def factory():
        return ServeLoop(
            cfg, run, params, batch=batch, max_len=max_len,
            admission=None, batched=batched, mode=mode, device=device,
        )

    replicas = [factory() for _ in range(n_replicas)]
    return FleetLoop(
        replicas, router=router, admission=admission,
        autoscale=autoscale, replica_factory=factory, **kw,
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b-smoke")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--router", default="capacity_weighted",
                    help="policy name from core.router.ROUTER")
    ap.add_argument("--admission", default="admit_all",
                    help="policy name from core.admission.ADMISSION")
    ap.add_argument("--autoscale", default=None,
                    help="policy name from core.autoscale.AUTOSCALE "
                         "(default: fixed pool)")
    ap.add_argument("--no-redispatch", action="store_true")
    ap.add_argument("--hedge", action="store_true",
                    help="hedged duplicate dispatch for deadline-critical "
                         "requests (core.router.plan_hedge)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("fleet --device cuda: no CUDA device is available; "
                           "pass --device cpu to run the plain path on the CPU")

    cfg = get_config(args.arch)
    run = RunConfig(remat="none", attention_impl="pallas",
                    decode_attention_impl="kernel",
                    ssd_chunk=min(256, args.prompt_len))
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params = M.init_model(cfg, gen, dtype=getattr(torch, cfg.compute_dtype))
    corpus = SyntheticCorpus(cfg.vocab_size, args.prompt_len, args.seed)
    reqs = [
        Request(i, corpus.grain_tokens(i, 1)[0], args.gen)
        for i in range(args.requests)
    ]
    fleet = build_fleet(
        cfg, run, params, args.replicas, args.batch,
        args.prompt_len + args.gen + 1,
        router=args.router, admission=args.admission,
        autoscale=args.autoscale,
        device=args.device,
        redispatch=not args.no_redispatch,
        hedge=args.hedge,
    )
    stats = fleet.run_requests(reqs)
    print(
        f"fleet served {stats['completed']}/{args.requests} requests over "
        f"{args.replicas} replicas (router={stats['router']}, "
        f"routed={stats['routed_per_replica']}, "
        f"redispatched={stats['redispatched']}, device={args.device})  "
        f"{stats['tokens_per_s']:.1f} tok/s fleet-wide"
    )
    return stats


if __name__ == "__main__":
    main()
