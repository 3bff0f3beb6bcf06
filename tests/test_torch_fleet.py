"""The port's fleet layer on the CPU: ``repro_torch.launch.fleet`` and the
policy modules it calls, ``repro_torch.core.router`` and
``repro_torch.core.autoscale``.

* Their registries and the replica-type catalog equal the JAX package's.
* Every router and autoscaler, and the planning helpers, decide as the JAX
  package's do on seeded sequences of views (200 decisions each).
* The JAX package's stub-replica FleetLoop tests (``test_router.py``,
  ``test_autoscale.py``, ``test_hedge.py``, ``test_pool.py``,
  ``test_affinity.py``), run against the port with the same stubs and
  asserts; the scenarios with no wall-clock cadence in play also run
  through both FleetLoops, whose stats must agree.
* A real 2-replica fleet of the port serves the JAX package's fleet's token
  streams on bridged weights (fp32, greedy), and a lone replica's.
* ``main --device cpu`` serves every request; ``device="cuda"`` without a
  card raises.
"""

import dataclasses
import math
import time
import types

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.core import admission, autoscale, router
from repro_torch.launch import fleet, serve

try:
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.configs.base import RunConfig as JaxRunConfig
    from repro.core import admission as jax_admission
    from repro.core import autoscale as jax_autoscale
    from repro.core import router as jax_router
    from repro.launch import fleet as jax_fleet
    from repro.launch import serve as jax_serve
    from repro.models import model as JM
except ImportError:  # the card's machine has no JAX
    jax = None

PORT = types.SimpleNamespace(name="port", admission=admission, autoscale=autoscale, router=router,
                             fleet=fleet, Request=serve.Request)


@pytest.fixture
def ref():
    """The JAX package's side of a parity test."""
    if jax is None:
        pytest.skip("JAX is not installed: the reference side of this test is missing")
    return types.SimpleNamespace(name="jax", admission=jax_admission, autoscale=jax_autoscale,
                                 router=jax_router, fleet=jax_fleet, Request=jax_serve.Request)


# ------------------------------------------------------ registries, catalog


def test_registries_and_catalog_equal_jax(ref):
    assert list(router.ROUTER) == list(ref.router.ROUTER)
    assert list(autoscale.AUTOSCALE) == list(ref.autoscale.AUTOSCALE)
    for reg, jreg in ((router.ROUTER, ref.router.ROUTER), (autoscale.AUTOSCALE, ref.autoscale.AUTOSCALE)):
        for name in reg:
            assert reg[name]().name == jreg[name]().name == name
    assert list(autoscale.REPLICA_TYPES) == list(ref.autoscale.REPLICA_TYPES)
    for name, rt in autoscale.REPLICA_TYPES.items():
        assert dataclasses.asdict(rt) == dataclasses.asdict(ref.autoscale.REPLICA_TYPES[name])
        assert rt.value == ref.autoscale.REPLICA_TYPES[name].value
    assert (autoscale.GROW, autoscale.SHRINK, autoscale.HOLD) == (
        ref.autoscale.GROW, ref.autoscale.SHRINK, ref.autoscale.HOLD)
    with pytest.raises(ValueError):
        router.get_router("nope")
    with pytest.raises(ValueError):
        autoscale.get_autoscaler("nope")
    with pytest.raises(ValueError):
        autoscale.get_replica_type("tpu_v9")


# ------------------------------------------------ seeded decision sequences

TYPES = ("default", "fast", "slow", "spot")


def _replica_fields(rng, ids, load):
    """One ReplicaView's fields per id: capacities include 0 and repeated
    values (ties), some replicas are not alive, some queues empty; ``load``
    scales the backlog."""
    out = []
    for i in ids:
        u = rng.random()
        cap = 0.0 if u < 0.15 else float(rng.choice([1.0, 2.0, 4.0])) if u < 0.5 else float(rng.uniform(0.1, 8.0))
        empty = rng.random() < 0.3
        rt = TYPES[rng.integers(len(TYPES))]
        out.append(dict(
            replica_id=int(i),
            capacity=cap,
            nameplate=cap * float(rng.choice([1.0, 1.0, 1.3])),
            backlog_work=0.0 if empty else float(rng.uniform(0.0, load)),
            queue_depth=0 if empty else int(rng.integers(1, 9)),
            oldest_age_s=0.0 if empty else float(rng.uniform(0.0, 60.0)),
            alive=bool(rng.random() > 0.15),
            rtype=rt,
            price=float(rng.choice([1.0, 0.4, 0.35, float(rng.uniform(0.1, 2.0))])),
            resident_sessions=frozenset(int(s) for s in rng.choice(6, size=rng.integers(0, 3), replace=False)),
            staging=bool(rng.random() < 0.1),
        ))
    return out


def _request_fields(rng, k, t=0.0):
    return dict(job_id=k, arrive_t=t, n_tasks=1, total_work=float(rng.uniform(1.0, 64.0)),
                slo_class=int(rng.integers(0, 3)),
                deadline_s=math.inf if rng.random() < 0.3 else float(rng.uniform(20.0, 120.0)),
                session_id=int(rng.integers(-1, 6)))


def _ids(rng, prev):
    """Replica ids for the next decision: often the same roster (the
    routers' steady state), else a new sorted subset of 0..6."""
    if prev is not None and rng.random() < 0.6:
        return prev
    return sorted(int(i) for i in rng.choice(7, size=rng.integers(1, 6), replace=False))


def _views(pkg, fields):
    return [pkg.router.ReplicaView(**f) for f in fields]


ROUTER_SPECS = list(router.ROUTER) + ["class_reserved(0.3)", "affinity(5.0)"]


def _router(pkg, spec):
    if spec == "class_reserved(0.3)":
        return pkg.router.get_router(pkg.router.ClassReservedRouter(reserve_frac=0.3))
    if spec == "affinity(5.0)":
        return pkg.router.get_router(pkg.router.AffinityRouter(backlog_ceiling_s=5.0))
    return pkg.router.get_router(spec)


@pytest.mark.parametrize("spec", ROUTER_SPECS)
def test_router_picks_equal_jax(ref, spec):
    rng = np.random.default_rng(sum(map(ord, spec)))
    picks = {"port": [], "jax": []}
    rtr = {pkg.name: _router(pkg, spec) for pkg in (PORT, ref)}
    ids = None
    for k in range(200):
        ids = _ids(rng, ids)
        fields = _replica_fields(rng, ids, load=float(rng.choice([1.0, 50.0, 500.0])))
        req = _request_fields(rng, k)
        for pkg in (PORT, ref):
            picks[pkg.name].append(rtr[pkg.name].pick(pkg.admission.JobRequest(**req), _views(pkg, fields)))
    assert picks["port"] == picks["jax"]
    assert len({p for p in picks["port"] if p is not None}) > 1  # the sequence does route


SCALER_SPECS = list(autoscale.AUTOSCALE) + ["cost_aware(spot_frac_max=0.3)", "predictive(period_s=200, rtype=spot)",
                                            "deadline_aware(budget_s=40)"]


def _scaler(pkg, spec):
    a = pkg.autoscale
    if spec == "cost_aware(spot_frac_max=0.3)":
        return a.get_autoscaler(a.CostAwareScaler(spot_frac_max=0.3))
    if spec == "predictive(period_s=200, rtype=spot)":
        return a.get_autoscaler(a.PredictiveScaler(period_s=200.0, rtype="spot"))
    if spec == "deadline_aware(budget_s=40)":
        return a.get_autoscaler(a.DeadlineAwareScaler(budget_s=40.0))
    return a.get_autoscaler(spec)


@pytest.mark.parametrize("spec", SCALER_SPECS)
def test_autoscaler_decisions_equal_jax(ref, spec):
    """The same PoolView sequence, time increasing and load moving between
    regimes, with the arrival feed, vetoes and completions at the same
    points: every decision equal, field for field."""
    rng = np.random.default_rng(sum(map(ord, spec)))
    got = {"port": [], "jax": []}
    asc = {pkg.name: _scaler(pkg, spec) for pkg in (PORT, ref)}
    t, ids, n_req = 0.0, None, 0
    for k in range(200):
        t += float(rng.exponential(4.0))
        regime = (k // 25) % 3  # heavy, light, mid
        ids = _ids(rng, ids)
        fields = _replica_fields(rng, ids, load=(3000.0, 2.0, 200.0)[regime])
        arrivals = [_request_fields(rng, n_req + j, t) for j in range(int(rng.poisson(2 + 2 * math.sin(t / 32))))]
        n_req += len(arrivals)
        n_warming = int(rng.integers(0, 3))
        p99 = {0: float("nan") if rng.random() < 0.2 else float(rng.uniform(0, 100)), 1: float(rng.uniform(0, 100))}
        follow = rng.random()
        done_t = t + float(rng.uniform(0.0, 10.0))
        for pkg in (PORT, ref):
            a = asc[pkg.name]
            for r in arrivals:
                a.note_request(pkg.admission.JobRequest(**r))
            view = pkg.autoscale.PoolView(time=t, replicas=tuple(_views(pkg, fields)), n_warming=n_warming,
                                          class_p99=p99)
            d = a.decide(view)
            got[pkg.name].append((d.action, d.replica_id, d.rtype, d.reason))
            if d.action != pkg.autoscale.HOLD:
                if follow < 0.3:
                    a.veto(d)
                elif follow < 0.8:
                    a.note_action_done(done_t)
    assert got["port"] == got["jax"]
    actions = {g[0] for g in got["port"]}
    assert actions == {"hold"} if spec == "fixed" else "grow" in actions


def test_planning_helpers_equal_jax(ref):
    """plan_hedge, plan_redispatch, reserve_ids, service_estimate_s and
    default_shrink_victim on the same seeded inputs give equal results."""
    rng = np.random.default_rng(7)
    ids = None
    for k in range(200):
        ids = _ids(rng, ids)
        fields = _replica_fields(rng, ids, load=float(rng.choice([1.0, 50.0])))
        req = _request_fields(rng, k)
        primary = int(rng.choice(ids + [99]))
        frac = float(rng.choice([0.0, 0.3, 0.5, 1.0]))
        inflight = [dict(request_id=j, replica_id=int(rng.choice(ids + [99])), age_s=float(rng.uniform(0, 30)),
                         est_s=float(rng.uniform(0.1, 10)), remaining_work=float(rng.uniform(0, 64)))
                    for j in range(int(rng.integers(0, 8)))]
        late = float(rng.choice([0.5, 2.0, 3.0]))
        work, rate = float(rng.uniform(0, 64)), float(rng.choice([0.0, 1e-12, rng.uniform(0.1, 8)]))
        out = {}
        for pkg in (PORT, ref):
            r, a = pkg.router, pkg.autoscale
            views = _views(pkg, fields)
            out[pkg.name] = (
                r.plan_hedge(pkg.admission.JobRequest(**req), primary, views, frac),
                r.plan_redispatch([r.InflightView(**f) for f in inflight], views, late),
                r.reserve_ids(views, frac),
                r.service_estimate_s(work, rate),
                a.default_shrink_victim(a.PoolView(time=0.0, replicas=tuple(views))),
            )
        assert out["port"] == out["jax"], k


# ----------------------------------------------- FleetLoop with stub replicas


class _StubReplica:
    """Minimal ServeLoop-compatible replica: serves `speed` tokens per
    request per tick (``test_router.py``'s stub)."""

    def __init__(self, speed: int, batch: int = 2):
        self.speed, self.batch = speed, batch

    def start(self, requests, prompt_len=None, t0=None):
        self.ready = list(requests)
        self.active = []
        self.done = []
        self.tok_rate = 0.0
        self.peak_rate = 0.0

    def enqueue(self, r):
        self.ready.append(r)

    def cancel(self, rid):
        for q in (self.ready, self.active):
            for r in list(q):
                if r.rid == rid:
                    q.remove(r)
                    return True
        return False

    def outstanding_rids(self):
        return [r.rid for r in self.active + self.ready]

    def queued_rids(self):  # movable at zero cost (spawn-time rebalance)
        return [r.rid for r in self.ready]

    def backlog_tokens(self):
        return float(
            sum(r.max_new - len(r.tokens) for r in self.active)
            + sum(r.max_new for r in self.ready)
        )

    @property
    def idle(self):
        return not self.active and not self.ready

    def _admit(self):
        while self.ready and len(self.active) < self.batch:
            r = self.ready.pop(0)
            r.submitted = 0.0
            self.active.append(r)

    def _serve(self, n):
        for r in list(self.active):
            for _ in range(n):
                r.tokens.append(1)
                if len(r.tokens) >= r.max_new:
                    r.finished = time.perf_counter()
                    self.active.remove(r)
                    self.done.append(r)
                    break

    def tick(self):
        self._admit()
        if not self.active:
            return "done"
        self._serve(self.speed)
        self.tok_rate = float(self.speed)
        self.peak_rate = max(self.peak_rate, self.tok_rate)
        return "step"

    def stats(self):
        return {"completed": len(self.done)}


class _StallingReplica(_StubReplica):
    """One healthy tick, then its measured rate collapses and it finishes
    nothing more."""

    def __init__(self):
        super().__init__(2)
        self.n = 0

    def tick(self):
        self.n += 1
        if self.n > 1:
            self.tok_rate = 0.05  # EMA collapse: observably degraded
            return "step"
        return super().tick()


class _Premeasured(_StubReplica):
    """Opens its session with its rate already measured."""

    def start(self, requests, prompt_len=None, t0=None):
        super().start(requests, prompt_len, t0)
        self.tok_rate = float(self.speed)
        self.peak_rate = float(self.speed)


class _DegradedStub(_Premeasured):
    """Measured peak 4, current EMA 0.05; serves `serve` tokens per request
    per tick (0: a stuck straggler)."""

    def __init__(self, serve=0):
        super().__init__(4)
        self.serve = serve

    def start(self, requests, prompt_len=None, t0=None):
        super().start(requests, prompt_len, t0)
        self.tok_rate = 0.05
        self.peak_rate = 4.0

    def tick(self):
        self._admit()
        self._serve(self.serve)
        return "step"


class _EpsilonStalled(_StubReplica):
    """Measures an epsilon rate and never finishes anything."""

    def __init__(self):
        super().__init__(1)

    def tick(self):
        self._admit()
        self.tok_rate = 1e-13
        self.peak_rate = max(self.peak_rate, 1e-12)
        return "step"


class _WallClockSlow(_Premeasured):
    """One token per active request every `serve_dt` wall seconds, EMA 0.8
    of its measured peak 1.0 while serving; cold at start."""

    def __init__(self, serve_dt=0.015):
        super().__init__(1)
        self.serve_dt = serve_dt
        self._last = None

    def start(self, requests, prompt_len=None, t0=None):
        super().start(requests, prompt_len, t0)
        self.tok_rate = 0.0
        self.peak_rate = 0.0

    def tick(self):
        self._admit()
        if self.active:
            self.peak_rate = 1.0
            self.tok_rate = 0.8
            now = time.perf_counter()
            if self._last is None or now - self._last >= self.serve_dt:
                self._last = now
                self._serve(1)
        return "step"


class _HolderStub(_Premeasured):
    """Pre-measured stub advertising session residency."""

    def __init__(self, speed, resident=()):
        super().__init__(speed)
        self._resident = set(resident)

    def resident_sessions(self):
        return frozenset(self._resident)


def _scripted(pkg, script):
    """An autoscaler of ``pkg`` that returns the decisions of ``script``
    (action, replica id), then holds."""

    class Scripted(pkg.autoscale.Autoscaler):
        name = "scripted"

        def __init__(self):
            self._i = 0

        def reset(self):
            self._i = 0

        def decide(self, view):
            d = (pkg.autoscale.ScaleDecision(*script[self._i]) if self._i < len(script)
                 else pkg.autoscale.ScaleDecision(pkg.autoscale.HOLD))
            self._i += 1
            return d

    return Scripted()


def _mk(pkg, n, gen=8, **kw):
    return [pkg.Request(i, np.zeros(4, np.int32), gen, **kw) for i in range(n)]


def _class0(pkg, n, gen=8):
    return _mk(pkg, n, gen, slo_class=0, deadline_s=30.0)


# Each scenario: (build(pkg) -> (FleetLoop, requests), the reference test's
# asserts, whether it is free of wall-clock cadence). The FleetLoop tests of
# the JAX package that each one mirrors are named beside it.
def _check_spread(s, f, reqs):
    assert s["completed"] == 12 and s["rejected"] == 0
    assert all(n > 0 for n in s["routed_per_replica"])  # spread, not piled


def _check_rescue(s, f, reqs):
    assert s["completed"] == 8
    assert s["redispatched"] > 0
    assert s["completed_per_replica"] == [8, 0]  # rescued to the healthy one
    assert sum(s["completed_per_replica"]) == s["completed"]


def _check_grow(s, f, reqs):
    assert s["completed"] == 16 and s["rejected"] == 0
    assert s["spawned"] >= 1
    assert s["rebalanced"] >= 1  # spawned capacity absorbed the queue
    assert sum(s["completed_per_replica"]) == 16
    assert sum(s["completed_per_replica"][1:]) > 0
    assert s["autoscaler"] == "backlog_threshold"


def _check_scripted_drain(s, f, reqs):
    assert s["completed"] == 10
    assert s["spawned"] == 1 and s["drained"] == 1
    assert s["pool_final"] == 1  # the drained spawn retired
    assert sum(s["completed_per_replica"]) == 10


def _check_hedge_win(s, f, reqs):
    assert s["completed"] == 2
    assert s["hedged"] == 1 and s["hedge_wins"] == 1
    assert s["duplicate_tokens"] == 0  # the stuck primary generated none
    assert s["completed_per_replica"] == [2, 0]
    assert all(r.finished >= 0 and len(r.tokens) == r.max_new for r in reqs)


def _check_hedge_loser(s, f, reqs):
    assert s["completed"] == 2
    assert s["hedged"] == 1 and s["hedge_wins"] == 0
    assert sum(s["completed_per_replica"]) == 2
    assert all(r.finished >= 0 and len(r.tokens) == r.max_new for r in reqs)


def _check_epsilon_floor(s, f, reqs):
    assert s["completed"] == 2
    assert s["redispatched"] >= 1  # the floor made the rescue possible
    assert all(est is not None and est < 60.0 for est in f._est_s.values())
    assert all(r.finished >= 0 and len(r.tokens) == r.max_new for r in reqs)


def _check_cold_slow(s, f, reqs):
    assert s["completed"] == 2
    assert s["redispatched"] == 0  # the slow replica served its own request
    assert s["completed_per_replica"] == [1, 1]
    fast_floor_est = 8.0 / (8.0 * f.headroom)
    ests = [v for v in f._est_s.values() if v is not None]
    assert any(est >= 1.4 * fast_floor_est for est in ests), ests


def _check_typed(s, f, reqs):
    assert s["completed"] == 6
    assert s["replica_types"] == ["fast", "slow"]
    want = (s["replica_seconds"] / 2 * autoscale.get_replica_type("fast").price
            + s["replica_seconds"] / 2 * autoscale.get_replica_type("slow").price)
    assert abs(s["cost"] - want) < 1e-6
    assert abs(sum(s["cost_by_type"].values()) - s["cost"]) < 1e-9


def _check_untyped(s, f, reqs):
    assert s["completed"] == 4
    assert abs(s["cost"] - s["replica_seconds"]) < 1e-9  # untyped: cost is replica-seconds
    assert s["cost_by_type"] == {"default": s["cost"]}


def _check_affinity(s, f, reqs):
    assert s["completed"] == 2
    # the follow-up landed on the slow holder; the sessionless request went
    # capacity-weighted to the fast replica
    assert s["routed_per_replica"] == [1, 1]


def _affinity_requests(pkg):
    return [pkg.Request(0, np.zeros(4, np.int32), 8, session_id=5), pkg.Request(1, np.zeros(4, np.int32), 8)]


SCENARIOS = {
    # test_router.py::test_fleet_loop_routes_and_rescues_with_stub_replicas
    "router_spread": (lambda p: (p.fleet.FleetLoop(
        [_StubReplica(4), _StubReplica(2), _StubReplica(1)], router="capacity_weighted",
        admission="admit_all", redispatch=True, probe_s=0.0), _mk(p, 12)), _check_spread, True),
    "router_rescue": (lambda p: (p.fleet.FleetLoop(
        [_StubReplica(2), _StallingReplica()], router="round_robin", admission=None,
        redispatch=True, probe_s=0.0, late_factor=0.5), _mk(p, 8)), _check_rescue, False),
    # test_autoscale.py::test_fleet_loop_grows_rebalances_and_drains_with_stubs
    "autoscale_grow": (lambda p: (p.fleet.FleetLoop(
        [_StubReplica(1, batch=1)], router="capacity_weighted", admission=None, redispatch=False,
        scale_check_s=0.0, autoscale=p.autoscale.BacklogThresholdScaler(
            grow_backlog_s=2.0, shrink_backlog_s=0.5, sustain_s=0.0, cooldown_s=0.0,
            min_replicas=1, max_replicas=3),
        replica_factory=lambda: _StubReplica(4, batch=2)), _mk(p, 16, gen=16)), _check_grow, True),
    # test_autoscale.py::test_fleet_loop_scripted_drain_retires_idle_replica
    "autoscale_scripted_drain": (lambda p: (p.fleet.FleetLoop(
        [_StubReplica(2, batch=2)], router="round_robin", admission=None, redispatch=False,
        scale_check_s=0.0, autoscale=_scripted(p, [("grow",), ("shrink", 1)]),
        replica_factory=lambda: _StubReplica(2, batch=2)), _mk(p, 10, gen=12)), _check_scripted_drain, True),
    # test_hedge.py::test_fleet_hedge_win_rescues_degraded_primary
    "hedge_win": (lambda p: (p.fleet.FleetLoop(
        [_Premeasured(2), _DegradedStub(serve=0)], router="class_reserved", redispatch=False,
        hedge=True), _class0(p, 2)), _check_hedge_win, True),
    # test_hedge.py::test_fleet_hedge_loser_clone_is_cancelled_not_counted
    "hedge_loser": (lambda p: (p.fleet.FleetLoop(
        [_Premeasured(1), _DegradedStub(serve=8)], router="class_reserved", redispatch=False,
        hedge=True), _class0(p, 2)), _check_hedge_loser, True),
    # test_hedge.py::test_fleet_premeasurement_estimate_floor_rescues_stalled_dispatch
    "hedge_epsilon_floor": (lambda p: (p.fleet.FleetLoop(
        [_EpsilonStalled(), _Premeasured(4)], router="round_robin", redispatch=True, probe_s=0.0,
        late_factor=0.001), _class0(p, 2)), _check_epsilon_floor, False),
    # test_pool.py::test_fleet_cold_slow_replica_backfills_by_its_own_type
    "pool_cold_slow": (lambda p: (p.fleet.FleetLoop(
        [_Premeasured(8), _WallClockSlow()], replica_types=("fast", "slow"), router="round_robin",
        redispatch=True, probe_s=0.0, late_factor=0.1), _class0(p, 2)), _check_cold_slow, False),
    # test_pool.py::test_fleet_loop_typed_stats_and_untyped_identity
    "pool_typed": (lambda p: (p.fleet.FleetLoop(
        [_Premeasured(2), _Premeasured(1)], replica_types=("fast", "slow"), router="shortest_backlog",
        redispatch=False), _class0(p, 6)), _check_typed, True),
    "pool_untyped": (lambda p: (p.fleet.FleetLoop(
        [_Premeasured(2)], router="shortest_backlog", redispatch=False), _class0(p, 4)), _check_untyped, True),
    # test_affinity.py::test_fleetloop_routes_by_stub_resident_sessions
    "affinity_holder": (lambda p: (p.fleet.FleetLoop(
        [_HolderStub(8), _HolderStub(2, resident={5})], router="affinity", redispatch=False),
        _affinity_requests(p)), _check_affinity, True),
}
# what follows each host's clock: left out where two FleetLoops are compared
CLOCKED = ("wall_s", "tokens_per_s", "mean_latency_s", "replica_seconds", "cost", "cost_by_type")


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_fleet_loop_stub_scenario(name):
    build, check, _ = SCENARIOS[name]
    f, reqs = build(PORT)
    stats = f.run_requests(reqs)
    check(stats, f, reqs)


@pytest.mark.parametrize("name", [n for n, s in SCENARIOS.items() if s[2]])
def test_fleet_loop_stub_scenario_stats_equal_jax(ref, name):
    build = SCENARIOS[name][0]
    out = {}
    for pkg in (PORT, ref):
        f, reqs = build(pkg)
        stats = f.run_requests(reqs)
        out[pkg.name] = ({k: v for k, v in stats.items() if k not in CLOCKED}, [r.tokens for r in reqs])
    assert out["port"] == out["jax"]


def test_fleet_loop_resolves_policies_from_shared_registries():
    loop = fleet.FleetLoop([_StubReplica(2)], router="capacity_weighted", admission="slo_classes",
                           autoscale="backlog_threshold")
    assert isinstance(router.get_router(loop.router), router.CapacityWeightedRouter)
    assert isinstance(admission.get_policy(loop.admission), admission.SloClassesPolicy)
    assert isinstance(autoscale.get_autoscaler(loop.autoscale), autoscale.BacklogThresholdScaler)
    pre = router.ShortestBacklogRouter()
    resolved = router.get_router(fleet.FleetLoop([_StubReplica(2)], router=pre).router)
    assert isinstance(resolved, router.ShortestBacklogRouter) and resolved is not pre
    pre_asc = autoscale.BacklogThresholdScaler(grow_backlog_s=11.0)
    resolved = autoscale.get_autoscaler(fleet.FleetLoop([_StubReplica(2)], autoscale=pre_asc).autoscale)
    assert resolved is not pre_asc and resolved.grow_backlog_s == 11.0
    with pytest.raises(ValueError):
        fleet.FleetLoop([], router="round_robin")


def test_fleet_loop_add_drain_and_typed_factories():
    """add_replica/drain_replica are public pool hooks; a typed factory
    registry spawns by type; replica_types must parallel the pool."""
    loop = fleet.FleetLoop([_StubReplica(2)], replica_factory=lambda: _StubReplica(2))
    assert loop.add_replica() == 1
    assert len(loop.replicas) == 2
    assert loop.drain_replica(1) is True
    assert loop.drain_replica(1) is False  # already draining
    assert loop.drain_replica(7) is False  # out of range
    with pytest.raises(ValueError):
        fleet.FleetLoop([_StubReplica(2)]).add_replica()
    built = []
    typed = fleet.FleetLoop([_Premeasured(2)], replica_types=("fast",), redispatch=False,
                            replica_factory={k: (lambda k=k: built.append(k) or _Premeasured(2))
                                             for k in ("fast", "spot")})
    i = typed.add_replica("spot")
    assert built == ["spot"] and typed._rtype[i] == "spot"
    with pytest.raises(ValueError):
        typed.add_replica("tpu_v9")
    with pytest.raises(ValueError):
        fleet.FleetLoop([_Premeasured(1)], replica_types=("fast", "slow"))


# ------------------------------------------------- real replicas, both packages

SMOKE = "qwen3-1.7b-smoke"
RUN = RunConfig(remat="none", attention_impl="pallas", decode_attention_impl="kernel")
LENS = (8, 12)
GEN, MAX_LEN = 8, 32


def _prompts(vocab, n=6):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, LENS[i % len(LENS)]).astype(np.int32) for i in range(n)]


def test_real_fleet_streams_equal_jax_fleet_and_lone_replica(ref):
    """qwen3-1.7b-smoke, fp32, greedy, 2 replicas x arena batch 2, 6
    requests: every rid's tokens equal between the JAX package's fleet and
    the port's (bridged weights), and equal to a lone port replica's.
    Routing counts may differ: they follow each host's clock."""
    jcfg = dataclasses.replace(jax_get_config(SMOKE), compute_dtype="float32")
    jparams = JM.init_model(jax.random.PRNGKey(0), jcfg)
    prompts = _prompts(jcfg.vocab_size)
    jreqs = [jax_serve.Request(i, p, GEN) for i, p in enumerate(prompts)]
    jstats = jax_fleet.build_fleet(jcfg, JaxRunConfig(remat="none", attention_impl="xla"), jparams, 2, 2,
                                   MAX_LEN).run_requests(jreqs)
    cfg = dataclasses.replace(get_config(SMOKE), compute_dtype="float32")
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    reqs = [serve.Request(i, p, GEN) for i, p in enumerate(prompts)]
    f = fleet.build_fleet(cfg, RUN, params, 2, 2, MAX_LEN, device="cpu")
    stats = f.run_requests(reqs)
    lone = [serve.Request(i, p, GEN) for i, p in enumerate(prompts)]
    serve.ServeLoop(cfg, RUN, params, batch=2, max_len=MAX_LEN, device="cpu").run_requests(lone)
    assert jstats["completed"] == stats["completed"] == 6
    assert sum(stats["completed_per_replica"]) == 6 and sum(stats["routed_per_replica"]) == 6
    assert all(len(r.tokens) == GEN for r in reqs)
    assert [r.tokens for r in reqs] == [r.tokens for r in jreqs] == [r.tokens for r in lone]
    # one copy of the weights: every replica holds the same tensors
    assert all(rep.params is params for rep in f.replicas)


def test_main_serves_every_request_on_cpu():
    stats = fleet.main(["--arch", SMOKE, "--replicas", "2", "--requests", "6", "--prompt-len", "16",
                        "--gen", "8", "--device", "cpu"])
    assert stats["completed"] == 6 and sum(stats["completed_per_replica"]) == 6


def test_cuda_without_a_card_raises(monkeypatch):
    """No silent CPU: the fleet's replicas and its entry point raise where
    no card is present."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config(SMOKE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet.build_fleet(cfg, RUN, None, 2, 2, MAX_LEN, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet.main(["--arch", SMOKE, "--device", "cuda"])
