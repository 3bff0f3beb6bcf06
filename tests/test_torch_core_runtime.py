"""The port's cluster-runtime modules on the CPU, decision for decision
against ``repro.core`` on seeded inputs: capacity, placement, replication,
heartbeat, namespace, tuning, the slot schedulers, the single-job simulator
with and without speculation, and the locality sampler.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest

from repro_torch.configs import hadoop_cluster as hc
from repro_torch.core import capacity, heartbeat, namespace, placement, replication, scheduler, simulator, tuning
from repro_torch.core.topology import Location, Topology
from repro_torch.data import sampler
from torch_sim_golden import plain

try:
    import jax  # noqa: F401

    from repro.configs import hadoop_cluster as jax_hc
    from repro.core import capacity as jax_capacity
    from repro.core import heartbeat as jax_heartbeat
    from repro.core import namespace as jax_namespace
    from repro.core import placement as jax_placement
    from repro.core import replication as jax_replication
    from repro.core import scheduler as jax_scheduler
    from repro.core import simulator as jax_simulator
    from repro.core import topology as jax_topology
    from repro.core import tuning as jax_tuning
    from repro.data import sampler as jax_sampler
except ImportError:  # the card's machine has no JAX
    jax = None


@pytest.fixture
def ref():
    """The JAX package's side of a parity test."""
    if jax is None:
        pytest.skip("JAX is not installed: the reference side of this test is missing")
    return types.SimpleNamespace(
        hc=jax_hc, capacity=jax_capacity, heartbeat=jax_heartbeat, namespace=jax_namespace,
        placement=jax_placement, replication=jax_replication, scheduler=jax_scheduler,
        simulator=jax_simulator, topology=jax_topology, tuning=jax_tuning, sampler=jax_sampler)


PORT = types.SimpleNamespace(
    hc=hc, capacity=capacity, heartbeat=heartbeat, namespace=namespace, placement=placement,
    replication=replication, scheduler=scheduler, simulator=simulator,
    topology=types.SimpleNamespace(Location=Location, Topology=Topology), tuning=tuning, sampler=sampler)


def _both(ref, fn):
    """``fn`` run on the port's modules and on the reference's, as plain values."""
    return plain(fn(PORT)), plain(fn(ref))


# ------------------------------------------------------ config, nameplate


def test_paper_constants_equal_reference(ref):
    names = [n for n in dir(ref.hc) if n.isupper() and not n.startswith("TPU_")]
    assert names and [plain(getattr(hc, n)) for n in names] == [plain(getattr(ref.hc, n)) for n in names]
    assert list(hc.NODE_CONFIGS) == list(ref.hc.NODE_CONFIGS)
    for name, cfg in hc.NODE_CONFIGS.items():
        rcfg = ref.hc.NODE_CONFIGS[name]
        assert plain(cfg) == plain(rcfg)
        assert (cfg.relative_compute, cfg.disk_bw_mbps) == (rcfg.relative_compute, rcfg.disk_bw_mbps)
    assert not [n for n in dir(hc) if n.startswith("TPU")]


def test_nameplate_defaults_are_the_h100s():
    node = capacity.NodeProfile("n")
    assert (node.flops, node.hbm_bw, node.link_bw) == (
        hc.H100_PEAK_FLOPS_BF16, hc.H100_HBM_BPS, hc.H100_NVLINK_BPS) == (989e12, 3.35e12, 900e9)
    assert capacity.PodProfile("p", [node]).ici_bw == hc.H100_NVLINK_BPS
    assert Topology(1, 1).local_bw == hc.H100_HBM_BPS


@pytest.mark.parametrize("seed", range(3))
def test_profiles_with_explicit_figures_equal_reference(ref, seed):
    """With the same figures given, the profiles compute the reference's
    ``effective_flops``; the figures are taken from the reference's own
    profiles, so no golden or simulator path depends on the defaults."""
    rng = np.random.default_rng(seed)
    speeds = [float(s) for s in rng.uniform(0.2, 2.0, size=3)]
    rpods = ref.capacity.heterogeneous_fleet(speeds, nodes_per_pod=5, chips_per_node=int(rng.integers(1, 9)))
    for rpod in rpods:
        nodes = [capacity.NodeProfile(n.name, flops=n.flops, hbm_bw=n.hbm_bw, link_bw=n.link_bw, chips=n.chips,
                                      speed_factor=n.speed_factor) for n in rpod.nodes]
        pod = capacity.PodProfile(rpod.name, nodes, ici_bw=rpod.ici_bw, dcn_bw=rpod.dcn_bw)
        assert [n.effective_flops for n in nodes] == [n.effective_flops for n in rpod.nodes]
        assert pod.effective_flops == rpod.effective_flops
    mine = capacity.heterogeneous_fleet(speeds, nodes_per_pod=5, chips_per_node=rpods[0].nodes[0].chips)
    assert [[(n.name, n.chips, n.speed_factor) for n in p.nodes] for p in mine] == [
        [(n.name, n.chips, n.speed_factor) for n in p.nodes] for p in rpods]


@pytest.mark.parametrize("seed", range(3))
def test_capacity_estimator_equal_reference(ref, seed):
    def run(m):
        rng = np.random.default_rng(seed)
        est = m.capacity.CapacityEstimator(alpha=float(rng.uniform(0.1, 0.9)))
        ws = [f"w{i}" for i in range(6)]
        for w in ws[:4]:
            est.register(w, float(rng.uniform(0.5, 4.0)))
        out = []
        for _ in range(60):
            w = ws[int(rng.integers(len(ws)))]
            out.append(est.update(w, float(rng.uniform(0, 8)), float(rng.choice([0.0, rng.uniform(0.1, 5)]))))
            if rng.random() < 0.05:
                est.drop(ws[int(rng.integers(len(ws)))])
            out.append((est.capacities(ws), est.relative(ws)))
        return out

    mine, theirs = _both(ref, run)
    assert mine == theirs


# ------------------------------------------------------------- placement


@pytest.mark.parametrize("seed", range(6))
def test_placement_equal_reference(ref, seed):
    def run(m):
        rng = np.random.default_rng(seed)
        pods, nodes, r = int(rng.integers(1, 4)), int(rng.integers(1, 6)), int(rng.integers(1, 4))
        topo = m.topology.Topology(num_pods=pods, nodes_per_pod=nodes)
        workers = topo.workers()
        caps = [float(c) for c in rng.uniform(0.05, 4.0, size=len(workers))]
        grains = [m.placement.Grain(i, int(rng.integers(1, 64)) << 20, float(rng.uniform(0.5, 3.0)))
                  for i in range(int(rng.integers(1, 150)))]
        out = [m.placement.proportional_counts(caps, len(grains)),
               m.placement.uniform_counts(len(workers), len(grains))]
        for proportional in (True, False):
            plan = m.placement.plan_placement(grains, workers, caps, topo, r, proportional=proportional)
            a = m.placement.locality_aware_assignment(grains, plan, workers, caps, topo)
            out += [plan, a, a.makespan_s]
        return out

    mine, theirs = _both(ref, run)
    assert mine == theirs


@pytest.mark.parametrize("seed", range(6))
def test_het_accumulation_schedule_equal_reference(ref, seed):
    def run(m):
        rng = np.random.default_rng(seed)
        out = []
        for _ in range(20):
            caps = [float(c) for c in rng.uniform(0.01, 100.0, size=int(rng.integers(1, 12)))]
            total = int(rng.integers(len(caps), 300))
            s = m.placement.het_accumulation_schedule(caps, total, min_per_pod=int(rng.integers(0, 3)))
            out.append((s, s.total))
        return out

    mine, theirs = _both(ref, run)
    assert mine == theirs


# ----------------------------------------------------------- replication


@pytest.mark.parametrize("seed", range(4))
def test_replica_manager_recovery_equal_reference(ref, seed):
    def run(m):
        rng = np.random.default_rng(seed)
        topo = m.topology.Topology(num_pods=3, nodes_per_pod=int(rng.integers(2, 5)))
        workers = topo.workers()
        grains = [m.placement.Grain(i, int(rng.integers(1, 32)) << 20) for i in range(40)]
        caps = [float(c) for c in rng.uniform(0.3, 3.0, size=len(workers))]
        plan = m.placement.plan_placement(grains, workers, caps, topo, 3)
        use_caps = dict(zip(workers, caps)) if seed % 2 else None
        mgr = m.replication.ReplicaManager(plan, {g.gid: g.nbytes for g in grains}, topo, 3, capacities=use_caps)
        out = []
        for k in rng.permutation(len(workers))[:3]:
            out.append(mgr.fail_worker(workers[int(k)]))
            out.append((mgr.under_replicated(), mgr.lost()))
            out.append(mgr.recover())
            out.append((mgr.under_replicated(), mgr.lost(), [mgr.live_replicas(g.gid) for g in grains]))
        out.append((mgr.creation_cost_s(0, src_bw=2e11), mgr.storage_overhead()))
        return out

    mine, theirs = _both(ref, run)
    assert mine == theirs


def test_striping_and_creation_cost_equal_reference(ref):
    for k, m_ in ((4, 2), (6, 3), (10, 4)):
        a, b = replication.StripingScheme(k, m_), ref.replication.StripingScheme(k, m_)
        assert (a.storage_overhead(), a.recovery_bytes(128 << 20, 2), a.tolerable_failures()) == (
            b.storage_overhead(), b.recovery_bytes(128 << 20, 2), b.tolerable_failures())
    assert replication.replication_recovery_bytes(1 << 27) == ref.replication.replication_recovery_bytes(1 << 27)
    topo = Topology(2, 2)
    grains = [placement.Grain(i, 8 << 20) for i in range(4)]
    plan = placement.plan_placement(grains, topo.workers(), [1.0] * 4, topo, 3)
    mgr = replication.ReplicaManager(plan, {g.gid: g.nbytes for g in grains}, topo, 3)
    # the default source rate is the H100's HBM rate
    assert mgr.creation_cost_s(0) == mgr.creation_cost_s(0, src_bw=hc.H100_HBM_BPS)
    assert mgr.creation_cost_s(0) < grains[0].nbytes * mgr.r / hc.H100_HBM_BPS


# ------------------------------------------------------------- heartbeat


@pytest.mark.parametrize("seed", range(4))
def test_heartbeat_monitor_equal_reference(ref, seed):
    def run(m):
        rng = np.random.default_rng(seed)
        dead = []
        mon = m.heartbeat.HeartbeatMonitor(interval_s=3.0, dead_after_s=float(rng.choice([30.0, 60.0, 600.0])),
                                           on_dead=lambda w, t: dead.append((w, t)))
        ws = [f"w{i}" for i in range(8)]
        for w in ws:
            mon.register(w, 0.0, nameplate=float(rng.uniform(0.5, 2.0)))
        silent_from = {w: float(rng.uniform(50, 900)) if rng.random() < 0.4 else 1e9 for w in ws}
        out = []
        cmds = list(m.heartbeat.Command)
        for t in np.arange(0.0, 1200.0, 3.0):
            t = float(t)
            for w in ws:
                if rng.random() < 0.05:
                    mon.enqueue(w, cmds[int(rng.integers(len(cmds)))], gid=int(rng.integers(100)))
                if t < silent_from[w] or rng.random() < 0.01:
                    reply = mon.beat(m.heartbeat.Heartbeat(w, t, grains_done=float(rng.uniform(0, 4)),
                                                            elapsed_s=3.0))
                    out.append((w, t, reply))
            out.append(("sweep", t, mon.sweep(t), mon.alive(t)))
            if rng.random() < 0.01:
                w = ws[int(rng.integers(len(ws)))]
                if not mon.is_alive(w):
                    mon.revive(w, t)
                else:
                    mon.pronounce(w, t)
        out.append((dead, mon.capacity.capacities(ws)))
        return out

    mine, theirs = _both(ref, run)
    assert mine == theirs


def test_command_and_heartbeat_types_equal_reference(ref):
    assert [(c.name, c.value) for c in heartbeat.Command] == [(c.name, c.value) for c in ref.heartbeat.Command]
    assert [f.name for f in dataclasses.fields(heartbeat.Heartbeat)] == [
        f.name for f in dataclasses.fields(ref.heartbeat.Heartbeat)]


# ------------------------------------------------------------- namespace


@pytest.mark.parametrize("shards", [1, 3, 8])
def test_namespace_equal_reference(ref, shards):
    def run(m):
        rng = np.random.default_rng(shards)
        ns = m.namespace.ShardedNamespace(shards=shards, ram_bytes_per_shard=200 * 400)
        out = []
        made = []
        for i in range(300):
            name = f"dir{i % 7}/file_{int(rng.integers(1 << 20))}"
            try:
                f = ns.create_file(name, nbytes=int(rng.integers(1, 600)) << 20, block_size=128 << 20,
                                   replication=int(rng.integers(1, 4)))
                made.append(name)
                out.append((name, f))
            except (MemoryError, ValueError, KeyError) as e:
                out.append((name, type(e).__name__))
            if made and rng.random() < 0.1:
                ns.delete_file(made.pop(int(rng.integers(len(made)))))
        out.append([(s.objects, s.memory_bytes(), sorted(s.files)) for s in ns.shards])
        out.append((ns.objects, ns.memory_bytes(), ns.max_client_rps(0.2), ns.imbalance()))
        single = m.namespace.Namespace(ram_bytes=1 << 30)
        f = single.create_file("x", nbytes=(3 << 27) + 5, block_size=128 << 20)
        out.append((f, single.block_report("w0", [(f.blocks[0], 128 << 20, 1), (9999, 1, 0)]),
                    single.memory_headroom(), m.namespace.Namespace.ram_needed(10**6, 2.0),
                    m.namespace.Namespace.gb_per_million_blocks()))
        return out

    mine, theirs = _both(ref, run)
    assert mine == theirs


# ---------------------------------------------------------------- tuning


def test_tune_equal_reference(ref):
    def run(m):
        rng = np.random.default_rng(0)
        out = []
        for _ in range(200):
            inp = m.tuning.TuningInput(
                total_input_bytes=int(rng.integers(1 << 30, 40 << 40)), n_slots=int(rng.integers(1, 64)),
                est_grain_seconds=float(rng.uniform(0.1, 300.0)), grain_tokens=1 << int(rng.integers(8, 22)),
                n_reduce_slots=int(rng.integers(1, 32)))
            out.append(m.tuning.tune(inp))
        out.append(m.tuning.efficiency_curve(1e-3, 3.0, [2**i for i in range(8, 22)]))
        out.append(m.tuning.estimate_grain_seconds(1 << 16, 6e9, 4e14))
        return out

    mine, theirs = _both(ref, run)
    assert mine == theirs


# ------------------------------------------------------------ schedulers


@pytest.mark.parametrize("name", sorted(scheduler.SCHEDULERS))
def test_scheduler_decisions_equal_reference(ref, name):
    assert list(scheduler.SCHEDULERS) == list(ref.scheduler.SCHEDULERS)

    def run(m):
        rng = np.random.default_rng(len(name))
        sched = m.scheduler.SCHEDULERS[name]()
        out = []
        for step in range(300):
            jobs = [m.scheduler.JobView(
                job_id=j, submit_t=float(rng.uniform(0, 100)), n_pending=int(rng.integers(1, 20)),
                n_running=int(rng.integers(0, 8)), remaining_work=float(rng.uniform(0.0, 500.0)),
                alloc_capacity=float(rng.choice([0.0, rng.uniform(0.1, 10.0)])), slo_class=int(rng.integers(0, 3)),
                deadline_t=float(rng.choice([np.inf, rng.uniform(50, 400)])))
                for j in range(int(rng.integers(1, 7)))]
            worker = m.simulator.SimWorker(m.topology.Location(0, step % 4), float(rng.uniform(0.1, 2.0)))
            out.append(sched.select(float(step), jobs, worker))
        return out

    mine, theirs = _both(ref, run)
    assert mine == theirs


# ---------------------------------------------- single-job simulator, LATE


def _speculation_setup(m, het=True, straggler=True, fail=False, n_grains=64, cross_bw=2e9):
    topo = m.topology.Topology(num_pods=2, nodes_per_pod=8, in_pod_bw=50e9, cross_pod_bw=cross_bw)
    workers = [m.simulator.SimWorker(loc, 1.0 if (loc.pod == 0 or not het) else 0.4) for loc in topo.workers()]
    if straggler:
        workers[3].slow_at, workers[3].slow_factor = 10.0, 0.01
    if fail:
        workers[1].fail_at = 30.0
    grains = [m.placement.Grain(g, nbytes=8 << 30, work=20.0, remote_input=(g >= n_grains * 0.65))
              for g in range(n_grains)]
    plan = m.placement.plan_placement(grains, [w.loc for w in workers], [w.rate for w in workers], topo, 3)
    return topo, workers, grains, plan


@pytest.mark.parametrize("policy", ["off", "naive", "late"])
@pytest.mark.parametrize("regime", ["het+straggler", "homogeneous", "failure", "elastic"])
def test_run_job_equal_reference(ref, policy, regime):
    def run(m):
        kw = dict(het=regime != "homogeneous", straggler=regime != "homogeneous", fail=regime in ("failure", "elastic"))
        topo, workers, grains, plan = _speculation_setup(m, **kw)
        sim = m.simulator.SimCluster(workers, topo, dead_after_s=60.0)
        return sim.run_job(grains, plan, policy=policy, elastic=regime == "elastic")

    mine, theirs = _both(ref, run)
    assert mine == theirs


def test_late_rescues_stragglers_in_the_port():
    def run(policy):
        topo, workers, grains, plan = _speculation_setup(PORT)
        return simulator.SimCluster(workers, topo).run_job(grains, plan, policy=policy)

    off, naive, late = run("off"), run("naive"), run("late")
    assert off.completed == naive.completed == late.completed == 64
    assert late.makespan < off.makespan * 0.8
    assert late.makespan <= naive.makespan
    assert naive.n_speculative > late.n_speculative and naive.wasted_work >= 2.0 * late.wasted_work


# --------------------------------------------------------------- sampler


@pytest.mark.parametrize("seed", range(3))
def test_sampler_moved_bytes_equal_reference(ref, seed):
    def run(m):
        rng = np.random.default_rng(seed)
        topo = m.topology.Topology(num_pods=2, nodes_per_pod=3)
        workers = topo.workers()
        grains = [m.placement.Grain(i, int(rng.integers(1, 16)) << 20) for i in range(30)]
        caps = [float(c) for c in rng.uniform(0.3, 3.0, size=len(workers))]
        plan = m.placement.plan_placement(grains, workers, caps, topo, int(rng.integers(1, 3)))
        s = m.sampler.GrainSampler(grains, plan, topo)
        its = {w: s.pod_iterator(w) for w in workers}
        out = [s.local_gids(w) for w in workers]
        for _ in range(200):
            w = workers[int(rng.integers(len(workers)))]
            out.append(next(its[w]).gid)
        for _ in range(20):
            out.append(s.fetch(int(rng.integers(len(grains))), workers[int(rng.integers(len(workers)))]).gid)
        out.append((s.stats, s.locality_fraction()))
        return out

    mine, theirs = _both(ref, run)
    assert mine == theirs
