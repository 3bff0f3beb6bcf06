"""The simulator's stored golden hashes, and the fingerprints and cases they
pin, for the port (``repro_torch.core.workload``).

This is the port's one copy of ``tests/test_simperf.py``'s ``FLEET_CASES``,
``WORKLOAD_CASES``, ``FLEET_GOLDEN``, ``WORKLOAD_GOLDEN`` and fingerprint
functions (``tests/test_torch_sim.py`` asserts that they are equal). It
imports no JAX, so ``chip_smoke.py`` reads it on a machine that has none.
The case runners take the workload module to run, the port's or the
reference's; :func:`plain` turns a result of either into plain values, so
that the two packages' objects compare.
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib

# --------------------------------------------------------------- fingerprints


def _canon(v) -> str:
    return repr(v)


def _trace_lines(events) -> list[str]:
    return [
        f"{e.time!r}|{e.kind}|"
        + ",".join(f"{k}={_canon(v)}" for k, v in sorted(e.detail.items()))
        for e in events
    ]


def fleet_fingerprint(res) -> str:
    """sha256 over a fleet run's churn trace, every per-request decision and
    attempt record, and the summary counters."""
    lines = _trace_lines(res.trace)
    for r in res.requests:
        lines.append(
            f"req {r.rid}|{r.decision}|{r.admit_t!r}|{r.finish_t!r}"
            f"|{r.served_by}|"
            + ";".join(
                f"{d.replica}:{d.t!r}:{d.end_t!r}:{d.outcome}:{d.progress!r}"
                for d in r.dispatches
            )
        )
    lines.append(
        f"sum {res.makespan!r}|{res.completed}|{res.n_rejected}"
        f"|{res.n_deferred}|{res.n_redispatched}|{res.stranded}"
        f"|{res.wasted_work!r}|{res.n_hedged}|{res.n_hedge_wins}"
        f"|{res.duplicate_work!r}|{res.n_spawned}|{res.n_retired}"
        f"|{res.pool_peak}|{res.replica_seconds!r}"
        f"|{sorted(res.served_by.items())!r}"
    )
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()


def workload_fingerprint(res) -> str:
    """The ``run_workload`` mirror of :func:`fleet_fingerprint`: churn trace,
    per-job outcomes and summary counters."""
    lines = _trace_lines(res.churn)
    for j in res.jobs:
        lines.append(
            f"job {j.job_id}|{j.decision}|{j.admit_t!r}|{j.submit_t!r}"
            f"|{j.first_launch_t!r}|{j.finish_t!r}|{j.completed}|{j.n_tasks}"
        )
    lines.append(
        f"sum {res.makespan!r}|{res.completed}|{res.wasted_work!r}"
        f"|{res.moved_bytes!r}|{res.cross_pod_bytes!r}|{res.n_speculative}"
        f"|{res.n_spec_won}|{res.reassigned_after_failure}"
        f"|{res.re_replicated_bytes!r}|{res.re_replication_s!r}"
        f"|{res.n_re_replicated}|{res.n_admitted}|{res.n_rejected}"
        f"|{res.n_deferred}"
    )
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()


# ------------------------------------------------------------- golden cases
#
# One row per (preset × policy combination) the claims exercise; kwargs are
# run_fleet / run_workload arguments.

FLEET_CASES: dict[str, tuple[str, dict]] = {
    "hetero/cw": ("fleet_hetero", dict(router="capacity_weighted")),
    "hetero/rr": ("fleet_hetero", dict(router="round_robin")),
    "hetero/sb": ("fleet_hetero", dict(router="shortest_backlog")),
    "hetero/cw+admit_all": ("fleet_hetero", dict(admission="admit_all")),
    "hetero/cw+threshold": ("fleet_hetero", dict(admission="threshold")),
    "straggler/cw+rd": ("fleet_straggler", dict(router="capacity_weighted")),
    "straggler/rr-no-rd": ("fleet_straggler", dict(router="round_robin", redispatch=False)),
    "straggler/reserved+hedge": ("fleet_straggler", dict(router="class_reserved", hedge=True)),
    "straggler/cw+rd/seed1": ("fleet_straggler", dict(router="capacity_weighted", seed=1)),
    "churny/cw+token_bucket": ("fleet_churny", dict(router="capacity_weighted", admission="token_bucket")),
    "churny/sb+slo_classes": ("fleet_churny", dict(router="shortest_backlog", admission="slo_classes")),
    "churny/reserved+hedge": ("fleet_churny", dict(router="class_reserved", hedge=True)),
    "churny/cw+token_bucket/seed1": (
        "fleet_churny", dict(router="capacity_weighted", admission="token_bucket", seed=1)),
    "bursty/cw+backlog_threshold": ("fleet_bursty", dict(autoscale="backlog_threshold")),
    "bursty/token_bucket+backlog_threshold": (
        "fleet_bursty", dict(admission="token_bucket", autoscale="backlog_threshold")),
    "bursty/cw+fixed": ("fleet_bursty", dict(autoscale="fixed")),
    "diurnal/cw+backlog_threshold": ("fleet_diurnal", dict(autoscale="backlog_threshold")),
    "diurnal/sb+deadline_aware": ("fleet_diurnal", dict(router="shortest_backlog", autoscale="deadline_aware")),
    "spot/cw+rd": ("fleet_spot", dict(router="capacity_weighted")),
    "spot/reserved+hedge": ("fleet_spot", dict(router="class_reserved", hedge=True)),
    "spot/cw+cost_aware/seed2": ("fleet_spot", dict(router="capacity_weighted", autoscale="cost_aware", seed=2)),
    "sessions/affinity": ("fleet_sessions", dict(router="affinity")),
    "sessions/cw": ("fleet_sessions", dict(router="capacity_weighted")),
    "sessions/affinity+hedge": ("fleet_sessions", dict(router="affinity", hedge=True)),
    "sessions/affinity/seed1": ("fleet_sessions", dict(router="affinity", seed=1)),
    "spot_staged/cw+cost_aware": ("fleet_spot_staged", dict(router="capacity_weighted", autoscale="cost_aware")),
    "spot_staged/affinity+cost_aware/seed2": (
        "fleet_spot_staged", dict(router="affinity", autoscale="cost_aware", seed=2)),
}

WORKLOAD_CASES: dict[str, tuple[str, dict]] = {
    "hetero_2pod/fifo": ("hetero_2pod", dict(scheduler="fifo")),
    "hetero_2pod/capacity": ("hetero_2pod", dict(scheduler="capacity")),
    "homogeneous/capacity": ("homogeneous", dict(scheduler="capacity")),
    "shuffle_heavy/fifo": ("shuffle_heavy", dict(scheduler="fifo")),
    "faulty/capacity": ("faulty", dict(scheduler="capacity")),
    "churny_3pod/capacity+static": ("churny_3pod", dict(scheduler="capacity", elastic="static")),
    "churny_3pod/capacity+reproportion": ("churny_3pod", dict(scheduler="capacity", elastic="reproportion")),
    "overload_2pod/admit_all": ("overload_2pod", dict(scheduler="capacity", admission="admit_all")),
    "overload_2pod/slo_classes": ("overload_2pod", dict(scheduler="capacity", admission="slo_classes")),
    "churny_3pod_slo/token_bucket+reproportion": (
        "churny_3pod_slo", dict(scheduler="capacity", admission="token_bucket", elastic=True)),
}

FLEET_GOLDEN: dict[str, str] = {
    "bursty/cw+backlog_threshold": "4faee53629ade1ae73e3e2296173b7fa0f5b0dcb4b71737bec16bffede4997eb",
    "bursty/cw+fixed": "aa8a0359298942dd1dc27d7e69971c6dc1bc552b333e157e83e5f28f4bfa67ee",
    "bursty/token_bucket+backlog_threshold": "48e04dc4f9bb9ad22bd60f3ee932ccdec27d67dd761979966e36ec03b27f5a35",
    "churny/cw+token_bucket": "738fad60a058e0a0d270ba757178178df76e1765248b88725caf6fc98c71d472",
    "churny/cw+token_bucket/seed1": "e9deee7f188a4a13b262bb7245bd021a9a02caf652d89bc1db6c3a077ad6f6be",
    "churny/reserved+hedge": "782ccfbccae1468b49c9e479b4353f6460d9bd4d1ed511e681b0f0b10c80a62b",
    "churny/sb+slo_classes": "0da6d1d3925c4ca05068bfac9e7315c8a8d2ddd9a2f9cc037f6bb1e5f10c0ea4",
    "diurnal/cw+backlog_threshold": "62d37117e41b947475a0cf9333ecf3a5af3d2609d34ae1ffd307fde9c11d0338",
    "diurnal/sb+deadline_aware": "33abf27bbe48ed14d821c23440c6f32d7089737f73a350ffe0e9058203511e7d",
    "hetero/cw": "073aa34a64fac974d5a7eb8de43e238daaa749dbc8bec036760a7b1889417fbe",
    "hetero/cw+admit_all": "ba9c25f0edd88195f13061671d96ff892dcc807d70f4723c50b8d84c5e7a6a86",
    "hetero/cw+threshold": "ba9c25f0edd88195f13061671d96ff892dcc807d70f4723c50b8d84c5e7a6a86",
    "hetero/rr": "dce9a3d456b6e2b5f0cc1b05dabdcca06add71f56d6ca20b6f8021e64b31b966",
    "hetero/sb": "daec49a55fe69c0ebc474a7186839e78050107e2d4c8d27e4db9392f6da80f57",
    "sessions/affinity": "ba145338975e0a4026117df4786a14bdc8fdb972c0db290194391bed30ccb4fc",
    "sessions/affinity+hedge": "bce85c97a8de844afff99456bb632bfffe16447aedf276f8d806cedea3f76af3",
    "sessions/affinity/seed1": "a1ef16727c43e7f4b8b475da8e43ce07cc36193b34b73451596e389709077978",
    "sessions/cw": "65b5dc95b9ef3868399c5a81aa8bb35aaf35fedc3ed231530469cd9fcbfe9dc6",
    "spot/cw+cost_aware/seed2": "ddbe633e78a4367eba76ffa988a473e4207a8b64f4b56337a24b5fa390d7e1a8",
    "spot/cw+rd": "96d52d84edfc714f1e056284d67e19c3f9211443a3831ffc17e20e494e862c5f",
    "spot/reserved+hedge": "fb5b143cc60d6c590bf064d5c63a328d01d7f0a661d7818a2b84e0a127f00ec8",
    "spot_staged/affinity+cost_aware/seed2": "fbefad5466177b58c5c49c0a8c28977fd3834988f448322a7cdac500cc2da797",
    "spot_staged/cw+cost_aware": "b5a118edce56113ec56c55c3a19798f92c546e6405f61e190f14213f08f2f40b",
    "straggler/cw+rd": "85154c9f4e93a1bdd3d965beeba651c837b7a9ec6a4366d894d0489392ba919f",
    "straggler/cw+rd/seed1": "7bbf6167be4d8550f5a9da879307c36ea616339229ee7cea067e901e17d6872c",
    "straggler/reserved+hedge": "59367e26363714610c32ea5de74f99654802f67e4a3d5644ff80b3455b0c55c4",
    "straggler/rr-no-rd": "70fc9046eb91e56a4d107b36a793a9c3087c725b3b0658a5bf147e79cb8ce5b0",
}
WORKLOAD_GOLDEN: dict[str, str] = {
    "churny_3pod/capacity+reproportion": "c3271dfb971e05a226fc688a7ad40001f9511a67b9a7206cc259bf5afe94bbea",
    "churny_3pod/capacity+static": "405519e6f09d1ad40aed09228b5d5c74a86d9dcc6aa95e3740ef60321d77bae3",
    "churny_3pod_slo/token_bucket+reproportion": "862cdee96ac6c3203c162a8e2cd831ffe211e5d2da71ca50fb335722132255fe",
    "faulty/capacity": "72acc544596143e2b401beeaf020304712e3ea3c7cac37a620b40cd9813355c9",
    "hetero_2pod/capacity": "1d73701cf9b3b9252ae9e7ec63f55fead4a49dcb456b00bf2c6cb30b6d9aa78e",
    "hetero_2pod/fifo": "9acc40d1e22aa41c9aa9c917754f19e41b028ec3b34eb6ef425b8db85bd65dbf",
    "homogeneous/capacity": "7012db091a0580c192e8fca82b509484df5bb680fc75ed2588246472ac167e5a",
    "overload_2pod/admit_all": "c7b40a3c94d7b997fd26fbc86f960a8166c232889cb526ebeb51a8e9acf94694",
    "overload_2pod/slo_classes": "0df2662700487d901d05cbc999c9250d1448ccd81a438d88fd5a74f6f3fbc43f",
    "shuffle_heavy/fifo": "20efb26164bfc374f40e56e831f1af8c885d93ef5540184f90986789ea0ee9e0",
}

# The ``check_views=True`` cases, which compare the incremental accumulators
# with a brute-force re-sum by ``==``: (preset, seed, run_fleet kwargs).
# They are ``test_simperf.py``'s three tests at the first 15 and 10 seeds of
# its two property regimes, and its oldest-dispatch pair; Python's
# compensated ``sum`` breaks the equality on all but the straggler case.
CHECK_VIEWS_CASES: dict[str, tuple[str, int, dict]] = {
    **{f"accumulators/churny/seed{s}": ("fleet_churny", s, dict(router="class_reserved", hedge=True))
       for s in range(15)},
    **{f"accumulators_autoscale/bursty/seed{s}": (
        "fleet_bursty", s, dict(autoscale="backlog_threshold", admission="token_bucket")) for s in range(10)},
    "oldest_dispatch/straggler": ("fleet_straggler", 0, dict(router="class_reserved", hedge=True)),
    "oldest_dispatch/churny/seed2": ("fleet_churny", 2, {}),
}


def plain(x):
    """A value's fields, recursively, as tuples of names and reprs: an
    object of the port equals the reference's when every field does, though
    their classes differ."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple((f.name, plain(getattr(x, f.name))) for f in dataclasses.fields(x))
    if isinstance(x, dict):
        return ("dict",) + tuple((plain(k), plain(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return (type(x).__name__,) + tuple(plain(v) for v in x)
    if isinstance(x, (set, frozenset)):
        return ("set",) + tuple(sorted(repr(plain(v)) for v in x))
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name, x.value)
    return repr(x)


def run_fleet_case(workload, case: str, **extra):
    preset, kwargs = FLEET_CASES[case]
    kwargs = dict(kwargs)
    seed = kwargs.pop("seed", 0)
    return workload.run_fleet(preset, seed=seed, **kwargs, **extra)


def run_workload_case(workload, case: str):
    preset, kwargs = WORKLOAD_CASES[case]
    kwargs = dict(kwargs)
    seed = kwargs.pop("seed", 0)
    sim, jobs = workload.build_sim(preset, seed=seed)
    return sim.run_workload(jobs, **kwargs)


def run_check_views_case(workload, case: str):
    preset, seed, kwargs = CHECK_VIEWS_CASES[case]
    return workload.run_fleet(preset, seed=seed, check_views=True, **kwargs)
