"""The port's serving replica (``repro_torch.launch.serve``) on the CPU.

* Its arena token streams equal the JAX package's arena streams on
  bridged weights (fp32, greedy), through the plain path and through the
  kernel knobs (whose plain versions run on the CPU); on jamba-smoke (the
  Mamba-2 hybrid) in the arena and in serial mode too.
* Ports of the JAX package's serve tests (``test_serve_arena.py``, the
  serving tests of ``test_system.py``, the ServeLoop bookkeeping tests of
  ``test_affinity.py``, ``test_router.py`` and ``test_admission.py``).
* The copied admission policies decide as ``repro.core.admission`` does.

* The arena's captured decode step (``serve._capture`` replaced by a
  stand-in that reruns the step on its static buffers): the eager arena's
  streams bit for bit, a replay on every decode call, other arenas and
  unwarmed loops eager, and kernel launches counted once a replay.

The ``gpu``-marked tests run on the card, through the CUDA kernels and the
captured step, and skip elsewhere: the arena-vs-serial identity (dense,
MoE and Mamba cuts), the arena held once, and the kernel paths against the
plain ones.
"""

import dataclasses
import heapq
import math
import time

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.core import admission
from repro_torch.data.dataset import SyntheticCorpus
from repro_torch.launch.serve import Request, ServeLoop
from repro_torch.models import model as M

try:
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.configs.base import RunConfig as JaxRunConfig
    from repro.core import admission as jax_admission
    from repro.launch.serve import Request as JaxRequest
    from repro.launch.serve import ServeLoop as JaxServeLoop
    from repro.models import model as JM
except ImportError:  # the card's machine has no JAX: only the gpu test runs there
    jax = None


@pytest.fixture(autouse=True)
def _jax_reference(request):
    if jax is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("JAX is not installed: the reference side of this test is missing")


SMALL = dict(num_layers=2, d_model=64, vocab_size=64)
CFG = get_config("qwen3-1.7b").reduced(**SMALL)
RUN = RunConfig(attention_impl="xla")
KERNEL_RUN = RunConfig(attention_impl="pallas", decode_attention_impl="kernel")
LENS = (6, 9, 12, 15)  # one distinct position per slot: the cohort worst case


def _params(cfg=CFG):
    return M.init_model(cfg, torch.Generator().manual_seed(0))


def _requests(n: int, gen: int = 8, seed: int = 0, cls=Request) -> list:
    corpus = SyntheticCorpus(CFG.vocab_size, max(LENS), seed)
    return [cls(i, corpus.grain_tokens(i, 1)[0][: LENS[i % len(LENS)]], gen) for i in range(n)]


def _loop(params, mode: str, batch: int = 4, run=RUN, cfg=CFG) -> ServeLoop:
    return ServeLoop(cfg, run, params, batch=batch, max_len=32, mode=mode, device="cpu")


# ------------------------------------------------- parity with the JAX replica


@pytest.fixture(scope="module")
def jax_arena_streams():
    """The JAX package's arena streams, fp32, on its own seeded weights."""
    jcfg = dataclasses.replace(jax_get_config("qwen3-1.7b").reduced(**SMALL), compute_dtype="float32")
    jparams = JM.init_model(jax.random.PRNGKey(0), jcfg)
    reqs = _requests(7, cls=JaxRequest)
    loop = JaxServeLoop(jcfg, JaxRunConfig(remat="none", attention_impl="xla"), jparams,
                        batch=4, max_len=32, mode="arena")
    stats = loop.run_requests(reqs)
    assert stats["completed"] == 7
    return jax.tree.map(np.asarray, jparams), [r.tokens for r in reqs]


@pytest.mark.parametrize("run", [RUN, KERNEL_RUN], ids=["plain", "kernel-knobs"])
def test_arena_streams_equal_jax_arena(jax_arena_streams, run):
    jparams_np, jax_streams = jax_arena_streams
    cfg = dataclasses.replace(CFG, compute_dtype="float32")
    params = bridge.params_from_jax(jparams_np, cfg)
    reqs = _requests(7)
    stats = _loop(params, "arena", run=run, cfg=cfg).run_requests(reqs)
    assert stats["completed"] == 7
    assert [r.tokens for r in reqs] == jax_streams


JAMBA = "jamba-1.5-large-398b"


@pytest.fixture(scope="module")
def jamba_jax_streams():
    """jamba-smoke's JAX arena streams, fp32, on the JAX package's weights."""
    jcfg = dataclasses.replace(jax_get_config(JAMBA).reduced(vocab_size=SMALL["vocab_size"]), compute_dtype="float32")
    jparams = JM.init_model(jax.random.PRNGKey(0), jcfg)
    reqs = _requests(7, cls=JaxRequest)
    JaxServeLoop(jcfg, JaxRunConfig(remat="none", ssd_chunk=8), jparams, batch=4, max_len=32,
                 mode="arena").run_requests(reqs)
    return jax.tree.map(np.asarray, jparams), [r.tokens for r in reqs]


@pytest.mark.parametrize("mode", ["arena", "serial"])
def test_jamba_streams_equal_jax_arena(jamba_jax_streams, mode):
    """jamba-smoke (Mamba-2 and attention blocks, MoE every other layer) in
    fp32 on the JAX package's weights: seven requests through four slots
    give the JAX arena's greedy tokens, in the port's arena and in its
    serial reference. A join re-prefills its slot, so the reference's C8
    hazard (a parked row's Mamba state moves) does not reach the streams."""
    jparams_np, jax_streams = jamba_jax_streams
    cfg = dataclasses.replace(get_config(JAMBA).reduced(vocab_size=SMALL["vocab_size"]), compute_dtype="float32")
    params = bridge.params_from_jax(jparams_np, cfg)
    reqs = _requests(7)
    run = dataclasses.replace(KERNEL_RUN, ssd_chunk=8)
    stats = _loop(params, mode, run=run, cfg=cfg).run_requests(reqs)
    assert stats["completed"] == 7
    assert [r.tokens for r in reqs] == jax_streams


# ------------------------------------------- ports of tests/test_serve_arena.py


def test_arena_streams_bit_identical_to_serial():
    """Join/leave at token boundaries must not perturb any request's
    tokens: the arena path (slot reuse, active-mask parking, index writes)
    reproduces the serial reference."""
    params = _params()
    n = 7  # > batch: forces mid-session joins into reused slots
    serial = _requests(n)
    _loop(params, "serial").run_requests(serial)
    arena = _requests(n)
    stats = _loop(params, "arena").run_requests(arena)
    assert stats["completed"] == n
    assert [r.tokens for r in arena] == [r.tokens for r in serial]


def test_arena_one_dispatch_per_step_under_mixed_lengths():
    params = _params()
    arena = _loop(params, "arena").run_requests(_requests(8))
    cohort = _loop(params, "cohort").run_requests(_requests(8))
    assert arena["decode_steps"] == cohort["decode_steps"]  # same work
    assert arena["decode_calls"] * 2 <= cohort["decode_calls"]
    assert arena["slot_occupancy"] > 0.5
    assert cohort["slot_occupancy"] <= 0.3  # singleton groups: 1/batch each
    assert arena["mode"] == "arena" and cohort["mode"] == "cohort"
    assert arena["prefill_calls"] == 8


def test_cancel_mid_decode_frees_slot():
    params = _params()
    reqs = _requests(5, gen=12)
    loop = _loop(params, "arena")
    loop.start(reqs, t0=time.perf_counter())
    while loop.tick() != "done":
        active = [rid for rid in loop._slot_rid if rid is not None]
        if active and loop._cancelled == 0:
            assert loop.cancel(active[0])
            assert sum(rid is None for rid in loop._slot_rid) >= 1
    stats = loop.stats()
    assert stats["cancelled"] == 1
    assert stats["completed"] == 4
    done_rids = {r.rid for r in reqs if r.finished >= 0}
    assert len(done_rids) == 4
    assert all(len(r.tokens) == 12 for r in reqs if r.rid in done_rids)


def test_ttft_anchored_at_arrival_survives_slot_reuse():
    params = _params()
    n = 9  # > 2 full generations through 4 slots: every slot is reused
    reqs = _requests(n, gen=6)
    stats = _loop(params, "arena").run_requests(reqs)
    assert stats["completed"] == n
    for r in reqs:
        assert r.arrived >= 0 and r.first_token > r.arrived
        assert r.finished >= r.first_token
        assert r.submitted >= r.arrived
        assert r.first_token - r.arrived >= r.queue_wait - 1e-9
    assert max(r.queue_wait for r in reqs) > 0
    assert stats["mean_ttft_s"] >= stats["mean_queue_wait_s"] >= 0


# ------------------------------------------- ports of tests/test_system.py


def _system_requests(n):
    corpus = SyntheticCorpus(CFG.vocab_size, 16, 0)
    return [Request(i, corpus.grain_tokens(i, 1)[0], max_new=4) for i in range(n)]


def test_serve_loop_completes_requests():
    params = _params()
    reqs = _system_requests(5)
    stats = ServeLoop(CFG, RUN, params, batch=2, max_len=24, device="cpu").run_requests(reqs)
    assert stats["completed"] == 5
    assert all(len(r.tokens) == 4 for r in reqs)
    assert stats["mean_ttft_s"] >= 0
    assert stats["decode_calls"] < stats["decode_steps"]
    assert stats["mean_latency_s"] >= stats["mean_queue_wait_s"] >= 0


def test_serve_loop_admission_from_shared_registry():
    params = _params()
    loop = ServeLoop(CFG, RUN, params, batch=2, max_len=24, device="cpu",
                     admission=admission.ThresholdPolicy(max_backlog_s=1e-6))
    stats = loop.run_requests(_system_requests(4))
    assert stats["completed"] == 2 and stats["rejected"] == 2

    reqs_b = _system_requests(4)
    batched = ServeLoop(CFG, RUN, params, batch=2, max_len=24, device="cpu").run_requests(reqs_b)
    reqs_nb = _system_requests(4)
    ServeLoop(CFG, RUN, params, batch=2, max_len=24, batched=False, device="cpu").run_requests(reqs_nb)
    assert batched["completed"] == 4
    assert batched["decode_calls"] < sum(len(r.tokens) for r in reqs_b)
    pairs = [(a, b) for ra, rb in zip(reqs_b, reqs_nb) for a, b in zip(ra.tokens, rb.tokens)]
    assert sum(a == b for a, b in pairs) / len(pairs) > 0.9


# ------------------------------------------- bookkeeping (no model runs)


def _bare_loop(**kw):
    return ServeLoop(None, None, None, batch=2, max_len=8, device="cpu", **kw)


def test_serveloop_cancel_evicts_parked_session():
    """Port of test_affinity.py::test_serveloop_cancel_evicts_parked_session."""
    loop = _bare_loop(admission=None, warmup=False)
    loop.start([])
    s = heapq.heappop(loop._free_slots)
    loop._session_slot[42] = s
    assert loop.resident_sessions() == frozenset({42})
    loop.enqueue(Request(1, np.zeros(4, np.int32), 4, session_id=42))
    assert loop.cancel(1)
    assert loop.resident_sessions() == frozenset()
    assert sorted(loop._free_slots) == [0, 1]
    loop._session_slot[43] = heapq.heappop(loop._free_slots)
    loop.enqueue(Request(2, np.zeros(4, np.int32), 4))
    assert loop.cancel(2)
    assert loop.resident_sessions() == frozenset({43})


def test_serve_loop_cancel_removes_request_from_session_books():
    """Port of test_router.py::test_serve_loop_cancel_removes_request_from_session_books."""
    loop = _bare_loop(admission=None, warmup=False)
    loop.start([])
    r = Request(0, np.zeros(4, np.int32), 8)
    loop.enqueue(r)
    assert loop.outstanding_rids() == [r.rid]
    assert loop.cancel(r.rid) is True
    assert loop.outstanding_rids() == [] and loop.idle
    assert loop.cancel(r.rid) is False
    r.finished = 1.0
    assert loop.stats()["completed"] == 0
    assert loop.stats()["cancelled"] == 1
    loop.enqueue(r)
    assert loop.outstanding_rids() == [r.rid]


def test_serve_loop_uses_the_same_registry():
    """Port of test_admission.py::test_serve_loop_uses_the_same_registry."""
    loop = _bare_loop(admission="slo_classes")
    assert isinstance(admission.get_policy(loop.admission), admission.SloClassesPolicy)
    pre = admission.SloClassesPolicy(target_backlog_s=5.0)
    resolved = admission.get_policy(_bare_loop(admission=pre).admission)
    assert isinstance(resolved, admission.SloClassesPolicy)
    assert resolved.target_backlog_s == 5.0


def test_cuda_loop_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeLoop(None, None, None, batch=2, max_len=8)


# ------------------------------------------- the captured arena step


class _Rerun:
    """Stands in for a CUDA graph on the CPU: the capture runs the function
    once for its output, and each replay runs it again on the same static
    inputs and writes its result into that output. A graph replays kernels
    and no Python, so a replay leaves ``ops.LAUNCHES`` as it found it."""

    def __init__(self, fn):
        self.fn = fn
        self.out = fn()

    def replay(self):
        from repro_torch.kernels import ops

        counts = dict(ops.LAUNCHES)
        self.out.copy_(self.fn())
        ops.LAUNCHES.update(counts)


@pytest.fixture
def rerun_capture(monkeypatch):
    """``serve._capture`` replaced by :class:`_Rerun`, on any device."""
    from repro_torch.launch import serve

    def capture(fn, device):
        g = _Rerun(fn)
        return g, g.out

    monkeypatch.setattr(serve, "_capture", capture)


def _session_script(loop) -> tuple:
    """One session through three slots: joins into reused slots, a cancel
    mid-decode, a parked multi-turn session resumed from its slot and one
    evicted under slot pressure. The requests and the stats."""
    corpus = SyntheticCorpus(CFG.vocab_size, max(LENS), 0)

    def req(rid, gen, sid=-1, end=False):
        return Request(rid, corpus.grain_tokens(rid, 1)[0][: LENS[rid % len(LENS)]], gen,
                       session_id=sid, session_end=end)

    reqs = [req(0, 2, sid=1), req(1, 8), req(2, 9)]
    later = {1: [req(3, 3, sid=1, end=True), req(4, 2, sid=2)], 5: [req(5, 4), req(6, 5), req(7, 6)]}
    loop.start(list(reqs), t0=time.perf_counter())
    for tick in range(1, 200):
        status = loop.tick()
        for r in later.pop(tick, []):
            reqs.append(r)
            loop.enqueue(r)
        if tick == 3:
            assert loop.cancel(2)
        if status == "done" and not later:
            break
    return reqs, loop.stats()


def test_replayed_arena_streams_equal_the_eager_arena(rerun_capture):
    """The captured step's static-buffer path (inputs copied in, the output
    read from the graph's) gives the eager arena's tokens bit for bit, over
    joins, a cancel, a resumed session and an evicted one; every decode
    call replays."""
    params = _params()
    runs = {}
    for warm in (False, True):
        loop = ServeLoop(CFG, RUN, params, batch=3, max_len=32, device="cpu", warmup=warm)
        loop.warm(max(LENS))
        reqs, stats = _session_script(loop)
        runs[warm] = [r.tokens for r in reqs]
        assert stats["cancelled"] == 1 and stats["prefill_skipped"] >= 1 and stats["sessions_evicted"] >= 1
        assert stats["completed"] == len(reqs) - 1
        assert stats["decode_graph_replays"] == (stats["decode_calls"] if warm else 0) and stats["decode_calls"]
    assert runs[True] == runs[False]


def test_other_arenas_and_unwarmed_loops_step_eagerly(rerun_capture):
    """A loop built with ``warmup=False`` captures nothing; on a warmed
    loop, an arena that is not the captured one (a copy, as the benchmark's
    fault hands it) steps eagerly, and its state moves while the captured
    arena's does not."""
    params = _params()
    cold = ServeLoop(CFG, RUN, params, batch=4, max_len=32, device="cpu", warmup=False)
    stats = cold.run_requests(_requests(5))
    assert cold._graph is None and stats["decode_graph_replays"] == 0 and stats["decode_calls"]

    loop = _loop(params, "arena")
    loop.warm(max(LENS))
    assert loop._graph is not None and loop._graph.holds(loop._arena)
    copy = {k: v.clone() for k, v in loop._arena.items()}
    assert not loop._graph.holds(copy)
    pos = loop._arena["pos"].clone()
    toks, act = torch.zeros((4, 1), dtype=torch.long), torch.ones(4, dtype=torch.bool)
    loop._decode_arena(copy, toks, act)
    assert loop._graph_replays == 0
    assert torch.equal(loop._arena["pos"], pos) and torch.equal(copy["pos"], pos + 1)
    loop._decode_arena(dict(loop._arena), toks, act)  # the same tensors: the captured arena
    assert loop._graph_replays == 1 and torch.equal(loop._arena["pos"], pos + 1)


def test_launches_count_a_replay_as_its_captured_kernels_and_a_capture_as_none(rerun_capture, monkeypatch):
    """K1's plain version counted as the kernel's launches are: warm-up's
    one eager step counts, its capture nothing, and each replay the layers'
    K1 launches the capture recorded."""
    from repro_torch.kernels import ops

    plain = ops.decode_attention_plain

    def counted(*args, **kwargs):
        ops.LAUNCHES["decode_attention"] += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(ops, "decode_attention_plain", counted)
    ops.reset_launches()
    loop = _loop(_params(), "arena", run=KERNEL_RUN)
    loop.warm(max(LENS))
    L = CFG.num_layers
    assert loop._graph.launches["decode_attention"] == L
    assert ops.LAUNCHES["decode_attention"] == L  # the warm-up step; the capture ran none
    ops.reset_launches()
    loop.start(_requests(6), t0=time.perf_counter())
    while loop.tick() != "done":
        pass
    stats = loop.stats()
    assert stats["decode_graph_replays"] == stats["decode_calls"] > 0
    assert ops.LAUNCHES["decode_attention"] == L * stats["decode_calls"]
    ops.reset_launches()


# ------------------------------------------- the copied admission policies


def _decision_log(mod, name: str, seed: int = 0) -> list:
    """Drive one policy through a seeded arrival/poll/capacity/completion
    sequence and log every decision it makes."""
    rng = np.random.default_rng(seed)
    policy = mod.get_policy(name)
    log, t, cap, backlog, depth = [], 0.0, 40.0, 0.0, 0
    hist: dict = {}
    admitted = []

    def view():
        return mod.ClusterView(
            time=t, live_capacity=cap, total_capacity=64.0, free_slots=max(0, 8 - depth),
            queue_depth=depth, backlog_work=backlog, deferred_depth=policy.n_deferred,
            deferred_work=policy.deferred_work, class_p99=mod.trailing_class_p99(hist),
        )

    for i in range(300):
        t += float(rng.exponential(0.3))
        req = mod.JobRequest(
            job_id=i, arrive_t=t, n_tasks=1, total_work=float(rng.integers(1, 64)),
            slo_class=int(rng.integers(0, 3)),
            deadline_s=[math.inf, 5.0, 20.0][int(rng.integers(0, 3))],
        )
        d = policy.offer(req, view())
        log.append(("offer", i, d))
        if d == mod.ADMIT:
            admitted.append(req)
            backlog += req.total_work
            depth += 1
        for r, dd in policy.poll(view()):
            log.append(("poll", r.job_id, dd))
            if dd == mod.ADMIT:
                admitted.append(r)
                backlog += r.total_work
                depth += 1
        if admitted and rng.random() < 0.5:
            done = admitted.pop(0)
            sojourn = t - done.arrive_t
            hist.setdefault(done.slo_class, []).append(sojourn)
            backlog -= done.total_work
            depth -= 1
            policy.on_job_done(t, done, sojourn)
        if rng.random() < 0.05:
            cap = float(rng.choice([10.0, 40.0, 64.0]))
            policy.on_capacity(t, cap)
    return log


@pytest.mark.parametrize("name", sorted(admission.ADMISSION))
def test_copied_admission_decides_as_reference(name):
    assert sorted(admission.ADMISSION) == sorted(jax_admission.ADMISSION)
    ours = _decision_log(admission, name)
    assert ours == _decision_log(jax_admission, name)
    assert any(d != admission.ADMIT for _, _, d in ours) or name == "admit_all"


# ------------------------------------------------------------ on the card


@pytest.mark.gpu
def test_arena_streams_bit_identical_to_serial_on_card():
    """The arena-vs-serial identity through the CUDA kernels: batch 4 and
    batch 1 must give the same greedy tokens on the card too (cuBLAS may
    pick other algorithms for the two widths). head_dim 64: the kernels
    take 64, 128 or 256."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    cfg = get_config("qwen3-1.7b").reduced(num_layers=2, d_model=128, vocab_size=256, head_dim=64)
    params = M.init_model(cfg, torch.Generator(device="cuda").manual_seed(0), dtype=torch.bfloat16)

    def run(mode):
        reqs = _requests(7)
        loop = ServeLoop(cfg, KERNEL_RUN, params, batch=4, max_len=32, mode=mode, device="cuda")
        return loop.run_requests(reqs), reqs

    stats, arena = run("arena")
    _, serial = run("serial")
    assert stats["completed"] == 7
    assert stats["decode_graph_replays"] == stats["decode_calls"]
    assert [r.tokens for r in arena] == [r.tokens for r in serial]


CARD_CUTS = {
    "moonshot": lambda: get_config("moonshot-v1-16b-a3b").reduced(head_dim=64),
    "jamba": lambda: get_config(JAMBA).reduced(d_model=256, head_dim=128, num_heads=2, num_kv_heads=1),
    "xlstm": lambda: get_config("xlstm-1.3b").reduced(),
}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", sorted(CARD_CUTS))
def test_replayed_arena_streams_equal_serial_on_card(arch):
    """The arena-vs-serial identity with every arena step replayed from its
    CUDA graph, on a MoE cut (moonshot-smoke at head_dim 64), the Mamba-2
    hybrid (jamba-smoke at d_model 256, four Mamba heads) and the xLSTM
    stack (xlstm-smoke: mLSTM and sLSTM steps), bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    cfg = CARD_CUTS[arch]()
    params = M.init_model(cfg, torch.Generator(device="cuda").manual_seed(0), dtype=torch.bfloat16)

    def run(mode):
        reqs = _requests(7)
        loop = ServeLoop(cfg, KERNEL_RUN, params, batch=4, max_len=32, mode=mode, device="cuda")
        return loop.run_requests(reqs), reqs

    stats, arena = run("arena")
    _, serial = run("serial")
    assert stats["completed"] == 7 and stats["decode_graph_replays"] == stats["decode_calls"] > 0
    assert [r.tokens for r in arena] == [r.tokens for r in serial]


EXTRA = 96 * 2**20


@pytest.mark.gpu
def test_one_arena_after_warm_up_and_the_first_admit_on_card():
    """Warm-up builds the loop's arena and captures its step; the first
    admit writes into that arena, so the card holds one arena, at no point
    two. Beside it the card holds the graph's small pool and cuBLAS's
    workspace for each new stream (32 MiB on this card): ``EXTRA``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    cfg = get_config("qwen3-1.7b").reduced(num_layers=2, d_model=128, vocab_size=256, head_dim=64)
    params = M.init_model(cfg, torch.Generator(device="cuda").manual_seed(0), dtype=torch.bfloat16)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loop = ServeLoop(cfg, KERNEL_RUN, params, batch=4, max_len=65536, mode="arena", device="cuda")
    loop.warm(max(LENS))
    arena = loop._arena
    loop.start(_requests(4), t0=time.perf_counter())
    loop.tick()
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in (arena["pos"], arena["k"], arena["v"]))
    held = torch.cuda.memory_allocated() - base
    peak = torch.cuda.max_memory_allocated() - base
    assert loop._arena is arena and loop.stats()["decode_graph_replays"] == 1
    assert nbytes <= held < nbytes + EXTRA, (held, nbytes)
    assert peak < 2 * nbytes, (peak, nbytes)


@pytest.mark.gpu
def test_moe_kernel_path_matches_plain_on_card():
    """A small MoE stack (moonshot-smoke widths at head_dim 128, 64 experts
    top-6) in fp32 on the card: the kernel path (K2 prefill, K1 decode)
    against the plain path through ``chip_smoke.paths_agree``, logits within
    1e-3 of the largest |logit| and the same experts chosen at every layer
    and step. The routing's tie rule holds on the card too: equal
    probabilities go to the lower index."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from chip_smoke import paths_agree
    from repro_torch.models import moe

    cfg = dataclasses.replace(
        get_config("moonshot-v1-16b-a3b").reduced(head_dim=128, num_experts=64, experts_per_token=6),
        compute_dtype="float32")
    params = M.init_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    prompt = torch.randint(0, cfg.vocab_size, (2, 64), generator=torch.Generator(device="cuda").manual_seed(1),
                           device="cuda")
    agree = paths_agree(cfg, params, prompt, 72)
    assert agree["sound"]
    assert agree["max_abs_diff"] <= 1e-3 * max(1.0, agree["max_abs_logit"])
    assert agree["moe_calls"] == 5 * cfg.num_layers and agree["routing_identical"]
    tied = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3, 0.1]], device="cuda").log()
    assert moe._top_k_routing(tied, 3)[2].tolist() == [[1, 2, 4]]


@pytest.mark.gpu
def test_mamba_kernel_path_matches_plain_on_card():
    """jamba-smoke at d_model 256 (four Mamba heads) and head_dim 128 in fp32
    on the card: the kernel path (K3 and K2 in the prefill, K1 in the decode
    steps) against the plain path (K3's plain version summed in fp64)
    through ``chip_smoke.paths_agree``, logits within 1e-3 of the largest
    |logit| and the same experts chosen at every MoE layer and step, on a
    320-token prompt (five MoE groups of 64; the scan pads it to two chunks
    of 256)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from chip_smoke import paths_agree

    cfg = dataclasses.replace(get_config(JAMBA).reduced(d_model=256, head_dim=128, num_heads=2, num_kv_heads=1),
                              compute_dtype="float32")
    params = M.init_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    prompt = torch.randint(0, cfg.vocab_size, (2, 320), generator=torch.Generator(device="cuda").manual_seed(1),
                           device="cuda")
    agree = paths_agree(cfg, params, prompt, 328)
    assert agree["sound"]
    assert agree["max_abs_diff"] <= 1e-3 * max(1.0, agree["max_abs_logit"])
    n_moe = sum(cfg.layer_is_moe(i) for i in range(cfg.num_layers))
    assert agree["moe_calls"] == 5 * n_moe and agree["routing_identical"]
