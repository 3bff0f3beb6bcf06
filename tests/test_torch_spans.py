"""The program's span recorder (``repro_torch.spans``) and the spans of the
serve tick, the decode step and the training coordinator, on the CPU: a
tiny ``ServeLoop`` in arena mode and a tiny ``HetCoordinator`` step.

* Off, no site calls the recorder; on, every tick, admit and decode has its
  spans, nested, children within their parents, and each admit carries its
  request's id.
* The token streams and the rate EMA are the same bits with the recorder on
  and off (the loop's own clock reads replaced by a counter).
* The coordinator's spans come in the schedule's counts.
* The stamps share the profiler's clock: every ``aten::mm`` the profiler
  records inside a decode step lies inside a ``model.*`` span.
* A latent-attention MoE (a cut of ``moonlight-16b-a3b``): each prefill
  holds an ``attn.mla`` span a layer and a ``moe.apply`` span an expert
  layer, with ``moe.route``, ``moe.experts`` and ``moe.shared`` inside it;
  ``stats()`` counts the prefills' routed pairs and the most one expert
  took, for a routing known in advance.

The ``gpu``-marked tests check on the card that each eager decode step's
first K1 kernel starts inside its ``serve.decode.issue`` span, and that each
replayed step's K1 kernels run inside its ``serve.decode`` span.
"""

import dataclasses
import time
import types
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.core.coordinator import HetCoordinator, PodRuntime
from repro_torch.launch import serve
from repro_torch.launch.serve import Request, ServeLoop
from repro_torch.models import model as M

CFG = dataclasses.replace(get_config("qwen3-1.7b").reduced(num_layers=2, d_model=64, vocab_size=64),
                          compute_dtype="float32")
RUN = RunConfig(attention_impl="xla")
SERVE_NAMES = {"serve.tick", "serve.pump", "serve.admit", "serve.prefill", "serve.first_token",
               "serve.slot_write", "serve.decode", "serve.decode.issue", "serve.decode.readback",
               "serve.decode.book", "model.attn", "model.ffn", "model.head"}


@pytest.fixture(autouse=True)
def _recorder_off():
    spans.disable()
    spans.drain()
    yield
    spans.disable()
    spans.drain()


def _requests(n=7, gen=5):
    g = torch.Generator().manual_seed(1)
    return [Request(i, torch.randint(0, CFG.vocab_size, (6 + i % 4,), generator=g).numpy(), gen + i % 3)
            for i in range(n)]


def _serve(record: bool, reqs=None, batch=4):
    """Serve ``reqs`` to the end, the recorder on from ``start``; the
    requests, the rate after each tick, the tick count and the spans."""
    params = M.init_model(CFG, torch.Generator().manual_seed(0))
    loop = ServeLoop(CFG, RUN, params, batch=batch, max_len=32, mode="arena", warmup=False, device="cpu")
    reqs = reqs if reqs is not None else _requests()
    if record:
        spans.enable()
    loop.start(reqs)
    rates, ticks = [], 0
    while loop.tick() != "done":
        ticks += 1
        rates.append(loop.tok_rate)
    spans.disable()
    return reqs, rates, ticks + 1, spans.drain()


def _inside(child, parent):
    return parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns


def test_off_no_site_calls_the_recorder(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span site called the recorder while it was off")

    for name in ("begin", "end", "then"):
        monkeypatch.setattr(spans, name, refuse)
    reqs, _, _, got = _serve(record=False)
    assert got == [] and all(len(r.tokens) == r.max_new for r in reqs)


def test_every_tick_and_decode_has_its_spans_nested():
    reqs, _, ticks, got = _serve(record=True)
    names = Counter(s.name for s in got)
    assert set(names) == SERVE_NAMES
    assert all(s.end_ns >= s.start_ns for s in got)
    for s in got:
        if s.parent >= 0:
            assert _inside(s, got[s.parent]), (s, got[s.parent])
    assert names["serve.tick"] == ticks
    assert all(got[s.parent].name == "serve.tick" for s in got if s.name == "serve.decode")
    decodes = [i for i, s in enumerate(got) if s.name == "serve.decode"]
    assert decodes
    for i in decodes:
        kids = [s.name for s in got if s.parent == i]
        assert kids == ["serve.decode.issue", "serve.decode.readback", "serve.decode.book"]
        issue = next(j for j, s in enumerate(got) if s.parent == i)
        model = [s.name for s in got if s.parent == issue]
        assert model == ["model.attn", "model.ffn"] * CFG.num_layers + ["model.head"]
    # the children of an issued step tile it: one clock read ends one and begins the next
    for i in decodes:
        kids = [s for s in got if s.parent == i]
        assert all(a.end_ns == b.start_ns for a, b in zip(kids, kids[1:]))


def test_every_admit_carries_its_request_id():
    reqs, _, _, got = _serve(record=True)
    admits = [(i, s) for i, s in enumerate(got) if s.name == "serve.admit"]
    assert sorted(s.rid for _, s in admits) == sorted(r.rid for r in reqs)
    assert all(s.rid == -1 for s in got if s.name != "serve.admit")
    for i, _ in admits:
        assert [s.name for s in got if s.parent == i] == ["serve.prefill", "serve.first_token", "serve.slot_write"]


def test_streams_and_rate_are_the_same_bits_on_and_off(monkeypatch):
    """The loop's clock reads are replaced by a counter, so the rate EMA is
    a function of the reads the loop makes: with the recorder on it must make
    the same ones, and fold them into the same arithmetic."""

    def fake_time():
        n = [0]

        def ns():
            n[0] += 1_234_567
            return n[0]

        return types.SimpleNamespace(time_ns=ns, perf_counter=lambda: ns() / 1e9, sleep=time.sleep)

    runs = {}
    for record in (False, True):
        monkeypatch.setattr(serve, "time", fake_time())
        reqs, rates, ticks, got = _serve(record)
        runs[record] = ([r.tokens for r in reqs], rates, ticks)
        assert bool(got) == record
    assert runs[False] == runs[True]
    assert len(set(runs[True][1])) > 1


class _Event:
    """A stand-in for ``torch.cuda.Event`` on the CPU: elapsed time from the
    host clock."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 1e3 * (other.t - self.t)


@pytest.mark.parametrize("compress, combines", [(False, 2), (True, 3)])
def test_coordinator_spans_come_in_the_schedules_counts(monkeypatch, compress, combines):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    params = {"w": torch.randn(8, 8, generator=torch.Generator().manual_seed(0))}

    def grad_fn(p, batch):
        return {"w": p["w"] * batch}, {"loss": (p["w"] * batch).sum()}

    def update_fn(p, o, g):
        return {"w": p["w"] - 1e-3 * g["w"]}, o, {}

    coord = HetCoordinator(grad_fn=grad_fn, update_fn=update_fn,
                           pods=[PodRuntime("pod0", 1.0), PodRuntime("pod1", 0.5)],
                           total_microbatches=6, grain_tokens=16, compress=compress)
    spans.enable(device_events=True)
    _, _, rep = coord.step(params, None, iter(float(i) for i in range(1, 100)))
    spans.disable()
    got = spans.drain()
    k = rep.schedule.microbatches
    assert list(k) == [4, 2]
    names = Counter(s.name for s in got)
    assert names == {"train.grad": 6, "train.accumulate": 6 + 2, "train.combine": combines, "train.update": 1}
    assert [s.rid for s in got if s.name == "train.grad"] == list(range(6))
    assert [s.rid for s in got if s.name == "train.combine"][:2] == [0, 1]
    assert all(s.parent == -1 for s in got)
    assert all((s.device_s is not None) == (s.name in ("train.accumulate", "train.combine")) for s in got)
    assert all(s.device_s >= 0 for s in got if s.device_s is not None)
    order = [s.start_ns for s in got]
    assert order == sorted(order) and all(a.end_ns <= b.start_ns for a, b in zip(got, got[1:]))


def test_device_events_are_off_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    spans.enable()
    i = spans.begin("train.accumulate", device=True)
    spans.end(i)
    assert spans.drain()[0].device_s is None


def test_buffer_grows_past_its_capacity(monkeypatch):
    monkeypatch.setattr(spans, "_CAPACITY", 4)
    spans.enable()
    outer = spans.begin("a")
    for _ in range(9):
        spans.end(spans.begin("b"))
    spans.end(outer)
    got = spans.drain()
    assert len(got) == 10 and all(s.parent == 0 for s in got[1:]) and got[0].end_ns >= got[-1].end_ns


def test_spans_share_the_profilers_clock():
    """Every ``aten::mm`` that ``torch.profiler`` records while a decode step
    is issued lies inside one of the step's ``model.*`` spans."""
    params = M.init_model(CFG, torch.Generator().manual_seed(0))
    loop = ServeLoop(CFG, RUN, params, batch=4, max_len=32, mode="arena", warmup=False, device="cpu")
    loop.start(_requests(4))
    spans.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            loop.tick()
    spans.disable()
    got = spans.drain()
    issues = [s for s in got if s.name == "serve.decode.issue"]
    model = [s for s in got if s.name.startswith("model.")]
    mms = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::mm"]
    inside = [(a, b) for a, b in mms if any(s.start_ns <= a and b <= s.end_ns for s in issues)]
    assert len(issues) == 3 and len(inside) >= 3 * CFG.num_layers
    for a, b in inside:
        assert any(s.start_ns <= a and b <= s.end_ns for s in model), (a, b)


def _traced_ticks_on_card(warmup: bool):
    """Four decode ticks of a small qwen3 arena through K1, profiled, the
    recorder on: the loop's config, its stats, the spans and the start and
    end of every K1 split kernel."""
    cfg = get_config("qwen3-1.7b").reduced(num_layers=2, d_model=128, vocab_size=256, head_dim=64)
    params = M.init_model(cfg, torch.Generator(device="cuda").manual_seed(0), dtype=torch.bfloat16)
    run = RunConfig(attention_impl="pallas", decode_attention_impl="kernel")
    loop = ServeLoop(cfg, run, params, batch=4, max_len=64, mode="arena", warmup=warmup, device="cuda")
    g = torch.Generator().manual_seed(1)
    loop.start([Request(i, torch.randint(0, 256, (8 + i,), generator=g).numpy(), 12) for i in range(4)])
    loop.tick()  # every slot admitted, the kernels built
    torch.cuda.synchronize()
    spans.enable()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            loop.tick()
        torch.cuda.synchronize()
    spans.disable()
    k1 = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in prof.profiler.kineto_results.events()
                if e.device_type() == torch.autograd.DeviceType.CUDA and "split_kernel" in e.name())
    return cfg, loop.stats(), spans.drain(), k1


@pytest.mark.gpu
def test_first_k1_kernel_of_a_step_starts_inside_its_issue_span_on_card():
    """On the card, through K1, on an eager loop (``warmup=False``: no
    captured step): the profiler's device timeline and the recorder's host
    stamps agree, so each decode step's first K1 kernel starts after its
    ``serve.decode.issue`` span opens and before it closes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    cfg, stats, got, k1 = _traced_ticks_on_card(warmup=False)
    assert stats["decode_graph_replays"] == 0
    issues = [s for s in got if s.name == "serve.decode.issue"]
    starts = [a for a, _ in k1]
    assert len(issues) == 4 and len(starts) >= 4 * cfg.num_layers
    for s in issues:
        first = next(t for t in starts if t >= s.start_ns)
        assert first <= s.end_ns, (s, first)
    assert np.all(np.diff([s.start_ns for s in issues]) > 0)


@pytest.mark.gpu
def test_k1_kernels_of_a_replayed_step_run_inside_its_decode_span_on_card():
    """The replay's version: every decode step of a warmed loop replays its
    CUDA graph, which runs no ``model.*`` span, and each step's K1 kernels,
    one a layer, start and end inside its ``serve.decode`` span (the
    readback waits for them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    cfg, stats, got, k1 = _traced_ticks_on_card(warmup=True)
    assert stats["decode_graph_replays"] == stats["decode_calls"] == 5
    decodes = [s for s in got if s.name == "serve.decode"]
    assert len(decodes) == 4 and not any(s.name.startswith("model.") for s in got)
    assert len(k1) == 4 * cfg.num_layers
    for s in decodes:
        inside = [(a, b) for a, b in k1 if s.start_ns <= a and b <= s.end_ns]
        assert len(inside) == cfg.num_layers, (s, k1)


MLA_CFG = dataclasses.replace(
    get_config("moonlight-16b-a3b"), num_layers=3, d_model=32, num_heads=4, num_kv_heads=4, head_dim=12, d_ff=48,
    moe_d_ff=16, shared_d_ff=32, vocab_size=64, num_experts=8, experts_per_token=2, kv_lora_rank=16,
    qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8, compute_dtype="float32")


def _serve_mla(params, lens=(6, 9, 7), gen=4):
    loop = ServeLoop(MLA_CFG, RUN, params, batch=2, max_len=24, mode="arena", warmup=False, device="cpu")
    g = torch.Generator().manual_seed(2)
    reqs = [Request(i, torch.randint(0, 64, (n,), generator=g).numpy(), gen) for i, n in enumerate(lens)]
    spans.enable()
    loop.start(reqs)
    while loop.tick() != "done":
        pass
    spans.disable()
    return reqs, loop.stats(), spans.drain()


def test_mla_and_moe_spans_nest_as_named():
    params = M.init_model(MLA_CFG, torch.Generator().manual_seed(0))
    reqs, stats, got = _serve_mla(params)
    assert all(len(r.tokens) == r.max_new for r in reqs)
    for s in got:
        if s.parent >= 0:
            assert _inside(s, got[s.parent]), (s, got[s.parent])
    prefills = [i for i, s in enumerate(got) if s.name == "serve.prefill"]
    assert len(prefills) == len(reqs) == stats["prefill_calls"]
    for i in prefills:
        # a prefill: the attention of each layer, then the expert layers' FFN (the dense layer's has no span)
        assert [s.name for s in got if s.parent == i] == ["attn.mla", "attn.mla", "moe.apply", "attn.mla",
                                                          "moe.apply"]
    applies = [i for i, s in enumerate(got) if s.name == "moe.apply"]
    # the decode steps are eager here: each has its expert layers' spans too, under model.ffn
    assert len(applies) == 2 * (len(reqs) + stats["decode_calls"])
    for i in applies:
        kids = [s for s in got if s.parent == i]
        assert [s.name for s in kids] == ["moe.route", "moe.experts", "moe.shared"]
        assert all(a.end_ns == b.start_ns for a, b in zip(kids, kids[1:]))
    assert not any(s.name == "attn.mla" and got[s.parent].name != "serve.prefill" for s in got)


def test_the_stats_counter_counts_the_pairs_of_a_known_routing():
    """Every token of every expert layer chooses experts 3 and 6 (the
    router's product is zero and the bias decides): each prefill routes
    its tokens times 2 pairs a layer, and experts 3 and 6 take all of a
    layer's tokens."""
    params = M.init_model(MLA_CFG, torch.Generator().manual_seed(1))
    for blk in params["layers"][1:]:
        blk["moe"]["router"].zero_()
        blk["moe"]["bias"][[3, 6]] = 1.0
    lens = (6, 9, 7)
    reqs, stats, _ = _serve_mla(params, lens)
    layers = MLA_CFG.num_layers - MLA_CFG.first_dense_layers
    assert stats["moe_pairs"] == sum(lens) * MLA_CFG.experts_per_token * layers
    assert stats["moe_max_expert_pairs"] == sum(lens) * layers
    # a model without a dropless expert layer counts none
    params = M.init_model(CFG, torch.Generator().manual_seed(0))
    loop = ServeLoop(CFG, RUN, params, batch=2, max_len=24, mode="arena", warmup=False, device="cpu")
    loop.run_requests(_requests(2))
    assert (loop.stats()["moe_pairs"], loop.stats()["moe_max_expert_pairs"]) == (0, 0)
