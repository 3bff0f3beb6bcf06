"""Serving cells: the program's ``ServeLoop`` driven through its session
API, ``start([])``, ``enqueue`` and ``tick``, by an open or a closed loop.

* Open loop: each request is enqueued at its scheduled arrival, stamped
  with it (``Request.arrived``), so its TTFT counts the wait that a stall
  imposes on it. A ``"done"`` from ``tick()`` while arrivals remain means
  wait for the next arrival. Arrivals stop at the window's close; the
  requests that arrived in it are then drained, and one still unfinished a
  drain of ``max(window, drain_s)`` later has failed. No other timer ends
  the run.
* Closed loop: ``clients`` requests are admitted in set-up (the window
  opens once every slot holds one), and each client sends its next request
  when the last completes. At the close the open requests are cut; what
  they emitted is judged.

The benchmark's spans: each token's emission time (stamped after each tick
and at the start of each prefill, so a decode step's tokens get the time
before the prefills that follow it in the same tick), CUDA events around
each ``loop.prefill`` call, and with ``--trace 1`` the profiler over a
bounded slice of whole ticks in the middle of the window.
"""

from __future__ import annotations

import gc
import time
from collections import deque

import torch

from . import judge, program, traffic
from .program_spans import SpanSlice


class Timer:
    """A device span: CUDA events on the card, the host clock elsewhere."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        if self.cuda:
            self.a, self.b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            self.a.record()
        else:
            self.a = time.perf_counter()

    def stop(self) -> "Timer":
        if self.cuda:
            self.b.record()
        else:
            self.b = time.perf_counter()
        return self

    def seconds(self) -> float:
        return self.a.elapsed_time(self.b) / 1e3 if self.cuda else self.b - self.a


class Recorder:
    """The requests of a run, their tokens' stamps and the prefills."""

    def __init__(self, loop, slice_: SpanSlice, device):
        self.loop, self.slice = loop, slice_
        self.reqs, self.open, self.stamps = [], [], {}
        self.prefills = []  # (prompt tokens, Timer, in the slice, start on the loop's clock)
        self.slice_steps = []  # valid keys of each decode step in the slice
        self.late = []  # how late each arrival was enqueued
        orig = loop.prefill

        def prefill(toks):
            self.stamp()
            t = loop.now()
            with self.slice.span("bench.prefill"):
                timer = Timer(device)
                out = orig(toks)
                timer.stop()
            self.prefills.append((int(toks.shape[1]), timer, self.slice.on, t))
            return out

        loop.prefill = prefill

    def add(self, r) -> None:
        self.reqs.append(r)
        self.open.append(r)
        self.stamps[r.rid] = []

    def stamp(self) -> None:
        t = self.loop.now()
        keep = []
        for r in self.open:
            st = self.stamps[r.rid]
            while len(st) < len(r.tokens):
                st.append(r.first_token if not st else t)
            if r.finished < 0:
                keep.append(r)
        self.open = keep

    def active(self):
        """Requests that hold a slot: the next tick decodes each of them."""
        return [r for r in self.open if r.first_token >= 0 and r.finished < 0]

    def tick(self) -> str:
        if self.slice.on:
            act = self.active()
            if act:
                self.slice_steps.append(sum(len(r.prompt) + len(r.tokens) for r in act))
        with self.slice.span("bench.tick"):
            status = self.loop.tick()
        self.stamp()
        return status


class SliceControl:
    """Starts the profiler at the first tick past ``start_frac`` of the
    window and stops it once ``min_ticks`` ticks and ``min_prefills``
    prefills are in, or at ``max_frac`` of the window."""

    def __init__(self, rec: Recorder, spec: dict, seconds: float, t_open: float):
        self.rec, self.spec = rec, spec
        self.begin = t_open + spec["start_frac"] * seconds
        self.end = t_open + spec["max_frac"] * seconds
        self.ticks = self.p0 = 0

    def before(self, now: float) -> None:
        sl = self.rec.slice
        if sl.enabled and sl.state == "before" and now >= self.begin:
            sl.start()
            self.ticks, self.p0 = 0, len(self.rec.prefills)

    def after(self, now: float) -> None:
        sl = self.rec.slice
        if not sl.on:
            return
        self.ticks += 1
        pre = len(self.rec.prefills) - self.p0
        if (self.ticks >= self.spec["min_ticks"] and pre >= self.spec["min_prefills"]) or now >= self.end:
            sl.stop()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _record(r, stamps) -> dict:
    return {"rid": r.rid, "arrival": r.arrived, "prompt": int(len(r.prompt)), "max_new": r.max_new,
            "tokens": len(r.tokens), "submitted": r.submitted, "first_token": r.first_token,
            "finished": r.finished, "stamps": list(stamps)}


def run(cell, ref, phases) -> dict:
    """One serving run of ``cell`` (``spec.Cell``); returns what the metric
    readers and the judge read."""
    cfg, mix, dev, seed, seconds = cell.cfg, cell.mix, cell.device, cell.seed, cell.seconds
    d = ref.dims(cfg)
    t = time.perf_counter()
    mcfg = program.model_config(cfg)
    # served in the compute dtype, as launch/serve.py holds them
    params = ref.make_params(cfg, seed, dev, getattr(torch, mcfg.compute_dtype))
    _sync(dev)
    phases["weights_s"] = time.perf_counter() - t

    t = time.perf_counter()
    loop = program.serve_loop(mcfg, params, mix["slots"], mix["max_len"], dev)
    closed = mix["kind"] == "closed_loop"
    if closed:
        queue = traffic.pool(mix, seed, d.V)
        longest = mix["prompt"]["max"]
    else:
        gen = traffic.requests(mix, seed, seconds, d.V)
        longest = max(len(g.prompt) for g in gen)
    phases["traffic_s"] = time.perf_counter() - t
    t = time.perf_counter()
    loop.warm(longest)
    _sync(dev)
    phases["warm_s"] = time.perf_counter() - t

    sl = SpanSlice(cell.trace)
    rec = Recorder(loop, sl, dev)
    drain_limit = max(seconds, mix.get("drain_s", 0))
    loop.start([])
    if closed:
        t = time.perf_counter()
        for _ in range(mix["clients"]):
            g = next(queue)
            r = program.request(g.rid, g.prompt, g.max_new, loop.now())
            rec.add(r)
            loop.enqueue(r)
        while len(rec.active()) < mix["clients"]:
            rec.tick()
        phases["fill_s"] = time.perf_counter() - t
    stats_open = loop.stats()
    t_open = loop.now()
    phases["setup_s"] = cell.clock()  # the window opens
    ctl = SliceControl(rec, mix["trace"], seconds, t_open)
    t_close = t_open + seconds
    drained = True
    if closed:
        clients = list(rec.reqs)  # each client's request in flight
        while loop.now() < t_close:
            ctl.before(loop.now())
            rec.tick()
            ctl.after(loop.now())
            for i, r in enumerate(clients):
                if r.finished >= 0:  # the client sends its next request
                    g = next(queue)
                    clients[i] = program.request(g.rid, g.prompt, g.max_new, loop.now())
                    rec.add(clients[i])
                    loop.enqueue(clients[i])
        stats_close = loop.stats()
        t_end = loop.now()
    else:
        pending = deque(gen)
        while True:
            now = loop.now()
            while pending and pending[0].arrival <= now:
                g = pending.popleft()
                r = program.request(g.rid, g.prompt, g.max_new, g.arrival)
                rec.late.append(now - g.arrival)
                rec.add(r)
                loop.enqueue(r)
            ctl.before(now)
            status = rec.tick()
            now = loop.now()
            ctl.after(now)
            if now > t_close + drain_limit:
                drained = False
                break
            if status != "step":
                if not pending:
                    break
                with sl.span("bench.idle"):
                    time.sleep(min(max(pending[0].arrival - loop.now(), 0.0), 0.05))
        t_end = loop.now()
        stats_close = loop.stats()
    if sl.on:
        sl.stop()
    if sl.summary:
        # the profiler's cost: a tick's wall inside the slice against the window's
        ticks = stats_close["decode_calls"] - stats_open["decode_calls"]
        phases["slice_tick_ms"] = 1e3 * sl.summary["window_s"] / max(ctl.ticks, 1)
        phases["window_tick_ms"] = 1e3 * (t_end - t_open) / max(ticks, 1)
    phases["window_s"] = seconds
    phases["drain_s"] = max(0.0, t_end - t_close) if not closed else 0.0
    peak = torch.cuda.max_memory_allocated() if torch.device(dev).type == "cuda" else 0

    records = [_record(r, rec.stamps[r.rid]) for r in rec.reqs]
    attempted = [x for x in records if closed or x["arrival"] < seconds]
    failed = 0 if closed else sum(1 for x in attempted if x["finished"] < 0)
    data = {
        "seconds": seconds, "t_open": t_open, "t_close": t_close, "t_end": t_end, "dims": d,
        "slots": mix["slots"], "max_len": mix["max_len"], "requests": records, "attempted": len(attempted),
        "failed": failed, "drained": drained, "late_s": rec.late,
        "prefills": [{"s": s, "seconds": tm.seconds(), "in_slice": ins, "t": t0} for s, tm, ins, t0 in rec.prefills],
        "slice": sl.summary, "slice_steps": rec.slice_steps,
        "stats_open": stats_open, "stats_close": stats_close, "memory_peak_bytes": peak,
    }
    phases["requests_cut"] = sum(1 for x in records if x["finished"] < 0) if closed else 0
    phases["failed"] = failed
    if rec.late:
        phases["late_p99_ms"] = 1e3 * sorted(rec.late)[int(0.99 * (len(rec.late) - 1))]
    data["finish"] = lambda: _judge(cell, ref, params, rec, loop)
    return data


def _judge(cell, ref, params, rec, loop) -> dict:
    """Free the program's state, then hold a sample of its served tokens
    against the reference."""
    check = cell.mix["check"]
    pick = judge.sample(rec.reqs if cell.mix["kind"] == "closed_loop"
                        else [r for r in rec.reqs if r.finished >= 0], cell.seed, check["served_tokens"])
    loop.__dict__.clear()  # the arena and every other tensor the loop holds
    del loop
    gc.collect()
    if torch.device(cell.device).type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    g = judge.serve_gaps(ref, cell.cfg, params, pick, cell.device)
    g["requests"] = len(pick)
    g["reference_s"] = time.perf_counter() - t
    return g
