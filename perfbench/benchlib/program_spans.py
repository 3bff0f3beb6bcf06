"""The program's own spans in a traced run, and what is read from them.

The program records spans inside its serve tick, decode step and training
coordinator (``repro_torch.spans``), stamped on the clock the profiler
stamps its events in. A traced run turns the recorder on as its window
opens and reads it out after the close (:func:`traced`); the profiled
slice keeps its bounds on the same clock and its events
(:class:`SpanSlice`), whose idle gaps are then named by the innermost
program span around each as well as by the harness's span and the host
call. Nothing of this is read inside the window.

``run.py`` runs every cell through :func:`traced`, and the run modules
take :class:`SpanSlice` as their slice. Where the program has no recorder
(``program.recorder()`` returns ``None``), a run is left as it was; the
readers then return ``None``. An untraced run never touches the recorder.

What ``data`` gains: ``spans`` (the program's spans, in the order they
began), ``window_ns`` (the window's opening and close), and in
``data["slice"]``: ``ns`` (the slice's bounds), ``gaps`` (every idle gap,
``[start ns, end ns]``, longest first), ``gap_labels`` (the harness span and
host call of the ten longest), ``program_idle_gaps`` (those ten named
``<harness span> <program span> <host call>``) and ``idle_by_span`` (the
slice's idle seconds by the program span around each gap).
"""

from __future__ import annotations

import time

from . import program
from .stats import percentile
from .trace import Slice, _merge


class SpanSlice(Slice):
    """The harness's slice, keeping its bounds on the real-time clock and
    its events, for :func:`traced` to read its gaps after the window."""

    def start(self) -> None:
        self.ns = [time.time_ns(), 0]
        super().start()

    def stop(self) -> None:
        self.ns[1], prof = time.time_ns(), self.prof
        super().stop()
        self.summary["ns"] = self.ns
        self.summary["events"] = (prof.profiler.kineto_results, self.spans)


def slice_gaps(events, bench_spans):
    """Every gap between device work in a profiled slice, longest first, as
    ``[start ns, end ns]``; and for the ten longest, ``[harness span, host
    call]``: the innermost of each that covers the gap's middle, or ``-``,
    as ``trace.reduce`` names them."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], list(bench_spans)
    for e in events:
        a, b = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                dev.append((a, b))
        else:
            host.append((a, b, e.name()))
    merged = _merge(dev)
    gaps = sorted(([a, b] for (_, a), (b, _) in zip(merged, merged[1:])), key=lambda g: g[0] - g[1])
    labels = []
    for a, b in gaps[:10]:
        mid = (a + b) / 2
        cover = [(e - s, name) for s, e, name in host if s <= mid <= e]
        bench = min((c for c in cover if c[1].startswith("bench.")), default=(0, "-"))[1]
        op = min((c for c in cover if not c[1].startswith("bench.")), default=(0, "-"))[1]
        labels.append([bench, op])
    return gaps, labels


def traced(drive, cell, ref, phases) -> dict:
    """``drive(cell, ref, phases)`` (``serve.run`` or ``train.run``) with the
    program's spans where the cell is traced and the program has a
    recorder: on from the window's opening (the run's ``cell.clock()``
    call) until the run returns, CUDA events on the card; the drained spans
    and the window's bounds go into the run's ``data``, and the slice's gaps
    are named by them."""
    rec = program.recorder() if cell.trace else None
    if rec is None:
        data = drive(cell, ref, phases)
        (data.get("slice") or {}).pop("events", None)
        return data
    clock, opened = cell.clock, []

    def opening():
        rec.enable(device_events=cell.device == "cuda")
        opened.append(time.time_ns())
        return clock()

    cell.clock = opening
    try:
        data = drive(cell, ref, phases)
    finally:
        cell.clock = clock
        rec.disable()
    data["spans"] = rec.drain()
    data["window_ns"] = [opened[0], opened[0] + int(cell.seconds * 1e9)]
    s = data.get("slice")
    if s and "events" in s:
        results, bench_spans = s.pop("events")
        s["gaps"], s["gap_labels"] = slice_gaps(results.events(), bench_spans)
        s["program_idle_gaps"], s["idle_by_span"] = name_gaps(s["gaps"], s["gap_labels"], data["spans"], s["ns"])
    return data


def _path(spans, s) -> str:
    return s.name if s.parent < 0 else f"{spans[s.parent].name}/{s.name}"


def name_gaps(gaps, labels, spans, bounds):
    """The gaps that ``labels`` names (the longest), each named ``<harness
    span> <program span> <host call>`` with its seconds, the program span
    the innermost around the gap's middle, given as its parent and itself
    (``serve.decode.issue/model.attn``), or ``-``; and the idle seconds of
    every gap summed by that program span."""
    near = [s for s in spans if s.start_ns <= bounds[1] and s.end_ns >= bounds[0]]
    named, by_span = [], {}
    for k, (a, b) in enumerate(gaps):
        mid = (a + b) / 2
        cover = [s for s in near if s.start_ns <= mid <= s.end_ns]
        inner = min(cover, key=lambda s: s.end_ns - s.start_ns, default=None)
        where = "-" if inner is None else _path(spans, inner)
        by_span[where] = by_span.get(where, 0.0) + (b - a) / 1e9
        if k < len(labels):
            named.append([f"{labels[k][0]} {where} {labels[k][1]}", (b - a) / 1e9])
    return named, dict(sorted(by_span.items(), key=lambda kv: -kv[1]))


def outside(data, s) -> bool:
    """Span ``s`` lies in the window and outside the profiled slice."""
    w0, w1 = data["window_ns"]
    sl = (data.get("slice") or {}).get("ns")
    if not (w0 <= s.start_ns and 0 <= s.end_ns <= w1):
        return False
    return sl is None or s.end_ns < sl[0] or s.start_ns > sl[1]


def decode_ms(data, name: str):
    """The median of span ``name`` (``serve.decode.issue``,
    ``serve.decode.readback``) over the window's decode steps outside the
    profiled slice, in ms."""
    got = [(s.end_ns - s.start_ns) / 1e6 for s in data.get("spans") or () if s.name == name and outside(data, s)]
    return percentile(got, 50) if got else None


def decode_issue_ms(data):
    """:func:`decode_ms` of ``serve.decode.issue``: the input copies and the
    issue of a decode step (on the card, the replay's launch)."""
    return decode_ms(data, "serve.decode.issue")


def decode_readback_ms(data):
    """:func:`decode_ms` of ``serve.decode.readback``: the wait for a decode
    step's tokens on the host."""
    return decode_ms(data, "serve.decode.readback")


def admit_stall_p99_ms(data):
    """The 99th percentile, over the window's ticks outside the slice in
    which a slot was decoding, of the tick's time inside ``serve.admit``
    spans (a prefill and its first token hold every decoding slot), in ms."""
    spans = data.get("spans") or ()
    ticks = {i: 0 for i, s in enumerate(spans) if s.name == "serve.tick" and outside(data, s)}
    decoding = set()
    for s in spans:
        if s.parent in ticks:
            if s.name == "serve.decode":
                decoding.add(s.parent)
            elif s.name == "serve.admit":
                ticks[s.parent] += s.end_ns - s.start_ns
    got = [ticks[i] / 1e6 for i in decoding]
    return percentile(got, 99) if got else None


def accum_share(data):
    """The share of the window's steps' time in which the device ran the
    trainer's gradient accumulation and combine (``train.accumulate`` and
    ``train.combine``, by their CUDA events; on the CPU, where the work is
    done when its call returns, by the spans' own time), in %."""
    steps, spans = data.get("steps") or [], data.get("spans")
    if not steps or not spans:
        return None
    w0 = data["window_ns"][0]
    a, b = w0 + int(steps[0]["t0"] * 1e9), w0 + int(steps[-1]["t1"] * 1e9)
    secs = sum(s.device_s if s.device_s is not None else (s.end_ns - s.start_ns) / 1e9 for s in spans
               if s.name in ("train.accumulate", "train.combine") and a <= s.start_ns and 0 <= s.end_ns <= b)
    return 100.0 * secs / (steps[-1]["t1"] - steps[0]["t0"])
