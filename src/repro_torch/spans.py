"""Spans of the program's own phases: the serve tick, the decode step and
the training coordinator, for a traced benchmark run.

One recorder per process, off by default. A span site reads ``spans.on``
and does nothing more while it is false: nothing is allocated, stamped or
appended. When it is on, each span is a row of a preallocated buffer,
``(name, start_ns, end_ns, parent, rid)``: the parent is the index of the
span open around it (-1 at the top), ``rid`` a request's id on the spans
of a request (``-1`` where none; see the sites for the coordinator's). The
rows are read out once, after the run, by :func:`drain`.

Stamps are ``time.time_ns()``: the host's real-time clock, in which
``torch.profiler`` stamps its events, so a span and a profiler event (a
host call, a kernel on the device) compare directly. With
``enable(device_events=True)`` the sites that ask for it (the trainer's
gradient accumulation and combine, a serving prefill, an MLA prefill's
``attn.mla`` and a dropless MoE layer's ``moe.apply``) also record a CUDA
event at each end, except inside a CUDA graph's capture;
the pair is read as seconds only by :func:`drain`, so nothing on the timed
path waits for the device.

A site:

    span = spans.begin("serve.decode.issue") if spans.on else -1
    ...
    if span >= 0:
        span = spans.then(span, "serve.decode.readback")
    ...
    if span >= 0:
        spans.end(span)

The recorder assumes one thread; :func:`enable` and :func:`disable` are
called between the program's calls, never inside one.

The spans inside ``models/model.py::decode_step`` (``model.attn``,
``model.ffn``, ``model.head``) stamp the host's issue of the layers, so
they fire only on an eager step: on the card a serving loop replays its
arena's captured step as one CUDA graph, which runs no Python, and its
``serve.decode.issue`` then spans the input copies and the replay's launch.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np

on = False  # read at every site; set only by enable() and disable()

_NAME, _START, _END, _PARENT, _RID = range(5)
_CAPACITY = 1 << 18  # rows: a 51 s serving window takes ~30,000
_buf = np.empty((0, 5), np.int64)
_n = 0  # rows written
_cur = -1  # the innermost open span
_names: list[str] = []
_ids: dict[str, int] = {}
_device = False
_events: dict[int, tuple] = {}  # span index -> (start event, end event)


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int  # -1 while open
    parent: int  # index in the drained list, -1 at the top
    rid: int
    device_s: Optional[float]  # the CUDA events' seconds, where the site records them


def enable(device_events: bool = False) -> None:
    """Start recording, into an empty buffer (``_CAPACITY`` rows, doubled
    when full); with ``device_events``, the sites that ask for it also
    record CUDA events."""
    global on, _buf, _n, _cur, _device
    _buf = np.empty((_CAPACITY, 5), np.int64)
    _n, _cur, _device = 0, -1, device_events
    _names.clear()
    _ids.clear()
    _events.clear()
    on = True


def disable() -> None:
    """Stop recording; what was recorded stays for :func:`drain`."""
    global on
    on = False


def drain() -> list[Span]:
    """The spans recorded since :func:`enable` or the last drain, in the
    order they began, and an empty buffer. Resolving the CUDA events waits
    for the device, so drain after the timed window."""
    global _n, _cur
    out = []
    for i in range(_n):
        name, a, b, parent, rid = (int(x) for x in _buf[i])
        dev = None
        if i in _events:
            ea, eb = _events[i]
            eb.synchronize()
            dev = ea.elapsed_time(eb) / 1e3
        out.append(Span(_names[name], a, b, parent, rid, dev))
    _n, _cur = 0, -1
    _events.clear()
    return out


def _capturing() -> bool:
    """Whether a CUDA graph is being recorded: an event recorded then would
    be part of the graph, so a span inside a capture records none."""
    import torch

    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def begin(name: str, rid: int = -1, t: Optional[int] = None, device: bool = False) -> int:
    """Open a span inside the innermost open one, stamped ``t`` (a
    ``time.time_ns()`` the caller read) or now; its index."""
    global _buf, _n, _cur
    if _n == len(_buf):
        _buf = np.concatenate([_buf, np.empty_like(_buf)])
    i = _n
    key = _ids.get(name)
    if key is None:
        key = _ids[name] = len(_names)
        _names.append(name)
    row = _buf[i]
    row[_NAME], row[_PARENT], row[_RID], row[_END] = key, _cur, rid, -1
    if device and _device and not _capturing():
        import torch

        ea, eb = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ea.record()
        _events[i] = (ea, eb)
    row[_START] = time.time_ns() if t is None else t
    _n, _cur = i + 1, i
    return i


def end(i: int, t: Optional[int] = None) -> None:
    """Close span ``i``, stamped ``t`` or now; the span around it becomes
    the innermost open one again."""
    global _cur
    row = _buf[i]
    row[_END] = time.time_ns() if t is None else t
    if i in _events:
        _events[i][1].record()
    _cur = int(row[_PARENT])


def then(i: int, name: str, rid: int = -1, device: bool = False) -> int:
    """Close span ``i`` and open its sibling ``name`` at the same instant
    (one clock read); the new span's index."""
    t = time.time_ns()
    end(i, t)
    return begin(name, rid, t, device)
