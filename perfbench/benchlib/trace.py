"""The profiled slice of a traced run, and what is read from it.

A ``--trace 1`` run offers the same load as a plain one; ``torch.profiler``
records only a bounded slice in the middle of its window (whole ticks or
steps, each of which ends in a synchronisation). It records the device's
activity only (CUPTI: kernels, copies, fills, and the CUDA calls the host
made): recording every host operation as well doubled an eager decode
step's time on the card, and that would change the load it measures. The
harness's own spans (``bench.*``: a tick, a prefill, an idle wait, a
gradient or an update) are kept on the host's real-time clock, the clock
the profiler's events are stamped in.

From the slice come the seconds in which an operation ran on the device
(the union of kernel, copy and fill intervals), each kernel's summed time,
the longest idle gaps labelled by what the host was doing, and the slice's
length on the host's clock.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager


class Slice:
    """The profiler over a bounded slice of the window, and the harness's
    spans inside it."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.state = "before"  # before -> on -> done
        self.prof = None
        self.t0 = self.t1 = 0.0
        self.spans = []  # (start ns, end ns, name) on the real-time clock
        self.summary = None

    @property
    def on(self) -> bool:
        return self.state == "on"

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else [ProfilerActivity.CPU]
        self.prof = profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()
        self.state = "on"

    def stop(self) -> None:
        self.t1 = time.perf_counter()
        self.prof.stop()
        self.state = "done"
        self.summary = reduce(self.prof.profiler.kineto_results.events(), self.t1 - self.t0, self.spans)
        self.prof = None

    @contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        a = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((a, time.time_ns(), name))


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(events, window_s: float, spans=()) -> dict:
    """Read the slice's events: ``busy_s`` (device intervals, merged),
    ``window_s``, ``kernels`` {name: seconds} summed over calls, ``calls``
    {name: count}, ``device_ops`` (the ten longest by summed time) and
    ``idle_gaps`` (the ten longest gaps between device work, each named by
    the innermost harness span and the innermost host call that covered
    its middle)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], list(spans)
    for e in events:
        if e.device_type() == cuda:
            if e.is_user_annotation():
                continue  # a host span mirrored on the device's timeline
            dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        else:
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    kernels, calls = defaultdict(float), defaultdict(int)
    for a, b, name in dev:
        kernels[name] += (b - a) / 1e9
        calls[name] += 1
    merged = _merge([(a, b) for a, b, _ in dev])
    busy = sum(b - a for a, b in merged) / 1e9
    gaps = [(b0, a1) for (_, b0), (a1, _) in zip(merged, merged[1:])]
    labelled = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (a + b) / 2
        cover = [(e - s, name) for s, e, name in host if s <= mid <= e]
        bench = min((c for c in cover if c[1].startswith("bench.")), default=(0, "-"))[1]
        op = min((c for c in cover if not c[1].startswith("bench.")), default=(0, "-"))[1]
        labelled.append([f"{bench} {op}", (b - a) / 1e9])
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "window_s": window_s, "kernels": dict(kernels), "calls": dict(calls),
            "device_ops": [[name, s] for name, s in top], "idle_gaps": labelled}


def idle_share(data: dict):
    """The share of the profiled slice in which no kernel, copy or fill ran
    on the device (1 - busy / slice), or ``None`` where the run profiled
    nothing."""
    s = data.get("slice")
    if not s or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
