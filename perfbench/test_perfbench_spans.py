"""The program's own spans in a traced run (``benchlib/program_spans.py``,
``tools/spans.py``), at a tiny size on the CPU: each reading comes out
finite; a program without a recorder leaves the run as it was; and an idle
gap inside a program span is named by it."""

from __future__ import annotations

import math
import sys
from collections import namedtuple

import pytest

from benchlib import program, program_spans, serve, spec, train
from repro_torch.spans import Span

TOOL = spec.load_module(spec.BENCH_DIR / "tools" / "spans.py")
READINGS = {"qwen3-1.7b.docqa": ("decode_issue_ms", "admit_stall_p99_ms"),
            "qwen3-1.7b.batch": ("decode_issue_ms", "decode_readback_ms"),
            "qwen3-1.7b.train": ("accum_share",)}
ADDED = ("spans", "window_ns")
ADDED_TO_SLICE = ("ns", "gaps", "gap_labels", "program_idle_gaps", "idle_by_span")


def _traced(tiny_cell, name):
    c = tiny_cell(name, seconds=24.0 if name.endswith(".train") else 1.5)
    if c.mix["kind"] == "train":
        # a tiny microbatch takes 0.5-2 s here, and a step under the profiler up to 7 s on a loaded CPU: the
        # first step is traced and counted, and the window holds untraced steps after it
        c.mix.update(microbatches=3, first_steps=1, check_steps=1, trace=dict(c.mix["trace"], start_frac=0.0))
    c.trace = True
    drive = train.run if c.mix["kind"] == "train" else serve.run
    phases = {}
    return c, program_spans.traced(drive, c, c.ref, phases), phases


@pytest.mark.parametrize("name", list(READINGS))
def test_each_reading_is_finite_on_a_tiny_traced_run(tiny_cell, name):
    c, data, phases = _traced(tiny_cell, name)
    got = TOOL.readings(data, phases)
    for key in READINGS[name]:
        assert got[key] is not None and math.isfinite(got[key]), (key, got)
    assert data["slice"]["ns"][0] < data["slice"]["ns"][1]
    assert got["by_name"] and all(math.isfinite(v["host_ms_median"]) for v in got["by_name"].values())
    # the cell's metrics that read the program's spans read what the tool reads
    metrics = [m["name"] for m in c.per_layer + c.end_to_end]
    of_spans = [m for m in metrics if spec.reader(m).__module__ == program_spans.__name__]
    assert sorted(m.split(".")[0] for m in of_spans) == sorted(READINGS[name])
    assert all(spec.reader(m)(data) == got[m.split(".")[0]] for m in of_spans)
    # the other readers read the same values without what the spans added
    others = [m for m in metrics if m not in of_spans]
    before = {m: spec.reader(m)(data) for m in others}
    for key in ADDED:
        del data[key]
    for key in ADDED_TO_SLICE:
        data["slice"].pop(key, None)
    assert {m: spec.reader(m)(data) for m in others} == before
    assert all(spec.reader(m)(data) is None for m in of_spans)


def test_without_a_recorder_the_run_is_left_as_it_was(tiny_cell, monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)  # a program that has none
    assert program.recorder() is None
    c = tiny_cell("qwen3-1.7b.docqa")
    c.trace = True
    clock, seen = c.clock, []

    def drive(cell, ref, phases):
        seen.append(cell.clock)
        return {"slice": None, "requests": [], "steps": []}

    data = program_spans.traced(drive, c, c.ref, {})
    assert seen == [clock] and c.clock is clock
    assert data == {"slice": None, "requests": [], "steps": []}
    assert program_spans.decode_ms(data, "serve.decode.issue") is None
    assert program_spans.admit_stall_p99_ms(data) is None and program_spans.accum_share(data) is None


def test_an_untraced_run_never_turns_the_recorder_on(tiny_cell):
    c = tiny_cell("qwen3-1.7b.batch", seconds=0.5)
    data = program_spans.traced(serve.run, c, c.ref, {})
    assert not any(key in data for key in ADDED)
    assert not program.recorder().on


Event = namedtuple("Event", "a b name cuda")


class _Ev:
    """A profiler event of a slice: a kernel on the device or a host call."""

    def __init__(self, e: Event):
        self.e = e

    def start_ns(self):
        return self.e.a

    def duration_ns(self):
        return self.e.b - self.e.a

    def name(self):
        return self.e.name

    def device_type(self):
        import torch

        return torch.autograd.DeviceType.CUDA if self.e.cuda else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return False


def test_a_planted_gap_inside_a_program_span_is_named_by_it():
    events = [_Ev(Event(0, 10, "k0", True)), _Ev(Event(50, 60, "k1", True)), _Ev(Event(140, 150, "k2", True)),
              _Ev(Event(20, 40, "cudaLaunchKernel", False))]
    gaps, labels = program_spans.slice_gaps(events, [(0, 200, "bench.tick")])
    assert gaps == [[60, 140], [10, 50]] and labels == [["bench.tick", "-"], ["bench.tick", "cudaLaunchKernel"]]
    spans = [Span("serve.tick", 0, 200, -1, -1, None), Span("serve.decode", 5, 190, 0, -1, None),
             Span("serve.decode.issue", 5, 70, 1, -1, None), Span("model.attn", 15, 45, 2, -1, None),
             Span("serve.decode.readback", 70, 190, 1, -1, None), Span("serve.tick", 300, 400, -1, -1, None)]
    named, by_span = program_spans.name_gaps(gaps, labels, spans, (0, 200))
    assert named == [["bench.tick serve.decode/serve.decode.readback -", 80e-9],
                     ["bench.tick serve.decode.issue/model.attn cudaLaunchKernel", 40e-9]]
    assert by_span == {"serve.decode/serve.decode.readback": 80e-9, "serve.decode.issue/model.attn": 40e-9}
    outside = program_spans.name_gaps([[250, 260]], [], spans, (0, 500))
    assert outside == ([], {"-": 10e-9})
