"""The end of a run, ``run.py::report``, at a tiny size on the CPU: the
result line comes last, with the compared numbers last in it; a request that
never finished does not make the run incorrect; a traced run reports the
metrics read from the program's spans and names its idle gaps by them; and a
forbidden module that the judge loads after the window stops the run with no
result."""

from __future__ import annotations

import json
import sys
import types

import pytest

from benchlib import host, program_spans, serve, spec

RUN = spec.load_module(host.BENCH_DIR / "run.py")


@pytest.fixture
def finished(tiny_cell, monkeypatch):
    """A tiny run whose window has closed. The check for forbidden modules
    looks only at modules loaded from here on: other test files of the
    same test process may have loaded JAX."""
    before = dict(sys.modules)
    check = host.forbidden_modules

    def loaded_since(names=None):
        if names is None:
            names = [n for n, m in list(sys.modules.items()) if before.get(n) is not m]
        return check(names)

    monkeypatch.setattr(host, "forbidden_modules", loaded_since)
    c = tiny_cell("qwen3-1.7b.docqa", seconds=1.0)
    return c, serve.run(c, c.ref, {})


def _last_line(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_report_prints_the_result_last_with_checks_last(finished, capsys):
    c, data = finished
    data["setup_s"] = 1.0
    RUN.report(c, data, "cpu")
    out, err = capsys.readouterr()
    line = _last_line(out)
    assert line["correct"] is True and list(line)[-1] == "checks"
    assert set(line["checks"]) == set(c.mix["check"]["limits"])
    assert {"ttft_p90_ms", "itl_p99_ms", "setup_s"} <= set(line["metrics"])
    assert err.strip().splitlines()[-1].startswith("check gap:")


def test_a_request_that_never_finished_is_not_an_incorrect_output(finished, capsys):
    c, data = finished
    data["setup_s"], data["failed"] = 1.0, 3
    RUN.report(c, data, "cpu")
    line = _last_line(capsys.readouterr().out)
    assert line["correct"] is True and line["failed"] == 3


def test_a_traced_run_reports_the_program_spans(finished, capsys):
    c = finished[0]
    c.trace, c.seconds = True, 2.0
    c.mix["trace"] = dict(c.mix["trace"], min_ticks=1, min_prefills=0)  # most ticks outside the slice
    data = program_spans.traced(serve.run, c, c.ref, {})
    data["setup_s"] = 1.0
    assert data["spans"] and "program_idle_gaps" in data["slice"]
    # the CPU's slice has no device gaps to name: one is planted
    named = [["bench.tick serve.decode/serve.decode.readback -", 0.01]]
    data["slice"]["program_idle_gaps"] = named
    RUN.report(c, data, "cpu")
    line = _last_line(capsys.readouterr().out)
    assert line["correct"] is True and line["breakdown"]["idle_gaps"] == named
    assert {"decode_issue_ms.docqa", "admit_stall_p99_ms.docqa"} <= set(line["metrics"])
    assert {m["name"] for m in c.per_layer} >= set(line["metrics"])


@pytest.mark.parametrize("name", ["jax", "repro"])
def test_a_forbidden_module_loaded_by_the_judge_stops_the_run(finished, capsys, monkeypatch, name):
    c, data = finished
    data["setup_s"] = 1.0
    judge = data["finish"]

    def loads_forbidden():
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
        return judge()

    data["finish"] = loads_forbidden
    with pytest.raises(SystemExit) as e:
        RUN.report(c, data, "cpu")
    assert e.value.code != 0
    out, err = capsys.readouterr()
    assert '"correct"' not in out and name in err
