"""``decode_graph_share.batch``'s reader: the window's replayed decode calls
over its decode calls, from the loop's counts at the window's opening and
close; nothing where the program keeps no replay count or the window holds
no decode call. A tiny batch run on the CPU, where the program captures no
step, reads 0."""

from __future__ import annotations

import pytest

from benchlib import serve, spec

READ = spec.reader("decode_graph_share.batch")


def _stats(calls, replays=None):
    return {"decode_calls": calls, **({} if replays is None else {"decode_graph_replays": replays})}


def test_reads_the_windows_share_of_replayed_calls():
    data = {"stats_open": _stats(40, 40), "stats_close": _stats(240, 230)}
    assert READ(data) == pytest.approx(100.0 * 190 / 200)


def test_reads_nothing_without_the_count_or_a_call():
    assert READ({"stats_open": _stats(40), "stats_close": _stats(240)}) is None
    assert READ({"stats_open": _stats(40, 40), "stats_close": _stats(40, 40)}) is None


def test_a_tiny_batch_run_on_the_cpu_reads_no_replay(tiny_cell):
    c = tiny_cell("qwen3-1.7b.batch", seconds=1.0)
    data = serve.run(c, c.ref, {})
    assert data["stats_close"]["decode_calls"] > data["stats_open"]["decode_calls"]
    assert READ(data) == 0.0
