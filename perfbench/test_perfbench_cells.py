"""Every cell of ``BENCHMARK.json`` resolves to its files by name, and the
file keeps the shape the benchmark's contract gives it."""

from __future__ import annotations

import re

import pytest
import torch

from benchlib import host, spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    c = spec.resolve(name)
    assert c.chips == 1
    assert c.mix["kind"] in ("open_loop", "closed_loop", "train")
    assert callable(c.ref.make_params) and callable(c.ref.dims)
    assert [m["name"] for m in c.end_to_end if m["name"] != "setup_s"], "a cell reports an end-to-end metric"
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert c.per_layer, "a cell reports a per-layer metric"
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m["name"]))


def test_names_units_and_keys():
    allowed = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert set(BENCH) == allowed
    assert BENCH["command"] == ["python3", "perfbench/run.py"] and BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[key]]
    assert all(NAME.match(n) for n in names)
    assert len(set(n for n in names if n not in {c["name"] for c in BENCH["configs"]})) == \
        len([n for n in names if n not in {c["name"] for c in BENCH["configs"]}])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (host.ROOT / c["file"]).is_file() and c["file"].startswith("perfbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert len(layers) == 5
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        for cell in m["workloads"]:
            # each cell that reports a per-layer metric reports what it moves
            assert cell in CELLS and cell in e2e[m["moves"]].get("workloads", CELLS)


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_a_reader_returns_nothing_where_its_data_is_missing(name):
    """The ``workloads`` lists decide which cells report a metric; a reader
    itself returns ``None`` only where the run holds nothing for it."""
    assert spec.reader(name)({}) is None
    assert spec.reader(name)({"slice": None, "requests": [], "prefills": [], "steps": []}) is None


@pytest.mark.parametrize("name", CELLS)
def test_limits_hold_only_numbers_the_judge_compares(name):
    """A request left open when the drain ends is late, not wrong: no mix
    holds a count of failed requests among its limits."""
    limits = spec.resolve(name).mix["check"]["limits"]
    assert limits and set(limits) <= {"gap", "loss", "grad", "change"}
    assert all(isinstance(v, float) and v > 0 for v in limits.values())


def test_every_file_under_paths_is_named_from_name_characters():
    for p in (host.BENCH_DIR).rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(host.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_file_matches_the_program_it_runs(name):
    """The program's configuration (its preset and the file's overrides)
    has the sizes the file states, and the weights the benchmark makes
    have the program's shapes, leaf for leaf."""
    from benchlib import program
    from repro_torch.models import model as M

    c = spec.resolve(next(w["name"] for w in BENCH["workloads"] if w["config"] == name))
    cfg, d = c.cfg, c.ref.dims(c.cfg)
    m = program.model_config(cfg)
    assert (m.num_layers, m.d_model, m.num_heads, m.num_kv_heads, m.head_dim_, m.vocab_size) == \
        (d.L, d.D, d.H, d.KH, d.hd, d.V)
    assert m.tie_embeddings == d.tied and m.norm_eps == d.eps and m.rope_theta == d.theta
    assert m.qk_norm == d.qk_norm and m.d_ff == d.F
    assert not any(m.layer_is_moe(i) for i in range(m.num_layers))
    theirs = M.model_shapes(m)
    assert [tuple(t.shape) for _, t in c.ref.leaves_of(theirs, d)] == [s for _, s, _ in c.ref.leaf_paths(d)]
    assert len(c.ref.leaf_paths(d)) == sum(1 for _ in _leaves(theirs))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def test_weights_are_the_seeds_and_made_in_the_serving_dtype(tiny_cell):
    c = tiny_cell("qwen3-1.7b.docqa")
    d = c.ref.dims(c.cfg)
    a = c.ref.make_params(c.cfg, 2**40 + 3, "cpu", torch.bfloat16)
    b = c.ref.make_params(c.cfg, 2**40 + 3, "cpu", torch.bfloat16)
    e = c.ref.make_params(c.cfg, 2**40 + 4, "cpu", torch.bfloat16)
    for (_, x), (_, y), (_, z) in zip(c.ref.leaves_of(a, d), c.ref.leaves_of(b, d), c.ref.leaves_of(e, d)):
        assert x.dtype == torch.bfloat16 and torch.equal(x, y)
        assert x.abs().sum() == 0 or not torch.equal(x, z)
