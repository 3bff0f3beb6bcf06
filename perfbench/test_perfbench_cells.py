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
PROGRAM = host.ROOT / "src" / "repro_torch"
SERVED_LIMITS, TRAIN_LIMITS = {"gap", "mean_gap"}, {"loss", "grad", "change"}


def _modules(layer: str) -> list[str]:
    """The program's modules that a per-layer metric's ``layer`` names, as
    paths under ``src/repro_torch``: ``models/model.py``; a bare
    ``attention.py`` lies in the folder of the path before it."""
    out, folder = [], ""
    for name in re.findall(r"[A-Za-z0-9_/]+\.py", layer):
        if "/" in name:
            folder = name.rsplit("/", 1)[0]
        elif folder:
            name = f"{folder}/{name}"
        out.append(name)
    return out


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    c = spec.resolve(name)
    assert c.chips == 1
    assert c.mix["kind"] in ("open_loop", "closed_loop", "train")
    assert callable(c.ref.make_params) and callable(c.ref.dims)
    # the contract every reference states: the program's sizes, and its own CPU-sized cut
    assert callable(c.ref.program_sizes) and callable(c.ref.tiny_cut)
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
    for layer in {m["layer"] for m in BENCH["per_layer"]}:
        named = _modules(layer)
        assert named or layer == "device", f"{layer!r} names no module of the program"
        for mod in named:
            assert (PROGRAM / mod).is_file(), (layer, mod)
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


def _limits_breaches(mix: dict) -> list[str]:
    """What is wrong with a mix's ``check.limits``: a served mix limits the
    widest gap and may limit the mean gap beside it, never in its place; a
    training mix limits its loss, gradient and change gaps; every limit is
    a positive float."""
    limits = mix["check"]["limits"]
    allowed = TRAIN_LIMITS if mix["kind"] == "train" else SERVED_LIMITS
    out = [f"{k}: not a number the judge compares" for k in limits if k not in allowed]
    if mix["kind"] != "train" and "gap" not in limits:
        out.append("a served mix has no limit on the widest gap")
    if not limits:
        out.append("no limits")
    return out + [f"{k}: {v!r} is no positive float" for k, v in limits.items()
                  if not (isinstance(v, float) and v > 0)]


@pytest.mark.parametrize("name", CELLS)
def test_limits_hold_only_numbers_the_judge_compares(name):
    """A request left open when the drain ends is late, not wrong: no mix
    holds a count of failed requests among its limits."""
    assert _limits_breaches(spec.resolve(name).mix) == []


@pytest.mark.parametrize("limits,ok", [({"gap": 0.3}, True), ({"gap": 0.3, "mean_gap": 0.03}, True),
                                       ({"mean_gap": 0.03}, False), ({"gap": 0.3, "failed": 1.0}, False),
                                       ({"gap": 0.3, "loss": 1e-4}, False)])
def test_a_served_mix_limits_the_widest_gap(limits, ok):
    mix = {"kind": "open_loop", "check": {"limits": limits}}
    assert (_limits_breaches(mix) == []) == ok


def test_every_file_under_paths_is_named_from_name_characters():
    for p in (host.BENCH_DIR).rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(host.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_file_matches_the_program_it_runs(name):
    """The program's configuration (its preset and the file's overrides)
    holds every size that the reference states for the file
    (``program_sizes``), and the weights the benchmark makes have the
    program's shapes, leaf for leaf."""
    from benchlib import program

    c = spec.resolve(next(w["name"] for w in BENCH["workloads"] if w["config"] == name))
    assert program.breaches(c.ref, c.cfg) == []


def test_weights_are_the_seeds_and_made_in_the_serving_dtype(tiny_cell):
    c = tiny_cell("qwen3-1.7b.docqa")
    d = c.ref.dims(c.cfg)
    a = c.ref.make_params(c.cfg, 2**40 + 3, "cpu", torch.bfloat16)
    b = c.ref.make_params(c.cfg, 2**40 + 3, "cpu", torch.bfloat16)
    e = c.ref.make_params(c.cfg, 2**40 + 4, "cpu", torch.bfloat16)
    for (_, x), (_, y), (_, z) in zip(c.ref.leaves_of(a, d), c.ref.leaves_of(b, d), c.ref.leaves_of(e, d)):
        assert x.dtype == torch.bfloat16 and torch.equal(x, y)
        assert x.abs().sum() == 0 or not torch.equal(x, z)
