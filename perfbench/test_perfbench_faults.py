"""The rest of a run, past the harness's look for a card, at a tiny size on
the CPU, for every served cell of ``BENCHMARK.json`` (found by its mix's
kind) and the training cell: sound, ``correct`` comes out true; with the
timed path broken underneath, false. Once for each fault a cell can have: a decode step that
returns its state unchanged, a token altered where it is produced, an
optimizer step that returns its state unchanged, half of each training
microbatch left out (the mean taken over the rest). The cells have one card
each, so no exchange between cards can be left out.

The program runs in float32 here, so a sound run agrees with the float32
reference to round-off and the limits are the tiny size's own:
``TINY_LIMITS`` sits far above round-off and far below every fault."""

from __future__ import annotations

import pytest
import torch

from benchlib import judge, program, serve, spec, train

TINY_LIMITS = {"gap": 1e-3, "mean_gap": 1e-4, "loss": 1e-4, "grad": 1e-3, "change": 1e-3}
# every served cell of BENCHMARK.json, by its mix's kind
SERVED = [w["name"] for w in spec.benchmark()["workloads"] if spec.resolve(w["name"]).mix["kind"] != "train"]


def _verdict(c, got):
    return judge.verdict({k: TINY_LIMITS[k] for k in c.mix["check"]["limits"]}, got)


def _token_altered(loop):
    """The decode step's greedy token replaced by the next id."""
    step = loop._decode_arena

    def bad(arena, toks, act):
        return (step(arena, toks, act) + 1) % loop.cfg.vocab_size

    loop._decode_arena = bad


def _decode_state_unchanged(loop):
    """The decode step runs on a copy of the arena: the cache and the
    positions it returns are the ones it was given."""
    step = loop._decode_arena

    def bad(arena, toks, act):
        return step({k: (v.clone() if torch.is_tensor(v) else v) for k, v in arena.items()}, toks, act)

    loop._decode_arena = bad


SERVE_FAULTS = {"token_altered": _token_altered, "decode_state_unchanged": _decode_state_unchanged}


@pytest.mark.parametrize("cell", SERVED)
@pytest.mark.parametrize("fault", [None, *SERVE_FAULTS])
def test_serving_run_is_judged(tiny_cell, monkeypatch, cell, fault):
    c = tiny_cell(cell, seconds=1.0)
    if fault:
        make = program.serve_loop

        def faulty(*args, **kwargs):
            loop = make(*args, **kwargs)
            SERVE_FAULTS[fault](loop)
            return loop

        monkeypatch.setattr(program, "serve_loop", faulty)
    data = serve.run(c, c.ref, {})
    assert data["attempted"] > 0 and data["failed"] == 0
    got = data["finish"]()
    assert 0.0 <= got["mean_gap"] <= got["gap"]
    correct, checks = _verdict(c, got)
    assert correct == (fault is None), checks


def _update_unchanged(coord):
    def bad(p, o, g):
        return p, o, {}

    coord.update_fn = bad


def _half_batch(coord):
    grad = coord.grad_fn

    def bad(p, batch):
        half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        return grad(p, half)

    coord.grad_fn = bad


TRAIN_FAULTS = {"update_unchanged": _update_unchanged, "half_batch": _half_batch}


@pytest.mark.parametrize("fault", [None, *TRAIN_FAULTS])
def test_training_run_is_judged(tiny_cell, monkeypatch, fault):
    c = tiny_cell("qwen3-1.7b.train", seconds=0.5)
    if fault:
        make = program.trainer

        def faulty(*args, **kwargs):
            coord, opt_state = make(*args, **kwargs)
            TRAIN_FAULTS[fault](coord)
            return coord, opt_state

        monkeypatch.setattr(program, "trainer", faulty)
    data = train.run(c, c.ref, {})
    correct, checks = _verdict(c, data["finish"]())
    assert correct == (fault is None), checks
