"""The control: the reference put in the program's place with float8
products, the step below the bfloat16 that the configurations state. It has
to come out as not correct under each cell's limits. On the card it runs at
the cell's own size on three seeds (``tools/study.py`` reads the same
numbers); on the CPU, at a tiny size, its machinery is shown to move the
numbers compared far past round-off."""

from __future__ import annotations

import gc
from types import SimpleNamespace

import pytest
import torch

from benchlib import judge, serve, spec, traffic, train

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
SEEDS = (3_141_592_653, 2_718_281_828, 1_618_033_988)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes_at_the_cells_size(cuda, name):
    from benchlib import host

    c = spec.resolve(name)
    c.device, c.seconds, c.trace, c.clock = "cuda", 10.0, False, host.seconds_since_start
    limits = c.mix["check"]["limits"]
    for seed in SEEDS:
        c.seed = seed
        if c.mix["kind"] == "train":
            data = train.run(c, c.ref, {})
            assert judge.verdict(limits, data["finish"]())[0]
            d, mix = c.ref.dims(c.cfg), c.mix
            runs = {}
            for quant in (None, "fp8"):
                runs[quant] = c.ref.train(c.cfg, c.ref.make_params(c.cfg, seed, "cuda", torch.float32),
                                          lambda i: traffic.microbatch(mix, seed, i, d.V, "cuda")["tokens"],
                                          mix["optimizer"], mix["check_steps"], mix["microbatches"], quant=quant)
                gc.collect()
                torch.cuda.empty_cache()
            assert not judge.verdict(limits, judge.train_gaps(runs["fp8"], runs[None]))[0]
        else:
            data = serve.run(c, c.ref, {})
            orig = judge.serve_gaps
            judge.serve_gaps = lambda *a, **k: orig(*a, **{**k, "control": True})
            try:
                got = data["finish"]()
            finally:
                judge.serve_gaps = orig
            for k, lim in limits.items():
                assert got[k] <= lim < got["control_" + k], got
        gc.collect()
        torch.cuda.empty_cache()


def test_control_moves_the_served_logits_past_round_off(tiny_cell):
    c = tiny_cell("qwen3-1.7b.docqa")
    params = c.ref.make_params(c.cfg, 11, "cpu", torch.float32)
    seq = torch.randint(0, 256, (40,), generator=torch.Generator().manual_seed(1))
    exact = c.ref.served_logits(c.cfg, params, [seq], [32])[0]
    low = c.ref.served_logits(c.cfg, params, [seq], [32], quant="fp8")[0]
    rel = float((exact - low).abs().max() / exact.abs().max())
    assert rel > 1e-3


def test_control_moves_the_training_readings_past_round_off(tiny_cell):
    c = tiny_cell("qwen3-1.7b.train")
    d, mix = c.ref.dims(c.cfg), c.mix
    runs = {q: c.ref.train(c.cfg, c.ref.make_params(c.cfg, 5, "cpu", torch.float32),
                           lambda i: traffic.microbatch(mix, 5, i, d.V, "cpu")["tokens"], mix["optimizer"],
                           mix["check_steps"], mix["microbatches"], quant=q) for q in (None, "fp8")}
    got = judge.train_gaps(runs["fp8"], runs[None])
    assert got["grad"] > 1e-3 and got["loss"] > 1e-5, got


def test_the_judge_reports_the_mean_gap_beside_the_widest(tiny_cell):
    """Served tokens that are the reference's own greedy tokens but for one,
    altered: the widest gap is that token's, the mean gap its share over
    the served tokens; the control's are read at the same positions."""
    c = tiny_cell("qwen3-1.7b.docqa")
    params = c.ref.make_params(c.cfg, 13, "cpu", torch.float32)
    gen = torch.Generator().manual_seed(2)
    prompts = [torch.randint(0, 256, (n,), generator=gen) for n in (24, 9)]
    reqs = []
    for rid, p in enumerate(prompts):
        toks = []
        for _ in range(5):  # greedy by the reference itself
            seq = torch.cat([p, torch.tensor(toks, dtype=torch.long)])
            toks.append(int(c.ref.served_logits(c.cfg, params, [seq], [len(seq)])[0][-1].argmax()))
        reqs.append(SimpleNamespace(rid=rid, prompt=p.numpy(), tokens=toks))
    exact = judge.serve_gaps(c.ref, c.cfg, params, reqs, "cpu", control=True)
    assert exact["tokens"] == 10 and exact["gap"] < 1e-5 and exact["mean_gap"] < 1e-6
    assert exact["control_gap"] >= exact["control_mean_gap"] >= 0.0
    reqs[1].tokens[-1] = (reqs[1].tokens[-1] + 1) % 256  # the last: no later position reads it
    got = judge.serve_gaps(c.ref, c.cfg, params, reqs, "cpu")
    assert got["gap"] > 1e-3 and got["mean_gap"] == pytest.approx(got["gap"] / 10, rel=1e-4)
    assert "control_mean_gap" not in got
