"""The plain reference agrees with the program, ``repro_torch``, at a tiny
size on the CPU in float32: the logits of a prefill and of each decode step
through the cache, and the training steps of the program's trainer."""

from __future__ import annotations

import pytest
import torch

from benchlib import program


def _logits_of_program(mcfg, params, prompt, served):
    """The program's logits at each served token's position: its prefill's
    last position, then a decode step per served token but the last."""
    from repro_torch.models import model as M

    run = program.serve_run()  # K2 and K1: their plain versions on the CPU
    logits, cache = M.prefill(mcfg, run, params, prompt[None], prompt.shape[0] + len(served))
    out = [logits[0, -1]]
    for tok in served[:-1]:
        lg, cache = M.decode_step(mcfg, run, params, cache, torch.tensor([[tok]]))
        out.append(lg[0, -1])
    return torch.stack(out).float()


@pytest.mark.parametrize("n_prompt,n_served", [(48, 7), (17, 12)])
def test_served_logits_agree_with_the_program(tiny_cell, n_prompt, n_served):
    c = tiny_cell("qwen3-1.7b.docqa")
    cfg = c.cfg
    mcfg = program.model_config(cfg)
    params = c.ref.make_params(cfg, 2**35 + 1, "cpu", torch.float32)
    gen = torch.Generator().manual_seed(4)
    prompt = torch.randint(0, 256, (n_prompt,), generator=gen)
    served = torch.randint(0, 256, (n_served,), generator=gen).tolist()
    mine = _logits_of_program(mcfg, params, prompt, served)
    seq = torch.cat([prompt, torch.tensor(served[:-1])])
    ref = c.ref.served_logits(cfg, params, [seq], [n_prompt])[0]
    assert ref.shape == mine.shape == (n_served, 256)
    assert float((ref - mine).abs().max()) < 1e-4 * float(ref.abs().max())


def test_training_steps_agree_with_the_program(tiny_cell):
    """The harness's training cell at a tiny size in float32: the judged
    gaps of the program's first steps against the reference are round-off."""
    from benchlib import train

    c = tiny_cell("qwen3-1.7b.train")
    data = train.run(c, c.ref, {})
    got = data["finish"]()
    assert got["loss"] < 1e-5 and got["grad"] < 1e-4 and got["change"] < 1e-4, got
