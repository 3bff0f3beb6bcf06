"""The seeded weights of ``moonlight-16b-a3b`` route on the token's identity
with margins wider than bf16 round-off (``moonlight_ref._route_by_token``):
the channel holds what the reference says, and at a cut on the CPU the
program in bf16, and the fp8 control, choose every token's experts as the
float32 reference does, the correction bias deciding among equals."""

from __future__ import annotations

import pytest
import torch

from benchlib import program, spec

CELL = "moonlight-16b-a3b.docqa8k"


@pytest.fixture
def cut(tiny_cfg):
    """The configuration at its reference's cut with six layers, so that five
    expert layers route; the program in bf16."""
    c = spec.resolve(CELL)
    cfg = tiny_cfg(c.cfg, c.ref, fp32=False)
    cfg["num_hidden_layers"] = 6
    cfg["program"]["overrides"]["num_layers"] = 6
    return c.ref, cfg


def test_the_routing_channel_holds_the_embedding_alone(cut):
    ref, cfg = cut
    d = ref.dims(cfg)
    m = ref.route_dims(d)
    p = ref.make_params(cfg, 2**34 + 3, "cpu", torch.bfloat16)
    assert m == d.D // 4 and ref.route_dims(ref.dims(spec.resolve(CELL).cfg)) == ref.ROUTE_DIMS
    assert set(p["embed"][:, :m].unique().tolist()) == {-1.0, 1.0}
    for i, layer in enumerate(p["layers"]):
        writes = [layer["attn"]["wo"]]
        writes += [layer["ffn"]["down"]] if i < d.dense else [layer["moe"]["down"], layer["moe"]["shared"]["down"]]
        assert all(not w[..., :m].any() and w[..., m:].any() for w in writes), i
        if i < d.dense:
            continue
        w = layer["moe"]
        assert not w["router"][m:].any()
        assert set(w["router"][:m].unique().tolist()) == {-ref.ROUTE_SCALE, ref.ROUTE_SCALE}
        assert torch.equal(w["bias"].sort().values.float(), torch.arange(d.E) * ref.BIAS_STEP)


def _program_routes(mcfg, params, prompt, served, monkeypatch):
    """Each expert layer's choices (sets, as sorted rows) of the program's
    prefill of ``prompt`` and decode steps over ``served``, by position."""
    from repro_torch.models import model as M
    from repro_torch.models import moe

    calls = []
    gates = moe._gates

    def spy(cfg, p, x):
        g, top = gates(cfg, p, x)
        calls.append(top.sort(-1).values)
        return g, top

    monkeypatch.setattr(moe, "_gates", spy)
    run = program.serve_run()
    _, cache = M.prefill(mcfg, run, params, prompt[None], prompt.shape[0] + len(served))
    for tok in served:
        _, cache = M.decode_step(mcfg, run, params, cache, torch.tensor([[tok]]))
    n = len(calls) // (1 + len(served))  # expert layers
    return [torch.cat([calls[layer]] + [calls[n * (1 + j) + layer] for j in range(len(served))]) for layer in range(n)]


def _reference_routes(ref, cfg, params, seq, quant, monkeypatch):
    calls = []
    route = ref.route

    def spy(d, w, t, quant=None):
        g, top = route(d, w, t, quant)
        calls.append(top.sort(-1).values)
        return g, top

    monkeypatch.setattr(ref, "route", spy)
    ref.served_logits(cfg, params, [seq], [seq.shape[0]], quant=quant)
    monkeypatch.setattr(ref, "route", route)
    return calls


def test_the_program_in_bf16_and_the_control_route_as_the_reference(cut, monkeypatch):
    ref, cfg = cut
    d = ref.dims(cfg)
    params = ref.make_params(cfg, 2**35 + 17, "cpu", torch.bfloat16)
    gen = torch.Generator().manual_seed(11)
    prompt = torch.randint(0, d.V, (60,), generator=gen)
    served = torch.randint(0, d.V, (8,), generator=gen).tolist()
    seq = torch.cat([prompt, torch.tensor(served)])
    want = _reference_routes(ref, cfg, params, seq, None, monkeypatch)
    assert len(want) == d.L - d.dense
    got = _program_routes(program.model_config(cfg), params, prompt, served, monkeypatch)
    for layer, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), f"expert layer {layer}: {int((a != b).any(-1).sum())} tokens differ"
    for layer, (a, b) in enumerate(zip(_reference_routes(ref, cfg, params, seq, "fp8", monkeypatch), want)):
        assert torch.equal(a, b), f"control, expert layer {layer}"


def test_the_correction_bias_decides_among_equal_products(cut, monkeypatch):
    """Without the bias some tokens choose other experts (a tie of whole
    products broken by the index instead), but no choice of a larger
    product is undone by it."""
    ref, cfg = cut
    d = ref.dims(cfg)
    params = ref.make_params(cfg, 2**35 + 29, "cpu", torch.float32)
    seq = torch.randint(0, d.V, (200,), generator=torch.Generator().manual_seed(12))
    with_bias = _reference_routes(ref, cfg, params, seq, None, monkeypatch)
    for layer in params["layers"][d.dense:]:
        layer["moe"]["bias"].zero_()
    without = _reference_routes(ref, cfg, params, seq, None, monkeypatch)
    moved = sum(int((a != b).any(-1).sum()) for a, b in zip(with_bias, without))
    assert 0 < moved < seq.shape[0] * len(with_bias)
    m = ref.route_dims(d)
    h_sign = params["embed"][seq, :m]
    for layer, chosen in zip(params["layers"][d.dense:], with_bias):
        n = (h_sign @ layer["moe"]["router"][:m].sign()).round()  # matching signs less mismatching
        kth = n.gather(-1, chosen).min(-1).values
        assert (n.sort(-1, descending=True).values[:, d.K] <= kth).all()
