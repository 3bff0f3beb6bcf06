"""The port's mixture-of-experts FFN (``repro_torch.models.moe``) and the
MoE stacks built on it, on the CPU.

* ``moe_apply`` against the JAX package's ``moe_apply`` in fp32 on the same
  numpy inputs: the selected experts, their queue positions and the keep
  masks exactly (read from the reference's two ``jax.nn.one_hot`` calls),
  ``moe_drop_frac`` to the bit, y within ``Y_TOL`` and ``moe_aux`` within
  ``AUX_TOL``; with drops forced by a capacity factor of 0.5.
* Ties between router probabilities go to the lower expert index, as
  ``jax.lax.top_k`` breaks them.
* A sequence longer than the dispatch group and not a multiple of it
  raises, as in the reference (which asserts).
* Prefill then decode reproduces the forward pass (moonshot and mixtral,
  capacity set so nothing drops), as ``tests/test_consistency.py`` holds
  the reference to.
* At decode every row is its own dispatch group, so a parked row's token
  and cache change no active row's logits, in the port and in the
  reference.
* ``ServeLoop`` gives the same greedy tokens in arena and serial mode on
  moonshot-smoke.
* The dropless, DeepSeek-V3-style path (``moonlight-16b-a3b``'s): sigmoid
  ``noaux_tc`` routing equals a loop over the tokens, with a correction
  bias that changes the choice but not the gates; the grouped dispatch
  equals each token's sum over its experts when every token picks the same
  expert and when some expert gets no rows; the shared experts and the
  dense first layer are in the stack; with the new fields at their
  defaults, ``moe_apply`` gives the capacity path's bits.

The tests that need JAX skip on a machine without it.
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.data.dataset import SyntheticCorpus
from repro_torch.launch.serve import Request, ServeLoop
from repro_torch.models import model as M
from repro_torch.models import moe

try:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.configs.base import RunConfig as JaxRunConfig
    from repro.models import model as JM
    from repro.models import moe as jax_moe
except ImportError:  # the card's machine has no JAX
    jax = None

needs_jax = pytest.mark.skipif(jax is None, reason="JAX is not installed: the reference side is missing")

Y_TOL = 1e-5  # fp32 y: the combine sums the k slots in another order than the one-hot einsum
AUX_TOL = 1e-6  # fp32 aux: means summed in another order
STREAM_TOL = 3e-5  # fp32 logits, prefill + decode against forward (tests/test_consistency.py)
WIDE = dict(num_experts=64, experts_per_token=6)  # moonshot's routing at moonshot-smoke's widths, d 64


def _cfgs(arch="moonshot-v1-16b-a3b", **over):
    pcfg = dataclasses.replace(get_config(arch).reduced(**over), compute_dtype="float32")
    if jax is None:
        return None, pcfg
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(**over), compute_dtype="float32")
    return jcfg, pcfg


def _moe_params(rng, d, e, f):
    return {"router": rng.standard_normal((d, e)).astype(np.float32) / np.sqrt(d),
            "gate": rng.standard_normal((e, d, f)).astype(np.float32) / np.sqrt(d),
            "up": rng.standard_normal((e, d, f)).astype(np.float32) / np.sqrt(d),
            "down": rng.standard_normal((e, f, d)).astype(np.float32) / np.sqrt(f)}


def _jax_moe(jcfg, params, x, inference):
    """The reference's y and aux, and the arguments of its two one-hot
    calls: the selected experts (ng, g, k) and (positions, capacity)."""
    seen = []
    one_hot = jax.nn.one_hot

    def record(a, n, **kw):
        seen.append((np.asarray(a), n))
        return one_hot(a, n, **kw)

    with mock.patch.object(jax.nn, "one_hot", record):
        y, aux = jax_moe.moe_apply(jcfg, {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x), None,
                                   inference=inference)
    (top_i, _), (pos, cap) = seen
    return np.asarray(y), {k: np.asarray(v) for k, v in aux.items()}, top_i, pos, cap


@needs_jax
@pytest.mark.parametrize("cf", [None, 0.5], ids=["default_cf", "cf0.5_drops"])
@pytest.mark.parametrize("inference", [False, True], ids=["train", "inference"])
@pytest.mark.parametrize("wide", [False, True], ids=["smoke_E4k2", "E64k6"])
def test_moe_apply_matches_jax(wide, inference, cf):
    over = dict(WIDE) if wide else {}
    if cf is not None:
        over.update(moe_capacity_factor=cf, moe_eval_capacity_factor=cf)
    jcfg, pcfg = _cfgs(**over)
    rng = np.random.default_rng(0)
    params = _moe_params(rng, pcfg.d_model, pcfg.num_experts, pcfg.ffn_dim)
    x = rng.standard_normal((2, 128, pcfg.d_model)).astype(np.float32)  # 2 groups of 64 per row
    jy, jaux, top_i, pos, cap = _jax_moe(jcfg, params, x, inference)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    py, paux = moe.moe_apply(pcfg, tp, torch.from_numpy(x), inference=inference)
    r = moe.route(pcfg, tp, torch.from_numpy(x).reshape(4, 64, pcfg.d_model), inference)
    assert r.cap == cap
    np.testing.assert_array_equal(r.top_i.numpy(), top_i)
    np.testing.assert_array_equal(r.pos.numpy(), pos)
    np.testing.assert_array_equal(r.keep.numpy(), pos < cap)
    assert np.float32(paux["moe_drop_frac"].item()) == jaux["moe_drop_frac"]
    assert abs(paux["moe_aux"].item() - float(jaux["moe_aux"])) < AUX_TOL
    assert float(np.abs(py.numpy() - jy).max()) < Y_TOL
    dropped = float(jaux["moe_drop_frac"])
    if cf == 0.5:
        assert dropped > 0.3  # half the capacity the slots need: many drops
    elif not inference and wide:
        assert dropped > 0.0  # 1.25 is tight for 64 experts: some drops


@pytest.mark.parametrize("k", [1, 3, 6])
def test_top_k_ties_go_to_the_lower_index(k):
    """Duplicated router columns give equal probabilities; the order is
    the lower index first, as ``jax.lax.top_k`` orders them (and as
    ``torch.topk`` does not)."""
    rng = np.random.default_rng(1)
    d, e = 16, 12
    router = rng.standard_normal((d, e)).astype(np.float32)
    for dst, src in ((3, 1), (7, 1), (9, 4), (11, 0), (10, 4)):
        router[:, dst] = router[:, src]
    x = rng.standard_normal((40, d)).astype(np.float32)
    logits = torch.from_numpy(x @ router)
    probs, top_p, top_i = moe._top_k_routing(logits, k)
    assert torch.equal(probs[:, [3, 7, 9, 10, 11]], probs[:, [1, 1, 4, 4, 0]])  # exact ties
    for row in range(40):
        p = probs[row].tolist()
        srt = sorted(range(e), key=lambda j: (-p[j], j))
        assert top_i[row].tolist() == srt[:k]
    if jax is not None:
        _, want = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x @ router), axis=-1), k)
        np.testing.assert_array_equal(top_i.numpy(), np.asarray(want))
    assert torch.allclose(top_p.sum(-1), torch.ones(40))


@needs_jax
def test_tied_router_columns_route_as_jax():
    """The whole layer with tied experts: the reference and the port pick
    the same experts and queue positions."""
    over = dict(WIDE)
    jcfg, pcfg = _cfgs(**over)
    rng = np.random.default_rng(2)
    params = _moe_params(rng, pcfg.d_model, pcfg.num_experts, pcfg.ffn_dim)
    for dst in range(1, 64, 2):  # every odd expert ties with the even one below it
        params["router"][:, dst] = params["router"][:, dst - 1]
    x = rng.standard_normal((1, 64, pcfg.d_model)).astype(np.float32)
    jy, _, top_i, pos, _ = _jax_moe(jcfg, params, x, False)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    r = moe.route(pcfg, tp, torch.from_numpy(x), False)
    assert torch.equal(r.probs[..., 1::2], r.probs[..., ::2])  # exact ties
    np.testing.assert_array_equal(r.top_i.numpy(), top_i)
    np.testing.assert_array_equal(r.pos.numpy(), pos)
    py, _ = moe.moe_apply(pcfg, tp, torch.from_numpy(x), inference=False)
    assert float(np.abs(py.numpy() - jy).max()) < Y_TOL


def test_sequence_not_a_multiple_of_the_group_raises():
    _, pcfg = _cfgs()  # group 64 in the smoke config
    params = M.init_model(pcfg, torch.Generator().manual_seed(0))["layers"][0]["moe"]
    with pytest.raises(ValueError, match="not a multiple of the dispatch group 64"):
        moe.moe_apply(pcfg, params, torch.zeros(1, 96, pcfg.d_model))
    y, _ = moe.moe_apply(pcfg, params, torch.zeros(1, 128, pcfg.d_model))  # two whole groups
    assert y.shape == (1, 128, pcfg.d_model)
    if jax is not None:
        jcfg = _cfgs()[0]
        with pytest.raises(AssertionError):
            jax_moe.moe_apply(jcfg, {k: jnp.asarray(v.numpy()) for k, v in params.items()},
                              jnp.zeros((1, 96, jcfg.d_model)), None)


def _nodrop(cfg):
    cf = float(cfg.num_experts) / cfg.experts_per_token
    return dataclasses.replace(cfg, moe_capacity_factor=cf, moe_eval_capacity_factor=cf)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "mixtral-8x22b"])
def test_prefill_then_decode_matches_forward(arch):
    """The reference's ``test_prefill_decode_matches_forward`` on the port:
    S = 40 runs past mixtral-smoke's window of 16, so its ring wraps."""
    cfg = _nodrop(dataclasses.replace(get_config(arch).reduced(), compute_dtype="float32"))
    params = M.init_model(cfg, torch.Generator().manual_seed(1))
    B, S = 2, 40
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)))
    run = RunConfig(attention_impl="xla")
    full, aux = M.forward(cfg, run, params, tokens)
    assert float(aux["moe_drop_frac"]) == 0.0 and float(aux["moe_aux"]) > 0.0
    split = S - 5
    logits, cache = M.prefill(cfg, run, params, tokens[:, :split], max_len=S)
    assert float((logits[:, 0] - full[:, split - 1]).abs().max()) < STREAM_TOL
    for t in range(split, S):
        logits, cache = M.decode_step(cfg, run, params, cache, tokens[:, t:t + 1])
        assert float((logits[:, 0] - full[:, t]).abs().max()) < STREAM_TOL, t
    assert cache["pos"].tolist() == [S] * B


def test_decode_isolation_port():
    """At decode (S = 1) every row is its own dispatch group with a
    capacity of 1 per expert and distinct experts per slot, so nothing is
    dropped and rows do not compete: the parked row's token and cache
    change no active row's logits, bit for bit."""
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b").reduced(), compute_dtype="float32")
    params = M.init_model(cfg, torch.Generator().manual_seed(2))
    rng = np.random.default_rng(2)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 12)))
    run = RunConfig(attention_impl="xla", decode_attention_impl="einsum")
    _, base = M.prefill(cfg, run, params, prompt, 24)
    act = torch.tensor([True, False, True])
    outs = []
    for variant in range(3):
        cache = {k: v.clone() for k, v in base.items()}
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 1)))
        tok[0], tok[2] = 5, 7
        if variant:
            cache["k"][:, 1].normal_(generator=torch.Generator().manual_seed(variant))
            cache["v"][:, 1].normal_(generator=torch.Generator().manual_seed(variant + 10))
        logits, _ = M.decode_step(cfg, run, params, cache, tok, active=act)
        outs.append(logits[act])
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    cache = {k: v.clone() for k, v in base.items()}
    cap = []
    real = moe.route

    def spy(*a, **kw):
        r = real(*a, **kw)
        cap.append((r.cap, bool(r.keep.all())))
        return r

    with mock.patch.object(moe, "route", spy):
        M.decode_step(cfg, run, params, cache, torch.zeros((3, 1), dtype=torch.long), active=act)
    assert cap == [(1, True)] * cfg.num_layers


@needs_jax
def test_decode_isolation_reference():
    """The reference's decode step: a parked row's token and cache change
    no active row's logits, bit for bit, and nothing is dropped. The
    reference's serve caveat (parked slots consume router capacity) holds
    only for a prefill that batches several prompts in one group."""
    jcfg, _ = _cfgs()
    jp = JM.init_model(jax.random.PRNGKey(0), jcfg)
    run_j = JaxRunConfig(attention_impl="xla", remat="none")
    rng = np.random.default_rng(3)
    _, base = JM.prefill(jcfg, run_j, jp, jnp.asarray(rng.integers(0, jcfg.vocab_size, (3, 12))), 24)
    act = jnp.asarray([True, False, True])
    step = jax.jit(lambda c, t: JM.decode_step(jcfg, run_j, jp, c, t, None, active=act)[0])
    outs = []
    for variant in range(3):
        cache = base
        tok = np.array([[5], [variant * 31 + 1], [7]])
        if variant:
            noise = jax.random.normal(jax.random.PRNGKey(variant), base["layers"]["b0"]["attn"]["k"].shape)
            kv = base["layers"]["b0"]["attn"]
            kv = {"k": kv["k"].at[:, 1].set(noise[:, 1]), "v": kv["v"].at[:, 1].set(noise[:, 1] * 2)}
            cache = {**base, "layers": {"b0": {**base["layers"]["b0"], "attn": kv}}}
        outs.append(np.asarray(step(cache, jnp.asarray(tok)))[[0, 2]])
    assert all(np.array_equal(o, outs[0]) for o in outs[1:])
    # every group of a decode step is one row: capacity 1, nothing dropped
    x = jnp.asarray(rng.standard_normal((3, 1, jcfg.d_model)).astype(np.float32))
    first = jax.tree.map(lambda a: a[0], jp["layers"]["b0"]["moe"])
    _, aux = jax_moe.moe_apply(jcfg, first, x, None, inference=True)
    assert float(aux["moe_drop_frac"]) == 0.0


def test_arena_streams_equal_serial_moe():
    """moonshot-smoke, fp32: the arena's greedy tokens equal the serial
    (one slot per call) tokens, through the plain path and the kernel knobs."""
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b").reduced(), compute_dtype="float32")
    params = M.init_model(cfg, torch.Generator().manual_seed(0))
    lens = (6, 9, 12, 15)
    corpus = SyntheticCorpus(cfg.vocab_size, max(lens), 0)

    def run(mode, knobs):
        reqs = [Request(i, corpus.grain_tokens(i, 1)[0][: lens[i % 4]], 8) for i in range(7)]
        loop = ServeLoop(cfg, knobs, params, batch=4, max_len=32, mode=mode, device="cpu")
        stats = loop.run_requests(reqs)
        assert stats["completed"] == 7
        return [r.tokens for r in reqs]

    for knobs in (RunConfig(attention_impl="xla"),
                  RunConfig(attention_impl="pallas", decode_attention_impl="kernel")):
        arena = run("arena", knobs)
        assert arena == run("serial", knobs)
        assert all(len(t) == 8 for t in arena)


# ---------------------------------------------------------------------------
# Dropless, DeepSeek-V3-style MoE (the port's own; no JAX twin)
# ---------------------------------------------------------------------------

DROPLESS = dict(num_layers=3, d_model=32, num_heads=4, num_kv_heads=4, head_dim=12, d_ff=48, moe_d_ff=16,
                shared_d_ff=32, vocab_size=64, num_experts=8, experts_per_token=2, kv_lora_rank=16,
                qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8, compute_dtype="float32")


def _dropless_cfg(**over):
    return dataclasses.replace(get_config("moonlight-16b-a3b"), **{**DROPLESS, **over})


def _dropless_params(cfg, seed=0, bias=0.05):
    g = torch.Generator().manual_seed(seed)
    p = M.init_model(cfg, g)["layers"][1]["moe"]
    p["bias"].normal_(0.0, bias, generator=g)
    return p


def _per_token(cfg, p, x):
    """The layer token by token: sigmoid scores, the top k of scores + bias
    (ties to the lower index), gates from the scores alone, renormalised and
    scaled; each chosen expert's SwiGLU weighed by its gate; the shared
    experts."""
    out = []
    for t in x:
        scores = torch.sigmoid(t @ p["router"])
        order = sorted(range(cfg.num_experts), key=lambda e: (-float(scores[e] + p["bias"][e]), e))
        chosen = order[:cfg.experts_per_token]
        g = scores[chosen] / scores[chosen].sum() * cfg.routed_scale
        y = sum(gi * (F.silu(t @ p["gate"][e]) * (t @ p["up"][e])) @ p["down"][e] for gi, e in zip(g, chosen))
        sh = p["shared"]
        out.append(y + (F.silu(t @ sh["gate"]) * (t @ sh["up"])) @ sh["down"])
    return torch.stack(out)


def test_sigmoid_routing_equals_a_loop_over_tokens_and_the_bias_moves_only_the_choice():
    cfg = _dropless_cfg()
    p = _dropless_params(cfg)
    x = torch.randn(40, cfg.d_model, generator=torch.Generator().manual_seed(1))
    gates, top = moe._gates(cfg, p, x)
    scores = torch.sigmoid(x @ p["router"])
    for t in range(x.shape[0]):
        want = sorted(range(cfg.num_experts), key=lambda e: (-float(scores[t, e] + p["bias"][e]), e))
        assert top[t].tolist() == want[:cfg.experts_per_token]
        g = scores[t, top[t]]
        assert torch.allclose(gates[t], g / g.sum() * cfg.routed_scale, rtol=1e-6, atol=0)
    unbiased = dict(p, bias=torch.zeros_like(p["bias"]))
    g0, top0 = moe._gates(cfg, unbiased, x)
    moved = (top0 != top).any(-1)
    assert moved.any() and not moved.all()  # the bias changes some tokens' choice
    # where it does not, the gates are the same bits: the bias is not in them
    assert torch.equal(g0[~moved], gates[~moved])
    y, aux = moe.moe_apply(cfg, p, x[None], inference=True)
    assert float((y[0] - _per_token(cfg, p, x)).abs().max()) < 1e-5
    assert float(aux["moe_drop_frac"]) == 0.0


@pytest.mark.parametrize("case", ["one_expert_for_all", "idle_experts"])
def test_dropless_dispatch_equals_the_per_token_sum(case):
    cfg = _dropless_cfg()
    p = _dropless_params(cfg, seed=3)
    if case == "one_expert_for_all":
        # every token's choice is the same two experts, 5 and 2: the others get no rows
        p["router"].zero_()
        p["bias"].zero_()
        p["bias"][5], p["bias"][2] = 1.0, 0.5
    else:
        p["bias"][[0, 3, 6]] = -10.0  # three experts no token chooses
    x = torch.randn(33, cfg.d_model, generator=torch.Generator().manual_seed(4))
    load = torch.zeros(2, dtype=torch.long)
    y, _ = moe.moe_apply(cfg, p, x[None], inference=True, load=load)
    assert float((y[0] - _per_token(cfg, p, x)).abs().max()) < 1e-5
    _, top = moe._gates(cfg, p, x)
    counts = torch.bincount(top.reshape(-1), minlength=cfg.num_experts)
    assert load.tolist() == [33 * cfg.experts_per_token, int(counts.max())]
    if case == "one_expert_for_all":
        assert top.tolist() == [[5, 2]] * 33 and load.tolist() == [66, 33]
    else:
        assert counts[[0, 3, 6]].tolist() == [0, 0, 0]


def test_the_shared_experts_and_the_dense_first_layer_are_in_the_stack():
    cfg = _dropless_cfg()
    defs = M.model_defs(cfg)
    assert "ffn" in defs["layers"][0] and "moe" not in defs["layers"][0]
    assert defs["layers"][0]["ffn"]["gate"].shape == (cfg.d_model, cfg.d_ff)
    for blk in defs["layers"][1:]:
        assert "ffn" not in blk and blk["moe"]["shared"]["gate"].shape == (cfg.d_model, cfg.shared_d_ff)
        assert blk["moe"]["bias"].shape == (cfg.num_experts,)
    assert M.count_params_exact(cfg) == cfg.count_params()
    params = M.init_model(cfg, torch.Generator().manual_seed(5))
    toks = torch.randint(0, cfg.vocab_size, (1, 9), generator=torch.Generator().manual_seed(6))
    run = RunConfig(attention_impl="xla", remat="none")
    base, _ = M.forward(cfg, run, params, toks)
    # taking out the shared experts, or the dense layer's FFN, changes the output
    for zero in (params["layers"][1]["moe"]["shared"]["down"], params["layers"][0]["ffn"]["down"]):
        keep = zero.clone()
        zero.zero_()
        assert not torch.allclose(M.forward(cfg, run, params, toks)[0], base)
        zero.copy_(keep)


def test_new_fields_at_their_defaults_keep_the_capacity_paths_bits():
    """moonshot-smoke with every new field given its default value
    explicitly: ``moe_apply`` returns the bits of the capacity path put
    together from its parts (route, scatter into the (E, groups * C, D)
    buffer, the experts' bmm, the gather by the gates), as it did before the
    dropless path."""
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b").reduced(), compute_dtype="float32")
    same = dataclasses.replace(cfg, first_dense_layers=0, shared_d_ff=0, routed_scale=1.0, moe_dropless=False,
                               kv_lora_rank=0)
    assert same == cfg and set(moe.moe_defs(cfg)) == {"router", "gate", "up", "down"}
    p = M.init_model(cfg, torch.Generator().manual_seed(7))["layers"][0]["moe"]
    x = torch.randn(2, 64, cfg.d_model, generator=torch.Generator().manual_seed(8))
    for inference in (False, True):
        y, aux = moe.moe_apply(cfg, p, x, inference=inference)
        g = cfg.moe_group_size
        want, r = moe._dispatch_combine(cfg, p["router"], x.reshape(-1, g, cfg.d_model), inference,
                                        lambda xe: moe._experts(p, xe))
        assert torch.equal(y, want.reshape(x.shape))
        assert torch.equal(aux["moe_aux"], moe._aux(r, g))
