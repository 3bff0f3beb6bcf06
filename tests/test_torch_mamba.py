"""The port's Mamba-2 block and the jamba hybrid against the JAX package.

Inputs come from numpy generators and JAX's own seeded weights, handed to
the port through ``repro_torch.bridge``; on the CPU the port's
``ops.ssm_scan`` (K3) runs its plain version. Compute is fp32 unless a
test says otherwise, and fp32 results must agree to 1e-4 of the largest
|reference| of each tensor (at least 1): the random-weight stack grows
its SSM state to ~1e5, so an absolute limit would measure the weights.
bf16 results agree to 1e-2 of it, the fp32 SSM state included: the
scan's inputs are bf16 products, which the two packages may round one
bf16 unit (2^-8 of a value) apart, and both sides sum in fp32 from them.

jamba-smoke has one Mamba head (d_inner 128 = one 128-wide head); the
``d_model=256`` variant has four, so the folding of heads into K3's rows
is exercised. The JAX reference advances the Mamba state of inactive rows
in ``decode_step`` (ROADMAP C8); the port keeps it, so the parity tests
compare rows never parked, one test shows the reference's fault and its
twin that the port leaves a parked row's state bit for bit.
"""

import dataclasses
from functools import partial

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.models import model as M
from repro_torch.models import ssm

try:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.configs.base import RunConfig as JaxRunConfig
    from repro.models import common as jcommon
    from repro.models import model as JM
    from repro.models import ssm as jssm
except ImportError:  # the card's machine has no JAX
    jax = None

TOL = 1e-4
BF16_TOL = 1e-2
CHUNK = 8  # prompts of 20 and 21 tokens pad to whole chunks
VOCAB = 64
ARCH = "jamba-1.5-large-398b"
MAMBA_KEYS = ("conv_x", "conv_b", "conv_c", "ssm")


@pytest.fixture(autouse=True)
def _jax_reference():
    if jax is None:
        pytest.skip("JAX is not installed: the reference side of this test is missing")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, exp, tol=TOL):
    got, exp = _np(got), _np(exp)
    assert got.shape == exp.shape, (got.shape, exp.shape)
    err = float(np.abs(got - exp).max()) if got.size else 0.0
    scale = max(1.0, float(np.abs(exp).max())) if exp.size else 1.0
    assert err <= tol * scale, (err, scale)


def _pair(a, dtype="float32"):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, getattr(jnp, dtype)), torch.from_numpy(a).to(getattr(torch, dtype))


def _cfgs(dtype="float32", **over):
    kw = {"vocab_size": VOCAB, **over}
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(**kw), compute_dtype=dtype)
    pcfg = dataclasses.replace(get_config(ARCH).reduced(**kw), compute_dtype=dtype)
    return jcfg, pcfg


# ------------------------------------------------------ the causal conv


@pytest.mark.parametrize("S", [1, 2, 3, 300])
@pytest.mark.parametrize("carried", [False, True], ids=["zero-state", "carried-state"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_bit_for_bit(S, carried, dtype):
    """Output and new state equal the reference's bit for bit: the taps are
    summed left to right in the input's dtype, each product rounded first.
    S < 3 keeps part of the previous state (or the zero padding) in the new
    one."""
    rng = np.random.default_rng(S)
    xj, xt = _pair(rng.standard_normal((2, S, 24)), dtype)
    kj, kt = _pair(rng.standard_normal((4, 24)) * 0.5, dtype)
    sj, st = _pair(rng.standard_normal((2, 3, 24)), dtype) if carried else (None, None)
    out, state = ssm._causal_conv(xt, kt, st)
    jout, jstate = jssm._causal_conv(xj, kj, sj)
    assert out.dtype == xt.dtype and state.shape == (2, 3, 24)
    assert np.array_equal(_np(out), _np(jout))
    assert np.array_equal(_np(state), _np(jstate))
    if S < 3 and not carried:
        assert float(state[:, : 3 - S].abs().max()) == 0.0


# ------------------------------------------------------ the block alone


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_full_and_step_match(dtype):
    """Four heads, a 21-token input (pads at chunk 8): the full pass, its
    final state, the decode cache the JAX package's prefill builds from it
    (``_mamba_full_with_cache``), and one step from that cache."""
    jcfg, pcfg = _cfgs(dtype, d_model=256)
    assert ssm.mamba_heads(pcfg) == 4
    jp = jcommon.build_params(jssm.mamba_defs(jcfg), jax.random.PRNGKey(1))
    pp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    tol = TOL if dtype == "float32" else BF16_TOL
    rng = np.random.default_rng(2)
    xj, xt = _pair(rng.standard_normal((2, 21, 256)), dtype)
    _close(ssm.mamba_apply_full(pcfg, pp, xt, chunk=CHUNK), jssm.mamba_apply_full(jcfg, jp, xj, None, chunk=CHUNK),
           tol)
    out, state = ssm.mamba_apply_full(pcfg, pp, xt, chunk=CHUNK, return_state=True)
    _, jh = jssm.mamba_apply_full(jcfg, jp, xj, None, chunk=CHUNK, return_state=True)
    jout, jcache = JM._mamba_full_with_cache(jcfg, JaxRunConfig(ssd_chunk=CHUNK), jp, xj, None)
    assert out.dtype == xt.dtype and state["ssm"].dtype == torch.float32
    _close(out, jout, tol)
    _close(state["ssm"], jh, tol)
    for key in MAMBA_KEYS:
        assert state[key].shape == tuple(jcache[key].shape)
        _close(state[key], jcache[key], tol)
    sj, st = _pair(rng.standard_normal((2, 1, 256)), dtype)
    y, new = ssm.mamba_apply_step(pcfg, pp, state, st)
    jy, jnew = jssm.mamba_apply_step(jcfg, jp, jcache, sj, None)
    assert y.shape == (2, 1, 256) and y.dtype == xt.dtype
    _close(y, jy, tol)
    for key in MAMBA_KEYS:
        _close(new[key], jnew[key], tol)


def test_mamba_prefill_state_continues_like_one_pass():
    """Prefill 12 tokens, then 3 steps: each step's output equals the full
    pass over the grown sequence at its last position (the conv state and
    the SSM state carry everything)."""
    _, pcfg = _cfgs(d_model=256)
    params = M.init_model(pcfg, torch.Generator().manual_seed(3))["layers"][0]["mamba"]
    x = torch.randn(2, 15, 256, generator=torch.Generator().manual_seed(4))
    _, state = ssm.mamba_apply_full(pcfg, params, x[:, :12], chunk=CHUNK, return_state=True)
    for t in range(12, 15):
        y, state = ssm.mamba_apply_step(pcfg, params, state, x[:, t:t + 1])
        full = ssm.mamba_apply_full(pcfg, params, x[:, :t + 1], chunk=CHUNK)
        _close(y[:, 0], full[:, -1])


# ------------------------------------------------------ the hybrid stack


@pytest.fixture(scope="module", params=[64, 256], ids=["one-head", "four-heads"])
def jamba(request):
    """jamba-smoke (16 layers: two periods of 7 Mamba + 1 attention, MoE
    every other layer), fp32, on the JAX package's seeded weights, bridged;
    d_model 64 (one Mamba head) or 256 (four)."""
    jcfg, pcfg = _cfgs(d_model=request.param)
    jp = JM.init_model(jax.random.PRNGKey(0), jcfg)
    return jcfg, pcfg, jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp), pcfg)


def _tokens(rng, *shape):
    t = rng.integers(0, VOCAB, size=shape).astype(np.int32)
    return jnp.asarray(t), torch.from_numpy(t.astype(np.int64))


def _cache_close(pc, jc, pcfg, rows=slice(None)):
    jt = bridge.cache_from_jax(jax.tree.map(np.asarray, jc), pcfg)
    assert set(pc) == set(jt) == {"pos", "k", "v", "mamba"}
    assert torch.equal(pc["pos"][rows], jt["pos"][rows])
    for key in ("k", "v"):
        _close(pc[key][:, rows], jt[key][:, rows])
    for key in MAMBA_KEYS:
        assert pc["mamba"][key].shape == jt["mamba"][key].shape
        _close(pc["mamba"][key][:, rows], jt["mamba"][key][:, rows])


RUN_J = JaxRunConfig(remat="none", ssd_chunk=CHUNK) if jax else None
RUN_P = RunConfig(attention_impl="pallas", decode_attention_impl="kernel", ssd_chunk=CHUNK)


def test_jamba_forward_prefill_and_decode_match(jamba):
    """Forward (logits and MoE metrics), prefill of 20 tokens (logits and
    the whole cache through ``cache_from_jax``), then four decode steps
    under an active mask: logits and cache of the rows never parked (the
    reference moves a parked row's Mamba state, C8). The port runs its kernel knobs (their plain
    versions here)."""
    jcfg, pcfg, jp, pp = jamba
    assert [pcfg.layer_kind(i) for i in range(8)] == ["mamba"] * 3 + ["attn"] + ["mamba"] * 4
    rng = np.random.default_rng(5)
    jt, pt = _tokens(rng, 3, 20)
    jl, jaux = jax.jit(partial(JM.forward, jcfg, RUN_J))(jp, jt)
    pl, paux = M.forward(pcfg, RUN_P, pp, pt)
    _close(pl, jl)
    _close(paux["moe_drop_frac"], jaux["moe_drop_frac"], 1e-6)
    _close(paux["moe_aux"], jaux["moe_aux"], 1e-5)
    jl, jc = jax.jit(partial(JM.prefill, jcfg, RUN_J, max_len=32))(jp, jt)
    pl, pc = M.prefill(pcfg, RUN_P, pp, pt, 32)
    _close(pl, jl)
    _cache_close(pc, jc, pcfg)
    assert pc["mamba"]["ssm"].shape == (14, 3, ssm.mamba_heads(pcfg), 16, 128) and pc["k"].shape[0] == 2
    step = jax.jit(lambda p, c, t, a: JM.decode_step(jcfg, RUN_J, p, c, t, None, active=a))
    ever_parked = np.zeros(3, bool)
    for act in ([1, 1, 1], [1, 0, 1], [1, 1, 1], [1, 1, 1]):
        act = np.array(act, bool)
        ever_parked |= ~act
        jt, pt = _tokens(rng, 3, 1)
        jl, jc = step(jp, jc, jt, jnp.asarray(act))
        pl, pc = M.decode_step(pcfg, RUN_P, pp, pc, pt, active=torch.from_numpy(act))
        rows = act & ~ever_parked  # a row parked once holds the reference's moved state after it
        _close(pl[rows], np.asarray(jl)[rows])
        _cache_close(pc, jc, pcfg, rows=np.flatnonzero(~ever_parked))
    assert pc["pos"].tolist() == [24, 23, 24]


def test_reference_decode_advances_parked_mamba_state(jamba):
    """ROADMAP C8 on the JAX package: ``decode_step`` with ``active =
    [True, False]`` keeps the parked row's position but moves its conv and
    SSM state (the step ignores ``active`` for Mamba blocks)."""
    jcfg, _, jp, _ = jamba
    rng = np.random.default_rng(6)
    jt, _ = _tokens(rng, 2, 12)
    _, jc = jax.jit(partial(JM.prefill, jcfg, RUN_J, max_len=32))(jp, jt)
    jt, _ = _tokens(rng, 2, 1)
    _, new = JM.decode_step(jcfg, RUN_J, jp, jc, jt, None, active=jnp.asarray([True, False]))
    assert np.asarray(new["pos"]).tolist() == [13, 12]
    for j in (0, 1, 2, 4):  # the Mamba slots of the period
        for key in MAMBA_KEYS:
            before, after = (np.asarray(c["layers"][f"b{j}"]["mamba"][key])[:, 1] for c in (jc, new))
            assert not np.array_equal(before, after), (j, key)


def test_parked_row_mamba_state_untouched(jamba):
    """The port's twin of C8: the parked row keeps its position and every
    bit of its four Mamba tensors (and its KV); the active row advances and
    matches the reference."""
    jcfg, pcfg, jp, pp = jamba
    rng = np.random.default_rng(6)
    jt, pt = _tokens(rng, 2, 12)
    _, jc = jax.jit(partial(JM.prefill, jcfg, RUN_J, max_len=32))(jp, jt)
    _, pc = M.prefill(pcfg, RUN_P, pp, pt, 32)
    before = {key: pc["mamba"][key].clone() for key in MAMBA_KEYS}
    kv = (pc["k"][:, 1].clone(), pc["v"][:, 1].clone())
    act = np.array([True, False])
    for _ in range(2):
        jt, pt = _tokens(rng, 2, 1)
        jl, jc = JM.decode_step(jcfg, RUN_J, jp, jc, jt, None, active=jnp.asarray(act))
        pl, pc = M.decode_step(pcfg, RUN_P, pp, pc, pt, active=torch.from_numpy(act))
        _close(pl[:1], np.asarray(jl)[:1])
    _cache_close(pc, jc, pcfg, rows=slice(0, 1))
    assert pc["pos"].tolist() == [14, 12]
    for key in MAMBA_KEYS:
        assert torch.equal(pc["mamba"][key][:, 1], before[key][:, 1]), key
        assert not torch.equal(pc["mamba"][key][:, 0], before[key][:, 0]), key
    assert torch.equal(pc["k"][:, 1], kv[0]) and torch.equal(pc["v"][:, 1], kv[1])


def test_short_prompt_conv_state_keeps_padding(jamba):
    """A 2-token prompt leaves the zero padding in the first slot of each
    conv state, as the reference's does, and decodes on from there."""
    jcfg, pcfg, jp, pp = jamba
    rng = np.random.default_rng(7)
    jt, pt = _tokens(rng, 2, 2)
    jl, jc = JM.prefill(jcfg, RUN_J, jp, jt, 8)
    pl, pc = M.prefill(pcfg, RUN_P, pp, pt, 8)
    _close(pl, jl)
    _cache_close(pc, jc, pcfg)
    for key in ("conv_x", "conv_b", "conv_c"):
        assert float(pc["mamba"][key][:, :, 0].abs().max()) == 0.0
    jt, pt = _tokens(rng, 2, 1)
    jl, jc = JM.decode_step(jcfg, RUN_J, jp, jc, jt, None)
    pl, pc = M.decode_step(pcfg, RUN_P, pp, pc, pt)
    _close(pl, jl)
    _cache_close(pc, jc, pcfg)


def test_jamba_four_layer_cut_count():
    """The cut that ``chip_smoke.py`` serves at full width: layers 0-3 of
    jamba-1.5-large-398b (Mamba + dense FFN, Mamba + MoE, Mamba + dense
    FFN, attention + MoE) with the embedding, head and final norm. The
    port's count equals the JAX package's per-layer definitions summed,
    and the constant the script checks."""
    from chip_smoke import JAMBA_CUT_PARAMS, JAMBA_LAYERS

    full, jfull = get_config(ARCH), jax_get_config(ARCH)
    cut = dataclasses.replace(full, num_layers=JAMBA_LAYERS)
    jdefs = JM.model_defs(jfull)
    ref = sum(jcommon.param_count(JM._block_defs(jfull, j)) for j in range(JAMBA_LAYERS))
    ref += sum(jcommon.param_count(jdefs[k]) for k in ("embed", "lm_head", "final_norm"))
    assert M.count_params_exact(cut) == ref == JAMBA_CUT_PARAMS == 22_974_884_480
    assert [cut.layer_kind(i) for i in range(4)] == ["mamba", "mamba", "mamba", "attn"]
    assert [cut.layer_is_moe(i) for i in range(4)] == [False, True, False, True]
