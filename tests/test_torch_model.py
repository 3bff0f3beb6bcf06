"""The port's dense model against the JAX package on bridged weights.

The JAX param tree from ``M.init_model(PRNGKey(0))`` goes to the port as
numpy arrays (``repro_torch.bridge``); token inputs come from one numpy
generator. Compute is fp32 and logits must agree to 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import RunConfig as JaxRunConfig
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import model as M

TOL = 1e-4
SMALL = dict(num_layers=2, d_model=64, vocab_size=64)


def _cfgs(**over):
    kw = {**SMALL, **over}
    jcfg = dataclasses.replace(jax_get_config("qwen3-1.7b").reduced(**kw), compute_dtype="float32")
    pcfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(**kw), compute_dtype="float32")
    return jcfg, pcfg


def _params(jcfg, pcfg):
    jp = JM.init_model(jax.random.PRNGKey(0), jcfg)
    return jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp), pcfg)


def _close(a, b, tol=TOL):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    b = b.detach().float().numpy() if isinstance(b, torch.Tensor) else np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a - b).max()) if a.size else 0.0
    assert err < tol, err


def _cache_close(pcache, jcache, pcfg, rows=None):
    jc = bridge.cache_from_jax(jax.tree.map(np.asarray, jcache), pcfg)
    sel = slice(None) if rows is None else rows
    _close(pcache["k"][:, sel], jc["k"][:, sel])
    _close(pcache["v"][:, sel], jc["v"][:, sel])
    assert torch.equal(pcache["pos"][sel], jc["pos"][sel])


def _tokens(rng, *shape):
    t = rng.integers(0, SMALL["vocab_size"], size=shape).astype(np.int32)
    return jnp.asarray(t), torch.from_numpy(t.astype(np.int64))


@pytest.mark.parametrize(
    "port_run",
    [RunConfig(attention_impl="xla"),
     RunConfig(attention_impl="chunked", attention_chunk=8),
     RunConfig(attention_impl="pallas")],
    ids=["xla", "chunked", "pallas"],
)
def test_forward_logits_match(port_run):
    jcfg, pcfg = _cfgs()
    jp, pp = _params(jcfg, pcfg)
    jt, pt = _tokens(np.random.default_rng(0), 2, 20)
    jl, _ = JM.forward(jcfg, JaxRunConfig(attention_impl="xla", remat="none"), jp, jt)
    pl, aux = M.forward(pcfg, port_run, pp, pt)
    _close(pl, jl)
    assert set(aux) == {"moe_aux", "moe_drop_frac"}


@pytest.mark.parametrize("window", [0, 16])
def test_prefill_logits_and_cache_match(window):
    """A prompt of 24 against a 16-slot ring exercises the ring order."""
    jcfg, pcfg = _cfgs(sliding_window=window)
    jp, pp = _params(jcfg, pcfg)
    jt, pt = _tokens(np.random.default_rng(1), 2, 24)
    run_j = JaxRunConfig(attention_impl="xla", remat="none")
    jl, jc = JM.prefill(jcfg, run_j, jp, jt, 32)
    pl, pc = M.prefill(pcfg, RunConfig(attention_impl="xla"), pp, pt, 32)
    _close(pl, jl)
    assert pc["k"].shape[2] == (16 if window else 32)
    _cache_close(pc, jc, pcfg)


def test_decode_step_per_slot_pos_and_active_mask():
    """Rows drift apart under an active mask; every step's active rows
    match, and so do the whole caches (with full attention the reference
    leaves parked rows untouched too)."""
    jcfg, pcfg = _cfgs()
    jp, pp = _params(jcfg, pcfg)
    rng = np.random.default_rng(2)
    jt, pt = _tokens(rng, 3, 10)
    run_j = JaxRunConfig(attention_impl="xla", remat="none")
    run_p = RunConfig(attention_impl="xla")
    _, jc = JM.prefill(jcfg, run_j, jp, jt, 24)
    _, pc = M.prefill(pcfg, run_p, pp, pt, 24)
    for act in ([1, 1, 1], [1, 0, 1], [0, 1, 1], [1, 1, 0], [1, 0, 0]):
        act = np.array(act, bool)
        jt, pt = _tokens(rng, 3, 1)
        jl, jc = JM.decode_step(jcfg, run_j, jp, jc, jt, None, active=jnp.asarray(act))
        pl, pc = M.decode_step(pcfg, run_p, pp, pc, pt, active=torch.from_numpy(act))
        _close(pl[act], np.asarray(jl)[act])
        _cache_close(pc, jc, pcfg)
    assert pc["pos"].tolist() == [14, 13, 13]


def test_decode_sliding_window_wraps_and_parks():
    """Decode across the ring's wrap point, then park one row. The active
    rows match the reference; the parked row's cache and position stay as
    they were (the reference writes its last ring slot instead: ROADMAP
    C4, so it is left out of the comparison)."""
    jcfg, pcfg = _cfgs(sliding_window=16)
    jp, pp = _params(jcfg, pcfg)
    rng = np.random.default_rng(3)
    jt, pt = _tokens(rng, 2, 12)
    run_j = JaxRunConfig(attention_impl="xla", remat="none")
    run_p = RunConfig(attention_impl="xla")
    _, jc = JM.prefill(jcfg, run_j, jp, jt, 32)
    _, pc = M.prefill(pcfg, run_p, pp, pt, 32)
    for _ in range(7):  # positions 12..18: the ring wraps at 16
        jt, pt = _tokens(rng, 2, 1)
        jl, jc = JM.decode_step(jcfg, run_j, jp, jc, jt, None)
        pl, pc = M.decode_step(pcfg, run_p, pp, pc, pt)
        _close(pl, jl)
        _cache_close(pc, jc, pcfg)
    before = {k: v.clone() for k, v in pc.items()}
    act = np.array([True, False])
    jt, pt = _tokens(rng, 2, 1)
    jl, jc = JM.decode_step(jcfg, run_j, jp, jc, jt, None, active=jnp.asarray(act))
    pl, pc = M.decode_step(pcfg, run_p, pp, pc, pt, active=torch.from_numpy(act))
    _close(pl[:1], np.asarray(jl)[:1])
    _cache_close(pc, jc, pcfg, rows=slice(0, 1))
    for key in ("k", "v", "pos"):
        assert torch.equal(pc[key][:, 1] if key != "pos" else pc[key][1],
                           before[key][:, 1] if key != "pos" else before[key][1])


@pytest.mark.parametrize("window", [0, 16])
def test_kernel_knobs_match_jax_interpret(window):
    """The port's kernel knobs (``pallas``/``kernel``: the plain versions on
    the CPU) against the JAX package's Pallas kernels in interpret mode,
    through prefill and three decode steps."""
    jcfg, pcfg = _cfgs(sliding_window=window)
    jp, pp = _params(jcfg, pcfg)
    rng = np.random.default_rng(4)
    jt, pt = _tokens(rng, 2, 20)
    run_j = JaxRunConfig(attention_impl="pallas_interpret", decode_attention_impl="kernel_interpret",
                         remat="none")
    run_p = RunConfig(attention_impl="pallas", decode_attention_impl="kernel")
    jl, jc = JM.prefill(jcfg, run_j, jp, jt, 24)
    pl, pc = M.prefill(pcfg, run_p, pp, pt, 24)
    _close(pl, jl)
    for _ in range(3):
        jt, pt = _tokens(rng, 2, 1)
        jl, jc = JM.decode_step(jcfg, run_j, jp, jc, jt, None)
        pl, pc = M.decode_step(pcfg, run_p, pp, pc, pt)
        _close(pl, jl)
    _cache_close(pc, jc, pcfg)


def test_full_width_param_count_matches_reference():
    """qwen3-1.7b at full width, counted from shapes (nothing allocated)."""
    cfg = get_config("qwen3-1.7b")
    assert M.count_params_exact(cfg) == cfg.count_params()
    assert M.count_params_exact(cfg) == JM.count_params_exact(jax_get_config("qwen3-1.7b"))


def test_bridged_shapes_match_init_and_init_is_seeded():
    jcfg, pcfg = _cfgs()
    _, pp = _params(jcfg, pcfg)
    a = M.init_model(pcfg, torch.Generator().manual_seed(5))
    b = M.init_model(pcfg, torch.Generator().manual_seed(5))
    flat = lambda t: jax.tree.leaves(jax.tree.map(lambda x: tuple(x.shape), t))  # noqa: E731
    assert flat(a) == flat(pp)
    assert all(torch.equal(x, y) for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))
    emb = a["embed"]
    assert float(emb.abs().max()) <= 0.04 + 1e-6  # truncated at 2 std of 0.02


def test_unported_archs_raise():
    with pytest.raises(NotImplementedError, match="not ported"):
        get_config("mixtral-8x22b")
    moe = dataclasses.replace(get_config("qwen3-1.7b").reduced(), num_experts=4, experts_per_token=2)
    with pytest.raises(NotImplementedError, match="not ported"):
        M.init_model(moe, torch.Generator())
    assert isinstance(get_config("qwen3-1.7b-smoke"), ModelConfig)
