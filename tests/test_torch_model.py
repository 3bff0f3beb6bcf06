"""The port's attention stacks against the JAX package on bridged weights.

The JAX param tree from ``M.init_model(PRNGKey(0))`` goes to the port as
numpy arrays (``repro_torch.bridge``); token inputs come from one numpy
generator. Compute is fp32 and logits must agree to 1e-4. qwen3 is held
in detail; each of the five other dense and MoE archs (internlm2-1.8b,
internlm2-20b, llama3-405b, moonshot-v1-16b-a3b, mixtral-8x22b) and the
two frontend archs (llava-next-34b, musicgen-medium), reduced, through
forward, prefill and decode on every attention knob; the frontends also
with prefix features. jamba-1.5-large-398b (the Mamba-2 hybrid) is held in
``tests/test_torch_mamba.py``; here its parameter counts and its bridge.
"""

import dataclasses
from functools import partial

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


def _cache_close(pcache, jcache, pcfg, rows=None, scaled=False):
    """K, V and positions against the reference's; ``scaled`` holds K and
    V to TOL of the largest |value| of the reference's (see _scaled_close)."""
    jc = bridge.cache_from_jax(jax.tree.map(np.asarray, jcache), pcfg)
    sel = slice(None) if rows is None else rows
    for key in ("k", "v"):
        ref = jc[key][:, sel]
        _close(pcache[key][:, sel], ref, TOL * max(1.0, float(ref.abs().max())) if scaled else TOL)
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
    """Every arch of the JAX package is ported now: the three that raised
    "not ported" until the Mamba-2 block and the frontends came (jamba,
    llava, musicgen) build at full width and as smoke configs, with the
    JAX package's parameter counts; a Mamba-block config and a frontend
    config built on qwen3 build too, and so does a MoE FFN."""
    for arch in LAST_ARCHS:
        cfg, smoke = get_config(arch), get_config(arch + "-smoke")
        assert cfg.name == arch and smoke.name == arch + "-smoke"
        assert M.count_params_exact(smoke) == JM.count_params_exact(jax_get_config(arch + "-smoke"))
        layers = M.init_model(smoke, torch.Generator())["layers"]
        assert len(layers) == smoke.num_layers
    base = get_config("qwen3-1.7b").reduced()
    mamba = dataclasses.replace(base, ssm_kind="mamba2", attn_every=2, d_model=128)
    layers = M.init_model(mamba, torch.Generator())["layers"]
    assert [set(blk) for blk in layers] == [{"norm", "attn", "ffn_norm", "ffn"}, {"norm", "mamba", "ffn_norm", "ffn"}]
    vision = M.init_model(dataclasses.replace(base, frontend="vision_patches"), torch.Generator())
    assert vision["frontend"]["proj"].shape == (M.FRONTEND_FEATURE_DIM["vision_patches"], base.d_model)
    moe = dataclasses.replace(base, num_experts=4, experts_per_token=2, moe_d_ff=32)
    layer = M.init_model(moe, torch.Generator())["layers"][0]
    assert set(layer) == {"norm", "attn", "ffn_norm", "moe"}
    assert layer["moe"]["gate"].shape == (4, moe.d_model, 32)
    assert isinstance(get_config("qwen3-1.7b-smoke"), ModelConfig)


# ------------------------------------------- the five dense and MoE archs

NEW_ARCHS = ("internlm2-1.8b", "internlm2-20b", "llama3-405b", "moonshot-v1-16b-a3b", "mixtral-8x22b")
# the last three, with the Mamba-2 block and the frontends; their exact
# parameter counts at full width (the JAX package's)
LAST_ARCHS = ("jamba-1.5-large-398b", "llava-next-34b", "musicgen-medium")
FULL_COUNTS = {"jamba-1.5-large-398b": 397_578_714_240, "llava-next-34b": 34_397_174_784,
               "musicgen-medium": 1_818_576_384}
FRONTEND_ARCHS = ("llava-next-34b", "musicgen-medium")
KNOBS = {  # port's RunConfig, the JAX package's
    "xla": (RunConfig(attention_impl="xla"), JaxRunConfig(attention_impl="xla", remat="none")),
    "chunked": (RunConfig(attention_impl="chunked", attention_chunk=8),
                JaxRunConfig(attention_impl="xla", remat="none")),
    "pallas": (RunConfig(attention_impl="pallas", decode_attention_impl="kernel"),
               JaxRunConfig(attention_impl="pallas_interpret", decode_attention_impl="kernel_interpret",
                            remat="none")),
}


# The five archs have no qk-norm: their K and V grow to |20-25| by the second
# layer and the unnormed q.k scores are peaked, so an fp32 rounding of a
# score is amplified by the softmax into what follows (up to 3e-5 of the
# scale of K, V and the logits against JAX here). Their caches and logits
# are held to TOL of the reference's largest |value| (at least 1).


def _scaled_close(a, b):
    _close(a, b, TOL * max(1.0, float(np.abs(np.asarray(b, np.float32)).max())))


def _arch_cfgs(arch):
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(vocab_size=SMALL["vocab_size"]), compute_dtype="float32")
    pcfg = dataclasses.replace(get_config(arch).reduced(vocab_size=SMALL["vocab_size"]), compute_dtype="float32")
    return jcfg, pcfg


def test_new_archs_registered():
    for arch in NEW_ARCHS:
        cfg, smoke = get_config(arch), get_config(arch + "-smoke")
        assert cfg.name == arch and smoke.name == arch + "-smoke"
        assert smoke.num_layers == 2 * cfg.period and smoke.num_experts == min(cfg.num_experts, 4)


@pytest.mark.parametrize("knob", list(KNOBS))
@pytest.mark.parametrize("arch", NEW_ARCHS + FRONTEND_ARCHS)
def test_new_arch_matches_jax(arch, knob):
    """Forward (logits and MoE aux), prefill (logits and cache), then four
    decode steps under an active mask, so the rows' positions drift apart;
    the frontend archs on tokens alone, as they serve. S = 24 runs past
    mixtral-smoke's window of 16 and is one MoE group.
    Under the window a parked row is left out once parked: the reference
    writes its last ring slot (ROADMAP C4)."""
    jcfg, pcfg = _arch_cfgs(arch)
    jp, pp = _params(jcfg, pcfg)
    run_p, run_j = KNOBS[knob]
    rng = np.random.default_rng(5)
    jt, pt = _tokens(rng, 3, 24)
    jl, jaux = jax.jit(partial(JM.forward, jcfg, run_j))(jp, jt)
    pl, paux = M.forward(pcfg, run_p, pp, pt)
    _scaled_close(pl, jl)
    # the same drops; the jitted reference may round the means otherwise
    _close(paux["moe_drop_frac"], jaux["moe_drop_frac"], 1e-6)
    _close(paux["moe_aux"], jaux["moe_aux"], 1e-5)
    if pcfg.num_experts:
        assert float(paux["moe_aux"]) > 0.0
    jl, jc = jax.jit(partial(JM.prefill, jcfg, run_j, max_len=32))(jp, jt)
    pl, pc = M.prefill(pcfg, run_p, pp, pt, 32)
    _scaled_close(pl, jl)
    _cache_close(pc, jc, pcfg, scaled=True)
    step = jax.jit(lambda p, c, t, a: JM.decode_step(jcfg, run_j, p, c, t, None, active=a))
    ever_parked = np.zeros(3, bool)
    for act in ([1, 1, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]):
        act = np.array(act, bool)
        ever_parked |= ~act
        jt, pt = _tokens(rng, 3, 1)
        jl, jc = step(jp, jc, jt, jnp.asarray(act))
        pl, pc = M.decode_step(pcfg, run_p, pp, pc, pt, active=torch.from_numpy(act))
        rows = act & ~ever_parked if pcfg.sliding_window else act
        _scaled_close(pl[rows], np.asarray(jl)[rows])
        _cache_close(pc, jc, pcfg, rows=np.flatnonzero(~ever_parked) if pcfg.sliding_window else None,
                     scaled=True)
    assert pc["pos"].tolist() == [27, 27, 28]


@pytest.mark.parametrize("arch", NEW_ARCHS + LAST_ARCHS)
def test_full_width_counts_match_reference(arch):
    """Total and active parameters at full width, counted from shapes
    (nothing allocated), equal the JAX package's counts."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert M.count_params_exact(cfg) == JM.count_params_exact(jcfg) == FULL_COUNTS.get(arch, M.count_params_exact(cfg))
    assert M.count_active_params_exact(cfg) == JM.count_active_params_exact(jcfg)
    if cfg.num_experts:
        assert M.count_active_params_exact(cfg) < M.count_params_exact(cfg) / 2
    else:
        assert M.count_active_params_exact(cfg) == M.count_params_exact(cfg)


@pytest.mark.parametrize("arch", NEW_ARCHS + LAST_ARCHS)
def test_bridged_shapes_match_init(arch):
    """The bridge carries every subtree (the ``moe``, ``mamba`` and
    ``frontend`` ones included) in the shapes ``init_model`` builds."""
    jcfg, pcfg = _arch_cfgs(arch)
    _, pp = _params(jcfg, pcfg)
    own = M.init_model(pcfg, torch.Generator().manual_seed(0))
    shapes = lambda t: jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda x: tuple(x.shape), t))[0]  # noqa: E731
    assert [(jax.tree_util.keystr(k), v) for k, v in shapes(pp)] == \
        [(jax.tree_util.keystr(k), v) for k, v in shapes(own)]
    assert any("moe" in blk for blk in pp["layers"]) == bool(pcfg.num_experts)


@pytest.mark.parametrize("arch", LAST_ARCHS)
def test_bridge_carries_every_leaf(arch):
    """Every leaf of the JAX param tree arrives in the port's tree with
    its values: the period-stacked layers one per layer, and every other
    entry, nested ones (``frontend.proj``) included, as it is."""
    jcfg, pcfg = _arch_cfgs(arch)
    jp, pp = _params(jcfg, pcfg)
    seen = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jp))[0]:
        keys = [k.key for k in path]
        if keys[0] == "layers":
            j = int(keys[1][1:])
            for n in range(pcfg.num_periods):
                node = pp["layers"][n * pcfg.period + j]
                for k in keys[2:]:
                    node = node[k]
                assert np.array_equal(node.numpy(), leaf[n]), keys
        else:
            node = pp
            for k in keys:
                node = node[k]
            assert np.array_equal(node.numpy(), leaf), keys
        seen += leaf.size
    assert seen == M.count_params_exact(pcfg) == sum(t.numel() for t in jax.tree.leaves(pp))
    assert ("frontend" in pp) == bool(pcfg.frontend)


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_prefix_features_forward_and_prefill_match(arch):
    """The frontend: 6 seeded feature vectors (128-dim audio frames, or
    1152-dim vision patches) projected before 10 tokens. Forward logits
    over all 16 positions, the prefill's logits and cache (16 positions),
    then two decode steps on tokens, against the JAX package."""
    jcfg, pcfg = _arch_cfgs(arch)
    jp, pp = _params(jcfg, pcfg)
    rng = np.random.default_rng(8)
    feat = rng.standard_normal((2, 6, M.FRONTEND_FEATURE_DIM[pcfg.frontend])).astype(np.float32)
    jf, pf = jnp.asarray(feat), torch.from_numpy(feat)
    jt, pt = _tokens(rng, 2, 10)
    run_p, run_j = KNOBS["pallas"]
    jl, _ = jax.jit(partial(JM.forward, jcfg, run_j))(jp, jt, prefix_features=jf)
    pl, _ = M.forward(pcfg, run_p, pp, pt, prefix_features=pf)
    assert pl.shape == (2, 16, pcfg.vocab_size)
    _scaled_close(pl, jl)
    jl, jc = jax.jit(partial(JM.prefill, jcfg, run_j, max_len=24))(jp, jt, prefix_features=jf)
    pl, pc = M.prefill(pcfg, run_p, pp, pt, 24, prefix_features=pf)
    _scaled_close(pl, jl)
    _cache_close(pc, jc, pcfg, scaled=True)
    assert pc["pos"].tolist() == [16, 16]
    for _ in range(2):
        jt, pt = _tokens(rng, 2, 1)
        jl, jc = JM.decode_step(jcfg, run_j, jp, jc, jt, None)
        pl, pc = M.decode_step(pcfg, run_p, pp, pc, pt)
        _scaled_close(pl, jl)
    _cache_close(pc, jc, pcfg, scaled=True)
