"""The port's training stack against the JAX package, and twins of the
training tests of ``tests/test_system.py``.

On the same seeded numpy inputs (weights from ``M.init_model(PRNGKey(0))``
through ``repro_torch.bridge``): ``lm_loss``; K2's gradient through
``ops.flash_attention`` (the plain forward here, the reference's
recompute backward) against ``jax.grad`` through the JAX
``kops.flash_attention(..., interpret=True)``; the gradients of
``make_grad_step`` for every family (dense, MoE, xLSTM, Mamba hybrid,
frontends), under ``RunConfig.remat`` "none" and "full", and the loss
after a ``make_train_step``; one ``HetCoordinator.step`` against
``repro.core.coordinator``'s; and ``launch.train.main`` against the JAX
``main``. Compute is fp32 where the two are held tight. Tolerances: the
loss 1e-6, K2's gradients 2e-6 of the largest |g| (both differentiate the
same fp32 function), a model's gradients per arch (``GRAD_CASES``: 1e-5
of each leaf's largest |g| for qwen3, up to 5e-3 for the ill-conditioned
SSM stacks, each also held against the port's fp64 gradient), the loss
after a step 1e-5; the coordinator's schedule, weights, virtual times and
tokens exactly, its combined gradients per arch. "full" and "dots" give
the gradients of "none" bit for bit on the CPU. The trainer runs bf16
compute: see ``test_train_main_matches_reference``; every arch's
``-smoke`` config trains through it (``test_train_main_trains_every_arch``).
K3's gradient is in ``tests/test_torch_ssm_grad.py``.
"""

import contextlib
import dataclasses
import tempfile
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import RunConfig
from repro_torch.core.coordinator import HetCoordinator, PodRuntime
from repro_torch.data.dataset import batch_iterator
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.launch import train as train_mod
from repro_torch.launch.elastic import ElasticController
from repro_torch.launch.steps import make_grad_step, make_train_step
from repro_torch.models import model as M
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import adamw

try:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.configs.base import RunConfig as JaxRunConfig
    from repro.core import coordinator as jcoord
    from repro.data.dataset import batch_iterator as jax_batch_iterator
    from repro.kernels import ops as jops
    from repro.launch import steps as jsteps
    from repro.launch import train as jtrain
    from repro.models import model as JM
    from repro.optim import adamw as jadamw
except ImportError:  # the card's machine has no JAX
    jax = None

needs_jax = pytest.mark.skipif(jax is None, reason="JAX is not installed: the reference side is missing")

SMALL = dict(num_layers=2, d_model=64, vocab_size=64)
F32 = dict(compute_dtype="float32")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _leafwise_close(got, exp, rel, floor=1e-30):
    """Each leaf within ``rel`` of the largest |value| of the reference's
    leaf, or of ``floor`` where that is smaller."""
    assert len(got) == len(exp)
    for a, b in zip(got, exp):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape
        assert float(np.abs(a - b).max()) <= rel * max(float(np.abs(b).max()), floor), (a.shape, np.abs(b).max())


def _worst(got, exp, floor):
    """The largest |got - exp| of a leaf over the largest |exp| of that
    leaf (at least ``floor``), over all leaves."""
    return max(float(np.abs(_np(a).astype(np.float64) - _np(b)).max()) / max(float(np.abs(_np(b)).max()), floor)
               for a, b in zip(got, exp))


def _pair_cfgs(arch, **over):
    """The arch's ``-smoke`` config on both sides, in fp32."""
    kw = {**F32, **over}
    return jax_get_config(arch).reduced(**kw), get_config(arch).reduced(**kw)


def _pair_params(jcfg, pcfg, seed=0):
    jp = JM.init_model(jax.random.PRNGKey(seed), jcfg)
    return jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp), pcfg)


# ----------------------------------------------------------------- loss


@needs_jax
@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss_matches_reference(masked):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 9, 37)) * 3).astype(np.float32)
    labels = rng.integers(0, 37, size=(2, 9)).astype(np.int32)
    mask = (rng.random((2, 9)) > 0.3).astype(np.float32) if masked else None
    aux = {"moe_aux": np.float32(0.7), "moe_drop_frac": np.float32(0.1)}
    run = RunConfig(z_loss=1e-3, moe_aux_loss=1e-2)
    total, m = M.lm_loss(None, run, torch.from_numpy(logits), torch.from_numpy(labels),
                         None if mask is None else torch.from_numpy(mask),
                         {k: torch.tensor(v) for k, v in aux.items()})
    jtotal, jm = JM.lm_loss(None, JaxRunConfig(z_loss=1e-3, moe_aux_loss=1e-2), jnp.asarray(logits),
                            jnp.asarray(labels), None if mask is None else jnp.asarray(mask),
                            {k: jnp.asarray(v) for k, v in aux.items()})
    assert set(m) == set(jm) == {"loss", "ce", "z_loss", "moe_aux", "moe_drop_frac"}
    for key in m:
        assert abs(float(m[key]) - float(jm[key])) <= 1e-6 * max(1.0, abs(float(jm[key])))
    assert float(total) == float(m["loss"])


# ----------------------------------------------------------------- K2's gradient


FLASH_GRAD_CASES = [
    # (B, Sq, Sk, H, KH, D, window, q_offset)
    (2, 32, 32, 4, 2, 16, 0, 0),  # causal, G = 2
    (1, 48, 48, 4, 4, 16, 8, 0),  # sliding window, G = 1
    (1, 16, 40, 8, 1, 16, 0, 24),  # query offset (a prefill tail), G = 8
    (1, 20, 30, 8, 1, 16, 6, 10),  # window and offset, G = 8
]


@needs_jax
@pytest.mark.parametrize("case", FLASH_GRAD_CASES)
def test_flash_attention_grads_match_reference(case):
    B, Sq, Sk, H, KH, D, win, off = case
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((B, Sq, H, D), (B, Sk, KH, D), (B, Sk, KH, D)))
    g = rng.standard_normal((B, Sq, H, D)).astype(np.float32)

    def jloss(q_, k_, v_):
        out = jops.flash_attention(q_, k_, v_, True, off, win, None, 16, 16, True)
        return jnp.sum(out * g), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ops.flash_attention(qt, kt, vt, q_offset=off, window=win)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    _leafwise_close([out], [jout], 2e-6)
    _leafwise_close([qt.grad, kt.grad, vt.grad], jgrads, 2e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_grads_match_plain_autograd(dtype):
    """The autograd function's recompute backward against autograd through
    the plain forward: the same function, so fp32 agrees to rounding and
    bf16 to a bf16 unit of each gradient's scale. The gradients keep the
    inputs' dtypes, and the backward launches nothing."""
    B, Sq, H, KH, D = 2, 40, 8, 2, 32
    gen = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(s, generator=gen).to(dtype) for s in ((B, Sq, H, D), (B, Sq, KH, D), (B, Sq, KH, D)))
    g = torch.randn(B, Sq, H, D, generator=gen).to(dtype)
    got = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(ops.LAUNCHES)
    ops.flash_attention(*got, window=12).backward(g)
    flash_attention_plain(*ref, window=12, scale=D**-0.5).backward(g)
    assert ops.LAUNCHES == before  # the CPU runs the plain forward: no kernel launch
    tol = 1e-6 if dtype == torch.float32 else 2**-7
    for a, b in zip(got, ref):
        assert a.grad.dtype == dtype
        _leafwise_close([a.grad], [b.grad], tol)


# ----------------------------------------------------------------- steps


# (arch, tol against the reference, exact_tol against the port's fp64
# gradient), each leaf's error over its largest |g| at least GRAD_FLOOR;
# the readings on this batch (3 x 24 tokens, seed 1, ssd_chunk 16) in the
# test's docstring. The new archs' limits sit 2.3-5x above their readings.
GRAD_CASES = [
    ("qwen3-1.7b", 1e-5, 1e-5),
    ("internlm2-1.8b", 2e-4, 1e-4),
    ("xlstm-1.3b", 5e-3, 2e-3),
    ("jamba-1.5-large-398b", 5e-3, 2e-2),
    ("moonshot-v1-16b-a3b", 5e-4, 5e-4),
    ("mixtral-8x22b", 1e-4, 1e-4),
    ("musicgen-medium", 1e-4, 2e-4),
    ("llava-next-34b", 2e-4, 2e-4),
]
# sLSTM's input-gate biases get |g| ~ 1e-11 at these weights (exp(i - m)
# with the stabiliser m tracking i), so a leaf's error is measured against
# at least 1e-6 of absolute scale, where the other leaves' |g| are 1e-5-30
GRAD_FLOOR = 1e-6
# the port's fp32 gradient no further from its fp64 gradient than this
# many times the reference's fp32 gradient is from it
EXACT_MARGIN = 2.0
SSD_CHUNK = 16  # 24 tokens pad to 2 chunks: the scan's padding and carry


def _grads_three_ways(arch, remat="none"):
    """The reference's fp32 gradient, the port's fp32 and the port's fp64
    gradients of one grad step on the arch's ``-smoke`` config (a frontend's
    8 prefix features before its tokens), as leaves, and the two metrics."""
    jcfg, pcfg = _pair_cfgs(arch)
    jp, pp = _pair_params(jcfg, pcfg)
    batch = next(batch_iterator(pcfg, 24, 3, seed=1, frontend_prefix=8 if pcfg.frontend else 0))
    jgrads, jm = jax.jit(jsteps.make_grad_step(
        jcfg, JaxRunConfig(remat=remat, attention_impl="pallas_interpret", ssd_chunk=SSD_CHUNK), None))(jp, batch)
    run = RunConfig(remat=remat, attention_impl="pallas", ssd_chunk=SSD_CHUNK)
    grads, m = make_grad_step(pcfg, run)(pp, batch)
    assert all(not p.requires_grad for p in tree_leaves(pp))  # the caller's params are untouched
    jg = bridge.params_from_jax(jax.tree.map(np.asarray, jgrads), pcfg)
    assert jax.tree.structure(jax.tree.map(lambda _: 0, grads)) == jax.tree.structure(jax.tree.map(lambda _: 0, jg))
    c64 = dataclasses.replace(pcfg, compute_dtype="float64")
    g64, _ = make_grad_step(c64, run)(tree_map(torch.Tensor.double, pp), batch)
    return tree_leaves(jg), tree_leaves(grads), tree_leaves(g64), jm, m


def _hold_grads(jg, grads, g64, jm, m, tol, exact_tol):
    assert set(m) == set(jm)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-6 * float(jm["loss"])
    _leafwise_close(grads, jg, tol, GRAD_FLOOR)
    _leafwise_close(grads, g64, exact_tol, GRAD_FLOOR)
    assert _worst(grads, g64, GRAD_FLOOR) <= EXACT_MARGIN * _worst(jg, g64, GRAD_FLOOR)


@needs_jax
@pytest.mark.parametrize("arch,tol,exact_tol", GRAD_CASES)
def test_grad_step_matches_reference(arch, tol, exact_tol):
    """The ``-smoke`` configs in fp32: each leaf's gradient within ``tol``
    of its largest |g| of the reference's, and within ``exact_tol`` of the
    port's own gradient computed in fp64 (the exact gradient to fp32's
    eyes), and no further from that than EXACT_MARGIN times the
    reference's own distance. qwen3 (qk-norm) sits at ~2e-6 of each other
    and of fp64. The other stacks are ill-conditioned at random weights:
    their backward cancels, so fp32 rounding grows on both sides. Readings
    (port vs reference; port vs fp64; reference vs fp64): internlm2 7.4e-5,
    3.9e-5, 9.8e-5 (no qk-norm: a sharp softmax); xlstm 2.0e-3, 7.4e-4,
    1.8e-3 (the mLSTM input gates); jamba 2.1e-3, 7.6e-3, 6.3e-3 (Mamba's
    a_log and dt_bias); moonshot 1.2e-4, 1.6e-4, 1.9e-4; mixtral 3.2e-5,
    4.0e-5, 4.2e-5; musicgen 3.2e-5, 8.7e-5, 8.2e-5; llava 5.2e-5, 7.8e-5,
    1.0e-4. The port is never further than 1.4x the reference from fp64.
    An O(|g|) error (a dropped term, a wrong mask, an unrouted expert)
    fails every limit."""
    _hold_grads(*_grads_three_ways(arch), tol, exact_tol)


@needs_jax
def test_train_step_loss_after_step_matches_reference():
    """One AdamW step on each side from the same weights and batch, then
    the loss at the new params: to 1e-5. (At step 1 AdamW moves an element
    by ±lr·sign(g); lr is 3e-6 after the first of 100 warmup steps, so a
    sign flipped by rounding moves the loss far less than that.)"""
    jcfg, pcfg = _pair_cfgs("qwen3-1.7b")
    jp, pp = _pair_params(jcfg, pcfg)
    batch, batch2 = (next(batch_iterator(pcfg, 24, 4, seed=s)) for s in (2, 3))
    jrun = JaxRunConfig(remat="none", attention_impl="pallas_interpret")
    run = RunConfig(remat="none", attention_impl="pallas")
    jp1, jo1, jm = jax.jit(jsteps.make_train_step(jcfg, jrun, None))(jp, jadamw.init_opt_state(jp), batch)
    p1, o1, m = make_train_step(pcfg, run)(pp, adamw.init_opt_state(pp), batch)
    assert p1 is pp and int(o1["step"]) == int(jo1["step"]) == 1
    for key in ("loss", "grad_norm", "lr"):
        assert abs(float(m[key]) - float(jm[key])) <= 1e-5 * max(1.0, abs(float(jm[key])))
    _, jm2 = jax.jit(jsteps.make_grad_step(jcfg, jrun, None))(jp1, batch2)
    _, m2 = make_grad_step(pcfg, run)(p1, batch2)
    assert abs(float(m2["loss"]) - float(jm2["loss"])) <= 1e-5
    o1j = bridge.opt_state_from_jax(jax.tree.map(np.asarray, jo1), pcfg)
    assert o1j["step"].dtype == torch.int32 and int(o1j["step"]) == 1
    _leafwise_close(tree_leaves(o1["mu"]), tree_leaves(o1j["mu"]), 1e-5)


@needs_jax
@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "moonshot-v1-16b-a3b", "llava-next-34b"])
def test_opt_state_bridge_carries_nested_leaves(arch):
    """``bridge.opt_state_from_jax`` carries the moments of every leaf,
    nested ones included (jamba's ``mamba`` and ``moe`` blocks, moonshot's
    experts, llava's ``frontend.proj``): the port's state has the tree of
    ``adamw.init_opt_state`` on the port's params, and each moment is the
    JAX moment of the same leaf (here mu = params, nu = params squared)."""
    jcfg, pcfg = _pair_cfgs(arch)
    jp, pp = _pair_params(jcfg, pcfg)
    jo = {**jadamw.init_opt_state(jp), "mu": jp, "nu": jax.tree.map(jnp.square, jp)}
    o = bridge.opt_state_from_jax(jax.tree.map(np.asarray, jo), pcfg)
    same = jax.tree.structure(jax.tree.map(lambda _: 0, adamw.init_opt_state(pp)))
    assert jax.tree.structure(jax.tree.map(lambda _: 0, o)) == same
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(o["mu"]), tree_leaves(pp)))
    assert all(torch.equal(a, b.square()) for a, b in zip(tree_leaves(o["nu"]), tree_leaves(pp)))


def test_grad_accum_matches_plain_step():
    """k = 4 sequential microbatches ≡ one step on the whole batch (the
    twin of tests/test_perf_levers.py::test_grad_accum_matches_plain_step)."""
    cfg = get_config("internlm2-1.8b").reduced(**F32)
    run1 = RunConfig(remat="none", attention_impl="pallas", z_loss=0.0)
    run4 = dataclasses.replace(run1, grad_accum_steps=4)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (8, 32)), "labels": rng.integers(0, cfg.vocab_size, (8, 32)),
             "mask": np.ones((8, 32), np.float32)}
    params = M.init_model(cfg, torch.Generator().manual_seed(0))
    p1, _, m1 = make_train_step(cfg, run1)(tree_map(torch.clone, params), adamw.init_opt_state(params), batch)
    p4, _, m4 = make_train_step(cfg, run4)(tree_map(torch.clone, params), adamw.init_opt_state(params), batch)
    assert max(float((a - b).abs().max()) for a, b in zip(tree_leaves(p1), tree_leaves(p4))) < 1e-5
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-4


def test_bf16_moments_step_and_dtype():
    cfg = get_config("qwen3-1.7b").reduced(**F32)
    run = RunConfig(remat="none", attention_impl="pallas", optimizer_dtype="bfloat16")
    params = M.init_model(cfg, torch.Generator().manual_seed(0))
    opt = adamw.init_opt_state(params, torch.bfloat16)
    batch = next(batch_iterator(cfg, 32, 4, seed=0))
    p, o, m = make_train_step(cfg, run)(params, opt, batch)
    assert np.isfinite(float(m["loss"]))
    assert all(x.dtype == torch.bfloat16 for x in tree_leaves(o["mu"]))
    fp32 = sum(x.numel() * 4 for x in tree_leaves(params))
    assert sum(x.numel() * x.element_size() for x in tree_leaves(o["mu"])) == fp32 // 2


# ----------------------------------------------------------------- RunConfig.remat


REMAT_ARCHS = ["qwen3-1.7b", "xlstm-1.3b", "moonshot-v1-16b-a3b"]


@contextlib.contextmanager
def _op_counts(counts):
    """Count the aten ops dispatched inside, by name."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            counts[func.__name__] = counts.get(func.__name__, 0) + 1
            return func(*args, **(kwargs or {}))

    with Count():
        yield


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_matches_none(arch, remat):
    """``remat`` "full" and "dots" give the gradients and metrics of "none"
    bit for bit on the CPU: the recompute reruns the same operations on the
    same inputs. Each period's kernels run twice (their forward and the
    recompute: on the card each is a launch), and "dots" reruns no weight
    product (``aten.mm``: the same count as "none"), while "full" reruns
    them all; both rerun the batched products (``aten.bmm``: the scan's and
    attention's recompute backwards, the experts) and the kernels (each a
    custom op, ``repro_torch::flash_attention`` or ``ssm_scan``, whose plain
    version the mode sees as one op)."""
    cfg = get_config(arch).reduced(**F32)
    params = M.init_model(cfg, torch.Generator().manual_seed(0))
    batch = next(batch_iterator(cfg, 24, 2, seed=1))
    out, forwards, ops_seen = {}, {}, {}
    plain = {"flash_attention": ops.flash_attention_plain, "ssm_scan": ops.ssm_scan_plain}

    def counted(name):
        def call(*args, **kwargs):
            forwards[mode][name] = forwards[mode].get(name, 0) + 1
            return plain[name](*args, **kwargs)
        return call

    for mode in ("none", remat):
        forwards[mode], ops_seen[mode] = {}, {}
        with mock.patch.object(ops, "flash_attention_plain", counted("flash_attention")), \
                mock.patch.object(ops, "ssm_scan_plain", counted("ssm_scan")), _op_counts(ops_seen[mode]):
            out[mode] = make_grad_step(cfg, RunConfig(remat=mode, attention_impl="pallas", ssd_chunk=SSD_CHUNK))(
                params, batch)
    (g0, m0), (g1, m1) = out["none"], out[remat]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g1), tree_leaves(g0)))
    assert all(torch.equal(m1[k], m0[k]) for k in m0)
    kernel = "ssm_scan" if cfg.ssm_kind else "flash_attention"
    n = sum(cfg.layer_kind(i) in ("attn", "mlstm") for i in range(cfg.num_layers))
    assert forwards["none"] == {kernel: n} and forwards[remat] == {kernel: 2 * n}
    mm = ops_seen["none"].get("mm.default", 0)

    def batched(seen):
        return seen.get("bmm.default", 0) + seen.get(f"{kernel}.default", 0)

    assert batched(ops_seen[remat]) > batched(ops_seen["none"])
    assert ops_seen[remat]["mm.default"] == mm if remat == "dots" else ops_seen[remat]["mm.default"] > mm


@needs_jax
@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_full_matches_reference(arch):
    """The port's ``remat="full"`` gradients against the reference's
    ``remat="full"`` (``jax.checkpoint`` of its scan body), to the "none"
    limits of ``test_grad_step_matches_reference`` (the readings equal the
    "none" ones to 3 digits)."""
    tol, exact_tol = next(c[1:] for c in GRAD_CASES if c[0] == arch)
    _hold_grads(*_grads_three_ways(arch, remat="full"), tol, exact_tol)


# ----------------------------------------------------------------- the coordinator


@needs_jax
@pytest.mark.parametrize("arch,layers,tol,exact", [
    pytest.param(*case, id=case[0])
    for case in (("qwen3-1.7b", 2, 1e-5, False), ("internlm2-1.8b", 2, None, False), ("xlstm-1.3b", 8, 1e-1, True),
                 ("moonshot-v1-16b-a3b", 2, 1e-3, True))])
def test_coordinator_step_matches_reference(arch, layers, tol, exact):
    """One global step on pods of speed 1, 0.5 and 0.25 over 8 microbatches:
    schedule, weights, virtual and homogeneous seconds, tokens and the
    virtual clock equal the reference's exactly. Fed the reference's own
    microbatch gradients (bridged), the port's accumulation and combine
    give the reference's combined gradients bit for bit. With its own
    gradients, the combined gradients agree leaf by leaf to ``tol`` of a
    leaf's largest |g|: 1e-5 on qwen3 (reading 2.3e-6); on internlm2 each
    microbatch gradient is only ~2e-5 sure in fp32, and the combined ones
    are not held. On xlstm (one 8-layer period at d_model 64) and moonshot
    the fp32 gradients of both sides wander from the exact ones (the
    reference's combined gradient is 1.3e-2 of a leaf's scale from the
    port's fp64 one on xlstm, where the mLSTM blocks amplify rounding: in
    fp64 they take the port to 7e-5 of it), so with ``exact`` the port's
    combined gradient is also held no further from its fp64 one than
    EXACT_MARGIN times the reference's (readings: xlstm 1.8e-2 against
    1.3e-2, and 3.1e-2 from the reference; moonshot 2.9e-4 from the
    reference)."""
    jcfg, pcfg = _pair_cfgs(arch, **{**SMALL, "num_layers": layers})
    jp, pp = _pair_params(jcfg, pcfg)
    speeds = [1.0, 0.5, 0.25]
    jgrad_fn = jax.jit(jsteps.make_grad_step(jcfg, JaxRunConfig(remat="none", attention_impl="pallas_interpret"), None))
    seen = {}

    def recorder(key):
        def update(p, o, g):
            seen[key] = tree_map(lambda x: torch.from_numpy(np.array(x)) if not isinstance(x, torch.Tensor)
                                 else x.clone(), bridge.params_from_jax(jax.tree.map(np.asarray, g), pcfg)
                                 if key == "jax" else g)
            return p, o, {}
        return update

    def bridged_grads(params, batch):
        g, m = jgrad_fn(jp, batch)
        return bridge.params_from_jax(jax.tree.map(np.asarray, g), pcfg), {k: torch.tensor(float(v)) for k, v in m.items()}

    def pods(mod):
        return [mod.PodRuntime(f"pod{i}", s) for i, s in enumerate(speeds)]

    jc = jcoord.HetCoordinator(grad_fn=jgrad_fn, update_fn=recorder("jax"), pods=pods(jcoord),
                               total_microbatches=8, grain_tokens=4 * 32)
    _, _, jrep = jc.step(jp, None, jax_batch_iterator(jcfg, 32, 4, seed=0))
    reports = {}
    for key, grad_fn in (("bridged", bridged_grads),
                         ("port", make_grad_step(pcfg, RunConfig(remat="none", attention_impl="pallas")))):
        pc = HetCoordinator(grad_fn=grad_fn, update_fn=recorder(key), pods=[PodRuntime(f"pod{i}", s)
                            for i, s in enumerate(speeds)], total_microbatches=8, grain_tokens=4 * 32)
        _, _, reports[key] = pc.step(pp, None, batch_iterator(pcfg, 32, 4, seed=0))
        assert pc._vtime == jc._vtime
    for rep in reports.values():
        assert rep.schedule.microbatches == jrep.schedule.microbatches == (5, 2, 1)
        assert rep.schedule.weights == jrep.schedule.weights
        assert (rep.virtual_step_s, rep.homo_virtual_s, rep.tokens) == (jrep.virtual_step_s, jrep.homo_virtual_s,
                                                                        jrep.tokens)
        assert rep.metrics.keys() == jrep.metrics.keys()
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(seen["bridged"]), tree_leaves(seen["jax"])))
    assert abs(reports["port"].metrics["loss"] - jrep.metrics["loss"]) <= 1e-6 * jrep.metrics["loss"]
    if tol is not None:
        _leafwise_close(tree_leaves(seen["port"]), tree_leaves(seen["jax"]), tol, GRAD_FLOOR)
    if exact:
        c64 = dataclasses.replace(pcfg, compute_dtype="float64")
        pc = HetCoordinator(grad_fn=make_grad_step(c64, RunConfig(remat="none", attention_impl="pallas")),
                            update_fn=recorder("p64"), pods=[PodRuntime(f"pod{i}", s) for i, s in enumerate(speeds)],
                            total_microbatches=8, grain_tokens=4 * 32)
        pc.step(tree_map(torch.Tensor.double, pp), None, batch_iterator(pcfg, 32, 4, seed=0))
        port, ref, g64 = (tree_leaves(seen[key]) for key in ("port", "jax", "p64"))
        assert _worst(port, g64, GRAD_FLOOR) <= EXACT_MARGIN * _worst(ref, g64, GRAD_FLOOR)


def test_streamed_combine_equals_weighted_combine():
    """Folding each pod's mean into the sum as it finishes gives the bits
    of ``_weighted_combine`` over all pods' means."""
    from repro_torch.core.coordinator import _fold_in, _weighted_combine

    gen = torch.Generator().manual_seed(5)
    means = [{"a": torch.randn(33, generator=gen), "b": [torch.randn(4, 3, generator=gen)]} for _ in range(3)]
    weights = (0.625, 0.25, 0.125)
    exp = _weighted_combine(means, weights)
    got = None
    for m, w in zip(means, weights):
        got = _fold_in(got, tree_map(torch.clone, m), w)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(exp)))


# ----------------------------------------------------------------- twins of tests/test_system.py

CFG = get_config("internlm2-1.8b").reduced(num_layers=2, d_model=64, vocab_size=64)
RUN = RunConfig(learning_rate=3e-3, warmup_steps=5, total_steps=100, remat="none",
                attention_impl="pallas", attention_chunk=32, ssd_chunk=16)


def _coordinator(speeds, compress=False, het=True, microbatches=8):
    params = M.init_model(CFG, torch.Generator().manual_seed(0))
    opt = adamw.init_opt_state(params)
    coord = HetCoordinator(
        grad_fn=make_grad_step(CFG, RUN),
        update_fn=lambda p, o, g: adamw.adamw_update(RUN, p, g, o),
        pods=[PodRuntime(f"pod{i}", s) for i, s in enumerate(speeds)],
        total_microbatches=microbatches,
        grain_tokens=4 * 32,
        compress=compress,
        het_schedule=het,
    )
    return coord, params, opt


@pytest.mark.parametrize("compress,steps,drop", [(False, 30, 0.1), (True, 25, 0.05)],
                         ids=["plain", "int8_ef"])
def test_training_loss_decreases(compress, steps, drop):
    """One pod, and two pods with the int8 + error-feedback combine (the
    twins of test_training_loss_decreases and test_compressed_combine_trains)."""
    coord, params, opt = _coordinator([1.0] if not compress else [1.0, 0.5], compress=compress)
    batches = batch_iterator(CFG, 32, 4, seed=0)
    losses = []
    for _ in range(steps):
        params, opt, rep = coord.step(params, opt, batches)
        losses.append(rep.metrics["loss"])
    assert losses[-1] < losses[0] - drop, losses[::6]
    assert np.isfinite(losses).all()


def test_het_schedule_beats_homogeneous_assumption():
    coord, params, opt = _coordinator([1.0, 0.5, 0.25], het=True)
    batches = batch_iterator(CFG, 32, 4, seed=0)
    params, opt, rep = coord.step(params, opt, batches)
    assert rep.virtual_step_s < rep.homo_virtual_s
    assert rep.schedule.microbatches[0] == max(rep.schedule.microbatches)
    coord, params, opt = _coordinator([1.0, 0.5, 0.25], het=False)
    params, opt, rep = coord.step(params, opt, batches)
    assert rep.virtual_step_s == rep.homo_virtual_s


def test_capacity_estimator_adapts_schedule():
    coord, params, opt = _coordinator([1.0, 1.0], microbatches=10)
    batches = batch_iterator(CFG, 32, 4, seed=0)
    params, opt, rep0 = coord.step(params, opt, batches)
    assert rep0.schedule.microbatches == (5, 5)
    coord.set_speed("pod1", 0.25)  # pod1 throttles mid-run
    for _ in range(6):  # EWMA needs a few beats to converge
        params, opt, rep = coord.step(params, opt, batches)
    assert rep.schedule.microbatches[0] > rep.schedule.microbatches[1]


def test_checkpoint_restart_continuity():
    """Kill training, restore, continue — loss path stays sane."""
    coord, params, opt = _coordinator([1.0])
    batches = batch_iterator(CFG, 32, 4, seed=0)
    with tempfile.TemporaryDirectory() as d:
        cm = CheckpointManager(d, num_nodes=4, num_shards=4)
        for _ in range(10):
            params, opt, rep = coord.step(params, opt, batches)
        cm.save(10, {"params": params, "opt_state": opt})
        loss_at_10 = rep.metrics["loss"]
        template = {"params": tree_map(torch.zeros_like, params), "opt_state": tree_map(torch.zeros_like, opt)}
        state, info = cm.restore(10, template, failed_nodes={"node1"})
        saved = tree_leaves({"params": params, "opt_state": opt})
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(state), saved))
        coord2, _, _ = _coordinator([1.0])
        p2, o2 = state["params"], state["opt_state"]
        assert o2["step"].dtype == torch.int32 and int(o2["step"]) == int(opt["step"]) == 10
        p2, o2, rep2 = coord2.step(p2, o2, batches)
        assert abs(rep2.metrics["loss"] - loss_at_10) < 1.0


def test_elastic_pod_failure_recovery():
    coord, params, opt = _coordinator([1.0, 1.0, 0.5])
    with tempfile.TemporaryDirectory() as d:
        cm = CheckpointManager(d, num_nodes=4, num_shards=4)
        elastic = ElasticController(coord, checkpoints=cm)
        elastic.set_restore_template({"params": params, "opt_state": opt})
        batches = batch_iterator(CFG, 32, 4, seed=0)
        for _ in range(4):
            params, opt, _ = coord.step(params, opt, batches)
        cm.save(4, {"params": params, "opt_state": opt})
        saved = [t.clone() for t in tree_leaves(params)]
        params, opt, _ = coord.step(params, opt, batches)
        coord.monitor.pronounce("pod1", coord._vtime)
        assert [p.name for p in coord.alive_pods()] == ["pod0", "pod2"]
        assert elastic.events and elastic.events[0].kind == "pod_dead"
        params, opt, restored = elastic.maybe_restore(params, opt)
        assert restored and int(opt["step"]) == 4
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params), saved))
        params, opt, rep = coord.step(params, opt, batches)
        assert len(rep.schedule.microbatches) == 2 and rep.schedule.microbatches[0] > rep.schedule.microbatches[1]
        assert np.isfinite(rep.metrics["loss"])


def test_apply_churn_drives_elastic_controller():
    """The port's simulator churn trace replays against the controller (the
    twin of tests/test_elastic_churn.py's test): pod_dead shrinks the
    fleet, pod_alive re-grows it; with a coordinator, the next schedule is
    re-proportioned over the pods alive."""
    from repro_torch.core.heartbeat import HeartbeatMonitor
    from repro_torch.core.workload import build_sim

    sim, jobs = build_sim("churny_3pod", seed=0)
    res = sim.run_workload(jobs, scheduler="capacity", policy="late", elastic=True)
    monitor = HeartbeatMonitor()
    for p in range(3):
        monitor.register(f"pod{p}", 0.0)
    ctrl = ElasticController(monitor=monitor)
    applied = ctrl.apply_churn(res.churn)
    assert [e.kind for e in applied] == ["pod_dead", "pod_alive"]
    assert [e.kind for e in ctrl.events] == ["pod_dead", "pod_re_registered"]
    assert ctrl.events[0].detail["pod"] == "pod1"
    assert set(monitor.alive()) == {"pod0", "pod1", "pod2"}

    coord, _, _ = _coordinator([1.0, 1.0, 0.5])
    ctrl = ElasticController(coord)
    dead = [e for e in res.churn if e.kind == "pod_dead"]
    ctrl.apply_churn(dead)
    assert ctrl.alive_pod_names == ["pod0", "pod2"] and coord.schedule().microbatches == (5, 3)
    ctrl.apply_churn([e for e in res.churn if e.kind == "pod_alive"])
    assert ctrl.alive_pod_names == ["pod0", "pod1", "pod2"] and coord.schedule().microbatches == (3, 3, 2)


def test_restore_waits_for_an_async_save():
    """A death right after an async save restores that save (ROADMAP C9:
    the reference lists only the saves its writer thread has finished)."""
    coord, params, opt = _coordinator([1.0, 0.5])
    with tempfile.TemporaryDirectory() as d:
        cm = CheckpointManager(d, num_nodes=4, num_shards=4, async_save=True)
        elastic = ElasticController(coord, checkpoints=cm)
        elastic.set_restore_template({"params": params, "opt_state": opt})
        batches = batch_iterator(CFG, 32, 4, seed=0)
        params, opt, _ = coord.step(params, opt, batches)
        saved = [t.clone() for t in tree_leaves(params)]
        cm.save(1, {"params": params, "opt_state": opt})
        params, opt, _ = coord.step(params, opt, batches)  # in place: the snapshot keeps step 1
        coord.monitor.pronounce("pod1", coord._vtime)
        params, opt, restored = elastic.maybe_restore(params, opt)
        assert restored and elastic.events[-1].detail["step"] == 1 and int(opt["step"]) == 1
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params), saved))


def test_restore_keeps_no_pre_restore_tensor():
    """Once the caller rebinds to the restored state, nothing holds the
    params and moments it replaced: the controller's template becomes the
    restored state, and a second death restores onto it."""
    import gc
    import weakref

    coord, params, opt = _coordinator([1.0, 0.5, 0.5])
    with tempfile.TemporaryDirectory() as d:
        cm = CheckpointManager(d, num_nodes=4, num_shards=4)
        elastic = ElasticController(coord, checkpoints=cm)
        elastic.set_restore_template({"params": params, "opt_state": opt})
        batches = batch_iterator(CFG, 32, 4, seed=0)
        params, opt, _ = coord.step(params, opt, batches)
        cm.save(1, {"params": params, "opt_state": opt})
        for dead in ("pod1", "pod2"):
            old = [weakref.ref(t) for t in tree_leaves({"params": params, "opt_state": opt})]
            params, opt, _ = coord.step(params, opt, batches)
            coord.monitor.pronounce(dead, coord._vtime)
            params, opt, restored = elastic.maybe_restore(params, opt)
            gc.collect()
            assert restored and int(opt["step"]) == 1
            assert not any(r() is not None for r in old), f"pre-restore tensors alive after losing {dead}"


# ----------------------------------------------------------------- the entry point


# pod 1 dies at step 4, a step after the async save of step 2: the
# reference's restore lists only finished saves (ROADMAP C9), and one
# whole step gives its writer thread the time to finish
TRAIN_ARGS = ["--arch", "qwen3-1.7b-smoke", "--steps", "7", "--batch", "4", "--seq", "32", "--microbatches", "6",
              "--pods", "1.0,0.5", "--kill-pod", "1", "--kill-at", "4", "--ckpt-every", "2", "--log-every", "100",
              "--lr", "3e-3"]


@needs_jax
def test_train_main_matches_reference(tmp_path):
    """The port's ``main`` on the CPU against the JAX ``main``, pods 1.0 and
    0.5, pod 1 killed at step 4 and the state restored from the step-2
    checkpoint. The port starts from the JAX package's weights (its own
    init draws from a torch generator). Schedules and elastic events are
    equal; the losses agree within a bf16 tolerance: both compute in bf16,
    and their attention outputs and matmuls round in other places (the
    reference's trainer runs ``chunked`` attention): the step-0 losses were
    6e-5 apart and later ones up to 8.4e-4, at a loss of ~5.5, where one
    bf16 unit is 3.1e-2. The limits, 1e-3 at step 0 and 5e-3 after, are a
    sixth of a bf16 unit or less."""
    jcfg = jax_get_config("qwen3-1.7b-smoke")
    jp = JM.init_model(jax.random.PRNGKey(0), jcfg)
    pp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), get_config("qwen3-1.7b-smoke"))
    jout = jtrain.main(TRAIN_ARGS + ["--ckpt-dir", str(tmp_path / "jax")])
    with mock.patch.object(train_mod.M, "init_model", lambda cfg, gen: pp):
        out = train_mod.main(TRAIN_ARGS + ["--ckpt-dir", str(tmp_path / "port"), "--device", "cpu"])
    assert out["device"] == "cpu" and out["steps"] == jout["steps"] == 7
    assert [h["schedule"] for h in out["history"]] == [h["schedule"] for h in jout["history"]] \
        == [[4, 2]] * 4 + [[6]] * 3
    assert [h["step"] for h in out["history"]] == [h["step"] for h in jout["history"]]
    assert [(h["virtual_s"], h["homo_s"]) for h in out["history"]] == \
        [(h["virtual_s"], h["homo_s"]) for h in jout["history"]]
    assert out["elastic_events"] == jout["elastic_events"]
    assert [e["kind"] for e in out["elastic_events"]] == ["pod_dead", "restored"]
    assert out["elastic_events"][1]["detail"]["step"] == 2 and out["history"][4]["step"] == 3
    diffs = [abs(a["loss"] - b["loss"]) for a, b in zip(out["history"], jout["history"])]
    assert diffs[0] <= 1e-3 and max(diffs) <= 5e-3, diffs


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_main_trains_every_arch(arch):
    """Every family trains through the entry point: each arch's ``-smoke``
    config, 2 steps over pods 1.0 and 0.5 on the CPU. The losses are
    finite, a frontend's microbatches carry its 8 prefix features, and the
    first microbatch gives every parameter a non-zero gradient (the MoE
    router and experts, the Mamba and sLSTM gates, ``frontend.proj``)."""
    seen = []
    make = train_mod.make_grad_step

    def spy(cfg, run):
        step = make(cfg, run)

        def grad_step(params, batch):
            grads, metrics = step(params, batch)
            seen.append(("prefix_features" in batch, [bool(g.any()) for g in tree_leaves(grads)]))
            return grads, metrics
        return grad_step

    with mock.patch.object(train_mod, "make_grad_step", spy):
        out = train_mod.main(["--arch", f"{arch}-smoke", "--device", "cpu", "--steps", "2", "--batch", "2",
                              "--seq", "32", "--microbatches", "3", "--pods", "1.0,0.5", "--log-every", "100"])
    assert out["steps"] == 2 and all(np.isfinite(h["loss"]) for h in out["history"])
    assert len(seen) == 6 and all(prefix == bool(get_config(arch).frontend) for prefix, _ in seen)
    assert all(seen[0][1]), f"{seen[0][1].count(False)} leaves got no gradient"


def test_train_main_cuda_needs_a_device():
    with mock.patch.object(torch.cuda, "is_available", lambda: False):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_mod.main(["--steps", "1"])
