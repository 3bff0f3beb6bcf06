"""The port's xLSTM slice against the JAX package: K3 (the chunked SSD
scan), the mLSTM and sLSTM blocks, the xlstm model and its serving arena.

Inputs come from numpy generators and JAX's own seeded weights, handed to
the port through ``repro_torch.bridge``; on the CPU the port's
``ops.ssm_scan`` runs its plain version, held here against the Pallas
kernel in interpret mode. Compute is fp32 unless a test says otherwise,
and fp32 results must agree to 1e-4 of the largest |reference| (as
``tests/test_consistency.py``; relative, because the mLSTM input gate
reaches e^10). bf16 outputs agree to 1e-2 of it: both sides sum in fp32
from the same bf16 inputs, then round y to bf16, which moves an element by
at most one bf16 ulp (2^-8 of it).

The JAX reference advances the recurrent state of inactive rows in
``decode_step`` (ROADMAP C5); the port keeps it, so the parity tests
compare active rows only, and one test shows that the port leaves a
parked row's state untouched.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.data.dataset import SyntheticCorpus
from repro_torch.kernels import ops
from repro_torch.kernels.ssm_scan import ALIGN, fold, ssm_scan_plain, unfold
from repro_torch.launch.serve import Request, ServeLoop
from repro_torch.models import model as M
from repro_torch.models import ssm

try:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.configs.base import RunConfig as JaxRunConfig
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.launch.serve import Request as JaxRequest
    from repro.launch.serve import ServeLoop as JaxServeLoop
    from repro.models import common as jcommon
    from repro.models import model as JM
    from repro.models import ssm as jssm
except ImportError:  # the card's machine has no JAX: only gpu tests would run there
    jax = None

TOL = 1e-4
BF16_TOL = 1e-2
LAYERS = 8  # one period of the xLSTM pattern: 7 mLSTM + 1 sLSTM
SMALL = dict(num_layers=LAYERS, vocab_size=64)
LENS = (6, 9, 12, 15)
CHUNK = 8  # prompts of 9 and 15 tokens pad to whole chunks


@pytest.fixture(autouse=True)
def _jax_reference(request):
    if jax is None and request.node.get_closest_marker("gpu") is None:
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


# ------------------------------------------------------------- K3: the scan


SSM_CASES = [
    # (B, S, H, P, N, chunk) — as tests/test_kernels.py
    (2, 512, 4, 128, 64, 128),
    (1, 256, 2, 64, 32, 64),
    (2, 128, 8, 128, 16, 128),  # single chunk
]


def _scan_inputs(rng, B, S, H, P, N, dtype="float32"):
    xj, xt = _pair(rng.standard_normal((B, S, H, P)), dtype)
    laj, lat = _pair(-np.abs(rng.standard_normal((B, S, H))) * 0.1)
    bj, bt = _pair(rng.standard_normal((B, S, H, N)) * 0.2, dtype)
    cj, ct = _pair(rng.standard_normal((B, S, H, N)) * 0.2, dtype)
    return (xj, laj, bj, cj), (xt, lat, bt, ct)


@pytest.mark.parametrize("case", SSM_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_scan_plain_matches_pallas_interpret(case, dtype):
    B, S, H, P, N, chunk = case
    jin, tin = _scan_inputs(np.random.default_rng(11), B, S, H, P, N, dtype)
    y, h = ops.ssm_scan(*tin, chunk=chunk)
    assert y.dtype == tin[0].dtype and y.shape == (B, S, H, P)
    assert h.dtype == torch.float32 and h.shape == (B, H, N, P)
    yj, hj = jops.ssm_scan(*jin, chunk=chunk, interpret=True)
    _close(y, yj, TOL if dtype == "float32" else BF16_TOL)
    _close(h, hj)
    if dtype == "float32":  # and the sequential oracle, to the same bound
        ye, he = jref.ssm_scan_ref(*jin)
        _close(y, ye)
        _close(h, he)


def test_ssm_scan_state_carry_across_chunks():
    """The final state does not depend on the chunk length."""
    _, (x, la, b, c) = _scan_inputs(np.random.default_rng(12), 1, 64, 1, 8, 4)
    _, h16 = ops.ssm_scan(x, la, b, c, chunk=16)
    _, h64 = ops.ssm_scan(x, la, b, c, chunk=64)
    _close(h16, h64)


@pytest.mark.parametrize("S,chunk", [(100, 32), (20, 256), (70, 64)])
def test_chunked_ssd_pads_like_jax(S, chunk):
    """S not a multiple of the chunk: the port pads with identity steps as
    the JAX package's ``chunked_ssd`` does (its Pallas kernel would assert)."""
    jin, tin = _scan_inputs(np.random.default_rng(13), 2, S, 3, 9, 5)
    y, h = ssm.chunked_ssd(*tin, chunk=chunk)
    yj, hj = jssm.chunked_ssd(*jin, chunk=chunk)
    _close(y, yj)
    _close(h, hj)


def test_scan_fold_pads_with_identity_steps():
    """S pads to whole chunks with identity steps; P (5) and N (4) pad to
    multiples of 8 with zero columns."""
    x = torch.randn(2, 10, 3, 5)
    la = -torch.rand(2, 10, 3)
    b, c = torch.randn(2, 10, 3, 4), torch.randn(2, 10, 3, 4)
    xf, laf, bf, cf = fold(x, la, b, c, chunk=4)
    assert xf.shape == (6, 12, 8) and laf.shape == (6, 12) and bf.shape == cf.shape == (6, 12, 8)
    assert all(t.is_contiguous() for t in (xf, laf, bf, cf))
    assert float(laf[:, 10:].abs().max()) == 0.0 and float(xf[:, 10:].abs().max()) == 0.0
    assert float(xf[..., 5:].abs().max()) == 0.0 and float(bf[..., 4:].abs().max()) == float(cf[..., 4:].abs().max()) == 0.0
    assert torch.equal(xf[4, :10, :5], x[1, :, 1])
    with pytest.raises(ValueError, match="not a multiple"):
        ssm_scan_plain(x[:, :, 0], la[:, :, 0], b[:, :, 0], c[:, :, 0], chunk=4)


def test_ssm_scan_off_cpu_never_falls_back(monkeypatch):
    """Off the CPU the wrapper never runs the plain version. A meta tensor
    (the dry-run's stand-in) gets K3's custom-op fake: outputs of the right
    shapes and types, no launch, with or without a gradient (the kernel's
    forward is differentiable since its recompute backward). A CUDA tensor
    reaches the kernel, which refuses any other."""
    def plain(*a, **k):
        raise AssertionError("the plain version ran off the CPU")

    monkeypatch.setattr(ops, "ssm_scan_plain", plain)
    ops.reset_launches()
    x = torch.empty((1, 8, 2, 5), device="meta")
    la, b = torch.empty((1, 8, 2), device="meta"), torch.empty((1, 8, 2, 4), device="meta")
    for xx in (x.requires_grad_(), x.detach()):
        y, h = ops.ssm_scan(xx, la, b, b, chunk=4)
        assert y.device.type == h.device.type == "meta"
        assert y.shape == (1, 8, 2, 5) and h.shape == (1, 2, 4, 5) and h.dtype == torch.float32
    assert ops.LAUNCHES["ssm_scan"] == 0
    with pytest.raises(ValueError, match="CUDA device"):  # the kernel refuses a tensor that is not on the card
        ops.ssm_scan_cuda(torch.zeros((2, 8, 8)), torch.zeros((2, 8)), torch.zeros((2, 8, 8)),
                          torch.zeros((2, 8, 8)), 4)
    assert ops.LAUNCHES["ssm_scan"] == 0


@pytest.mark.parametrize("P", [17, 64, 65, 513])
def test_fold_unfold_round_trip_pads_p(P):
    """fold pads P to a multiple of ALIGN (the kernel's 16-byte rows) and
    unfold cuts it off: y and h come back at their own width, unchanged."""
    B, S, H, N = 2, 24, 3, 16
    x, b, c = torch.randn(B, S, H, P), torch.randn(B, S, H, N), torch.randn(B, S, H, N)
    la = -torch.rand(B, S, H)
    xf, laf, bf, cf = fold(x, la, b, c, chunk=8)
    pp = -(-P // ALIGN) * ALIGN
    assert xf.shape == (B * H, S, pp) and bf.shape == cf.shape == (B * H, S, N)
    assert bool((xf[..., P:] == 0).all())
    hf = torch.randn(B * H, N, pp)
    y, h = unfold(xf, hf, B, S, P, N)
    assert y.shape == (B, S, H, P) and h.shape == (B, H, N, P)
    assert torch.equal(y, x) and torch.equal(h, hf.reshape(B, H, N, pp)[..., :P])


@pytest.mark.parametrize("P", [17, 65, 513])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_scan_on_padded_fold_is_bit_identical(P, dtype):
    """The plain scan on fold's padded layout equals the scan on the
    unpadded one bit for bit, and the padded columns of y and h are exactly
    zero: padding changes nothing the kernel is held against."""
    B, S, H, N = 1, 64, 2, 24
    g = torch.Generator().manual_seed(P)
    dt = getattr(torch, dtype)
    x, c = torch.randn(B, S, H, P, generator=g).to(dt), torch.randn(B, S, H, N, generator=g).to(dt)
    b = torch.randn(B, S, H, N, generator=g) * 0.3
    la = -torch.rand(B, S, H, generator=g) * 0.2
    xf, laf, bf, cf = fold(x, la, b, c, chunk=32)
    y0, h0 = ssm_scan_plain(xf[..., :P].contiguous(), laf, bf, cf, 32)  # the layout without padding
    y1, h1 = ssm_scan_plain(xf, laf, bf, cf, 32)
    assert y1.shape[-1] == h1.shape[-1] == -(-P // ALIGN) * ALIGN
    assert torch.equal(y1[..., :P], y0) and torch.equal(h1[..., :P], h0)
    assert bool((y1[..., P:] == 0).all()) and bool((h1[..., P:] == 0).all())


def _tf32(a):
    """Round fp32 to TF32 as the kernel's ``cvt.rna.tf32.f32`` does: add half
    of the 13 low mantissa bits, then mask them off."""
    return ((a.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_mm(a, b, exact_a, exact_b, split=True):
    """a @ b the way the kernel takes its products: an operand that came in
    bf16 (exact) as it is, an fp32 one as hi + lo (both TF32), the products
    hi·hi' (+ hi·lo' + lo·hi'), each exact in fp32, summed in fp32.
    ``split=False`` takes one TF32 pass on the fp32 operands instead."""
    ah = a if exact_a else _tf32(a)
    bh = b if exact_b else _tf32(b)
    out = ah @ bh
    if split and not exact_b:
        out = out + ah @ _tf32(b - bh)
    if split and not exact_a:
        out = out + _tf32(a - ah) @ bh
    return out


def _split_scan(x, loga, b, c, chunk, split=True):
    """``ssm_scan_plain``'s chunked algorithm with every product taken as
    :func:`_split_mm` takes it (x and c exact if they came in bf16)."""
    bh, s, p = x.shape
    n = b.shape[-1]
    L = min(chunk, s)
    k = s // L
    xe = x.dtype == torch.bfloat16
    xk = x.reshape(bh, k, L, p).float()
    bk = b.reshape(bh, k, L, n).float()
    ck = c.reshape(bh, k, L, n).float()
    cum = torch.cumsum(loga.reshape(bh, k, L), dim=2)
    total = cum[:, :, -1]
    cb = _split_mm(ck, bk.transpose(-1, -2), xe, False, split)
    decay = torch.exp(torch.clamp_max(cum[..., :, None] - cum[..., None, :], 0.0))
    w = torch.where(torch.ones((L, L), dtype=torch.bool).tril(), cb * decay, 0.0)
    y = _split_mm(w, xk, False, xe, split)
    s_k = _split_mm((bk * torch.exp(total[..., None] - cum)[..., None]).transpose(-1, -2), xk, False, xe, split)
    h = torch.zeros((bh, n, p))
    y_inter = []
    for i in range(k):
        y_inter.append(_split_mm(ck[:, i], h, xe, False, split) * torch.exp(cum[:, i])[..., None])
        h = torch.exp(total[:, i])[:, None, None] * h + s_k[:, i]
    return (y + torch.stack(y_inter, dim=1)).reshape(bh, s, p).to(x.dtype), h


def _scaled_err(a, b):
    """Largest |a - b| / (|b| + the largest |b| of its row): each element
    against its own scale, as chip_smoke.py and the gpu tests hold K3."""
    a, b = a.float(), b.float()
    scale = b.abs() + b.abs().amax(dim=-1, keepdim=True)
    return float(((a - b).abs() / scale.clamp_min(1e-30)).max())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_tf32_split_meets_the_kernel_limits(dtype):
    """The kernel's precision choice, where it can run: at a reduced width
    (N = 64, P = 65, four chunks of 64, mLSTM-like gates), the plain
    algorithm with every product taken on split TF32 operands stays within
    the limits the kernel is held to on the card (y 1e-2 in bf16 and 1e-5
    in fp32, h 1e-5, scaled), while one TF32 pass on the fp32 operands
    misses the limit on h."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(16)
    B, S, H, P, N, chunk = 1, 256, 2, 65, 64, 64
    x = torch.from_numpy(rng.standard_normal((B, S, H, P)).astype(np.float32)).to(dt)
    x[..., -1] = 1  # the mLSTM normaliser column
    c = torch.from_numpy(rng.standard_normal((B, S, H, N)).astype(np.float32)).to(dt)
    gate = np.exp(np.clip(rng.standard_normal((B, S, H, 1)), -10, 10))
    b = torch.from_numpy((rng.standard_normal((B, S, H, N)) / N**0.5 * gate).astype(np.float32))
    la = torch.nn.functional.logsigmoid(torch.from_numpy(3 + rng.standard_normal((B, S, H)).astype(np.float32)))
    f = fold(x, la, b, c, chunk)
    ye, he = ssm_scan_plain(*f, chunk)
    ys, hs = _split_scan(*f, chunk)
    assert _scaled_err(ys, ye) <= (1e-2 if dtype == "bfloat16" else 1e-5)
    assert _scaled_err(hs, he) <= 1e-5
    _, h1 = _split_scan(*f, chunk, split=False)
    assert _scaled_err(h1, he) > 1e-5


# ------------------------------------------------------ the blocks alone


def _cfgs(**over):
    kw = {**SMALL, **over}
    jcfg = dataclasses.replace(jax_get_config("xlstm-1.3b").reduced(**kw), compute_dtype="float32")
    pcfg = dataclasses.replace(get_config("xlstm-1.3b").reduced(**kw), compute_dtype="float32")
    return jcfg, pcfg


def _block_params(defs, seed):
    jp = jcommon.build_params(defs, jax.random.PRNGKey(seed))
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def test_mlstm_full_and_step_match():
    jcfg, pcfg = _cfgs()
    jp, pp = _block_params(jssm.mlstm_defs(jcfg), 1)
    rng = np.random.default_rng(14)
    xj, xt = _pair(rng.standard_normal((2, 21, jcfg.d_model)))
    _close(ssm.mlstm_apply_full(pcfg, pp, xt, chunk=8), jssm.mlstm_apply_full(jcfg, jp, xj, None, chunk=8))
    # the prefill state against the JAX package's own cache builder
    out, state = ssm.mlstm_apply_full(pcfg, pp, xt, chunk=8, return_state=True)
    jout, jstate = JM._mlstm_full_with_cache(jcfg, JaxRunConfig(ssd_chunk=8), jp, xj, None)
    _close(out, jout)
    _close(state, jstate["state"])
    # one step from that state
    sj, st = _pair(rng.standard_normal((2, 1, jcfg.d_model)))
    y, new = ssm.mlstm_apply_step(pcfg, pp, state, st)
    jy, jnew = jssm.mlstm_apply_step(jcfg, jp, jstate, sj, None)
    _close(y, jy)
    _close(new, jnew["state"])


def test_slstm_full_and_step_match():
    jcfg, pcfg = _cfgs()
    jp, pp = _block_params(jssm.slstm_defs(jcfg), 2)
    rng = np.random.default_rng(15)
    xj, xt = _pair(rng.standard_normal((2, 13, jcfg.d_model)))
    out, state = ssm.slstm_apply_full(pcfg, pp, xt, return_state=True)
    jout, jstate = jssm.slstm_apply_full(jcfg, jp, xj, None, return_state=True)
    _close(out, jout)
    for key, j in zip(("h", "c", "n", "m"), jstate):
        _close(state[key], j)
    sj, st = _pair(rng.standard_normal((2, 1, jcfg.d_model)))
    y, new = ssm.slstm_apply_step(pcfg, pp, state, st)
    jy, jnew = jssm.slstm_apply_step(jcfg, jp, {"state": jstate}, sj, None)
    _close(y, jy)
    for key, j in zip(("h", "c", "n", "m"), jnew["state"]):
        _close(new[key], j)


# ------------------------------------------------------ the model


@pytest.fixture(scope="module")
def xlstm():
    """xlstm-smoke at one period (8 layers), fp32, on the JAX package's
    seeded weights, bridged."""
    jcfg, pcfg = _cfgs()
    jp = JM.init_model(jax.random.PRNGKey(0), jcfg)
    return jcfg, pcfg, jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp), pcfg)


def _tokens(rng, *shape):
    t = rng.integers(0, SMALL["vocab_size"], size=shape).astype(np.int32)
    return jnp.asarray(t), torch.from_numpy(t.astype(np.int64))


def _cache_close(pc, jc, pcfg, rows=slice(None)):
    jt = bridge.cache_from_jax(jax.tree.map(np.asarray, jc), pcfg)
    assert set(pc) == set(jt) == {"pos", "mlstm", "slstm"}
    assert torch.equal(pc["pos"][rows], jt["pos"][rows])
    _close(pc["mlstm"][:, rows], jt["mlstm"][:, rows])
    for key in ("h", "c", "n", "m"):
        _close(pc["slstm"][key][:, rows], jt["slstm"][key][:, rows])


def test_xlstm_prefill_and_decode_match_jax_and_forward(xlstm):
    """Prefill of 19 tokens (pads to 24 at chunk 8), then 5 decode steps:
    logits and the whole state against the JAX package; and each step's
    logits against the port's own forward over the grown sequence."""
    jcfg, pcfg, jp, pp = xlstm
    rng = np.random.default_rng(16)
    jt, pt = _tokens(rng, 2, 19)
    run_j = JaxRunConfig(remat="none", ssd_chunk=CHUNK)
    run_p = RunConfig(ssd_chunk=CHUNK)
    jl, jc = JM.prefill(jcfg, run_j, jp, jt, 32)
    pl, pc = M.prefill(pcfg, run_p, pp, pt, 32)
    _close(pl, jl)
    _cache_close(pc, jc, pcfg)
    assert pc["mlstm"].shape == (7, 2, 4, 16, 17) and pc["slstm"]["h"].shape == (1, 2, 64)
    seq = pt
    for _ in range(5):
        jt, pt = _tokens(rng, 2, 1)
        jl, jc = JM.decode_step(jcfg, run_j, jp, jc, jt, None)
        pl, pc = M.decode_step(pcfg, run_p, pp, pc, pt)
        _close(pl, jl)
        seq = torch.cat([seq, pt], dim=1)
        full, _ = M.forward(pcfg, run_p, pp, seq)
        _close(pl[:, -1], full[:, -1])
    _cache_close(pc, jc, pcfg)
    assert pc["pos"].tolist() == [24, 24]


def test_parked_row_state_untouched(xlstm):
    """``active = [True, False]``: the active row matches the JAX package;
    the parked row keeps its position and every bit of its mLSTM and sLSTM
    state (the reference would advance it: ROADMAP C5)."""
    jcfg, pcfg, jp, pp = xlstm
    rng = np.random.default_rng(17)
    jt, pt = _tokens(rng, 2, 12)
    run_j = JaxRunConfig(remat="none", ssd_chunk=CHUNK)
    run_p = RunConfig(ssd_chunk=CHUNK)
    _, jc = JM.prefill(jcfg, run_j, jp, jt, 32)
    _, pc = M.prefill(pcfg, run_p, pp, pt, 32)
    act = np.array([True, False])
    before = {"pos": pc["pos"].clone(), "mlstm": pc["mlstm"].clone(),
              **{k: t.clone() for k, t in pc["slstm"].items()}}
    for _ in range(2):
        jt, pt = _tokens(rng, 2, 1)
        jl, jc = JM.decode_step(jcfg, run_j, jp, jc, jt, None, active=jnp.asarray(act))
        pl, pc = M.decode_step(pcfg, run_p, pp, pc, pt, active=torch.from_numpy(act))
        _close(pl[:1], np.asarray(jl)[:1])
    _cache_close(pc, jc, pcfg, rows=slice(0, 1))
    assert torch.equal(pc["pos"], before["pos"] + torch.tensor([2, 0]))
    assert torch.equal(pc["mlstm"][:, 1], before["mlstm"][:, 1])
    assert not torch.equal(pc["mlstm"][:, 0], before["mlstm"][:, 0])
    for key, t in pc["slstm"].items():
        assert torch.equal(t[:, 1], before[key][:, 1]), key


def test_full_width_param_count_and_unported():
    cfg = get_config("xlstm-1.3b")
    assert M.count_params_exact(cfg) == JM.count_params_exact(jax_get_config("xlstm-1.3b")) == 2_270_677_328
    assert [cfg.layer_kind(i) for i in range(8)] == ["mlstm"] * 7 + ["slstm"]
    # the Mamba-2 hybrid, which raised "not ported" before its slice, builds
    # in the reference's layout and counts as the JAX package does
    jamba = get_config("xlstm-1.3b").reduced(ssm_kind="mamba2", attn_every=8, slstm_every=0)
    layers = M.init_model(jamba, torch.Generator())["layers"]
    assert [next(k for k in ("attn", "mamba") if k in blk) for blk in layers] == (["attn"] + ["mamba"] * 7) * 2
    assert layers[1]["mamba"]["a_log"].shape == (ssm.mamba_heads(jamba),)
    full = get_config("jamba-1.5-large-398b")
    assert M.count_params_exact(full) == JM.count_params_exact(jax_get_config("jamba-1.5-large-398b")) \
        == 397_578_714_240


def test_bridged_shapes_match_init(xlstm):
    _, pcfg, _, pp = xlstm
    a = M.init_model(pcfg, torch.Generator().manual_seed(5))
    shapes = lambda t: jax.tree.leaves(jax.tree.map(lambda x: tuple(x.shape), t))  # noqa: E731
    assert shapes(a) == shapes(pp)
    assert float(a["layers"][0]["mlstm"]["bf"][0]) == 3.0  # open forget gates
    assert float(a["layers"][7]["slstm"]["bf"][0]) == 3.0


# ------------------------------------------------------ the serving arena


def _requests(n, cls=Request, gen=8):
    corpus = SyntheticCorpus(SMALL["vocab_size"], max(LENS), 0)
    return [cls(i, corpus.grain_tokens(i, 1)[0][: LENS[i % len(LENS)]], gen) for i in range(n)]


def test_arena_streams_equal_jax_arena(xlstm):
    """Seven non-session requests through four slots (joins into freed
    slots re-prefill them, so the reference's C5 hazard does not reach
    these streams): the greedy tokens equal the JAX package's arena."""
    jcfg, pcfg, jp, pp = xlstm
    jreqs = _requests(7, cls=JaxRequest)
    JaxServeLoop(jcfg, JaxRunConfig(remat="none", ssd_chunk=CHUNK), jp, batch=4, max_len=32,
                 mode="arena").run_requests(jreqs)
    reqs = _requests(7)
    stats = ServeLoop(pcfg, RunConfig(ssd_chunk=CHUNK), pp, batch=4, max_len=32, mode="arena",
                      device="cpu").run_requests(reqs)
    assert stats["completed"] == 7 and stats["decode_calls"] < stats["decode_steps"]
    assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]


@pytest.mark.parametrize("mode", ["serial", "cohort"])
def test_arena_streams_bit_identical_to_other_modes(mode):
    """The arena (slot reuse, parking, in-place writes of every cache
    tensor) against the serial reference and the cohort regrouping: the
    same tokens, bit for bit. In fp32: in bf16 the CPU's matmul takes
    another path for a single row than for a batch (a (1, 64) @ (64, 64)
    row differs in its last bit from the same row of a (4, 64) product),
    and at seed 0 that flips a near-tied greedy token."""
    cfg = dataclasses.replace(get_config("xlstm-1.3b").reduced(**SMALL), compute_dtype="float32")
    params = M.init_model(cfg, torch.Generator().manual_seed(0))
    run = RunConfig(ssd_chunk=CHUNK)

    def serve(m):
        reqs = _requests(7)
        stats = ServeLoop(cfg, run, params, batch=4, max_len=32, mode=m, device="cpu").run_requests(reqs)
        assert stats["completed"] == 7
        return [r.tokens for r in reqs]

    assert serve("arena") == serve(mode)
