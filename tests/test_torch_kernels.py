"""K1 (flash-decode) and K2 (flash-attention forward) of the PyTorch port
against the JAX package (K3, the SSD scan, is in ``test_torch_ssm.py``).

On the CPU the port's wrappers run each kernel's plain PyTorch version;
here it is held against the Pallas kernel in interpret mode and against
the jnp oracle in ``repro/kernels/ref.py``, on the same numpy inputs and
to the tolerances of ``tests/test_kernels.py`` (fp32 2e-5; bf16 3e-2 for
decode, 2e-2 for flash). The ``gpu``-marked tests hold the CUDA kernels,
K3 included, against their plain versions on the card and skip elsewhere.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import (
    SPLIT_KEYS,
    decode_attention_cuda,
    decode_attention_plain,
    scratch_shape,
    split_plan,
)
from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain
from repro_torch.kernels.ssm_scan import fold, ssm_scan_cuda, ssm_scan_plain, unfold

try:
    import jax.numpy as jnp

    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
except ImportError:  # the card's machine has no JAX: only the gpu tests run there
    jnp = jops = jref = None

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _jax_reference(request):
    if jnp is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("JAX is not installed: the reference side of this test is missing")


def _pair(rng, *shape, dtype="float32"):
    """The same values as a JAX array and a torch CPU tensor."""
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a, getattr(jnp, dtype)), torch.from_numpy(a).to(DTYPES[dtype])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _err(a, b):
    return float(np.abs(_np(a) - _np(b)).max())


FLASH_CASES = [
    # (B, Sq, Sk, H, KH, D, window, q_offset, bq, bk)  — as tests/test_kernels.py
    (2, 128, 128, 4, 2, 64, 0, 0, 64, 64),
    (1, 100, 256, 8, 8, 128, 0, 156, 64, 64),  # ragged + offset (prefill tail)
    (2, 256, 256, 6, 2, 64, 64, 0, 64, 64),  # sliding window
    (1, 64, 64, 2, 1, 256, 0, 0, 32, 32),  # big head dim
    (1, 33, 65, 4, 4, 64, 0, 0, 32, 32),  # non-divisible seq (padding)
]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas_and_ref(case, dtype):
    B, Sq, Sk, H, KH, D, win, off, bq, bk = case
    rng = np.random.default_rng(1)
    qj, qt = _pair(rng, B, Sq, H, D, dtype=dtype)
    kj, kt = _pair(rng, B, Sk, KH, D, dtype=dtype)
    vj, vt = _pair(rng, B, Sk, KH, D, dtype=dtype)
    out = ops.flash_attention(qt, kt, vt, q_offset=off, window=win)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    tol = 2e-5 if dtype == "float32" else 2e-2
    pallas = jops.flash_attention(qj, kj, vj, True, off, win, None, bq, bk, True)
    ref = jref.flash_attention_ref(qj, kj, vj, causal=True, window=win, q_offset=off)
    assert _err(out, pallas) < tol
    assert _err(out, ref) < tol


def test_flash_window_first_block_fully_masked():
    """ROADMAP C2: with a window and a query offset, a row's first visited
    kv block can be fully masked. The port zeroes masked probabilities
    explicitly, so its result matches the oracle with no phantom mass."""
    B, Sq, Sk, H, KH, D, win, off = 1, 64, 192, 4, 2, 64, 40, 128
    rng = np.random.default_rng(2)
    qj, qt = _pair(rng, B, Sq, H, D)
    kj, kt = _pair(rng, B, Sk, KH, D)
    vj, vt = _pair(rng, B, Sk, KH, D)
    out = ops.flash_attention(qt, kt, vt, q_offset=off, window=win)
    ref = jref.flash_attention_ref(qj, kj, vj, causal=True, window=win, q_offset=off)
    pallas = jops.flash_attention(qj, kj, vj, True, off, win, None, 32, 32, True)
    assert _err(out, ref) < 2e-5
    assert _err(out, pallas) < 2e-5


DECODE_CASES = [
    # (B, S, H, KH, D, block_k of the Pallas kernel) — as tests/test_kernels.py
    (2, 512, 8, 2, 64, 128),
    (3, 300, 4, 4, 128, 128),  # padding + MHA
    (1, 1024, 16, 2, 64, 256),
]


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_pallas_and_ref(case, dtype):
    B, S, H, KH, D, bk = case
    rng = np.random.default_rng(3)
    qj, qt = _pair(rng, B, H, D, dtype=dtype)
    kj, kt = _pair(rng, B, S, KH, D, dtype=dtype)
    vj, vt = _pair(rng, B, S, KH, D, dtype=dtype)
    valid = rng.random((B, S)) > 0.3
    out = ops.decode_attention(qt, kt, vt, torch.from_numpy(valid))
    assert out.dtype == qt.dtype and out.shape == qt.shape
    tol = 2e-5 if dtype == "float32" else 3e-2
    pallas = jops.decode_attention(qj, kj, vj, jnp.asarray(valid), block_k=bk, interpret=True)
    ref = jref.decode_attention_ref(qj, kj, vj, jnp.asarray(valid))
    assert _err(out, pallas) < tol
    assert _err(out, ref) < tol


@pytest.mark.parametrize("S,bk", [(256, 128), (130, 64)])  # exact blocks | remainder block
def test_decode_ring_full_capacity(S, bk):
    B, H, KH, D = 2, 4, 2, 64
    rng = np.random.default_rng(4)
    qj, qt = _pair(rng, B, H, D)
    kj, kt = _pair(rng, B, S, KH, D)
    vj, vt = _pair(rng, B, S, KH, D)
    valid = np.ones((B, S), bool)
    out = ops.decode_attention(qt, kt, vt, torch.from_numpy(valid))
    assert _err(out, jops.decode_attention(qj, kj, vj, jnp.asarray(valid), block_k=bk, interpret=True)) < 2e-5
    assert _err(out, jref.decode_attention_ref(qj, kj, vj, jnp.asarray(valid))) < 2e-5


def test_decode_valid_only_in_remainder_block():
    B, S, H, KH, D, bk = 2, 190, 4, 2, 64, 64  # 3 Pallas blocks, the last holds 62 keys
    rng = np.random.default_rng(5)
    qj, qt = _pair(rng, B, H, D)
    kj, kt = _pair(rng, B, S, KH, D)
    vj, vt = _pair(rng, B, S, KH, D)
    idx = np.arange(S)
    valid = np.stack([idx >= 2 * bk, idx >= S - 5])
    out = ops.decode_attention(qt, kt, vt, torch.from_numpy(valid))
    assert _err(out, jops.decode_attention(qj, kj, vj, jnp.asarray(valid), block_k=bk, interpret=True)) < 2e-5
    assert _err(out, jref.decode_attention_ref(qj, kj, vj, jnp.asarray(valid))) < 2e-5


def test_decode_all_invalid_row_returns_zero():
    """The kernel contract (ROADMAP C3): a row with no valid key gives an
    exact zero output and l = 0, as the Pallas kernel does; the einsum/ref
    path spreads it uniformly instead, so only the valid row is compared
    with the oracle."""
    B, S, H, KH, D = 2, 128, 4, 2, 64
    rng = np.random.default_rng(6)
    qj, qt = _pair(rng, B, H, D)
    kj, kt = _pair(rng, B, S, KH, D)
    vj, vt = _pair(rng, B, S, KH, D)
    valid = np.stack([np.ones(S, bool), np.zeros(S, bool)])
    vt_mask = torch.from_numpy(valid)
    out = ops.decode_attention(qt, kt, vt, vt_mask)
    assert bool(torch.isfinite(out).all())
    assert float(out[1].abs().max()) == 0.0
    assert _err(out[0], jref.decode_attention_ref(qj, kj, vj, jnp.asarray(valid))[0]) < 2e-5
    acc, m, l = ops.decode_attention(qt, kt, vt, vt_mask, return_partials=True)
    pacc, pm, pl = jops.decode_attention(qj, kj, vj, jnp.asarray(valid), block_k=64,
                                         return_partials=True, interpret=True)
    assert float(l[1].max()) == 0.0 and float(acc[1].abs().max()) == 0.0
    for a, b in ((acc, pacc), (m, pm), (l, pl)):
        assert _err(a[0], b[0]) < 2e-5 * max(1.0, float(np.abs(_np(b[0])).max()))
    assert _err(m[1], pm[1]) == 0.0  # both keep the -1e30 surrogate of -inf


def test_decode_partials_combine():
    """Shard the cache in two, combine the partials, compare to the whole."""
    B, S, H, KH, D = 2, 256, 4, 2, 64
    rng = np.random.default_rng(7)
    qj, qt = _pair(rng, B, H, D)
    kj, kt = _pair(rng, B, S, KH, D)
    vj, vt = _pair(rng, B, S, KH, D)
    valid = torch.ones((B, S), dtype=torch.bool)
    parts = [ops.decode_attention(qt, kt[:, sl], vt[:, sl], valid[:, sl], return_partials=True)
             for sl in (slice(0, S // 2), slice(S // 2, S))]
    combined = ops.combine_decode_partials(*zip(*parts))
    exp = jref.decode_attention_ref(qj, kj, vj, jnp.ones((B, S), bool))
    assert _err(combined, exp) < 2e-5
    jparts = [jops.decode_attention(qj, kj[:, sl], vj[:, sl], jnp.ones((B, S // 2), bool),
                                    return_partials=True, interpret=True)
              for sl in (slice(0, S // 2), slice(S // 2, S))]
    assert _err(combined, jops.combine_decode_partials(*zip(*jparts))) < 2e-5


def test_wrappers_never_launch_on_cpu():
    ops.reset_launches()
    rng = np.random.default_rng(8)
    _, q = _pair(rng, 1, 8, 2, 64)
    _, k = _pair(rng, 1, 8, 2, 64)
    ops.flash_attention(q, k, k)
    ops.decode_attention(q[:, 0], k, k, torch.ones((1, 8), dtype=torch.bool))
    ops.ssm_scan(q, -torch.rand(1, 8, 2), k, k, chunk=4)
    assert ops.LAUNCHES == {"decode_attention": 0, "flash_attention": 0, "ssm_scan": 0}


@pytest.mark.parametrize("seq_len", [1, SPLIT_KEYS - 1, SPLIT_KEYS, SPLIT_KEYS + 1, 2048, 2050])
def test_decode_split_plan_depends_on_seq_len_only(seq_len):
    """K1 cuts S into fixed-length splits: the plan is a function of S
    alone, so a row's partials (and their combine order) are the same in
    any batch; the scratch holds one (acc, m, l) per row, head and split."""
    keys, n = split_plan(seq_len)
    assert keys == SPLIT_KEYS
    assert (n - 1) * keys < seq_len <= n * keys
    for b, h, d in ((1, 16, 128), (8, 16, 128), (3, 6, 64)):
        assert scratch_shape(b, h, d, seq_len) == (b, h, n, d + 2)


def test_decode_split_plan_rejects_empty_cache():
    with pytest.raises(ValueError):
        split_plan(0)


def test_cuda_wrappers_refuse_cpu_tensors():
    """On the CPU the wrappers in ops run the plain versions; the kernels'
    own entry points refuse CPU tensors before touching the library."""
    q = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention_cuda(q, q, q, scale=0.125)
    with pytest.raises(ValueError):
        decode_attention_cuda(q[:, 0], q, q, torch.ones(1, 64, dtype=torch.int32), scale=0.125)


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _on(dev, rng, *shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, DTYPES[dtype])


# on the card also: the qwen3 prefill shape, a window and offset where a
# row's first 64-key tile is all masked, Sq not a multiple of the 64-row tile
CARD_FLASH_CASES = FLASH_CASES + [
    (1, 1024, 1024, 16, 8, 128, 0, 0, 64, 64),
    (1, 100, 1124, 4, 2, 128, 70, 1024, 64, 64),
    (2, 200, 200, 4, 2, 64, 0, 0, 64, 64),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", CARD_FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain_on_card(cuda, case, dtype):
    B, Sq, Sk, H, KH, D, win, off, _, _ = case
    rng = np.random.default_rng(9)
    q, k, v = (_on(cuda, rng, B, s, h, D, dtype=dtype) for s, h in ((Sq, H), (Sk, KH), (Sk, KH)))
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, q_offset=off, window=win)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    exp = flash_attention_plain(q, k, v, q_offset=off, window=win, scale=D**-0.5)
    tol = 1e-4 if dtype == "float32" else 3e-2
    assert float((out.float() - exp.float()).abs().max()) < tol


# on the card also K1's split boundaries: S below one split, one short of
# it, at it, one past it, and a ragged last split
SPLIT_CASES = [(4, s, 8, 4, 128, 0) for s in (100, SPLIT_KEYS - 1, SPLIT_KEYS, SPLIT_KEYS + 1, 3 * SPLIT_KEYS + 7)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", DECODE_CASES + [(8, 2050, 16, 8, 128, 512)] + SPLIT_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("normalize", [True, False])
def test_decode_kernel_matches_plain_on_card(cuda, case, dtype, normalize):
    """Row 0 has no valid key (exact zeros, m = -1e30); row 1, where there
    is one, only keys of the kernel's last split."""
    B, S, H, KH, D, _ = case
    rng = np.random.default_rng(10)
    q = _on(cuda, rng, B, H, D, dtype=dtype)
    k, v = (_on(cuda, rng, B, S, KH, D, dtype=dtype) for _ in range(2))
    valid = torch.from_numpy(rng.random((B, S)) > 0.3).to(cuda, torch.int32)
    rows = slice(1, None) if B > 1 else slice(None)
    if B > 1:
        valid[0] = 0  # all-invalid row
        valid[1, :(S - 1) // SPLIT_KEYS * SPLIT_KEYS] = 0  # valid only in the last split
    got = decode_attention_cuda(q, k, v, valid, scale=D**-0.5, normalize=normalize)
    exp = decode_attention_plain(q, k, v, valid, scale=D**-0.5, normalize=normalize)
    torch.cuda.synchronize()
    if B > 1:
        assert float(got[0][0].abs().max()) == 0.0 and float(got[2][0].max()) == 0.0
        assert torch.equal(got[1][0], exp[1][0])  # both keep the -1e30 surrogate of -inf
    # fp32 sums in another order over S: 1e-4, relative to l's scale
    for a, b in zip(got, exp):
        assert float((a[rows] - b[rows]).abs().max()) < 1e-4 * max(1.0, float(b[rows].abs().max()))


# (B, S, H, P, N, chunk, sd of the log input gate; 0: b ~ 0.3 N(0, 1))
SSM_CARD_CASES = [
    (2, 100, 3, 17, 40, 32, 0.0),  # pads
    (2, 40, 3, 17, 40, 64, 0.0),  # below one chunk
    (2, 64, 3, 17, 40, 16, 0.0),  # exact
    (1, 1024, 4, 513, 512, 256, 1.0),  # one mLSTM prefill of xlstm-1.3b
    (1, 1024, 4, 513, 512, 256, 3.0),  # the same, input gates up to e^10
    (2, 256, 2, 64, 64, 64, 0.0),  # P = 64: no padding
    (2, 256, 2, 65, 64, 64, 0.0),  # P = 65
    (2, 200, 3, 17, 40, 64, 3.0),  # input gates up to e^10, pads
] + [(1, 64 * k, 2, 65, 48, 64, 1.0) for k in (1, 2, 3, 4)]  # one to four chunks


def _ssm_card_inputs(dev, case, dtype, seed=11):
    """x, loga, b, c in the model layout: b = 0.3 N(0, 1) with loga in
    [-0.2, 0] (sd 0), or as the mLSTM builds them (b = k exp(input gate), the
    gate's log ~ N(0, sd^2) clamped at +-10, loga = log sigmoid of an open
    forget gate, x with the normaliser's ones column)."""
    B, S, H, P, N, _, sd = case
    rng = np.random.default_rng(seed)
    x = _on(dev, rng, B, S, H, P, dtype=dtype)
    c = _on(dev, rng, B, S, H, N, dtype=dtype)
    b = _on(dev, rng, B, S, H, N, dtype="float32")
    if sd == 0:
        return x, -torch.from_numpy(rng.random((B, S, H)).astype(np.float32)).to(dev) * 0.2, b * 0.3, c
    x[..., -1] = 1
    gate = np.exp(np.clip(sd * rng.standard_normal((B, S, H, 1)), -10, 10)).astype(np.float32)
    b = b / N**0.5 * torch.from_numpy(gate).to(dev)
    loga = torch.nn.functional.logsigmoid(3 + torch.from_numpy(rng.standard_normal((B, S, H)).astype(np.float32)).to(dev))
    return x, loga, b, c


@pytest.mark.gpu
@pytest.mark.parametrize("case", SSM_CARD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_scan_kernel_matches_plain_on_card(cuda, case, dtype):
    """K3 through ``ops.ssm_scan`` (fold pads P and N to multiples of 8 and
    S to whole chunks): P odd (17, 65, 513 as mLSTM's head_dim + 1), S not a
    multiple of the chunk, b in fp32 as the mLSTM path hands it, one to
    four chunks, input gates up to e^10. Each element is held to its own
    scale, |plain| + the largest |plain| of its row (last axis): fp32 1e-5
    (sums in another order), bf16 1e-2 for y (it is rounded to bf16: one
    ulp is at most 2^-8 of that scale). The reference is the plain version
    on the same inputs widened to fp64, so that it sums in fp64: summed in
    fp32 it is itself up to 5e-5 of the scale from the exact result at input
    gates near e^10 (``scripts/k3_precision.py``)."""

    B, S, H, P, N, chunk, _ = case
    y, ye = _ssm_held_on_card(*_ssm_card_inputs(cuda, case, dtype), chunk)
    assert _scaled_err(y, ye) <= (1e-5 if dtype == "float32" else 1e-2)


def _scaled_err(a, b):
    """Largest |a - b| / (|b| + the largest |b| of its row, the last axis)."""
    a, b = a.float(), b.float()
    scale = b.abs() + b.abs().amax(dim=-1, keepdim=True)
    return float(((a - b).abs() / scale.clamp_min(1e-30)).max())


def _ssm_held_on_card(x, loga, b, c, chunk):
    """One ``ops.ssm_scan`` call on the card (one K3 launch) against the
    plain version on the inputs widened to fp64: h within 1e-5 of each
    element's scale. Returns y and the exact y rounded where the kernel
    rounds it, for the caller to hold."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    before = ops.LAUNCHES["ssm_scan"]
    y, h = ops.ssm_scan(x, loga, b, c, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssm_scan"] == before + 1
    ye, he = unfold(*ssm_scan_plain(*(t.double() for t in fold(x, loga, b, c, chunk)), chunk), B, S, P, N)
    assert y.dtype == x.dtype and y.shape == (B, S, H, P) and h.shape == (B, H, N, P)
    assert _scaled_err(h, he) <= 1e-5
    return y, ye.to(x.dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1000, 4096])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_scan_kernel_matches_plain_at_mamba_shape_on_card(cuda, S, dtype):
    """K3 at jamba's Mamba layout (BH 128, P 128, N 64, c shared by every
    head), over one prompt of 1000 tokens (pads to 1024) and one of 4096
    (16 chunks of 256): h as the cases above; y against the magnitude of
    the terms each element sums (the plain version in fp64 on |x|, loga,
    |b|, |c|), 1e-6 in fp32 and 1e-2 in bf16, as ``chip_smoke.py`` holds
    its "loga ~ -5" case. At Mamba's decays (down to e^-11 a step) a row of
    y is nearly c_t . b_t times x_t, and where that dot product cancels the
    row's own scale falls up to ~5000 times below the terms; there the
    kernel errs ~1.6e-7 of the terms in fp32 and 4e-6 to 2e-5 of the
    row's scale (``scripts/k3_precision.py``)."""
    from chip_smoke import mamba_scan_inputs

    x, loga, b, c = mamba_scan_inputs(torch.Generator(device=cuda).manual_seed(S), 1, S, DTYPES[dtype])
    y, ye = _ssm_held_on_card(x, loga, b, c, 256)
    ax, ab, ac = (t.double().abs() for t in (x, b, c))
    terms, _ = unfold(*ssm_scan_plain(*fold(ax, loga.double(), ab, ac, 256), 256), 1, S, 128, 64)
    err = float(((y.double() - ye.double()).abs() / terms.clamp_min(1e-300)).max())
    assert err <= (1e-6 if dtype == "float32" else 1e-2)


@pytest.mark.gpu
def test_ssm_scan_kernel_batch_invariant_at_mamba_shape_on_card(cuda):
    """At the Mamba layout with two prompts (BH 256), through
    ``chip_smoke.k3_bit_checks``: two calls give the same bits, each
    prompt's rows called alone give the bits they give in the batch, and a
    call replayed from a CUDA graph equals the eager call."""
    from chip_smoke import k3_bit_checks, mamba_scan_inputs

    gen = torch.Generator(device=cuda).manual_seed(14)
    bits = k3_bit_checks(fold(*mamba_scan_inputs(gen, 2, 1000, torch.bfloat16), 256), 128)
    assert all(bits.values()), bits


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_scan_kernel_deterministic_and_row_independent_on_card(cuda, dtype):
    """At the mLSTM prefill shape two calls give the same bits, and each row
    of a BH-4 call is bit-identical to that row called alone: the kernel
    sums in a fixed order, with no atomics, whatever the batch."""
    case = (1, 1024, 4, 513, 512, 256, 1.0)
    f = fold(*_ssm_card_inputs(cuda, case, dtype, seed=12), 256)
    y1, h1 = ssm_scan_cuda(*f, 256)
    y2, h2 = ssm_scan_cuda(*f, 256)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)
    for i in range(f[0].shape[0]):
        y, h = ssm_scan_cuda(*(t[i:i + 1].clone() for t in f), 256)
        assert torch.equal(y, y1[i:i + 1]) and torch.equal(h, h1[i:i + 1])


@pytest.mark.gpu
def test_ssm_scan_kernel_graph_replay_on_card(cuda):
    """A K3 call captured in a CUDA graph and replayed equals the eager call
    bit for bit: the wrapper allocates with torch.empty and the launch sets
    its shared-memory limit once per device, outside the capture."""
    case = (1, 1024, 4, 513, 512, 256, 1.0)
    f = fold(*_ssm_card_inputs(cuda, case, "bfloat16", seed=13), 256)
    y1, h1 = ssm_scan_cuda(*f, 256)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ssm_scan_cuda(*f, 256)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        yg, hg = ssm_scan_cuda(*f, 256)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(yg, y1) and torch.equal(hg, h1)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [2048, 2050])
@pytest.mark.parametrize("normalize", [True, False])
def test_decode_kernel_batch_invariant_on_card(cuda, S, normalize):
    """Row i of a batch-8 call is bit-identical to row i called alone: the
    split length depends on S only and the splits combine in a fixed order."""
    B, H, KH, D = 8, 16, 8, 128
    rng = np.random.default_rng(12)
    q = _on(cuda, rng, B, H, D, dtype="bfloat16")
    k, v = (_on(cuda, rng, B, S, KH, D, dtype="bfloat16") for _ in range(2))
    valid = torch.from_numpy(rng.random((B, S)) > 0.3).to(cuda, torch.int32)
    valid[2] = 0
    whole = decode_attention_cuda(q, k, v, valid, scale=D**-0.5, normalize=normalize)
    for i in range(B):
        alone = decode_attention_cuda(q[i:i + 1], k[i:i + 1], v[i:i + 1], valid[i:i + 1], scale=D**-0.5,
                                      normalize=normalize)
        for a, b in zip(whole, alone):
            assert torch.equal(a[i:i + 1], b)


# K2's gradient on the card: the kernel's forward, the reference's recompute
# backward (chip_smoke.k2_grad_check), at a small shape, at qwen3's training
# shape (2 x 1024, 16 q heads on 8 KV heads of 128) and at a window with a
# query offset, held against autograd through the plain forward
K2_CARD_GRAD_CASES = [((2, 128, 4, 2, 64), 0, 0), ((2, 1024, 16, 8, 128), 0, 0), ((1, 100, 4, 2, 128), 70, 1024)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", K2_CARD_GRAD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_grad_matches_plain_autograd_on_card(cuda, case, dtype):
    from chip_smoke import k2_grad_check

    shape, window, q_offset = case
    r = k2_grad_check(torch.Generator(device=cuda).manual_seed(15), shape, DTYPES[dtype], window=window,
                      q_offset=q_offset)
    assert r["grad_fn"] and r["forward_launches"] == 1 and r["backward_launches"] == 0 and r["dtype_kept"], r
    assert r["ok"], r


@pytest.mark.gpu
def test_flash_attention_on_card_does_not_detach(cuda):
    """For CUDA tensors that require a gradient the kernel's output carries
    a ``grad_fn``, and every input gets a gradient: nothing detaches."""
    rng = np.random.default_rng(16)
    q = _on(cuda, rng, 1, 64, 4, 64, dtype="bfloat16").requires_grad_()
    k, v = (_on(cuda, rng, 1, 64, 2, 64, dtype="bfloat16").requires_grad_() for _ in range(2))
    out = ops.flash_attention(q, k, v)
    assert out.requires_grad and out.grad_fn is not None
    out.float().square().sum().backward()
    assert all(t.grad is not None and t.grad.dtype == torch.bfloat16 and bool(t.grad.abs().sum() > 0)
               for t in (q, k, v))
