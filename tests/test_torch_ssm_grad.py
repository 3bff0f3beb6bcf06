"""K3's gradient: ``ops.ssm_scan`` is a ``torch.autograd.Function`` whose
forward is the kernel (its plain version on the CPU) and whose backward
recomputes the plain version under autograd (``ssm_scan_ref_vjp``).

On the CPU its gradients are held against ``jax.grad`` through the JAX
package's jnp ``chunked_ssd`` (``repro/models/ssm.py``), which is what the
reference differentiates when it trains an SSM: fp32 on both sides, at
xLSTM's layout (P = head_dim + 1, padded to a multiple of 8 by ``fold``)
and at Mamba's (c shared by every head, broadcast before the call, and b
per head as the Mamba block builds it), with S not a multiple of the chunk
(padded with identity steps). Both differentiate one fp32 function with
sums in other orders: each gradient within 2e-5 of its largest |g| (the
readings are below 3e-7; a dropped or misplaced term moves a gradient by
O(|g|)). The ``gpu``-marked twin runs the kernel's forward on the card.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ssm_scan import fold, ssm_scan_plain, ssm_scan_ref_vjp, unfold

try:
    import jax
    import jax.numpy as jnp

    from repro.models import ssm as jssm
except ImportError:  # the card's machine has no JAX: only the gpu tests run there
    jax = None

GRAD_TOL = 2e-5


@pytest.fixture(autouse=True)
def _jax_reference(request):
    if jax is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("JAX is not installed: the reference side of this test is missing")


def _inputs(rng, B, S, H, P, N, shared_c: bool):
    """fp32 numpy inputs in the model layout: x, a log decay as the models
    give it (log sigmoid of an open forget gate, or dt times -exp(a_log)),
    b and c; c of shape (B, S, 1, N) where every head shares it."""
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    loga = -np.abs(rng.standard_normal((B, S, H)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((B, S, H, N)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((B, S, 1 if shared_c else H, N)) * 0.3).astype(np.float32)
    return x, loga, b, c


def _close(got, exp, tol=GRAD_TOL):
    got, exp = np.asarray(got.detach().double()), np.asarray(exp, np.float64)
    assert got.shape == exp.shape
    assert float(np.abs(got - exp).max()) <= tol * max(float(np.abs(exp).max()), 1e-30)


# (B, S, H, P, N, chunk, c shared by the heads): xLSTM's layout (P = hd + 1
# pads from 17 to 24, N = hd), Mamba's (c broadcast over 4 heads)
LAYOUTS = {"xlstm": (2, 21, 3, 17, 16, 8, False), "mamba": (2, 21, 4, 16, 8, 8, True)}


@pytest.mark.parametrize("with_h", [False, True], ids=["y_only", "y_and_h"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_ssm_scan_grads_match_jax_chunked_ssd(layout, with_h):
    """Cotangents on y only (training: nothing reads the final state) and
    on y and h."""
    B, S, H, P, N, chunk, shared = LAYOUTS[layout]
    rng = np.random.default_rng(21)
    x, loga, b, c = _inputs(rng, B, S, H, P, N, shared)
    gy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    gh = rng.standard_normal((B, H, N, P)).astype(np.float32) if with_h else None

    def jloss(x_, la_, b_, c_):
        y, h = jssm.chunked_ssd(x_, la_, b_, jnp.broadcast_to(c_, b_.shape), chunk=chunk)
        return jnp.sum(y * gy) + (jnp.sum(h * gh) if with_h else 0.0)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (x, loga, b, c)))
    ins = [torch.from_numpy(a).requires_grad_() for a in (x, loga, b, c)]
    y, h = ops.ssm_scan(ins[0], ins[1], ins[2], ins[3].expand(B, S, H, N), chunk)
    assert y.grad_fn is not None and h.grad_fn is not None
    outs, cots = [y], [torch.from_numpy(gy)]
    if with_h:
        outs.append(h)
        cots.append(torch.from_numpy(gh))
    grads = torch.autograd.grad(outs, ins, cots)
    for got, exp in zip(grads, jgrads):
        _close(got, exp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_scan_grads_match_plain_autograd(dtype):
    """The autograd function against autograd straight through the plain
    version on the same folded inputs: the same function, so fp32 agrees to
    rounding and bf16 (x and c bf16, b fp32 as the mLSTM block gives them)
    to a bf16 unit of each gradient's scale. The gradients keep the inputs'
    dtypes, an unread final state counts as zero, and the backward launches
    nothing."""
    gen = torch.Generator().manual_seed(22)
    B, S, H, P, N, chunk = 2, 30, 3, 13, 8, 8
    x, c = (torch.randn(B, S, H, n, generator=gen).to(dtype) for n in (P, N))
    loga, b = -0.3 * torch.rand(B, S, H, generator=gen), torch.randn(B, S, H, N, generator=gen)
    gy = torch.randn(B, S, H, P, generator=gen).to(dtype)
    got = [t.clone().requires_grad_() for t in (x, loga, b, c)]
    ref = [t.clone().requires_grad_() for t in (x, loga, b, c)]
    before = dict(ops.LAUNCHES)
    y, _ = ops.ssm_scan(*got, chunk)
    y.backward(gy)
    yf, hf = ssm_scan_plain(*fold(*ref, chunk), chunk)
    unfold(yf, hf, B, S, P, N)[0].backward(gy)
    assert ops.LAUNCHES == before  # the CPU runs the plain forward: no kernel launch
    tol = 1e-6 if dtype == torch.float32 else 2**-7
    for a, r in zip(got, ref):
        assert a.grad.dtype == a.dtype
        _close(a.grad, r.grad.double().numpy(), tol)
    # no cotangent for h is the zero cotangent
    f = fold(*(t.detach() for t in (x, loga, b, c)), chunk)
    gyf = fold(gy, loga, b, c, chunk)[0]
    zero_h = torch.zeros(B * H, 8, 16)
    assert all(torch.equal(p, q) for p, q in zip(ssm_scan_ref_vjp(*f, gyf, None, chunk),
                                                 ssm_scan_ref_vjp(*f, gyf, zero_h, chunk)))


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# xLSTM's training shape (2 x 1024, 4 heads of P = 513, N = 512) and
# Mamba's (128 heads of P = 128, N = 64, c shared), at chunk 256
CARD_LAYOUTS = {"xlstm": (2, 1024, 4, 513, 512, False), "mamba": (1, 1000, 128, 128, 64, True)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", sorted(CARD_LAYOUTS))
def test_ssm_scan_grads_on_card(cuda, layout, dtype):
    """On the card the forward is one K3 launch and the backward launches
    nothing; every input gets a finite gradient of its own dtype and shape,
    equal to autograd straight through the plain version (the same
    recompute, so this checks the wiring: ``chip_smoke.k3_grad_check``)."""
    from chip_smoke import k3_grad_check

    B, S, H, P, N, shared = CARD_LAYOUTS[layout]
    x, loga, b, c = (torch.from_numpy(a).to(cuda) for a in _inputs(np.random.default_rng(23), B, S, H, P, N, shared))
    r = k3_grad_check(x.to(dtype), loga, b, c.to(dtype))
    assert r["ok"], r
