"""Operations and bytes that the work needs, counted from shapes, and the
peaks they are held against.

The counts read the function's shapes: its tokens, its causal pairs and its
valid keys, never what a kernel of the program happens to do, so a PR that
replaces a kernel leaves them valid. ``k1_least_s`` and ``window_pairs``
are copies of ``chip_smoke.py::k1_bound`` and ``window_pairs``.

``d`` is the ``Dims`` of a configuration (``configs/transformer_ref.py``).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate and HBM3 bandwidth,
# at the card's full 700 W; a card set lower runs below them
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def window_pairs(sq: int, window: int = 0) -> int:
    """(query, key) pairs a causal attention of ``sq`` rows visits."""
    if not window:
        return sq * (sq + 1) // 2
    w = min(window, sq)
    return w * (w + 1) // 2 + (sq - w) * w


def layer_params(d) -> int:
    """Weights a token goes through in one layer's products: q, k, v, o and
    the SwiGLU FFN."""
    return d.D * d.H * d.hd + 2 * d.D * d.KH * d.hd + d.H * d.hd * d.D + 3 * d.D * d.F


def head_params(d) -> int:
    return d.D * d.V


def prefill_flops(d, s: int) -> int:
    """One prefill of ``s`` tokens: the products of every token, causal
    attention, and the head at the last position."""
    return d.L * (2 * layer_params(d) * s + 4 * d.H * d.hd * window_pairs(s)) + 2 * head_params(d)


def decode_flops(d, keys: int) -> int:
    """One decoded token whose attention reads ``keys`` keys (its own
    included), in every layer."""
    return d.L * (2 * layer_params(d) + 4 * d.H * d.hd * keys) + 2 * head_params(d)


def train_flops(d, rows: int, seq: int) -> int:
    """One microbatch, forward and backward: 6 N per token for the products
    and three times the forward's causal attention."""
    n = d.L * layer_params(d) + head_params(d)
    return 6 * n * rows * seq + 3 * rows * d.L * 4 * d.H * d.hd * window_pairs(seq)


def least_s(flops: float, nbytes: float) -> float:
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def k2_least_s(d, s: int, itemsize: int = 2) -> float:
    """K2 (causal flash attention) over one layer of a prefill of ``s``
    tokens: 4 D operations per (q head, causal pair); q, k, v read once
    and the output written once."""
    flops = 4 * d.H * d.hd * window_pairs(s)
    nbytes = itemsize * s * d.hd * (2 * d.H + 2 * d.KH)
    return least_s(flops, nbytes)


def k1_least_s(d, batch: int, cap: int, n_valid: int, itemsize: int = 2) -> float:
    """K1 (flash-decode) over one layer of a decode step of ``batch`` slots
    of ``cap`` keys, ``n_valid`` of them valid in all: q and the int32 mask
    read once, the fp32 output written once, and the K and V of the valid
    keys only (no other key enters the result); 4 D operations per (q head,
    valid key)."""
    nbytes = batch * d.H * d.hd * itemsize + batch * cap * 4 + batch * d.H * d.hd * 4 \
        + 2 * n_valid * d.KH * d.hd * itemsize
    return least_s(4 * d.H * d.hd * n_valid, nbytes)
