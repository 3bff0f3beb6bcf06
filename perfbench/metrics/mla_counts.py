"""Operations and bytes of K2 (causal flash attention) over one layer of a
prefill of multi-head latent attention, counted at the published head
widths: q and k of ``N + P`` (no-RoPE and RoPE parts), v and the output of
``VH``. The program pads all four to one width K2 is built for; the padding
is not work the attention needs, so it shows as a loss in the share.

``d`` is the ``Dims`` of ``configs/moonlight_ref.py``.
"""

from __future__ import annotations

from benchlib.counts import least_s, window_pairs


def k2_mla_flops(d, s: int) -> int:
    """2 (q·k over N + P) + 2 (p·v over VH) operations per head and causal
    pair."""
    return 2 * d.H * window_pairs(s) * (d.N + d.P + d.VH)


def k2_mla_bytes(d, s: int, itemsize: int = 2) -> int:
    """q, k, v read once and the output written once, unpadded."""
    return itemsize * s * d.H * (2 * (d.N + d.P) + 2 * d.VH)


def k2_mla_least_s(d, s: int) -> float:
    return least_s(k2_mla_flops(d, s), k2_mla_bytes(d, s))
