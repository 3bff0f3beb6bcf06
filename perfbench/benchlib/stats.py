"""Percentiles and rates, taken over all requests and the whole window.

A request that never finished counts as missing any limit: its latency is
``math.inf``, and a percentile that reaches it is ``math.inf``.
"""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0..100) of ``values`` by linear
    interpolation between the closest ranks (numpy's default method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    if xs[hi] == math.inf:
        return math.inf if pos > lo or xs[lo] == math.inf else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def gaps(stamps) -> list[float]:
    """Gaps between consecutive stamps of one request's tokens."""
    return [b - a for a, b in zip(stamps, stamps[1:])]


def spread(values) -> float:
    """Distance between the first and third quartiles as a share of the
    median, as ``statistics.quantiles(values, n=4)`` gives them."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
