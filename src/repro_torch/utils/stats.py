"""Deterministic order statistics shared by the serving engine and the
QoS benchmarks.

The repo's latency summaries are *nearest-rank* percentiles — no
interpolation, so every reported number is an actual observed sample
and JSON round-trips bit-stably.  The rank definition is the standard
one: for a sorted sample of size n, the q-th percentile is the value at
1-indexed rank ``ceil(n * q / 100)`` (clamped to [1, n]).

The serving engine's original inline helper truncated ``q * n`` to an
integer before the ceiling division, which is exact for integer q but
off by one for fractional q whenever ``int(q * n)`` lands on a multiple
of 100 (e.g. q=33.35, n=3: the true rank is ceil(1.0005) = 2, the
truncating formula gave 1).  ``nearest_rank`` computes the ceiling on
the untruncated product; tests/test_stats.py pins the behavior with a
hypothesis property suite (monotonicity in q, membership, exact values
on known small lists, and the degenerate windows: empty, single-sample,
p=99 with n < 100).
"""
from __future__ import annotations

import math
from typing import Sequence


def nearest_rank(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of an ascending-sorted sample.

    ``q`` is in percent (p50 -> q=50).  Degenerate windows: an empty
    sample returns 0.0 (the engine's "no finished requests yet"
    convention); a single sample is every percentile of itself; and for
    n < 100 the p99 is the maximum (rank ceil(0.99 * n) == n exactly
    when n < 100 — the tail statistic saturates at the worst observed
    sample, it never rounds *down* past it).
    """
    n = len(sorted_vals)
    if n == 0:
        return 0.0
    k = min(n, max(1, math.ceil(n * q / 100)))
    return sorted_vals[k - 1]


def latency_summary(latencies: Sequence[float]) -> dict:
    """p50/p99/WCET/mean of an (unsorted) latency sample, as a flat
    JSON-stable dict — the per-curve record shape of the QoS suite
    (``benchmarks/fig6_tail.py``) and anything else reporting tail
    behavior."""
    vals = sorted(float(v) for v in latencies)
    n = len(vals)
    return {
        "n": n,
        "mean": (sum(vals) / n) if n else 0.0,
        "p50": nearest_rank(vals, 50),
        "p99": nearest_rank(vals, 99),
        "wcet": vals[-1] if n else 0.0,
    }
