"""Log-spaced latency histogram for request quantiles.

A serving runtime reports tail latency (p99), not means — the paper's
wait-fraction metric says how well *one* drain hides latency, while the
p99 says what the slowest-in-a-hundred tenant actually experienced
under concurrent load.  Quantiles over a fixed log-spaced bucket grid
are mergeable across tenants (unlike stored percentiles) and O(1) per
record, at the cost of a bounded relative error set by the bucket ratio
(~7% here: 60 buckets per 3 decades spanning 1 µs .. 100 s).
"""
from __future__ import annotations

import math
from bisect import bisect_left

__all__ = ["LatencyHistogram"]

# bucket upper edges: log-spaced, 20 per decade over [1e-6, 1e2] seconds
_N_PER_DECADE = 20
_LO_EXP, _HI_EXP = -6, 2
_EDGES = tuple(
    10.0 ** (_LO_EXP + i / _N_PER_DECADE)
    for i in range((_HI_EXP - _LO_EXP) * _N_PER_DECADE + 1)
)


class LatencyHistogram:
    """Fixed-grid log histogram: ``record(seconds)``, ``quantile(q)``,
    ``merge(other)``.  Values outside [1 µs, 100 s] clamp to the end
    buckets; the exact observed ``max`` is tracked separately so the
    tail is never under-reported by bucketing."""

    __slots__ = ("counts", "count", "sum", "max")

    def __init__(self):
        self.counts = [0] * (len(_EDGES) + 1)
        self.count = 0
        self.sum = 0.0
        self.max = 0.0

    def record(self, seconds: float) -> None:
        if seconds < 0 or math.isnan(seconds):
            seconds = 0.0
        elif math.isinf(seconds):
            # clamp to the overflow-bucket edge: an untreated +inf would
            # poison ``max`` — and every quantile, since quantile() clamps
            # its answer to ``max``
            seconds = _EDGES[-1]
        self.counts[bisect_left(_EDGES, seconds)] += 1
        self.count += 1
        self.sum += seconds
        if seconds > self.max:
            self.max = seconds

    def quantile(self, q: float) -> float:
        """Latency at quantile ``q`` in [0, 1] — the upper edge of the
        bucket holding the q-th sample (0.0 when empty)."""
        if self.count == 0:
            return 0.0
        q = min(1.0, max(0.0, q))
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank and c:
                if i >= len(_EDGES):  # overflow bucket: only max is honest
                    return self.max
                return min(_EDGES[i], self.max) if self.max else _EDGES[i]
        return self.max

    @property
    def p50(self) -> float:
        return self.quantile(0.50)

    @property
    def p95(self) -> float:
        return self.quantile(0.95)

    @property
    def p99(self) -> float:
        return self.quantile(0.99)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def merge(self, other: "LatencyHistogram") -> None:
        """Fold ``other`` into self (exact: same fixed grid)."""
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum += other.sum
        if other.max > self.max:
            self.max = other.max

    def __repr__(self):
        if not self.count:
            return "LatencyHistogram(empty)"
        return (
            f"LatencyHistogram(n={self.count}, p50={self.p50 * 1e3:.2f}ms, "
            f"p99={self.p99 * 1e3:.2f}ms, max={self.max * 1e3:.2f}ms)"
        )
