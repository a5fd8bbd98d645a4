"""Observability primitives (port of part of ``repro.runtime.telemetry``):
the log-bucket :class:`Histogram` the serving metrics record latencies
into, and the zero-cost :data:`NULL_TELEMETRY` recorder the runtime
threads through.  The tracer and the Prometheus export are not ported yet.
"""

from __future__ import annotations

import bisect
import contextlib
import math


class Histogram:
    """Fixed-bucket log-scale histogram (values in seconds by default).

    Bucket upper edges are ``lo * 10**(i / per_decade)``, so a percentile
    estimate carries a constant relative error of one bucket ratio
    anywhere in the range.  Values above the largest edge land in the
    overflow bucket and are reported as the observed max.
    """

    __slots__ = ("bounds", "counts", "n", "total", "min", "max")

    def __init__(self, lo: float = 1e-6, hi: float = 120.0,
                 per_decade: int = 5):
        n = int(math.ceil(per_decade * math.log10(hi / lo))) + 1
        self.bounds: tuple = tuple(lo * 10 ** (i / per_decade)
                                   for i in range(n))
        self.counts: list[int] = [0] * (n + 1)      # +1: overflow bucket
        self.n = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def record(self, value: float) -> None:
        v = float(value)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.n += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def percentile(self, p: float) -> float:
        """Estimated ``p``-th percentile (log-interpolated within the
        bucket holding that rank; clamped to the observed min/max)."""
        if not self.n:
            return 0.0
        rank = max(1, math.ceil(p / 100.0 * self.n))
        cum = 0
        for i, c in enumerate(self.counts):
            if cum + c >= rank:
                if i == len(self.bounds):       # overflow bucket
                    return self.max
                hi = self.bounds[i]
                lo = self.bounds[i - 1] if i else \
                    hi / (self.bounds[1] / self.bounds[0])
                frac = (rank - cum) / c
                est = lo * (hi / lo) ** frac
                return min(max(est, self.min), self.max)
            cum += c
        return self.max

    def percentiles(self, *ps: float) -> tuple:
        return tuple(self.percentile(p) for p in ps)


_NULL_CTX = contextlib.nullcontext()


class NullTelemetry:
    """The no-op recorder: ``timed`` hands back one shared null context."""

    def timed(self, phase: str, **args):
        return _NULL_CTX


NULL_TELEMETRY = NullTelemetry()
