"""Bounded-memory streaming quantile sketch (DDSketch-style).

Log-spaced buckets with relative accuracy ``alpha``: bucket ``i`` covers
``(gamma**(i-1), gamma**i]`` for ``gamma = (1+alpha)/(1-alpha)``, and every
value in a bucket is estimated by ``2*gamma**i/(gamma+1)`` — within
``alpha`` relative error of the true value. Quantiles interpolate linearly
between the estimates of the two adjacent order statistics (the same
convention as ``np.percentile(..., method="linear")``), so for any
non-negative data the reported quantile is within ``alpha`` relative error
of the exact linear-interpolated percentile: both endpoints of the convex
combination carry at most ``alpha`` relative error and all terms are
non-negative.

Memory is bounded by ``max_bins``: when exceeded, the lowest buckets are
collapsed together (sacrificing low-quantile accuracy first, like
DDSketch). With the default ``alpha=0.01`` a single bucket spans ~2% of a
decade, so 4096 bins cover ~35 orders of magnitude — collapse never
triggers for simulated latencies; it is purely a safety bound.

The sketch is deterministic, mergeable, and never touches an RNG, so it
is safe to maintain inside the bit-reproducible event engine.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional, Sequence

import numpy as np


class QuantileSketch:
    """Streaming quantile estimator with guaranteed relative error.

    ``add``/``add_weighted`` are O(1); ``add_many`` is vectorized over a
    numpy array; ``percentile`` is O(bins log bins). Values must be
    non-negative (latencies, sizes); values at or below ``min_value``
    land in a dedicated zero bucket estimated as 0.0.
    """

    __slots__ = ("alpha", "gamma", "_log_gamma", "min_value", "max_bins",
                 "_bins", "zero_count", "count", "_sum", "_min", "_max")

    def __init__(self, alpha: float = 0.01, min_value: float = 1e-9,
                 max_bins: int = 4096):
        if not 0.0 < alpha < 1.0:
            raise ValueError(f"alpha must be in (0, 1), got {alpha}")
        self.alpha = alpha
        self.gamma = (1.0 + alpha) / (1.0 - alpha)
        self._log_gamma = math.log(self.gamma)
        self.min_value = min_value
        self.max_bins = max_bins
        self._bins: Dict[int, int] = {}
        self.zero_count = 0
        self.count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    # -- ingestion ----------------------------------------------------------
    def add(self, x: float) -> None:
        self.add_weighted(x, 1)

    def add_weighted(self, x: float, n: int) -> None:
        if x < 0.0:
            raise ValueError(f"sketch values must be >= 0, got {x}")
        if x <= self.min_value:
            self.zero_count += n
        else:
            key = math.ceil(math.log(x) / self._log_gamma)
            self._bins[key] = self._bins.get(key, 0) + n
            if len(self._bins) > self.max_bins:
                self._collapse()
        self.count += n
        self._sum += x * n
        if x < self._min:
            self._min = x
        if x > self._max:
            self._max = x

    def add_many(self, xs) -> None:
        xs = np.asarray(xs, dtype=np.float64)
        if xs.size == 0:
            return
        if xs.size < 32:
            # scalar path: for the tiny per-delivery arrays on the hot
            # path, np.unique costs ~10x the handful of dict updates
            for x in xs.tolist():
                self.add_weighted(x, 1)
            return
        if float(xs.min()) < 0.0:
            raise ValueError("sketch values must be >= 0")
        small = xs <= self.min_value
        n_small = int(np.count_nonzero(small))
        self.zero_count += n_small
        if n_small < xs.size:
            nz = xs[~small] if n_small else xs
            keys = np.ceil(np.log(nz) / self._log_gamma).astype(np.int64)
            uniq, cnts = np.unique(keys, return_counts=True)
            bins = self._bins
            for k, c in zip(uniq.tolist(), cnts.tolist()):
                bins[k] = bins.get(k, 0) + c
            if len(bins) > self.max_bins:
                self._collapse()
        self.count += int(xs.size)
        self._sum += float(xs.sum())
        self._min = min(self._min, float(xs.min()))
        self._max = max(self._max, float(xs.max()))

    def merge(self, other: "QuantileSketch") -> None:
        if abs(other.gamma - self.gamma) > 1e-12:
            raise ValueError("cannot merge sketches with different gamma")
        for k, c in other._bins.items():
            self._bins[k] = self._bins.get(k, 0) + c
        self.zero_count += other.zero_count
        self.count += other.count
        self._sum += other._sum
        self._min = min(self._min, other._min)
        self._max = max(self._max, other._max)
        if len(self._bins) > self.max_bins:
            self._collapse()

    def _collapse(self) -> None:
        # collapse the lowest buckets together (low quantiles lose
        # accuracy first; the high tail — what hedging and p95 gates
        # read — is preserved exactly as sketched).
        keys = sorted(self._bins)
        spill = 0
        while len(keys) > self.max_bins:
            spill += self._bins.pop(keys.pop(0))
        if spill:
            self._bins[keys[0]] += spill

    # -- queries ------------------------------------------------------------
    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self.count if self.count else 0.0

    @property
    def min(self) -> float:
        return self._min if self.count else 0.0

    @property
    def max(self) -> float:
        return self._max if self.count else 0.0

    def _bucket_value(self, key: int) -> float:
        return 2.0 * self.gamma ** key / (self.gamma + 1.0)

    def percentile(self, q: float) -> Optional[float]:
        """Estimate the q-th percentile (q in [0, 100], linear
        interpolation — same convention as ``np.percentile``). None when
        the sketch is empty."""
        out = self.percentiles([q])
        return out[0] if out else None

    def percentiles(self, qs: Sequence[float]) -> list:
        if self.count == 0:
            return [None] * len(qs)
        n = self.count
        keys = sorted(self._bins)
        cum = self.zero_count
        cums = []
        for k in keys:
            cum += self._bins[k]
            cums.append(cum)

        def order_stat(r: int) -> float:
            # value of the r-th (0-based) order statistic, within alpha
            if r < self.zero_count:
                return 0.0
            idx = int(np.searchsorted(cums, r, side="right"))
            return self._bucket_value(keys[idx])

        out = []
        for q in qs:
            if not 0.0 <= q <= 100.0:
                raise ValueError(f"percentile must be in [0, 100], got {q}")
            h = q / 100.0 * (n - 1)
            k = math.floor(h)
            frac = h - k
            lo = order_stat(k)
            est = lo if frac == 0.0 else (1.0 - frac) * lo \
                + frac * order_stat(min(k + 1, n - 1))
            # the tracked extrema are exact; clamping only moves the
            # estimate toward the true value
            out.append(min(max(est, self._min), self._max))
        return out

    def quantile(self, f: float) -> Optional[float]:
        """``percentile`` with f in [0, 1]."""
        return self.percentile(f * 100.0)

    def to_dict(self) -> dict:
        return {"count": self.count, "sum": self._sum,
                "min": self.min, "max": self.max,
                "alpha": self.alpha, "bins": len(self._bins),
                "zero_count": self.zero_count}

    def __len__(self) -> int:
        return self.count

    def __repr__(self) -> str:
        return (f"QuantileSketch(count={self.count}, bins={len(self._bins)},"
                f" alpha={self.alpha})")
