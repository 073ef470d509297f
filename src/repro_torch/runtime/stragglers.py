"""Straggler mitigation: hedged blob fetches.

Object-storage latency is long-tailed (paper Fig. 5); at thousands of
concurrent readers the per-step tail is the max over many samples. The
hedge: if the primary GET has not completed within ``hedge_quantile`` of
the latency distribution, fire a backup request and take the earlier
completion — bounding the per-request tail at the cost of a small extra
request rate. (Same single-flight cache keeps the per-AZ GET invariant:
the hedge re-requests through the cache owner, not around it.)
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.stores import LatencyModel


@dataclasses.dataclass
class HedgeStats:
    requests: int = 0
    hedges: int = 0
    wins: int = 0          # backup finished first


class HedgedFetcher:
    """Models hedged GETs against the calibrated latency distribution."""

    def __init__(self, latency: Optional[LatencyModel] = None,
                 hedge_quantile: float = 0.95, seed: int = 0):
        self.latency = latency or LatencyModel()
        self.q = hedge_quantile
        self.rng = np.random.default_rng(seed)
        self.stats = HedgeStats()

    def hedge_threshold(self, size: int) -> float:
        med = self.latency.get_median(size)
        z = {0.90: 1.2816, 0.95: 1.6449, 0.99: 2.3263}.get(self.q, 1.6449)
        return med * float(np.exp(self.latency.sigma * z))

    def fetch(self, size: int) -> float:
        """Returns the effective completion latency with hedging."""
        self.stats.requests += 1
        t1 = self.latency.sample_get(size, self.rng)
        thresh = self.hedge_threshold(size)
        if t1 <= thresh:
            return t1
        self.stats.hedges += 1
        t2 = thresh + self.latency.sample_get(size, self.rng)
        if t2 < t1:
            self.stats.wins += 1
        return min(t1, t2)

    def tail_improvement(self, size: int, n: int = 20000,
                         pct: float = 99.0) -> Tuple[float, float]:
        """(p_tail without hedging, p_tail with hedging)."""
        base = np.array([self.latency.sample_get(size, self.rng)
                         for _ in range(n)])
        hedged = np.array([self.fetch(size) for _ in range(n)])
        return (float(np.percentile(base, pct)),
                float(np.percentile(hedged, pct)))
