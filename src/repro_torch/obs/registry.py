"""Metrics registry: named counters / gauges / histograms keyed by
component and AZ, with virtual-clock-windowed time series.

Every metric buckets its observations into fixed ``window_s`` windows of
the *virtual* clock, so time-sliced questions ("p95 during the
rebalance", "PUT rate while the AZ was dark") are queries over the
recorded series instead of bespoke instrumentation:

    reg = MetricsRegistry(window_s=0.25)
    h = reg.histogram("e2e", component="latency")
    h.observe(0.120, now=1.37)
    h.percentile(95)                  # whole run
    h.percentile(95, t0=1.0, t1=2.0)  # only observations in [1.0, 2.0)

Histograms are backed by :class:`~repro_torch.obs.sketch.QuantileSketch` — one
global sketch plus one per active window — so windowed quantiles come
from merging the per-window sketches, with the sketch's relative-error
guarantee intact (sketches merge losslessly).

Nothing here touches an RNG or the event loop: recording is purely a
side table, safe inside the bit-reproducible engine.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs.sketch import QuantileSketch

MetricKey = Tuple[str, str, Optional[int]]   # (name, component, az)


class Counter:
    """Monotonic counter with a per-window series of increments."""

    __slots__ = ("window_s", "total", "series")

    def __init__(self, window_s: float):
        self.window_s = window_s
        self.total = 0
        self.series: List[List[float]] = []   # [window_index, increment]

    def inc(self, n: int = 1, now: float = 0.0) -> None:
        self._inc_window(int(now // self.window_s), n)

    def _inc_window(self, idx: int, n: int) -> None:
        """Bulk path: increment with the window index already computed
        (``total_in`` never assumes unique or sorted series entries, so
        out-of-order bulk applies stay correct)."""
        self.total += n
        s = self.series
        if s and s[-1][0] == idx:
            s[-1][1] += n
        else:
            s.append([idx, n])

    def total_in(self, t0: float, t1: float) -> int:
        lo, hi = int(t0 // self.window_s), int(t1 // self.window_s)
        return int(sum(v for idx, v in self.series if lo <= idx < hi))

    def to_dict(self) -> dict:
        return {"total": self.total, "windows": len(self.series)}


class Gauge:
    """Point-in-time samples (virtual timestamp, value)."""

    __slots__ = ("samples",)

    def __init__(self, window_s: float = 0.0):
        self.samples: List[Tuple[float, float]] = []

    def set(self, value: float, now: float = 0.0) -> None:
        self.samples.append((now, value))

    @property
    def last(self) -> Optional[float]:
        return self.samples[-1][1] if self.samples else None

    def to_dict(self) -> dict:
        return {"last": self.last, "samples": len(self.samples)}


class Histogram:
    """Per-window quantile sketches with a buffered hot path.

    Observations land in a plain Python list for the current window (a
    ~100 ns append) and are flushed into that window's sketch in bulk
    when the window rolls over or the buffer fills — the engine's
    per-delivery hooks never pay per-observation sketch costs. The
    whole-run view is the (lossless) merge of the window sketches,
    built on query; queries happen a handful of times per run.
    """

    __slots__ = ("window_s", "alpha", "windows", "_buf", "_buf_idx")

    #: buffer cap — bounds memory and keeps flushes on the vectorized
    #: add_many path
    _BUF_MAX = 8192

    def __init__(self, window_s: float, alpha: float = 0.01):
        self.window_s = window_s
        self.alpha = alpha
        self.windows: List[Tuple[int, QuantileSketch]] = []
        self._buf: List[float] = []
        self._buf_idx = 0

    def _window_sketch(self, idx: int) -> QuantileSketch:
        w = self.windows
        if w and w[-1][0] == idx:
            return w[-1][1]
        sk = QuantileSketch(alpha=self.alpha)
        w.append((idx, sk))
        return sk

    def _flush(self) -> None:
        if self._buf:
            self._window_sketch(self._buf_idx).add_many(self._buf)
            self._buf = []

    def _bucket(self, now: float) -> List[float]:
        idx = int(now // self.window_s)
        if idx != self._buf_idx or len(self._buf) >= self._BUF_MAX:
            self._flush()
            self._buf_idx = idx
        return self._buf

    def observe(self, x: float, now: float = 0.0) -> None:
        self._bucket(now).append(x)

    def observe_weighted(self, x: float, n: int, now: float = 0.0) -> None:
        buf = self._bucket(now)
        if n <= 16:
            buf.extend([x] * n)
        else:
            # straight into the window sketch — adds commute with the
            # buffered values pending for the same window
            self._window_sketch(int(now // self.window_s)).add_weighted(x, n)

    def observe_many(self, xs, now: float = 0.0) -> None:
        buf = self._bucket(now)
        buf.extend(xs if type(xs) is list else np.asarray(xs).tolist())

    def _sliced(self, t0: Optional[float],
                t1: Optional[float]) -> QuantileSketch:
        self._flush()
        lo = -1 if t0 is None else int(t0 // self.window_s)
        hi = float("inf") if t1 is None else int(t1 // self.window_s)
        out = QuantileSketch(alpha=self.alpha)
        for idx, sk in self.windows:
            if lo <= idx < hi:
                out.merge(sk)
        return out

    @property
    def sketch(self) -> QuantileSketch:
        """Whole-run sketch (merged from the windows, lossless)."""
        return self._sliced(None, None)

    def percentile(self, q: float, t0: Optional[float] = None,
                   t1: Optional[float] = None) -> Optional[float]:
        return self._sliced(t0, t1).percentile(q)

    def percentiles(self, qs: Sequence[float], t0: Optional[float] = None,
                    t1: Optional[float] = None) -> list:
        return self._sliced(t0, t1).percentiles(qs)

    @property
    def count(self) -> int:
        self._flush()
        return sum(sk.count for _, sk in self.windows)

    @property
    def sum(self) -> float:
        self._flush()
        return sum(sk.sum for _, sk in self.windows)

    @property
    def mean(self) -> float:
        n = self.count
        return self.sum / n if n else 0.0

    def to_dict(self) -> dict:
        sk = self.sketch
        d = sk.to_dict()
        if sk.count:
            p50, p95, p99 = sk.percentiles([50, 95, 99])
            d.update(mean=sk.mean, p50=p50, p95=p95, p99=p99)
        d["windows"] = len(self.windows)
        return d


class MetricsRegistry:
    """Get-or-create registry of metrics keyed (name, component, az)."""

    def __init__(self, window_s: float = 0.25, alpha: float = 0.01):
        self.window_s = window_s
        self.alpha = alpha
        self.counters: Dict[MetricKey, Counter] = {}
        self.gauges: Dict[MetricKey, Gauge] = {}
        self.histograms: Dict[MetricKey, Histogram] = {}
        self.marks: List[Tuple[float, str]] = []   # (virtual time, label)

    def counter(self, name: str, component: str = "",
                az: Optional[int] = None) -> Counter:
        key = (name, component, az)
        c = self.counters.get(key)
        if c is None:
            c = self.counters[key] = Counter(self.window_s)
        return c

    def gauge(self, name: str, component: str = "",
              az: Optional[int] = None) -> Gauge:
        key = (name, component, az)
        g = self.gauges.get(key)
        if g is None:
            g = self.gauges[key] = Gauge()
        return g

    def histogram(self, name: str, component: str = "",
                  az: Optional[int] = None) -> Histogram:
        key = (name, component, az)
        h = self.histograms.get(key)
        if h is None:
            h = self.histograms[key] = Histogram(self.window_s, self.alpha)
        return h

    def mark(self, label: str, now: float) -> None:
        """Record a named instant (crash, rebalance trigger/complete…) —
        the anchors for windowed queries."""
        self.marks.append((now, label))

    def marks_named(self, prefix: str) -> List[Tuple[float, str]]:
        return [(t, label) for t, label in self.marks
                if label.startswith(prefix)]

    @staticmethod
    def _key_str(key: MetricKey) -> str:
        name, component, az = key
        out = f"{component}.{name}" if component else name
        return f"{out}[az={az}]" if az is not None else out

    def snapshot(self) -> dict:
        """JSON-ready dump of every metric (totals + summary quantiles)."""
        return {
            "counters": {self._key_str(k): c.to_dict()
                         for k, c in sorted(self.counters.items(),
                                            key=lambda kv: self._key_str(kv[0]))},
            "gauges": {self._key_str(k): g.to_dict()
                       for k, g in sorted(self.gauges.items(),
                                          key=lambda kv: self._key_str(kv[0]))},
            "histograms": {self._key_str(k): h.to_dict()
                           for k, h in sorted(self.histograms.items(),
                                              key=lambda kv: self._key_str(kv[0]))},
            "marks": [[t, label] for t, label in self.marks],
        }
