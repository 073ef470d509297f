"""ShuffleBench-style open-workload driver for the async engine.

Generates a timestamped record stream with a configurable arrival process
(Poisson or deterministic), key skew (Zipf over a bounded key universe,
exponent 0 = uniform), and record size — the knobs ShuffleBench (Henning
et al., 2024) identifies as dominating shuffle behavior. Feeding it to
``AsyncShuffleEngine.submit`` yields per-stage latency percentiles and
$/GiB under open-loop load, which is what the paper's Figs. 5–7 sweep.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.recordbatch import RecordBatch
from repro_torch.core.records import Record, serialized_size


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    arrival_rate: float = 10_000.0   # records/s offered across all sources
    duration_s: float = 5.0
    record_bytes: int = 1024         # serialized record size target
    key_skew: float = 0.0            # Zipf exponent; 0 = uniform keys
    num_keys: int = 10_000
    poisson: bool = True             # False: deterministic inter-arrivals
    seed: int = 0

    @property
    def n_records(self) -> int:
        return max(1, int(self.arrival_rate * self.duration_s))


def _key_probs(cfg: WorkloadConfig) -> np.ndarray:
    ranks = np.arange(1, cfg.num_keys + 1, dtype=np.float64)
    w = ranks ** -cfg.key_skew
    return w / w.sum()


def _arrivals_and_keys(cfg: WorkloadConfig) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(cfg.seed)
    n = cfg.n_records
    if cfg.poisson:
        gaps = rng.exponential(1.0 / cfg.arrival_rate, size=n)
        arrivals = np.cumsum(gaps)
    else:
        arrivals = (np.arange(n) + 1.0) / cfg.arrival_rate
    if cfg.key_skew > 0:
        keys = rng.choice(cfg.num_keys, size=n, p=_key_probs(cfg))
    else:
        keys = rng.integers(0, cfg.num_keys, size=n)
    return arrivals, keys


def _value_size(cfg: WorkloadConfig) -> int:
    # value padded so the serialized record lands on record_bytes
    probe = Record(int(0).to_bytes(8, "little"), b"")
    return max(1, cfg.record_bytes - serialized_size(probe))


def generate(cfg: WorkloadConfig) -> List[Tuple[float, Record]]:
    """Materialize the stream as [(arrival_time_s, record), ...]."""
    arrivals, keys = _arrivals_and_keys(cfg)
    vsize = _value_size(cfg)
    out: List[Tuple[float, Record]] = []
    for t, k in zip(arrivals, keys):
        rec = Record(int(k).to_bytes(8, "little"),
                     bytes(vsize), timestamp_us=int(t * 1e6))
        out.append((float(t), rec))
    return out


def generate_batch(cfg: WorkloadConfig) -> Tuple[np.ndarray, RecordBatch]:
    """Columnar twin of ``generate``: the whole stream as one
    ``RecordBatch`` (records identical to ``generate``'s, bit for bit)
    plus the arrival-time array — built fully vectorized, no per-record
    Python objects."""
    arrivals, keys = _arrivals_and_keys(cfg)
    batch = RecordBatch.from_fixed(
        keys.astype(np.uint64), _value_size(cfg),
        (arrivals * 1e6).astype(np.uint64))
    return arrivals, batch


def drive(engine, cfg: WorkloadConfig,
          batch_records: Optional[int] = None) -> None:
    """Submit the whole workload to an ``AsyncShuffleEngine`` (round-robin
    over instances, like a load-balanced source topic).

    ``batch_records``: when set, records are handed over in columnar
    micro-batches of that many consecutive arrivals (zero-copy row
    slices), delivered at each micro-batch's last arrival time — the
    engine's vectorized ingest lane. Per-record arrival times still feed
    the end-to-end latency accounting."""
    if batch_records is None:
        for t, rec in generate(cfg):
            engine.submit(t, rec)
        return
    arrivals, batch = generate_batch(cfg)
    n = len(batch)
    for s in range(0, n, batch_records):
        e = min(s + batch_records, n)
        engine.submit_batch(float(arrivals[e - 1]),
                            batch.slice_rows(s, e),
                            times=arrivals[s:e])
