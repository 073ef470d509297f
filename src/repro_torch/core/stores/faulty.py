"""FaultyStore: composable fault-injection decorator over any BlobStore.

Wraps an inner store and injects, at request-issue time:

  * **503 SlowDown throttling** via a per-prefix token bucket (S3
    throttles per key prefix; blob ids are uuid hex, so ``prefix_len``
    buckets spread uniformly). The error carries a ``retry_after_s``
    hint derived from the bucket refill rate;
  * **transient errors** (500 / connection reset) with probability
    ``transient_p`` per admitted request;
  * **timeout tails** with probability ``timeout_p``: the client burns
    the full ``timeout_s`` deadline before observing the failure.

Failures raise ``StoreError`` subclasses *before* the inner store is
touched: failed requests are not billed, never mutate store state, and
never count in the inner ``StoreStats`` (injector-side counters live in
``FaultStats``). Every draw comes from a dedicated seeded RNG, so a
faulty run is exactly reproducible — retries, backoff, and hedging in
the engine stay bit-deterministic.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.blob import ByteRange
from repro_torch.core.stores.base import (BlobStore, SlowDownError, StoreCosts,
                                    StoreStats, StoreTimeoutError,
                                    TransientStoreError)


@dataclasses.dataclass
class FaultStats:
    slowdowns: int = 0
    transients: int = 0
    timeouts: int = 0

    @property
    def total(self) -> int:
        return self.slowdowns + self.transients + self.timeouts


class FaultyStore:
    """Decorator implementing ``BlobStore`` over any inner ``BlobStore``."""

    def __init__(self, inner: BlobStore, *, seed: int = 0,
                 throttle_rate: Optional[float] = None,
                 throttle_burst: float = 20.0,
                 prefix_len: int = 2,
                 transient_p: float = 0.0,
                 timeout_p: float = 0.0,
                 timeout_s: float = 2.0,
                 detect_s: float = 0.05):
        self.inner = inner
        self.rng = np.random.default_rng(seed)
        self.throttle_rate = throttle_rate     # admitted req/s per prefix
        self.throttle_burst = throttle_burst
        self.prefix_len = prefix_len
        self.transient_p = transient_p
        self.timeout_p = timeout_p
        self.timeout_s = timeout_s
        self.detect_s = detect_s
        self.faults = FaultStats()
        self._buckets: Dict[str, List[float]] = {}  # prefix -> [tokens, t]

    # -- delegated state ----------------------------------------------------
    @property
    def stats(self) -> StoreStats:
        return self.inner.stats

    @property
    def costs(self) -> StoreCosts:
        return self.inner.costs

    @property
    def retention_s(self) -> float:
        return self.inner.retention_s

    # -- fault decision -----------------------------------------------------
    def _admit(self, blob_id: str, now: float) -> None:
        if self.throttle_rate is not None:
            prefix = blob_id[:self.prefix_len]
            bucket = self._buckets.setdefault(
                prefix, [self.throttle_burst, now])
            tokens = min(self.throttle_burst,
                         bucket[0] + (now - bucket[1]) * self.throttle_rate)
            bucket[1] = now
            if tokens < 1.0:
                bucket[0] = tokens
                self.faults.slowdowns += 1
                retry = ((1.0 - tokens) / self.throttle_rate
                         if self.throttle_rate > 0 else 1.0)
                raise SlowDownError(
                    f"503 SlowDown on prefix {prefix!r}",
                    detect_after_s=self.detect_s, retry_after_s=retry)
            bucket[0] = tokens - 1.0
        if self.transient_p or self.timeout_p:
            r = float(self.rng.random())
            if r < self.transient_p:
                self.faults.transients += 1
                raise TransientStoreError(
                    f"transient error on {blob_id}",
                    detect_after_s=self.detect_s)
            if r < self.transient_p + self.timeout_p:
                self.faults.timeouts += 1
                raise StoreTimeoutError(
                    f"timeout after {self.timeout_s}s on {blob_id}",
                    detect_after_s=self.timeout_s)

    # -- BlobStore API (fault check, then delegate) -------------------------
    def put(self, blob_id: str, data: bytes, now: float = 0.0,
            az: Optional[int] = None) -> float:
        self._admit(blob_id, now)
        return self.inner.put(blob_id, data, now, az)

    def get(self, blob_id: str, byte_range: Optional[ByteRange] = None,
            now: float = 0.0, az: Optional[int] = None
            ) -> Tuple[bytes, float]:
        self._admit(blob_id, now)
        return self.inner.get(blob_id, byte_range, now, az)

    def begin_put(self, blob_id: str, size: int, now: float = 0.0,
                  az: Optional[int] = None) -> float:
        self._admit(blob_id, now)
        return self.inner.begin_put(blob_id, size, now, az)

    def finish_put(self, blob_id: str, data: bytes, now: float,
                   az: Optional[int] = None) -> None:
        # the request was admitted at begin_put; completion cannot fail
        self.inner.finish_put(blob_id, data, now, az)

    def begin_get(self, blob_id: str, now: float = 0.0,
                  az: Optional[int] = None) -> Tuple[int, float]:
        self._admit(blob_id, now)
        return self.inner.begin_get(blob_id, now, az)

    def payload(self, blob_id: str) -> bytes:
        return self.inner.payload(blob_id)

    def run_retention(self, now: float) -> int:
        return self.inner.run_retention(now)

    def accrue_storage(self, now: float) -> None:
        self.inner.accrue_storage(now)

    def contains(self, blob_id: str) -> bool:
        return self.inner.contains(blob_id)

    def keys(self) -> list:
        return self.inner.keys()

    def delete(self, blob_id: str, now: float = 0.0) -> bool:
        return self.inner.delete(blob_id, now)
