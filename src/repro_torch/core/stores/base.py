"""BlobStore protocol: the swappable object-storage exchange layer.

The paper's economics hinge on the object store being an exchange layer
that can be swapped per deployment — S3 Standard today, S3 Express One
Zone or a premium low-latency tier tomorrow (§5.3, §6). Everything the
dataflow core (cache, engine, pipeline, simulator) needs from a store is
captured here as a structural ``Protocol``; concrete backends live in
sibling modules and decorators (``FaultyStore``) compose over any of
them.

Two call styles, both part of the protocol:

  * synchronous ``put``/``get`` — the functional (unit-test) path, where
    latency is sampled and *reported* but the state change is immediate;
  * event-driven ``begin_put``/``finish_put``/``begin_get``/``payload``
    — the async engine path, where an operation is split into issue time
    (sample latency, account the request) and completion time (apply the
    state change), so many PUTs/GETs overlap on the virtual clock.

Fault injection surfaces as ``StoreError`` subclasses raised at issue
time. Each error carries ``detect_after_s`` — the virtual time until the
*client* observes the failure (throttle responses come back quickly;
timeouts burn the full timeout budget) — so retry scheduling stays on
the deterministic event loop.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, Tuple, runtime_checkable

import numpy as np

from repro_torch.core.blob import ByteRange

MiB = 1024 ** 2


@dataclasses.dataclass
class StoreCosts:
    """Per-tier request + storage prices (defaults: S3 Standard,
    us-east-1 list prices, paper §5.1.4). See ``repro_torch.core.costs.TierPrices``
    for the named tiers that produce these."""
    put_per_req: float = 0.005 / 1000
    get_per_req: float = 0.0004 / 1000
    storage_per_gb_month: float = 0.023
    hours_per_month: float = 730.0
    cross_az_per_gb: float = 0.0      # zonal tiers: cross-AZ GET routing

    def storage_cost_per_gb_hour(self) -> float:
        return self.storage_per_gb_month / self.hours_per_month


@dataclasses.dataclass
class LatencyModel:
    """T = lognormal(median = t0 + size/bw, sigma). Long-tail per Fig. 5."""
    put_t0_s: float = 0.200
    put_bw: float = 40 * MiB      # bytes/s transfer component of PUT
    get_t0_s: float = 0.030
    get_bw: float = 350 * MiB
    sigma: float = 0.42           # p95 ≈ 2.0× median, p99 ≈ 2.7× median

    def put_median(self, size: int) -> float:
        return self.put_t0_s + size / self.put_bw

    def get_median(self, size: int) -> float:
        return self.get_t0_s + size / self.get_bw

    def sample_put(self, size: int, rng: np.random.Generator) -> float:
        return float(self.put_median(size) *
                     np.exp(self.sigma * rng.standard_normal()))

    def sample_get(self, size: int, rng: np.random.Generator) -> float:
        return float(self.get_median(size) *
                     np.exp(self.sigma * rng.standard_normal()))


@dataclasses.dataclass
class StoreStats:
    puts: int = 0
    gets: int = 0
    put_bytes: int = 0
    get_bytes: int = 0
    byte_seconds: float = 0.0     # integral of stored bytes over time
    cross_az_gets: int = 0        # reads routed out of the object's home AZ
    cross_az_get_bytes: int = 0   # bytes billed at cross_az_per_gb

    def cost_usd(self, costs: StoreCosts, retention_s: float = 0.0,
                 explicit_storage: bool = False) -> float:
        """Requests + cross-AZ routing + storage (byte·s integral, or
        puts×retention)."""
        c = self.puts * costs.put_per_req + self.gets * costs.get_per_req
        c += self.cross_az_get_bytes / 1e9 * costs.cross_az_per_gb
        if explicit_storage:
            gb_h = self.byte_seconds / 1e9 / 3600.0
        else:
            gb_h = self.put_bytes * retention_s / 1e9 / 3600.0
        return c + gb_h * costs.storage_per_gb_month / costs.hours_per_month


# -- fault taxonomy --------------------------------------------------------

class StoreError(Exception):
    """A failed store request, observed ``detect_after_s`` after issue.

    Raised at issue time (``put``/``get``/``begin_put``/``begin_get``)
    so the virtual-clock caller can schedule the failure observation and
    its retry deterministically. Failed requests are not billed and do
    not appear in ``StoreStats`` (AWS does not charge 5xx responses);
    injectors keep their own fault counters.
    """

    def __init__(self, msg: str, detect_after_s: float = 0.05,
                 retry_after_s: float = 0.0):
        super().__init__(msg)
        self.detect_after_s = detect_after_s
        self.retry_after_s = retry_after_s   # server backoff hint (503)


class SlowDownError(StoreError):
    """503 SlowDown: the per-prefix request-rate budget is exhausted."""


class TransientStoreError(StoreError):
    """500 / connection reset: safe to retry immediately-ish."""


class StoreTimeoutError(StoreError):
    """Client-side timeout: the tail exceeded the request deadline."""


# -- the protocol ----------------------------------------------------------

@runtime_checkable
class BlobStore(Protocol):
    """Structural interface every storage backend (and decorator) provides.

    ``az`` parameters identify the caller's availability zone; backends
    without AZ topology (S3 Standard's regional namespace) ignore them,
    zonal backends (Express One Zone) use them to price and delay
    cross-AZ access.
    """

    stats: StoreStats
    costs: StoreCosts
    retention_s: float

    # -- synchronous API (functional path) ---------------------------------
    def put(self, blob_id: str, data: bytes, now: float = 0.0,
            az: Optional[int] = None) -> float:
        """Store object; returns sampled completion latency (seconds)."""
        ...

    def get(self, blob_id: str, byte_range: Optional[ByteRange] = None,
            now: float = 0.0, az: Optional[int] = None
            ) -> Tuple[bytes, float]:
        """Fetch object (or ranged sub-object); returns (data, latency)."""
        ...

    # -- event-driven API (async engine path) ------------------------------
    def begin_put(self, blob_id: str, size: int, now: float = 0.0,
                  az: Optional[int] = None) -> float:
        """Start an async PUT; returns sampled latency. The object becomes
        durable only at ``finish_put`` — readers racing the upload must
        not observe it earlier."""
        ...

    def finish_put(self, blob_id: str, data: bytes, now: float,
                   az: Optional[int] = None) -> None:
        """Apply a completed PUT: object is durable as of ``now``."""
        ...

    def begin_get(self, blob_id: str, now: float = 0.0,
                  az: Optional[int] = None) -> Tuple[int, float]:
        """Start an async GET; returns (object size, sampled latency).
        Request accounting happens at issue time, like the real bill."""
        ...

    def payload(self, blob_id: str) -> bytes:
        """Raw object bytes (read at GET completion; never re-billed)."""
        ...

    # -- lifecycle ----------------------------------------------------------
    def run_retention(self, now: float) -> int:
        """Delete objects older than the retention period (paper §3.2)."""
        ...

    def accrue_storage(self, now: float) -> None:
        """Fold storage of still-live objects into ``stats.byte_seconds``
        up to ``now`` (idempotent: each byte·second is counted once)."""
        ...

    def contains(self, blob_id: str) -> bool:
        ...
