"""Simulated S3 Standard: calibrated lognormal latency + cost accounting.

The latency model is calibrated to the paper's Fig. 5 (16 MiB objects,
us-east-1): long-tailed lognormal with size-dependent medians, PUT ≈ 7–9×
slower than GET, p95 ≈ 2.2× median. The cost model uses AWS list prices.
The store is append-only and garbage-tolerant: orphaned blobs are removed
by retention, never by readers (paper §3.1/§3.2).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.blob import ByteRange
from repro_torch.core.stores.base import LatencyModel, StoreCosts, StoreStats


@dataclasses.dataclass
class StoredObject:
    data: bytes
    put_at: float        # durability time (drives retention age)
    accrued_to: float    # storage already folded into byte_seconds up to here
    home_az: Optional[int] = None


class SimulatedS3:
    """In-memory object store with simulated latency + cost accounting.

    Implements ``BlobStore``: used both by the functional (unit-test)
    path — where operations are synchronous and latency is just
    *reported* — and by the discrete-event engine, which schedules
    completions at ``now + sampled latency``. S3 Standard has a regional
    namespace, so the ``az`` hints are accepted and ignored.
    """

    def __init__(self, latency: Optional[LatencyModel] = None,
                 costs: Optional[StoreCosts] = None, seed: int = 0,
                 retention_s: float = 3600.0):
        if costs is None:
            # single source of truth for tier prices: repro_torch.core.costs
            from repro_torch.core.costs import STANDARD
            costs = STANDARD.store_costs()
        self.latency = latency or LatencyModel()
        self.costs = costs
        self.rng = np.random.default_rng(seed)
        self.retention_s = retention_s
        self.objects: Dict[str, StoredObject] = {}
        self.stats = StoreStats()

    # -- synchronous API (functional path) --------------------------------
    def put(self, blob_id: str, data: bytes, now: float = 0.0,
            az: Optional[int] = None) -> float:
        lat = self.begin_put(blob_id, len(data), now, az)
        self.finish_put(blob_id, data, now, az)
        return lat

    def get(self, blob_id: str, byte_range: Optional[ByteRange] = None,
            now: float = 0.0, az: Optional[int] = None
            ) -> Tuple[bytes, float]:
        if blob_id not in self.objects:
            raise KeyError(f"no such object {blob_id} (expired or orphan?)")
        data = self.objects[blob_id].data
        if byte_range is not None:
            data = data[byte_range.offset:byte_range.end]
        self.stats.gets += 1
        self.stats.get_bytes += len(data)
        return data, self._sample_get(len(data), az, blob_id)

    # -- event-driven API (async engine path) ------------------------------
    def begin_put(self, blob_id: str, size: int, now: float = 0.0,
                  az: Optional[int] = None) -> float:
        return self._sample_put(size, az)

    def finish_put(self, blob_id: str, data: bytes, now: float,
                   az: Optional[int] = None) -> None:
        self.objects[blob_id] = StoredObject(data, now, now, az)
        self.stats.puts += 1
        self.stats.put_bytes += len(data)

    def begin_get(self, blob_id: str, now: float = 0.0,
                  az: Optional[int] = None) -> Tuple[int, float]:
        if blob_id not in self.objects:
            raise KeyError(f"no such object {blob_id} (expired or orphan?)")
        size = len(self.objects[blob_id].data)
        self.stats.gets += 1
        self.stats.get_bytes += size
        return size, self._sample_get(size, az, blob_id)

    def payload(self, blob_id: str) -> bytes:
        return self.objects[blob_id].data

    # -- lifecycle ----------------------------------------------------------
    def _accrue_object(self, o: StoredObject, now: float) -> None:
        """Fold ``o``'s storage into ``byte_seconds`` up to ``now``,
        capped at the object's expiry: an object stops billing at
        ``put_at + retention_s`` no matter when a sweep or the end-of-run
        accrual actually observes it, so the byte·seconds integral is
        invariant to sweep cadence and cannot double-bill the window
        between expiry and deletion."""
        end = min(now, o.put_at + self.retention_s)
        if end > o.accrued_to:
            self.stats.byte_seconds += len(o.data) * (end - o.accrued_to)
            o.accrued_to = end

    def run_retention(self, now: float) -> int:
        dead = [k for k, o in self.objects.items()
                if now - o.put_at > self.retention_s]
        for k in dead:
            self._accrue_object(self.objects.pop(k), now)
        return len(dead)

    def accrue_storage(self, now: float) -> None:
        for o in self.objects.values():
            self._accrue_object(o, now)

    def contains(self, blob_id: str) -> bool:
        return blob_id in self.objects

    def keys(self) -> list:
        """Namespace listing (S3 LIST analogue) — snapshot of live keys."""
        return list(self.objects)

    def delete(self, blob_id: str, now: float = 0.0) -> bool:
        """Explicit DELETE (beyond retention expiry): bills storage up to
        ``now`` then drops the object. Returns False if absent."""
        o = self.objects.pop(blob_id, None)
        if o is None:
            return False
        self._accrue_object(o, now)
        return True

    # -- latency sampling hooks (overridden by zonal subclasses) ------------
    def _sample_put(self, size: int, az: Optional[int]) -> float:
        return self.latency.sample_put(size, self.rng)

    def _sample_get(self, size: int, az: Optional[int],
                    blob_id: str) -> float:
        return self.latency.sample_get(size, self.rng)
