"""Debatcher operator (paper §3.2, Fig. 3): notifications → ranged blob
fetch (through the cache layers) → record extraction, with exactly-once
dedup on (blob_id, partition) and commit blocking on in-flight reads."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Set, Tuple

from repro_torch.core.blob import Notification, extract, extract_batch
from repro_torch.core.cache import DistributedCache, LocalCache
from repro_torch.core.recordbatch import RecordBatch
from repro_torch.core.records import Record


@dataclasses.dataclass
class DebatcherStats:
    notifications: int = 0
    records_out: int = 0
    bytes_out: int = 0
    duplicates_dropped: int = 0
    reads_cache: int = 0
    reads_store: int = 0
    reads_coalesced: int = 0
    reads_local: int = 0


class Debatcher:
    """One Debatcher per stream thread in the destination AZ."""

    #: optional repro_torch.obs.Observability side-table, attached by the
    #: engine when observability is enabled
    obs = None

    def __init__(self, az: int, cache: DistributedCache,
                 local: Optional[LocalCache] = None,
                 exactly_once: bool = True):
        self.az = az
        self.cache = cache
        self.local = local
        self.exactly_once = exactly_once
        self.seen: Set[Tuple[str, int]] = set()
        self.inflight_until: float = 0.0
        self.stats = DebatcherStats()

    def begin(self, note: Notification) -> bool:
        """Admit one notification: False if it is a duplicate that must be
        dropped. Under exactly-once the (blob, partition) key is CLAIMED
        here — before the fetch is issued — so duplicate or reordered
        notifications arriving while the first fetch is still in flight
        cannot trigger a second delivery."""
        self.stats.notifications += 1
        key = (note.blob_id, note.partition)
        if self.exactly_once:
            if key in self.seen:
                self.stats.duplicates_dropped += 1
                return False
            self.seen.add(key)
        return True

    def complete(self, note: Notification, payload: bytes, lat: float,
                 src: str, now: float) -> List[Record]:
        """Deliver one admitted notification from its fetched payload."""
        setattr(self.stats, f"reads_{src}",
                getattr(self.stats, f"reads_{src}") + 1)
        recs = extract(payload, note.byte_range)
        self.stats.records_out += len(recs)
        self.stats.bytes_out += note.byte_range.length
        self.inflight_until = max(self.inflight_until, now + lat)
        if self.obs is not None:
            self.obs.on_extract(self.az, src, len(recs),
                                note.byte_range.length, now)
        return recs

    def complete_batch(self, note: Notification, payload, lat: float,
                       src: str, now: float) -> RecordBatch:
        """Columnar delivery: extract the partition's byte range straight
        into a ``RecordBatch`` (memoryview slice, vectorized arena gather
        — the payload is never re-copied into per-record objects)."""
        setattr(self.stats, f"reads_{src}",
                getattr(self.stats, f"reads_{src}") + 1)
        batch = extract_batch(payload, note.byte_range)
        self.stats.records_out += len(batch)
        self.stats.bytes_out += note.byte_range.length
        self.inflight_until = max(self.inflight_until, now + lat)
        if self.obs is not None:
            self.obs.on_extract(self.az, src, len(batch),
                                note.byte_range.length, now)
        return batch

    def process(self, note: Notification, now: float
                ) -> Tuple[List[Record], float, str]:
        """Resolve one notification synchronously (functional path).
        Returns (records, latency, source)."""
        if not self.begin(note):
            return [], 0.0, "duplicate"
        if self.local is not None:
            payload, lat, src = self.local.read(note.blob_id, now)
        else:
            payload, lat, src = self.cache.read(note.blob_id, now)
        return self.complete(note, payload, lat, src, now), lat, src

    def process_batch(self, note: Notification, now: float
                      ) -> Tuple[RecordBatch, float, str]:
        """Columnar counterpart of ``process``: returns a ``RecordBatch``
        instead of a list of ``Record`` objects."""
        if not self.begin(note):
            return RecordBatch.empty(), 0.0, "duplicate"
        if self.local is not None:
            payload, lat, src = self.local.read(note.blob_id, now)
        else:
            payload, lat, src = self.cache.read(note.blob_id, now)
        return self.complete_batch(note, payload, lat, src, now), lat, src

    def on_commit(self, now: float) -> float:
        """Block the commit until all outstanding reads completed."""
        return max(0.0, self.inflight_until - now)
