"""Multi-layer caching: LRU + single-flight + distributed (per-AZ) + local.

Implements the paper §3.3 invariants:
  * distributed cache is organized per AZ; all instances in an AZ form a
    cache cluster; each member owns a subset of blobs (consistent routing);
  * concurrent reads for the same blob are coalesced (single-flight) so a
    blob is downloaded from object storage **at most once per AZ** while
    the entry is live;
  * optional per-instance local LRU removes repeated remote lookups.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.stores import BlobStore, StoreError
from repro_torch.utils import stable_hash64


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    coalesced: int = 0       # requests served by an in-flight download
    evictions: int = 0
    insertions: int = 0
    store_gets: int = 0      # store GETs this cluster led (misses it filled)
    reroutes: int = 0        # entries moved owner-to-owner on resize

    @property
    def requests(self) -> int:
        return self.hits + self.misses + self.coalesced


class LRUCache:
    """Byte-capacity LRU of blob payloads."""

    def __init__(self, capacity_bytes: int):
        self.capacity = capacity_bytes
        self.entries: "OrderedDict[str, bytes]" = OrderedDict()
        self.size = 0
        self.stats = CacheStats()

    def get(self, key: str) -> Optional[bytes]:
        if key in self.entries:
            self.entries.move_to_end(key)
            self.stats.hits += 1
            return self.entries[key]
        self.stats.misses += 1
        return None

    def put(self, key: str, value: bytes) -> None:
        if key in self.entries:
            self.size -= len(self.entries.pop(key))
        if len(value) > self.capacity:
            return  # larger than the whole cache: skip
        while self.size + len(value) > self.capacity and self.entries:
            _, old = self.entries.popitem(last=False)
            self.size -= len(old)
            self.stats.evictions += 1
        self.entries[key] = value
        self.size += len(value)
        self.stats.insertions += 1

    def __contains__(self, key: str) -> bool:
        return key in self.entries


class SingleFlight:
    """Coalesce concurrent fetches of the same key (paper: "subsequent
    requests are blocked until the initial download completes")."""

    def __init__(self):
        self.inflight: Dict[str, List[Callable]] = {}

    def begin(self, key: str) -> bool:
        """True if caller is the leader (must fetch); False → coalesced."""
        if key in self.inflight:
            return False
        self.inflight[key] = []
        return True

    def wait(self, key: str, callback: Callable) -> None:
        self.inflight[key].append(callback)

    def complete(self, key: str, value: bytes) -> List[Callable]:
        waiters = self.inflight.pop(key, [])
        return waiters


class DistributedCache:
    """Per-AZ cache cluster: members own key-ranges; reads route through
    the owner, which fetches from object storage at most once per entry."""

    #: optional repro_torch.obs.Observability side-table, attached by the
    #: engine when observability is enabled
    obs = None

    def __init__(self, az: int, members: int, capacity_per_member: int,
                 store: BlobStore, cache_on_write: bool = True):
        self.az = az
        self.members = [LRUCache(capacity_per_member)
                        for _ in range(members)]
        self.flight = SingleFlight()
        self.store = store
        self.cache_on_write = cache_on_write
        self.stats = CacheStats()

    @property
    def store_gets(self) -> int:
        """Store GETs led by this cluster (all counting routes through
        ``stats.store_gets`` — never bumped ad hoc by callers)."""
        return self.stats.store_gets

    def owner_of(self, blob_id: str) -> int:
        """Rendezvous (highest-random-weight) routing: the owner is the
        member with the highest hash(blob, member). Unlike mod-N, growing
        or shrinking the member set re-routes only the minimal share of
        keys — the property ``resize`` relies on during rebalances."""
        n = len(self.members)
        if n == 1:
            return 0
        key = blob_id.encode()
        best, owner = -1, 0
        for m in range(n):
            w = stable_hash64(key + bytes((m & 0xFF, (m >> 8) & 0xFF)))
            if w > best:
                best, owner = w, m
        return owner

    def resize(self, n_members: int) -> int:
        """Change the member count WITHOUT flushing: every cached payload
        is re-routed to its new rendezvous owner (entries on surviving
        members that keep their owner do not move at all). Called by the
        cluster layer when a rebalance changes the per-AZ worker set; the
        moved count lands in ``stats.reroutes``."""
        n = max(1, int(n_members))
        old = len(self.members)
        if n == old:
            return 0
        cap = self.members[0].capacity
        if n > old:
            self.members.extend(LRUCache(cap) for _ in range(n - old))
            removed: List[LRUCache] = []
        else:
            removed = self.members[n:]
            del self.members[n:]
        moved = 0
        for idx, m in enumerate(self.members):
            stale = [(k, own) for k in m.entries
                     if (own := self.owner_of(k)) != idx]
            for key, own in stale:
                payload = m.entries.pop(key)
                m.size -= len(payload)
                self.members[own].put(key, payload)
                moved += 1
        for m in removed:
            for key, payload in m.entries.items():
                self.members[self.owner_of(key)].put(key, payload)
                moved += 1
        self.stats.reroutes += moved
        return moved

    def write(self, blob_id: str, payload: bytes, now: float = 0.0) -> float:
        """Write path: member uploads to the store; optionally caches."""
        lat = self.store.put(blob_id, payload, now, az=self.az)
        if self.cache_on_write:
            self.members[self.owner_of(blob_id)].put(blob_id, payload)
        return lat

    # -- event-driven API (async engine path) ------------------------------
    def probe(self, blob_id: str) -> Optional[bytes]:
        """Non-blocking owner lookup used by the engine's GET path: returns
        the payload on a hit (counting it), None on a miss. The engine then
        decides between coalescing onto an in-flight download and leading a
        store GET, and inserts via ``fill`` at the completion event — so
        cache fills genuinely race concurrent reads on the virtual clock."""
        hit = self.members[self.owner_of(blob_id)].get(blob_id)
        if hit is not None:
            self.stats.hits += 1
        return hit

    def note_miss(self, coalesced: bool = False) -> None:
        """Account a probe miss (coalesced = served by in-flight leader)."""
        if coalesced:
            self.stats.coalesced += 1
        else:
            self.stats.misses += 1

    def fill(self, blob_id: str, payload: bytes) -> None:
        """Insert into the owning member (write-through or GET completion)."""
        self.members[self.owner_of(blob_id)].put(blob_id, payload)

    def begin_store_get(self, blob_id: str, now: float = 0.0
                        ) -> Tuple[int, float]:
        """Lead one store GET on behalf of this cluster (async engine
        path): the single choke point for request accounting, so
        ``store.stats.gets`` and ``stats.store_gets`` stay consistent.
        Raises ``StoreError`` without counting if the request fails."""
        size, lat = self.store.begin_get(blob_id, now=now, az=self.az)
        self.stats.store_gets += 1
        if self.obs is not None:
            self.obs.on_store_get(self.az, size, lat, now)
        return size, lat

    def read(self, blob_id: str, now: float = 0.0) -> Tuple[bytes, float, str]:
        """Read path. Returns (payload, latency, source) where source is
        one of "cache" | "store" | "coalesced" (latency excludes queueing
        behind an in-flight download — the simulator handles that)."""
        member = self.members[self.owner_of(blob_id)]
        hit = member.get(blob_id)
        if hit is not None:
            self.stats.hits += 1
            return hit, 0.0005, "cache"  # intra-AZ RPC
        if not self.flight.begin(blob_id):
            # single-flight invariant: a coalesced request rides the
            # leader's download — served from the store's payload view,
            # never issuing (or accounting) a second store GET
            self.stats.coalesced += 1
            payload = self.store.payload(blob_id)
            return payload, 0.0005, "coalesced"
        self.stats.misses += 1
        try:
            payload, lat = self.store.get(blob_id, now=now, az=self.az)
        except (StoreError, KeyError):
            # leader failed before filling (fault injection, or the
            # object expired): release leadership so the retry — or the
            # next reader — can lead a fresh download, and so a later
            # success fills the member exactly once
            self.flight.complete(blob_id, b"")
            raise
        self.stats.store_gets += 1
        member.put(blob_id, payload)
        self.flight.complete(blob_id, payload)
        return payload, lat, "store"


class LocalCache:
    """Optional per-instance layer in front of the distributed cache."""

    def __init__(self, capacity_bytes: int, remote: DistributedCache):
        self.lru = LRUCache(capacity_bytes)
        self.remote = remote

    def probe(self, blob_id: str) -> Optional[bytes]:
        return self.lru.get(blob_id)

    def fill(self, blob_id: str, payload: bytes) -> None:
        self.lru.put(blob_id, payload)

    def read(self, blob_id: str, now: float = 0.0) -> Tuple[bytes, float, str]:
        hit = self.lru.get(blob_id)
        if hit is not None:
            return hit, 0.00005, "local"
        payload, lat, src = self.remote.read(blob_id, now)
        self.lru.put(blob_id, payload)
        return payload, lat, src
