"""Pluggable shuffle strategies (Exoshuffle-style policies, ROADMAP 3).

Exoshuffle's thesis is that the classic shuffle variants — map-side
pre-aggregation, push-based placement, multi-round merge — are
*library-level policies* over one exchange substrate, not engine
rewrites. This module is that seam for BlobShuffle: a small hook
protocol the ``AsyncShuffleEngine`` consults at four points of the
blob lifecycle, with the current behavior re-homed as
``DefaultStrategy`` (every hook is the identity — a default-strategy
run is bit-identical to the pre-seam engine, event for event).

Hook points (all invoked on the virtual clock, all deterministic):

  * ``prepare_batch`` — before a ``RecordBatch`` enters the batcher
    (and before arrival-latency bookkeeping). ``CombiningStrategy``
    pre-aggregates duplicate keys here with a declared deterministic
    combiner, shrinking shipped bytes under Zipf skew.
  * ``partition_target_az`` — destination-AZ routing for a partition's
    buffer/blob. ``PushStrategy`` threads the *cluster assignor's*
    current owner AZ through here so blobs land where their consumer
    actually runs.
  * ``put_az`` / ``fill_az`` — which AZ a finalized blob is PUT from /
    cache-filled into. Push-based placement writes into the
    destination AZ's zonal store + cache, so consumers read
    zonal-local from ``ExpressOneZoneStore`` with zero cross-AZ GETs
    (the cross-AZ *routing* bytes are surfaced in
    ``StrategyStats.push_cross_az_bytes`` and priced by the caller).
  * ``on_publish`` — notification interception.
    ``TwoRoundMergeStrategy`` parks small-blob notifications here and
    a background compactor coalesces them into one merged
    per-partition blob (Magnet/Riffle-style two-round merge), cutting
    notification and GET request counts by the merge fan-in.

Exactly-once is preserved by construction: strategies act strictly
upstream of the commit protocol (combining) or strictly downstream of
durable publication (merge — small blobs are already durable and
committed before their notifications are intercepted; the compactor
re-publishes exactly one merged notification per round or falls back
to delivering the originals if any merge step fails permanently).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.blob import (Blob, Notification, build_blob_from_buffers,
                             extract_batch)
from repro_torch.core.formats import detect_format
from repro_torch.core.recordbatch import RecordBatch
from repro_torch.core.stores import StoreError


@dataclasses.dataclass
class StrategyStats:
    """Per-run strategy-side counters (engine/store stats stay the
    source of truth for PUT/GET/byte accounting)."""
    # combining
    records_combined: int = 0        # input records merged away
    bytes_saved_logical: int = 0     # wire bytes removed pre-upload
    # push-based placement: blob bytes routed from the producer's AZ
    # into a different (destination) AZ at PUT time — the zonal store
    # only sees the placement AZ, so this cross-AZ routing volume is
    # surfaced here for the cost model
    push_cross_az_bytes: int = 0
    # two-round merge
    merge_rounds: int = 0
    merged_blobs: int = 0            # merged blobs published
    merged_blob_bytes: int = 0       # bytes the compactor PUT (conservation)
    merged_inputs: int = 0           # small blobs coalesced into them
    merge_cache_hits: int = 0        # compactor reads served zonally
    merge_store_gets: int = 0        # compactor reads that hit the store
    merge_fallback_notes: int = 0    # originals delivered after a failure
    merge_singles: int = 0           # lone notes passed through unmerged
    notes_intercepted: int = 0       # notifications parked by on_publish


class ShuffleStrategy:
    """Default (pass-through) strategy — the pre-seam engine behavior.

    Subclasses override individual hooks; every hook here is the exact
    identity the engine inlined before the seam existed, so running
    with ``DefaultStrategy`` is bit-identical to not having one.
    """

    name = "default"

    def __init__(self) -> None:
        self.engine = None
        self.stats = StrategyStats()

    def bind(self, engine) -> None:
        """Attach to the engine (called once from the engine ctor)."""
        self.engine = engine

    # -- ingest -----------------------------------------------------------
    def prepare_batch(self, batch: RecordBatch,
                      times: Optional[np.ndarray]
                      ) -> Tuple[RecordBatch, Optional[np.ndarray]]:
        """Transform a micro-batch before partitioning/buffering.
        Returns the (possibly smaller) batch and its aligned arrival
        times; must be deterministic."""
        return batch, times

    # -- placement --------------------------------------------------------
    def partition_target_az(self, partition: int) -> int:
        """Destination AZ used for buffering + blob target of
        ``partition`` (consulted through ``Batcher.partition_to_az``)."""
        return self.engine.partition_to_az(partition)

    def put_az(self, blob: Blob, inst_az: int) -> int:
        """AZ the store PUT is attributed to (zonal stores home the
        object there)."""
        return inst_az

    def fill_az(self, blob: Blob, inst_az: int) -> int:
        """AZ whose distributed cache receives the write-through fill."""
        return inst_az

    # -- notification path ------------------------------------------------
    def on_publish(self, note: Notification, inst: Optional[int]) -> bool:
        """Intercept a to-be-published notification. Return True to
        consume it (the strategy takes responsibility for eventual
        delivery or an explicit drop); False routes it normally."""
        return False

    # -- lifecycle ---------------------------------------------------------
    def on_assignment_changed(self) -> None:
        """Cluster partition assignment changed (rebalance completed)."""

    def work_pending(self) -> bool:
        """True while the strategy still has deferred work in flight
        (keeps the engine's retention sweep alive)."""
        return False


DefaultStrategy = ShuffleStrategy


# -- map-side combining ----------------------------------------------------

def _group_keys(batch: RecordBatch) -> Tuple[np.ndarray, int]:
    """(inverse, n_groups): per-row group id over distinct key bytes.

    Fixed-width keys dedup as a void view of the arena (one
    ``np.unique``); ragged keys fall back to a dict memo. Mirrors
    ``Batcher._partitions_by_unique_key`` so grouping is bit-stable
    with the partitioner's own dedup."""
    n = len(batch)
    if n == 0:
        return np.empty(0, np.int64), 0
    klen = np.diff(batch.key_offsets)
    if (klen == klen[0]).all() and klen[0] > 0:
        kw = int(klen[0])
        base = int(batch.key_offsets[0])
        arena = np.ascontiguousarray(batch.key_arena)
        rows = arena[base:base + n * kw].reshape(n, kw) \
            .view(np.dtype((np.void, kw)))[:, 0]
        _, inv = np.unique(rows, return_inverse=True)
        return inv.astype(np.int64, copy=False), int(inv.max()) + 1
    memo: Dict[bytes, int] = {}
    inv = np.empty(n, np.int64)
    for i in range(n):
        inv[i] = memo.setdefault(bytes(batch.key(i)), len(memo))
    return inv, len(memo)


def _last_occurrence(inv: np.ndarray, n_groups: int) -> np.ndarray:
    """Row index of each group's LAST occurrence, in ascending row
    order — the canonical representative set for stream semantics
    (latest record per key wins the timestamp)."""
    last = np.zeros(n_groups, np.int64)
    np.maximum.at(last, inv, np.arange(len(inv), dtype=np.int64))
    return np.sort(last)


class LastWinsCombiner:
    """Keep only the newest record per key (KTable upsert semantics —
    intermediate values for a key are superseded within the batch)."""

    name = "last-wins"

    def combine(self, batch: RecordBatch
                ) -> Tuple[Optional[RecordBatch], Optional[np.ndarray]]:
        """Returns (combined batch, kept-row indices) or (None, None)
        when no combining applies."""
        inv, g = _group_keys(batch)
        if g == len(batch):
            return None, None
        sel = _last_occurrence(inv, g)
        return batch.select(sel), sel


class SumU64Combiner:
    """Sum values as little-endian u64 word vectors per key (the
    wrap-around modular sum a windowed counter/aggregator would keep).
    Applies only to the headerless uniform-width shape whose value
    width is a multiple of 8; anything else passes through unchanged."""

    name = "sum-u64"

    def combine(self, batch: RecordBatch
                ) -> Tuple[Optional[RecordBatch], Optional[np.ndarray]]:
        n = len(batch)
        if n == 0 or batch.headers is not None:
            return None, None
        vlen = np.diff(batch.value_offsets)
        if not (vlen == vlen[0]).all():
            return None, None
        vw = int(vlen[0])
        if vw == 0 or vw % 8:
            return None, None
        if (int(batch.value_offsets[0]) != 0
                or int(batch.value_arena.size) != int(batch.value_offsets[-1])):
            return None, None
        inv, g = _group_keys(batch)
        if g == n:
            return None, None
        words = np.ascontiguousarray(batch.value_arena) \
            .reshape(n, vw).view("<u8")
        acc = np.zeros((g, vw // 8), np.uint64)
        np.add.at(acc, inv, words.astype(np.uint64, copy=False))
        sel = _last_occurrence(inv, g)
        out = batch.select(sel)
        va = np.ascontiguousarray(acc[inv[sel]].astype("<u8")) \
            .view(np.uint8).reshape(-1)
        return RecordBatch(out.key_offsets, out.key_arena,
                           out.value_offsets, va, out.timestamps,
                           None, None), sel


COMBINERS = {c.name: c for c in (LastWinsCombiner, SumU64Combiner)}


class CombiningStrategy(ShuffleStrategy):
    """Map-side combining: pre-aggregate duplicate keys inside each
    ingest micro-batch *before* partitioning, buffering, and latency
    bookkeeping. Under Zipf skew a handful of hot keys dominate the
    byte volume, so this directly shrinks shipped logical bytes (and
    every downstream PUT/GET/cache byte) at zero wire-format cost.

    Delivery differs from the default strategy only by the declared
    combiner — a deterministic, per-batch pure function — so runs stay
    bit-reproducible and auditable against a reference combine of the
    same input batches."""

    name = "combining"

    def __init__(self, combiner=None) -> None:
        super().__init__()
        if isinstance(combiner, str):
            combiner = COMBINERS[combiner]()
        self.combiner = combiner or LastWinsCombiner()

    def prepare_batch(self, batch, times):
        n = len(batch)
        if n <= 1:
            return batch, times
        out, sel = self.combiner.combine(batch)
        if out is None or len(out) == n:
            return batch, times
        st = self.stats
        st.records_combined += n - len(out)
        st.bytes_saved_logical += int(batch.serialized_sizes().sum()
                                      - out.serialized_sizes().sum())
        if times is not None:
            times = np.asarray(times, np.float64)[sel]
        return out, times


# -- push-based placement --------------------------------------------------

class PushStrategy(ShuffleStrategy):
    """Push-based shuffle: place every blob in its *destination* AZ.

    The default strategy PUTs from the producer's AZ (zonal stores
    home the object there; the write-through cache fill lands in the
    producer's cluster), so 2/3 of blobs are consumed cross-AZ — on
    ``ExpressOneZoneStore`` each such blob leads one cross-AZ store
    GET. Pushing instead homes the object *and* the cache fill in
    ``blob.target_az``: every consumer read is zonal (zero cross-AZ
    GETs); the producer pays the routing bytes once at PUT time,
    surfaced in ``stats.push_cross_az_bytes`` for the cost model.

    With an ``ElasticCluster`` attached, the destination AZ tracks the
    *assignor's current owner* of each partition (re-snapshotted after
    every completed rebalance via ``on_assignment_changed``), so blobs
    follow their consumer even when ownership moves cross-AZ."""

    name = "push"

    def put_az(self, blob, inst_az):
        return blob.target_az

    def fill_az(self, blob, inst_az):
        return blob.target_az

    def partition_target_az(self, partition):
        eng = self.engine
        cl = eng.cluster
        if cl is not None:
            st = cl.parts.get(partition)
            owner = st.owner if st is not None else None
            if owner is not None and cl.membership.is_alive_now(owner):
                return cl.membership.workers[owner].az
        return eng.partition_to_az(partition)


# -- two-round merge -------------------------------------------------------

class _MergeRound:
    __slots__ = ("partition", "az", "notes", "payloads", "remaining",
                 "failed")

    def __init__(self, partition: int, notes: List[Notification]):
        self.partition = partition
        self.az = notes[-1].target_az
        self.notes = notes
        self.payloads: List[Optional[bytes]] = [None] * len(notes)
        self.remaining = len(notes)
        self.failed = False


class TwoRoundMergeStrategy(PushStrategy):
    """Two-round merge (Magnet/Riffle-style push-merge) for huge
    fan-in: many small per-batcher blobs are coalesced into one
    per-partition merged blob by a background compactor running on the
    virtual clock in the destination AZ.

    Round one is push-based placement (inherited): small blobs are
    homed + cache-filled in their destination AZ, so the compactor's
    reads are zonal cache hits, not extra store traffic. Round two
    intercepts the smalls' notifications (``on_publish``), groups them
    per partition, and once ``fan_in`` notes accumulate — or
    ``max_wait_s`` elapses — reads the byte ranges, concatenates the
    record blocks (decoding + re-encoding only when blocks are
    framed), PUTs one merged blob, and publishes a single merged
    notification. Consumers therefore issue ~``1/fan_in`` of the
    default strategy's notifications and GETs.

    Exactly-once: interception happens strictly *after* the smalls are
    durable and their producer's commit has published them, so the
    commit protocol is untouched; the merged notification inherits the
    smalls' (blob, partition) dedup domain under a fresh blob id, and
    any permanent failure in the merge pipeline (fetch or PUT past
    ``max_attempts``, expired blob) falls back to delivering the
    original notifications unchanged — never silently dropping them.
    End-to-end latency accounting survives the rewrite: the smalls'
    arrival FIFOs are re-homed under the merged blob id the moment it
    becomes durable."""

    name = "merge"

    def __init__(self, fan_in: int = 8, max_wait_s: float = 0.25) -> None:
        super().__init__()
        self.fan_in = fan_in
        self.max_wait_s = max_wait_s
        self._pending: Dict[int, List[Notification]] = {}
        self._armed: Set[int] = set()
        self._active = 0
        self._seq = 0

    # -- interception ------------------------------------------------------
    def on_publish(self, note, inst):
        self.stats.notes_intercepted += 1
        buf = self._pending.setdefault(note.partition, [])
        buf.append(note)
        if len(buf) >= self.fan_in:
            self._start_round(note.partition)
        elif note.partition not in self._armed:
            self._armed.add(note.partition)
            self.engine.loop.after(self.max_wait_s, self._wait_fire,
                                   note.partition)
        return True

    def _wait_fire(self, partition: int) -> None:
        self._armed.discard(partition)
        if self._pending.get(partition):
            self._start_round(partition)

    def work_pending(self):
        return bool(self._pending) or self._active > 0

    # -- round one: gather the smalls (zonal reads) ------------------------
    def _start_round(self, partition: int) -> None:
        notes = self._pending.pop(partition)
        self.stats.merge_rounds += 1
        if len(notes) == 1:
            self.stats.merge_singles += 1
            self._deliver(notes)      # nothing to merge
            return
        r = _MergeRound(partition, notes)
        self._active += 1
        for idx in range(len(notes)):
            self._fetch_small(r, idx, 0)

    def _fetch_small(self, r: _MergeRound, idx: int, attempt: int,
                     grace: bool = True) -> None:
        if r.failed:
            return
        eng = self.engine
        note = r.notes[idx]
        cache = eng.caches[note.target_az]
        hit = cache.probe(note.blob_id)
        if hit is not None:
            self.stats.merge_cache_hits += 1
            eng.loop.after(eng.ecfg.rpc_latency_s,
                           self._small_ready, r, idx, hit)
            return
        if grace:
            # a commit-time publish can land at the same instant the
            # small became durable — one fill latency BEFORE its
            # write-through fill reaches the zonal cache. Re-probe once
            # after that window instead of leading a redundant store GET.
            eng.loop.after(eng.ecfg.cache_fill_latency_s
                           + eng.ecfg.rpc_latency_s,
                           self._fetch_small, r, idx, attempt, False)
            return
        cache.note_miss(coalesced=False)
        try:
            _, lat = cache.begin_store_get(note.blob_id, now=eng.loop.now)
        except StoreError as e:
            if attempt + 1 >= eng.ecfg.max_attempts:
                self._fail_round(r)
                return
            eng.metrics.get_retries += 1
            delay = eng._backoff(attempt + 1, e)
            eng.loop.after(e.detect_after_s + delay,
                           self._fetch_small, r, idx, attempt + 1)
            return
        except KeyError:
            self._fail_round(r)       # expired: merging cannot help
            return
        self.stats.merge_store_gets += 1
        eng._note_get_latency(lat)
        eng.loop.after(lat, self._small_got, r, idx)

    def _small_got(self, r: _MergeRound, idx: int) -> None:
        if r.failed:
            return
        eng = self.engine
        note = r.notes[idx]
        try:
            payload = eng.store.payload(note.blob_id)
        except KeyError:
            self._fail_round(r)
            return
        eng.caches[note.target_az].fill(note.blob_id, payload)
        self._small_ready(r, idx, payload)

    def _small_ready(self, r: _MergeRound, idx: int, payload) -> None:
        if r.failed:
            return
        r.payloads[idx] = payload
        r.remaining -= 1
        if r.remaining == 0:
            self._build_merged(r)

    # -- round two: merged blob --------------------------------------------
    def _build_merged(self, r: _MergeRound) -> None:
        eng = self.engine
        fmt = eng.batchers[0].fmt if eng.batchers else None
        chunks = []
        for note, payload in zip(r.notes, r.payloads):
            rng = note.byte_range
            block = memoryview(payload)[rng.offset:rng.end]
            if fmt is None and detect_format(block).format_id == 1:
                chunks.append(block)  # raw-in, raw-out: byte identity
            else:
                chunks.append(extract_batch(payload, rng).serialize_rows())
        self._seq += 1
        bid = f"merge-p{r.partition}-{self._seq:06d}"
        blob, notes = build_blob_from_buffers(
            {r.partition: chunks}, target_az=r.az, blob_id=bid, fmt=fmt)
        if eng.obs is not None:
            # the merged blob's lifecycle restarts here: batch_wait for
            # its records absorbs the smalls' whole first-round journey
            eng.obs.on_blob_handed_off(blob, r.az, None, eng.loop.now)
        self._put_merged(r, blob, notes[0], 0)

    def _put_merged(self, r: _MergeRound, blob: Blob,
                    mnote: Notification, attempt: int) -> None:
        eng = self.engine
        try:
            lat = eng.store.begin_put(blob.blob_id, blob.size,
                                      now=eng.loop.now, az=r.az)
        except StoreError as e:
            if attempt + 1 >= eng.ecfg.max_attempts:
                self._fail_round(r)
                return
            eng.metrics.put_retries += 1
            delay = eng._backoff(attempt + 1, e)
            eng.loop.after(e.detect_after_s + delay,
                           self._put_merged, r, blob, mnote, attempt + 1)
            return
        eng.loop.after(lat, self._merged_durable, r, blob, mnote, lat)

    def _merged_durable(self, r: _MergeRound, blob: Blob,
                        mnote: Notification, lat: float) -> None:
        eng = self.engine
        eng.store.finish_put(blob.blob_id, blob.payload, eng.loop.now,
                             az=r.az)
        eng.metrics.put_latencies.append(lat)
        self.stats.merged_blob_bytes += blob.size
        if eng.obs is not None:
            eng.obs.on_blob_durable(blob.blob_id, blob.size, r.az, lat,
                                    eng.loop.now)
        if eng.cfg.cache_on_write:
            eng.loop.after(eng.ecfg.cache_fill_latency_s,
                           eng.caches[r.az].fill, blob.blob_id,
                           blob.payload)
        # re-home the smalls' arrival FIFOs under the merged blob id so
        # end-to-end latency accounting (and duplicate detection) keeps
        # working across the rewrite
        arrivals: List[float] = []
        for note in r.notes:
            arrivals.extend(eng._blob_arrivals.pop(
                (note.blob_id, note.partition), []))
        eng._blob_arrivals[(blob.blob_id, r.partition)] = arrivals
        self.stats.merged_blobs += 1
        self.stats.merged_inputs += len(r.notes)
        self._active -= 1
        self._deliver([mnote], src_az=r.az)

    # -- delivery ----------------------------------------------------------
    def _fail_round(self, r: _MergeRound) -> None:
        if r.failed:
            return
        r.failed = True
        self._active -= 1
        self.stats.merge_fallback_notes += len(r.notes)
        self._deliver(r.notes)

    def _deliver(self, notes: List[Notification],
                 src_az: Optional[int] = None) -> None:
        """Publish notifications downstream, bypassing ``on_publish``
        (these are the strategy's own outputs, not new smalls)."""
        eng = self.engine
        for note in notes:
            eng.published.append(note)
            if eng.obs is not None:
                eng.obs.on_note_published(note, eng.loop.now)
            if eng.cluster is not None:
                eng.cluster.publish(note, src_az)
            else:
                eng.loop.after(eng.ecfg.notification_latency_s,
                               eng._notify, note)


# -- registry --------------------------------------------------------------

STRATEGIES = {
    "default": DefaultStrategy,
    "combining": CombiningStrategy,
    "push": PushStrategy,
    "merge": TwoRoundMergeStrategy,
}


def make_strategy(spec=None, **kwargs) -> ShuffleStrategy:
    """Resolve ``spec`` (None | name | instance) into a strategy."""
    if spec is None:
        return DefaultStrategy()
    if isinstance(spec, ShuffleStrategy):
        return spec
    try:
        cls = STRATEGIES[spec]
    except KeyError:
        raise ValueError(
            f"unknown shuffle strategy {spec!r}; "
            f"registered: {sorted(STRATEGIES)}") from None
    return cls(**kwargs)
