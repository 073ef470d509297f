"""Batcher operator (paper §3.1, Fig. 2).

Per destination partition, an in-memory buffer of serialized records;
buffers of partitions in the same destination AZ are grouped so the
accumulated size per AZ is tracked. A batch is finalized when
  (i)  the target batch size is reached,
  (ii) the max batching interval elapses, or
  (iii) a commit is initiated.
Finalized blobs upload asynchronously; an internal completion queue is
polled from the processing loop; per contributing partition a notification
is emitted. Commits block until all uploads completed + notifications sent.

Hot-path layout: buffers hold **serialized chunks** (bytes-like), not
``Record`` objects. The legacy ``process(record)`` path serializes each
record once on arrival; the columnar ``ingest(RecordBatch)`` path
partitions a whole batch with the vectorized FNV-1a partitioner, groups
rows per destination with one ``np.argsort``, and serializes each group
into a single chunk. ``_finalize`` then joins chunks exactly once into
the blob payload (``build_blob_from_buffers``) — the bytes are never
re-copied between buffering and upload.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.blob import Blob, Notification, build_blob_from_buffers
from repro_torch.core.cache import DistributedCache
from repro_torch.core.formats import get_format
from repro_torch.core.recordbatch import RecordBatch
from repro_torch.core.records import Record, serialize


@dataclasses.dataclass(frozen=True)
class BlobShuffleConfig:
    """Mirrors the constructor arguments in Listing 1."""
    batch_bytes: int = 16 * 1024 * 1024
    max_interval_s: float = 5.0
    num_partitions: int = 9
    num_az: int = 3
    cache_on_write: bool = True
    local_cache_bytes: int = 0           # 0 = disabled (paper default)
    distributed_cache_bytes: int = 4 * 1024 ** 3
    retention_s: float = 3600.0
    #: registered blob wire format used for finalized blocks ("raw-v1"
    #: writes the legacy byte-identical layout; "columnar-v2" compresses)
    wire_format: str = "raw-v1"


@dataclasses.dataclass
class PendingUpload:
    blob: Blob
    notifications: List[Notification]
    started_at: float
    completes_at: float


class _PartitionBuffer:
    """Serialized chunks + record count for one destination partition."""
    __slots__ = ("chunks", "count")

    def __init__(self):
        self.chunks: List = []
        self.count = 0

    def append(self, chunk, n: int) -> None:
        self.chunks.append(chunk)
        self.count += n


@dataclasses.dataclass
class BatcherStats:
    records_in: int = 0
    bytes_in: int = 0
    blobs: int = 0
    blob_bytes: int = 0
    notifications: int = 0
    finalize_size: int = 0
    finalize_interval: int = 0
    finalize_commit: int = 0


class Batcher:
    """One Batcher per stream thread (buffers shared across its tasks)."""

    #: optional repro_torch.obs.Observability side-table, attached by the
    #: engine when observability is enabled (never schedules events)
    obs = None

    def __init__(self, cfg: BlobShuffleConfig,
                 partition_to_az: Callable[[int], int],
                 partitioner: Callable[[bytes], int],
                 cache: DistributedCache,
                 uploader: Optional[Callable[
                     [Blob, List[Notification], Dict[int, int],
                      float], None]] = None,
                 name: Optional[str] = None,
                 partitioner_batch: Optional[Callable[
                     [RecordBatch], np.ndarray]] = None):
        self.cfg = cfg
        # Resolve the wire format once (raises UnknownFormatError on a
        # typo'd name at construction, not at first finalize). Raw v1 is
        # the identity encoding, so it skips the per-block hook entirely.
        fmt = get_format(cfg.wire_format)
        self.fmt = None if fmt.format_id == 1 else fmt
        self.partition_to_az = partition_to_az
        self.partitioner = partitioner
        # vectorized partitioner for RecordBatch ingest; when absent the
        # scalar partitioner is applied row-by-row (correct but slow)
        self.partitioner_batch = partitioner_batch
        self.cache = cache
        # When named, blob ids are "<name>-<seq>" instead of random uuids:
        # deterministic across runs (bit-reproducible virtual-clock runs,
        # stable per-prefix throttle buckets in FaultyStore) and prefixed
        # per producer, mirroring S3 key-prefix layout.
        self.name = name
        self._blob_seq = 0
        # Event-driven hook: when set, finalized blobs are handed to
        # ``uploader(blob, notes, per_partition_counts, now)`` instead of
        # being written synchronously — the async engine queues them on a
        # bounded per-instance upload lane and completes them on the
        # virtual clock. ``pending``/``ready`` stay empty in that mode.
        self.uploader = uploader
        # az -> partition -> serialized chunks; az -> bytes
        self.buffers: Dict[int, Dict[int, _PartitionBuffer]] = {}
        self.buffer_bytes: Dict[int, int] = {}
        self.last_finalize: Dict[int, float] = {}
        # min-heap of (completes_at, seq, PendingUpload): poll/on_commit
        # pop in completion order instead of O(n)-scanning per record
        self.pending: List[Tuple[float, int, PendingUpload]] = []
        self._pending_seq = 0
        self.ready: List[Notification] = []
        self.stats = BatcherStats()
        self._az_table: Optional[np.ndarray] = None

    # -- main processing loop ---------------------------------------------
    def process(self, rec: Record, now: float) -> List[Notification]:
        """Route one record into its per-partition buffer; poll completions."""
        part = self.partitioner(rec.key)
        az = self.partition_to_az(part)
        chunk = serialize(rec)
        self._append(az, part, chunk, 1, len(chunk), now)
        self._check_triggers(az, now)
        return self.poll(now)

    def ingest(self, batch: RecordBatch, now: float) -> List[Notification]:
        """Columnar bulk ingest: partition, group, and serialize a whole
        ``RecordBatch`` with vectorized ops — one stable argsort by
        (AZ, partition), then one serialized wire buffer **per touched
        AZ** whose per-partition chunks are zero-copy memoryview slices.
        Serializing per AZ (not per batch) means a buffered slice pins
        only its own AZ's wire bytes, which are released exactly when
        that AZ finalizes. Finalize triggers run after every partition
        group, so a blob overshoots ``batch_bytes`` by at most one
        group — mirroring the legacy path's at-most-one-record overshoot
        at batch granularity.

        All segment math is one vectorized pass: per-group partition/AZ
        from the group's first sorted row, a single global cumsum over
        ``sizes[order]`` for every group's byte offset, and AZ run
        boundaries from one ``diff``/``flatnonzero`` — the remaining
        Python loop does nothing but slice views and call ``_append``."""
        n = len(batch)
        if n == 0:
            return self.poll(now)
        parts = self.compute_partitions(batch)
        order, starts = self._group(batch)
        sizes = batch.serialized_sizes()
        az_table = self._partition_az_table()
        g_part = parts[order[starts[:-1]]]       # per-group partition id
        g_az = az_table[g_part]                  # per-group destination AZ
        boff = np.zeros(n + 1, np.int64)
        np.cumsum(sizes[order], out=boff[1:])
        goff = boff[starts]                      # per-group byte offsets
        run_bounds = np.concatenate(             # AZ runs within the groups
            ([0], np.flatnonzero(np.diff(g_az)) + 1, [len(g_az)]))
        for k in range(len(run_bounds) - 1):
            i, j = int(run_bounds[k]), int(run_bounds[k + 1])
            az = int(g_az[i])
            wire = memoryview(
                batch.serialize_rows(order[starts[i]:starts[j]]))
            base = int(goff[i])
            for g in range(i, j):
                s = int(goff[g]) - base
                e = int(goff[g + 1]) - base
                self._append(az, int(g_part[g]), wire[s:e],
                             int(starts[g + 1] - starts[g]), e - s, now)
                self._check_triggers(az, now)
        return self.poll(now)

    def _group(self, batch: RecordBatch) -> Tuple[np.ndarray, np.ndarray]:
        """Destination grouping, cached on the batch: ``order`` is the
        stable row permutation sorted by (AZ, partition); ``starts`` the
        (AZ, partition)-group boundaries within it (len = groups + 1).
        Shared by the engine's arrival bookkeeping so the argsort runs
        once per batch."""
        if batch.groups is None:
            parts = self.compute_partitions(batch)
            az_table = self._partition_az_table()
            composite = az_table[parts] * self.cfg.num_partitions + parts
            order = np.argsort(composite, kind="stable")
            sc = composite[order]
            bounds = np.flatnonzero(sc[1:] != sc[:-1]) + 1
            batch.groups = (order, np.concatenate(([0], bounds,
                                                   [len(parts)])))
        return batch.groups

    def compute_partitions(self, batch: RecordBatch) -> np.ndarray:
        """(N,) int32 destination partitions, cached on the batch."""
        if batch.partitions is None:
            if self.partitioner_batch is not None:
                batch.partitions = np.asarray(
                    self.partitioner_batch(batch), np.int32)
            else:
                batch.partitions = self._partitions_by_unique_key(batch)
        return batch.partitions

    def _partitions_by_unique_key(self, batch: RecordBatch) -> np.ndarray:
        """Scalar-partitioner fallback, one call per **unique** key.

        A partitioner is a pure function of the key bytes, so calling it
        per distinct key and broadcasting through ``np.unique``'s inverse
        is bit-equal to the old per-row ``np.fromiter`` sweep — and on
        the Zipf-shaped workloads this repo models (a few hot keys
        dominate) it collapses N Python calls to the distinct-key count.
        Fixed-width keys dedup as a void view of the arena; ragged keys
        fall back to a dict memo (still one partitioner call per unique
        key, just a Python-level dedup)."""
        n = len(batch)
        klen = np.diff(batch.key_offsets)
        if n and (klen == klen[0]).all() and klen[0] > 0:
            kw = int(klen[0])
            base = int(batch.key_offsets[0])
            arena = np.ascontiguousarray(batch.key_arena)
            rows = arena[base:base + n * kw].reshape(n, kw) \
                .view(np.dtype((np.void, kw)))[:, 0]
            uniq, inverse = np.unique(rows, return_inverse=True)
            uparts = np.fromiter(
                (self.partitioner(u.tobytes()) for u in uniq),
                np.int32, len(uniq))
            return uparts[inverse]
        memo: Dict[bytes, int] = {}
        out = np.empty(n, np.int32)
        for i in range(n):
            k = bytes(batch.key(i))
            p = memo.get(k)
            if p is None:
                p = memo[k] = self.partitioner(k)
            out[i] = p
        return out

    def _partition_az_table(self) -> np.ndarray:
        if self._az_table is None:
            self._az_table = np.fromiter(
                (self.partition_to_az(p)
                 for p in range(self.cfg.num_partitions)),
                np.int64, self.cfg.num_partitions)
        return self._az_table

    def _append(self, az: int, part: int, chunk, n: int, nbytes: int,
                now: float) -> None:
        buf = self.buffers.setdefault(az, {})
        pb = buf.get(part)
        if pb is None:
            pb = buf[part] = _PartitionBuffer()
        pb.append(chunk, n)
        self.buffer_bytes[az] = self.buffer_bytes.get(az, 0) + nbytes
        self.stats.records_in += n
        self.stats.bytes_in += nbytes
        self.last_finalize.setdefault(az, now)

    def _check_triggers(self, az: int, now: float) -> None:
        if self.buffer_bytes[az] >= self.cfg.batch_bytes:
            self._finalize(az, now, "size")
        elif now - self.last_finalize[az] >= self.cfg.max_interval_s:
            self._finalize(az, now, "interval")

    def poll(self, now: float) -> List[Notification]:
        """Drain the upload-completion queue (processed from the main
        thread, like the paper's internal result queue). The heap pops
        only completed entries — O(done · log n), not an O(n) scan."""
        out = list(self.ready)
        self.ready.clear()
        while self.pending and self.pending[0][0] <= now:
            _, _, p = heapq.heappop(self.pending)
            out.extend(p.notifications)
            self.stats.notifications += len(p.notifications)
        return out

    def flush_due(self, now: float) -> None:
        """Finalize every buffer whose max batching interval has elapsed
        (called from the engine's per-buffer timer events — the sync path
        piggybacks the same check on record arrival)."""
        for az in list(self.buffers):
            if (self.buffer_bytes.get(az, 0) > 0 and
                    now - self.last_finalize.get(az, now)
                    >= self.cfg.max_interval_s):
                self._finalize(az, now, "interval")

    def flush_all(self, now: float) -> None:
        """Commit-path finalize of every non-empty buffer."""
        for az in list(self.buffers):
            if self.buffer_bytes.get(az, 0) > 0:
                self._finalize(az, now, "commit")

    def buffered_bytes(self) -> int:
        return sum(self.buffer_bytes.values())

    # -- commit protocol ----------------------------------------------------
    def on_commit(self, now: float) -> Tuple[List[Notification], float]:
        """Finalize all buffers and BLOCK until outstanding uploads are
        durable; returns (notifications, commit-block seconds)."""
        self.flush_all(now)
        block_until = now
        notes: List[Notification] = []
        while self.pending:
            completes_at, _, p = heapq.heappop(self.pending)
            block_until = max(block_until, completes_at)
            notes.extend(p.notifications)
            self.stats.notifications += len(p.notifications)
        notes.extend(self.ready)
        self.ready.clear()
        return notes, max(0.0, block_until - now)

    # -- internals -----------------------------------------------------------
    def _finalize(self, az: int, now: float, why: str) -> None:
        parts = self.buffers.pop(az, {})
        self.buffer_bytes[az] = 0
        self.last_finalize[az] = now
        if not parts:
            return
        bid = None
        if self.name is not None:
            bid = f"{self.name}-{self._blob_seq:06d}"
            self._blob_seq += 1
        blob, notes = build_blob_from_buffers(
            {p: pb.chunks for p, pb in parts.items()}, target_az=az,
            blob_id=bid, fmt=self.fmt)
        if self.uploader is not None:
            counts = {p: pb.count for p, pb in parts.items()}
            self.uploader(blob, notes, counts, now)
        else:
            lat = self.cache.write(blob.blob_id, blob.payload, now)
            heapq.heappush(
                self.pending,
                (now + lat, self._pending_seq,
                 PendingUpload(blob, notes, now, now + lat)))
            self._pending_seq += 1
        self.stats.blobs += 1
        self.stats.blob_bytes += blob.size
        setattr(self.stats, f"finalize_{why}",
                getattr(self.stats, f"finalize_{why}") + 1)
        if self.obs is not None:
            self.obs.on_batch_finalized(az, blob, why, now)
