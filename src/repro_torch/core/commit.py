"""Commit protocol integration (paper §3.1/§3.2).

Mirrors Kafka Streams' periodic commits: state may only be committed once
(a) all blobs derived from processed records are durably stored,
(b) their notifications are published, and
(c) the Debatcher has fully processed all fetched batches.

Failures before commit roll back to the last committed offset: the source
records are REPLAYED (at-least-once); the Debatcher's (blob, partition)
dedup restores exactly-once at the output. Orphaned blobs (uploaded but
never referenced) stay unreachable and are collected by retention.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Set

from repro_torch.core.batcher import Batcher
from repro_torch.core.blob import Notification
from repro_torch.core.debatcher import Debatcher
from repro_torch.core.recordbatch import RecordBatch
from repro_torch.core.records import Record


@dataclasses.dataclass
class CommitStats:
    commits: int = 0
    commit_block_s: float = 0.0
    failures_injected: int = 0
    records_replayed: int = 0


class CommitCoordinator:
    """Drives a Batcher through commit intervals with failure injection."""

    def __init__(self, batcher: Batcher, debatchers: List[Debatcher],
                 publish: Callable[[Notification], None]):
        self.batcher = batcher
        self.debatchers = debatchers
        self.publish = publish
        # source records (or whole RecordBatches) since the last commit
        self.uncommitted: List = []
        self.unpublished: List[Notification] = []
        self.stats = CommitStats()
        # async-engine state: blobs whose PUT is still in flight, and the
        # start time of a commit waiting for them to drain (None = idle)
        self.outstanding: Set[str] = set()
        self._commit_started: Optional[float] = None
        # snapshot of the commit in progress: the uploads it waits for,
        # the notifications it will publish, and how many uncommitted
        # source units it covers — uploads/records arriving later belong
        # to the NEXT commit, so a commit finishes in bounded time even
        # under continuous load
        self._commit_wait: Set[str] = set()
        self._commit_notes: List[Notification] = []
        self._commit_n: int = 0
        self._commit_again: bool = False

    def process(self, rec: Record, now: float) -> None:
        self.uncommitted.append(rec)
        for note in self.batcher.process(rec, now):
            self.unpublished.append(note)

    def ingest(self, batch: RecordBatch, now: float) -> None:
        """Columnar bulk ingest: the whole batch is tracked as one
        uncommitted unit (flattened to records only on replay)."""
        self.uncommitted.append(batch)
        for note in self.batcher.ingest(batch, now):
            self.unpublished.append(note)

    def commit(self, now: float) -> float:
        """Blocking commit. Returns the blocked duration (seconds)."""
        notes, block_w = self.batcher.on_commit(now)
        self.unpublished.extend(notes)
        for note in self.unpublished:
            self.publish(note)
        self.unpublished.clear()
        block_r = max((d.on_commit(now) for d in self.debatchers),
                      default=0.0)
        self.uncommitted.clear()
        self.stats.commits += 1
        blocked = max(block_w, block_r)
        self.stats.commit_block_s += blocked
        return blocked

    # -- event-driven commit protocol (async engine path) -------------------
    # Notifications of in-flight uploads reach the coordinator only at the
    # upload's completion event; a commit therefore happens in two halves:
    # ``begin_commit`` flushes the buffers (enqueueing the tail uploads)
    # and SNAPSHOTS what this commit covers; ``try_finish_commit``
    # completes once the snapshot's uploads drain — publishing the
    # snapshot's notifications at once (read-committed visibility, which
    # preserves exactly-once under reordering and replay). Work arriving
    # after ``begin_commit`` belongs to the NEXT commit (chained
    # automatically), so commits finish in bounded time even while the
    # source keeps producing — Kafka Streams' commit covers records
    # processed up to the commit point, not future ones.
    def note_upload_started(self, blob_id: str) -> None:
        self.outstanding.add(blob_id)

    def note_upload_complete(self, blob_id: str,
                             notes: List[Notification],
                             publish_now: bool) -> None:
        """Record a durable upload. ``publish_now`` is the at-least-once
        mode: notifications fan out immediately (a crash after this point
        produces duplicates downstream); exactly-once defers them to the
        commit covering the upload."""
        self.outstanding.discard(blob_id)
        in_commit = blob_id in self._commit_wait
        self._commit_wait.discard(blob_id)
        if publish_now:
            for note in notes:
                self.publish(note)
        elif in_commit:
            self._commit_notes.extend(notes)
        else:
            self.unpublished.extend(notes)

    def note_upload_aborted(self, blob_id: str) -> None:
        """A PUT failed permanently: stop waiting for it (the loss shows
        up in the engine's ``uploads_aborted``, not as a hung commit)."""
        self.outstanding.discard(blob_id)
        self._commit_wait.discard(blob_id)

    def begin_commit(self, now: float) -> None:
        """First half of an async commit: flush buffers into the upload
        lane and snapshot the uploads/notifications/records this commit
        covers. If a commit is already in flight, remember to chain
        another one when it finishes."""
        self.batcher.flush_all(now)
        if self._commit_started is not None:
            self._commit_again = True
            return
        self._commit_started = now
        self._commit_wait = set(self.outstanding)
        self._commit_notes = list(self.unpublished)
        self.unpublished.clear()
        self._commit_n = len(self.uncommitted)

    def try_finish_commit(self, now: float) -> bool:
        """Second half: once every upload in the commit's snapshot is
        durable, publish its notifications and mark its offsets
        committed. Chains the next commit if more work accumulated."""
        if self._commit_started is None or self._commit_wait:
            return False
        for note in self._commit_notes:
            self.publish(note)
        self._commit_notes = []
        del self.uncommitted[:self._commit_n]
        self._commit_n = 0
        self.stats.commits += 1
        self.stats.commit_block_s += now - self._commit_started
        self._commit_started = None
        if self._commit_again or self.outstanding or self.unpublished:
            self._commit_again = False
            self.begin_commit(now)
            self.try_finish_commit(now)
        return True

    def fail_and_restart(self, now: float) -> List[Record]:
        """Crash before commit: uploads may be orphaned; notifications not
        yet published are lost; uncommitted source records replay."""
        self.stats.failures_injected += 1
        replay: List[Record] = []
        for item in self.uncommitted:
            if isinstance(item, RecordBatch):
                replay.extend(item.iter_records())
            else:
                replay.append(item)
        self.stats.records_replayed += len(replay)
        # lost: pending uploads (orphans stay in the store — harmless),
        # unpublished notifications, and all in-memory buffers.
        self.batcher.pending.clear()
        self.batcher.ready.clear()
        self.batcher.buffers.clear()
        self.batcher.buffer_bytes.clear()
        self.unpublished.clear()
        self.uncommitted.clear()
        self.outstanding.clear()
        self._commit_started = None
        self._commit_wait.clear()
        self._commit_notes.clear()
        self._commit_n = 0
        self._commit_again = False
        return replay
