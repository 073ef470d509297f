"""Durable, offset-addressed notification log + consumer-offset store.

The paper's "compact notifications" flow through a messaging layer the
engine previously modeled as fixed-delay point-to-point delivery. That is
not enough for elasticity: when partition ownership moves (scale-out,
crash, AZ outage), the new owner must be able to REPLAY every
notification the old owner had not durably consumed. This module makes
the messaging layer a per-partition, append-only, offset-addressed log —
the simulated twin of a Kafka notification topic — plus the
consumer-group offset store whose committed offsets are the exactly-once
handoff token: a new owner resumes from ``committed(group, partition)``
and the delivery-time dedup drops anything the old owner already got
downstream.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from repro_torch.core.blob import Notification


@dataclasses.dataclass
class LogStats:
    appends: int = 0
    bytes_appended: int = 0
    replayed: int = 0        # entries re-read during handoff/recovery


class NotificationLog:
    """Per-partition append-only log of notifications with dense offsets."""

    def __init__(self):
        self._parts: Dict[int, List[Notification]] = defaultdict(list)
        self.stats = LogStats()

    def append(self, note: Notification) -> int:
        """Append one notification to its partition's log; returns the
        entry's offset (dense, 0-based, per partition)."""
        log = self._parts[note.partition]
        log.append(note)
        self.stats.appends += 1
        self.stats.bytes_appended += note.size
        return len(log) - 1

    def end_offset(self, partition: int) -> int:
        return len(self._parts.get(partition, ()))

    def read(self, partition: int, start: int = 0,
             end: Optional[int] = None) -> List[Tuple[int, Notification]]:
        """Entries of ``partition`` in ``[start, end)`` as
        ``(offset, notification)`` pairs."""
        log = self._parts.get(partition, [])
        end = len(log) if end is None else min(end, len(log))
        return [(off, log[off]) for off in range(max(0, start), end)]

    def replay(self, partition: int, start: int
               ) -> List[Tuple[int, Notification]]:
        """``read`` that also counts the entries as replayed (handoff or
        crash recovery re-consumption)."""
        out = self.read(partition, start)
        self.stats.replayed += len(out)
        return out

    def partitions(self) -> List[int]:
        return sorted(self._parts)


class OffsetStore:
    """Committed consumer offsets per (group, partition).

    The durable handoff token: commits are monotonic (a stale coordinator
    can never move a group backwards), and a partition's new owner starts
    consuming from ``committed(group, partition)``.
    """

    def __init__(self):
        self._committed: Dict[Tuple[str, int], int] = {}
        self.commits = 0

    def commit(self, group: str, partition: int, offset: int) -> bool:
        """Advance the committed offset; returns True if it moved."""
        key = (group, partition)
        cur = self._committed.get(key, 0)
        if offset <= cur:
            return False
        self._committed[key] = offset
        self.commits += 1
        return True

    def committed(self, group: str, partition: int) -> int:
        return self._committed.get((group, partition), 0)
