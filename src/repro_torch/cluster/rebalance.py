"""Rebalance coordination: eager (stop-the-world) vs cooperative.

Two protocols over the same sticky assignment, mirroring Kafka's
``eager`` vs ``cooperative-sticky`` rebalance modes:

  * **eager** — every partition is revoked for a synchronization barrier
    (``sync_barrier_s``: the time for all members to rejoin the group);
    while revoked, nothing is consumed and newly published notifications
    pile up in the log. All partitions then resume from their committed
    offsets at once. Simple, and visibly expensive: the pause shows up
    directly in the p95-during-rebalance metric.

  * **cooperative** — only partitions whose owner actually changes hand
    off; unchanged partitions keep flowing throughout. The moved set can
    additionally migrate in Megaphone-style incremental *waves*
    (``migration_batch`` partitions every ``migration_interval_s``),
    bounding the instantaneous state-movement so latency stays flat.

Exactly-once handoff, in both modes: a partition's offsets are committed
at its handoff point, the new owner replays the notification log from
the committed offset, and the cluster's delivery-time dedup (by log
offset and (blob, partition)) drops anything the old owner had already
delivered — including completions of fetches that were still in flight
when ownership moved.

A new trigger supersedes in-flight migration waves: each trigger bumps a
round counter, and stale waves abandon themselves (the newest
assignment already covers every partition).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.cluster.assignor import StickyAzAssignor


@dataclasses.dataclass
class RebalanceEvent:
    reason: str              # "join" | "leave" | "crash" | manual
    mode: str                # "eager" | "cooperative"
    started_at: float
    ended_at: float
    moved: List[int]         # partitions whose owner changed
    replayed: int = 0        # log entries re-scheduled for the new owners
    generation: int = 0
    superseded: bool = False


class RebalanceCoordinator:
    def __init__(self, cluster, assignor: StickyAzAssignor,
                 mode: str = "cooperative", *,
                 sync_barrier_s: float = 0.25,
                 migration_batch: int = 0,
                 migration_interval_s: float = 0.05):
        if mode not in ("eager", "cooperative"):
            raise ValueError(f"unknown rebalance mode: {mode!r}")
        self.cluster = cluster
        self.assignor = assignor
        self.mode = mode
        self.sync_barrier_s = sync_barrier_s
        self.migration_batch = migration_batch
        self.migration_interval_s = migration_interval_s
        self.events: List[RebalanceEvent] = []
        self._round = 0

    @property
    def partitions_moved(self) -> int:
        return sum(len(e.moved) for e in self.events if not e.superseded)

    def trigger(self, reason: str, now: float) -> RebalanceEvent:
        cluster = self.cluster
        self._round += 1
        rnd = self._round
        new = self.assignor.assign(
            cluster.partition_meta(),
            list(cluster.membership.workers.values()),
            cluster.assignment())
        moved = sorted(p for p, w in new.items()
                       if cluster.parts[p].owner != w)
        ev = RebalanceEvent(reason, self.mode, now, now, moved,
                            generation=cluster.membership.generation)
        self.events.append(ev)
        loop = cluster.loop
        if self.mode == "eager":
            for st in cluster.parts.values():
                cluster.revoke(st.partition)
            loop.after(self.sync_barrier_s, self._eager_resume, new, ev,
                       rnd)
        else:
            if not moved:
                # nothing to migrate, but the membership still changed:
                # cache clusters must realign to the new worker set
                cluster.on_rebalance_complete(ev)
                return ev
            step = max(1, self.migration_batch) if self.migration_batch \
                else len(moved)
            waves = [moved[i:i + step] for i in range(0, len(moved), step)]
            for k, wave in enumerate(waves):
                loop.after(k * self.migration_interval_s, self._wave,
                           wave, new, ev, k == len(waves) - 1, rnd)
        return ev

    def _stale(self, ev: RebalanceEvent, rnd: int) -> bool:
        if rnd != self._round:
            ev.superseded = True
            return True
        return False

    def _eager_resume(self, new: Dict[int, str], ev: RebalanceEvent,
                      rnd: int) -> None:
        if self._stale(ev, rnd):
            return
        for p, w in sorted(new.items()):
            ev.replayed += self.cluster.assign_partition(p, w)
        ev.ended_at = self.cluster.loop.now
        self.cluster.on_rebalance_complete(ev)

    def _wave(self, wave: List[int], new: Dict[int, str],
              ev: RebalanceEvent, last: bool, rnd: int) -> None:
        if self._stale(ev, rnd):
            return
        for p in wave:
            ev.replayed += self.cluster.assign_partition(p, new[p])
        if last:
            ev.ended_at = self.cluster.loop.now
            self.cluster.on_rebalance_complete(ev)
