"""ElasticCluster: the glue between the subsystem and the engine.

Owns the notification log, the offset store, membership, the rebalance
coordinator, and (optionally) the autoscaler, and plugs into
``AsyncShuffleEngine`` via three hooks:

  * ``engine._publish`` → ``publish``: a finalized notification becomes
    a durable log entry and is delivered (after the messaging delay,
    plus the cross-AZ extra when producer and owner AZs differ) to the
    partition's current OWNER — not to a fixed per-AZ debatcher;
  * ``engine._fetch_done`` → ``on_delivery``: the exactly-once gate —
    stale owners and replayed duplicates are dropped by log offset and
    (blob, partition), the paper's Debatcher dedup made partition-scoped
    state that migrates with ownership;
  * ``engine._commit_all`` → ``commit_offsets``: consumer offsets
    advance to each partition's contiguous delivered frontier on the
    engine's commit cadence — the token a new owner resumes from.

Cache alignment: after every completed rebalance the per-AZ
``DistributedCache`` clusters are resized to the alive worker count in
their AZ via consistent re-routing (``resize``) — ownership moves with
the assignment, entries are NOT flushed.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, List, Optional, Set

from repro_torch.cluster.assignor import PartitionMeta, StickyAzAssignor
from repro_torch.cluster.autoscaler import Autoscaler, AutoscalePolicy
from repro_torch.cluster.membership import UP, Membership, WorkerInfo
from repro_torch.cluster.notification_log import NotificationLog, OffsetStore
from repro_torch.cluster.rebalance import RebalanceCoordinator, RebalanceEvent
from repro_torch.core.blob import Notification
from repro_torch.core.costs import AwsPrices


class _PartitionState:
    """Partition-scoped consumption state. It belongs to the PARTITION,
    not the worker — like a Kafka Streams state store, it survives its
    owner and migrates on reassignment, which is what lets the dedup
    hold across crash handoffs."""
    __slots__ = ("partition", "home_az", "owner", "delivered", "seen_blobs")

    def __init__(self, partition: int, home_az: int):
        self.partition = partition
        self.home_az = home_az
        self.owner: Optional[str] = None
        self.delivered: Set[int] = set()    # offsets >= committed
        self.seen_blobs: Set[str] = set()   # (blob, partition) dedup

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"_PartitionState(p={self.partition}, az={self.home_az}, "
                f"owner={self.owner})")


@dataclasses.dataclass
class ClusterStats:
    published: int = 0
    delivered: int = 0
    undeliverable: int = 0       # appended with no live owner (replay later)
    replayed_entries: int = 0    # scheduled again for a new owner
    handoff_duplicates_dropped: int = 0
    stale_drops: int = 0         # deliveries to (silently) dead workers
    cross_az_deliveries: int = 0  # owner consumed outside the home AZ
    offset_commits: int = 0
    cache_reroutes: int = 0      # cache entries moved (never flushed)
    worker_seconds: float = 0.0  # integral of alive workers over time


class ElasticCluster:
    GROUP = "debatch"

    def __init__(self, engine, *, mode: str = "cooperative",
                 assignor: Optional[StickyAzAssignor] = None,
                 heartbeat_timeout_s: float = 2.0,
                 autoscale: Optional[AutoscalePolicy] = None,
                 sync_barrier_s: float = 0.25,
                 migration_batch: int = 0,
                 migration_interval_s: float = 0.05):
        self.engine = engine
        self.loop = engine.loop
        self.log = NotificationLog()
        self.offsets = OffsetStore()
        self.stats = ClusterStats()
        self.membership = Membership(engine.loop, heartbeat_timeout_s,
                                     self._on_membership)
        self.rebalancer = RebalanceCoordinator(
            self, assignor or StickyAzAssignor(), mode,
            sync_barrier_s=sync_barrier_s, migration_batch=migration_batch,
            migration_interval_s=migration_interval_s)
        self.parts: Dict[int, _PartitionState] = {
            p: _PartitionState(p, engine.partition_to_az(p))
            for p in range(engine.cfg.num_partitions)}
        self._ws_t = self.loop.now
        engine.attach_cluster(self)
        # bootstrap: one worker per already-active engine instance, and a
        # single silent initial assignment (not a counted rebalance)
        self._bootstrapping = True
        for i in range(engine.n_instances):
            if engine.active[i]:
                self.membership.join(f"w{i}", engine._inst_az[i], i)
        self._bootstrapping = False
        initial = self.rebalancer.assignor.assign(
            self.partition_meta(), self.membership.alive(), {})
        for p, w in initial.items():
            self.parts[p].owner = w
        engine.on_assignment_changed()
        self._align_caches()
        self.autoscaler: Optional[Autoscaler] = None
        if autoscale is not None:
            self.autoscaler = Autoscaler(self, autoscale)
            self.autoscaler.start()

    # -- topology views ----------------------------------------------------
    def partition_meta(self) -> List[PartitionMeta]:
        return [PartitionMeta(st.partition, st.home_az)
                for st in self.parts.values()]

    def assignment(self) -> Dict[int, str]:
        return {p: st.owner for p, st in self.parts.items()
                if st.owner is not None}

    def partitions_of(self, worker_id: str) -> int:
        return sum(1 for st in self.parts.values()
                   if st.owner == worker_id)

    def total_lag(self) -> int:
        """Uncommitted notification-log entries (Kafka consumer lag)."""
        return sum(self.log.end_offset(p)
                   - self.offsets.committed(self.GROUP, p)
                   for p in self.parts)

    def undelivered_lag(self) -> int:
        """Entries not yet delivered downstream — the backpressure signal
        (committed lag additionally counts the delivered-but-uncommitted
        window, which only drains on the commit cadence)."""
        return sum(self.log.end_offset(p)
                   - self.offsets.committed(self.GROUP, p)
                   - len(st.delivered)
                   for p, st in self.parts.items())

    # -- worker operations -------------------------------------------------
    def add_worker(self, az: Optional[int] = None) -> str:
        """Scale-out: provision an engine instance + join the group
        (join triggers a rebalance in the configured mode)."""
        inst = self.engine.add_instance(az)
        wid = f"w{inst}"
        self.membership.join(wid, self.engine._inst_az[inst], inst)
        return wid

    def remove_worker(self, worker_id: str) -> None:
        """Graceful scale-in: drain the instance, then leave (the
        rebalance hands its partitions off from committed offsets)."""
        w = self.membership.workers[worker_id]
        self.engine.remove_instance(w.inst)
        self.membership.leave(worker_id)

    def crash_worker(self, worker_id: str) -> None:
        """Fail-stop now: the engine instance dies immediately (uploads
        and buffers lost, uncommitted records replay); the GROUP only
        reacts one heartbeat timeout later. No-op if the worker already
        left or crashed (e.g. the autoscaler retired it first)."""
        w = self.membership.workers[worker_id]
        if w.state != UP or w.silent_since is not None:
            return
        self.engine._fail(w.inst, permanent=True)
        self.membership.crash(worker_id)

    def crash_worker_at(self, t: float, worker_id: str) -> None:
        self.loop.at(t, self.crash_worker, worker_id)

    def az_outage(self, az: int) -> None:
        """Every worker in ``az`` fail-stops at once; their partitions
        fall back to cross-AZ owners at detection."""
        for w in list(self.membership.alive()):
            if w.az == az and w.silent_since is None:
                self.crash_worker(w.worker_id)

    def az_outage_at(self, t: float, az: int) -> None:
        self.loop.at(t, self.az_outage, az)

    def _on_membership(self, kind: str, w: WorkerInfo) -> None:
        self._accrue(self.loop.now)
        if self._bootstrapping:
            return
        obs = self.engine.obs
        if obs is not None:
            obs.mark(f"rebalance_trigger:{kind}", self.loop.now)
        self.rebalancer.trigger(kind, self.loop.now)

    # -- data plane --------------------------------------------------------
    def publish(self, note: Notification, src_az: Optional[int] = None
                ) -> int:
        """Engine hook: append to the log and deliver to the partition's
        owner; entries published while ownership is in flux (revoked,
        owner silently dead) wait in the log for the next resume."""
        off = self.log.append(note)
        self.stats.published += 1
        st = self.parts[note.partition]
        w = (self.membership.workers.get(st.owner)
             if st.owner is not None else None)
        if w is None or not self.membership.is_alive_now(w.worker_id):
            self.stats.undeliverable += 1
            return off
        self._schedule_delivery(st, off, note, w, src_az)
        return off

    def _schedule_delivery(self, st: _PartitionState, off: int,
                           note: Notification, w: WorkerInfo,
                           src_az: Optional[int]) -> None:
        e = self.engine.ecfg
        delay = e.notification_latency_s
        if src_az is not None and src_az != w.az:
            delay += e.cross_az_notification_extra_s
        if w.az != note.target_az:
            self.stats.cross_az_deliveries += 1
        self.loop.after(delay, self.engine.cluster_deliver, w.az, note,
                        off, w.worker_id)

    def on_delivery(self, note: Notification, offset: int,
                    worker_id: str) -> bool:
        """Engine hook, called at fetch completion — the exactly-once
        gate. False drops the delivery (the engine releases the lane)."""
        st = self.parts[note.partition]
        if not self.membership.is_alive_now(worker_id):
            self.stats.stale_drops += 1
            return False
        committed = self.offsets.committed(self.GROUP, note.partition)
        if (offset < committed or offset in st.delivered
                or note.blob_id in st.seen_blobs):
            self.stats.handoff_duplicates_dropped += 1
            return False
        st.delivered.add(offset)
        st.seen_blobs.add(note.blob_id)
        self.stats.delivered += 1
        return True

    def commit_offsets(self, now: float) -> int:
        """Advance every partition's committed offset to its contiguous
        delivered frontier (engine commit hook). Returns partitions
        whose committed offset moved."""
        return sum(self._commit_partition(p) for p in self.parts)

    def _commit_partition(self, p: int) -> bool:
        st = self.parts[p]
        c = self.offsets.committed(self.GROUP, p)
        while c in st.delivered:
            st.delivered.discard(c)
            c += 1
        if self.offsets.commit(self.GROUP, p, c):
            self.stats.offset_commits += 1
            return True
        return False

    # -- rebalance plumbing (called by RebalanceCoordinator) ---------------
    def revoke(self, partition: int) -> None:
        self.parts[partition].owner = None

    def assign_partition(self, partition: int, worker_id: str) -> int:
        """Hand one partition to ``worker_id``: commit its offsets (the
        handoff token), switch ownership, and replay the log from the
        committed offset. Returns the number of entries re-scheduled."""
        st = self.parts[partition]
        if st.owner == worker_id:
            return 0
        self._commit_partition(partition)
        st.owner = worker_id
        return self._resume(st)

    def _resume(self, st: _PartitionState) -> int:
        w = self.membership.workers.get(st.owner)
        if w is None or w.state != UP:
            return 0
        start = self.offsets.committed(self.GROUP, st.partition)
        n = 0
        for off, note in self.log.replay(st.partition, start):
            if off in st.delivered or note.blob_id in st.seen_blobs:
                continue    # already downstream: nothing to redo
            self._schedule_delivery(st, off, note, w, None)
            n += 1
        self.stats.replayed_entries += n
        return n

    def on_rebalance_complete(self, ev: RebalanceEvent) -> None:
        # the assignment snapshot moved: strategies routing blob
        # placement by owner AZ (push-based shuffle) re-snapshot, and
        # the batchers drop their cached partition→AZ tables
        obs = self.engine.obs
        if obs is not None:
            obs.mark("rebalance_complete", self.loop.now)
        self.engine.on_assignment_changed()
        self._align_caches()

    def _align_caches(self) -> None:
        """Re-route (never flush) each AZ's cache cluster to its alive
        worker count — cache ownership follows the assignment."""
        per_az = Counter(w.az for w in self.membership.alive())
        for az, cache in enumerate(self.engine.caches):
            self.stats.cache_reroutes += cache.resize(
                max(1, per_az.get(az, 0)))

    # -- accounting --------------------------------------------------------
    def _accrue(self, now: float) -> None:
        self.stats.worker_seconds += \
            len(self.membership.alive()) * (now - self._ws_t)
        self._ws_t = now

    def infra_cost_usd(self, cost_per_hour: Optional[float] = None
                       ) -> float:
        """Worker-time cost of the run so far (elastic $ vs static $)."""
        if cost_per_hour is None:
            cost_per_hour = AwsPrices().ec2_r6in_xlarge_hour
        return self.stats.worker_seconds / 3600.0 * cost_per_hour

    def finalize(self, now: float) -> None:
        """End-of-run bookkeeping (engine ``run()`` hook): close the
        worker-seconds integral and commit the final frontiers."""
        self._accrue(now)
        self.commit_offsets(now)
