"""Event-driven async BlobShuffle engine (virtual clock).

Replaces the strictly sequential PUT → notify → GET → commit execution of
the original pipeline facade with a discrete-event model of the paper's
actual concurrency structure (§3, §5):

  * finalized blobs enter a **bounded per-instance upload lane**
    (``upload_parallelism`` in-flight PUTs; the rest queue), with PUT
    completions sampled from ``SimulatedS3``'s lognormal latency model;
  * notification **fan-out** is asynchronous: each contributing partition's
    notification is delivered to the destination AZ's Debatcher after a
    messaging delay;
  * Debatchers **prefetch**: up to ``fetch_parallelism`` speculative GETs
    are issued the moment notifications arrive, so retrieval latency
    overlaps both other GETs and the producers' uploads;
  * **cache fills race reads**: the write-through fill lands one event
    after PUT completion, so an early prefetch can miss the cache, lead a
    store GET, and later requests coalesce onto it (single-flight);
  * **commits route through ``CommitCoordinator``**: a commit begins by
    flushing buffers into the upload lane and finishes only when every
    outstanding PUT is durable; under exactly-once, notifications become
    visible in commit batches (read-committed), so duplicate, reordered,
    or replayed work never double-delivers downstream.

Both lanes are resilient against an unreliable ``BlobStore`` (e.g. a
``FaultyStore``-wrapped tier): failed PUTs/GETs retry with exponential
backoff + deterministic jitter (503 SlowDown responses additionally
honor the server's retry-after hint and put the lane under a
backpressure penalty that collapses its parallelism to 1); slow GETs can
be hedged with a second request once the observed latency quantile is
exceeded, first completion wins. A periodic retention sweep deletes
expired blobs on the virtual clock, and end-of-run storage accrual folds
still-live objects into ``StoreStats.byte_seconds``.

Everything runs on the deterministic ``EventLoop`` in
``repro_torch.core.events`` — a fixed seed reproduces the exact event order,
including every retry, backoff draw, and hedge.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict, deque
from typing import Callable, Deque, Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.batcher import Batcher, BlobShuffleConfig
from repro_torch.core.blob import Blob, Notification
from repro_torch.core.cache import DistributedCache, LocalCache
from repro_torch.core.commit import CommitCoordinator
from repro_torch.core.debatcher import Debatcher
from repro_torch.core.events import EventLoop
from repro_torch.core.recordbatch import RecordBatch, default_partitioner_batch
from repro_torch.core.records import Record, default_partitioner
from repro_torch.core.stores import BlobStore, SimulatedS3, SlowDownError, StoreError
from repro_torch.core.strategy import make_strategy
from repro_torch.obs import make_observability
from repro_torch.obs.sketch import QuantileSketch

GiB = 1024 ** 3


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Concurrency + resilience knobs of the async engine.

    ``upload_parallelism = fetch_parallelism = 1`` degenerates to the old
    synchronous single-in-flight execution — the baseline the paper's
    batching/caching design is measured against.
    """
    upload_parallelism: int = 4        # in-flight PUTs per instance
    fetch_parallelism: int = 8         # in-flight GETs per AZ Debatcher
    commit_interval_s: Optional[float] = None  # None: commit on drain only
    notification_latency_s: float = 0.002      # messaging-layer delay
    # extra delay for a notification whose producer and consumer sit in
    # different AZs (mirrors the cross-AZ penalties of stores/express.py);
    # 0.0 keeps the legacy uniform-latency behavior bit-identical
    cross_az_notification_extra_s: float = 0.0
    cache_fill_latency_s: float = 0.001        # write-through fill delay
    rpc_latency_s: float = 0.0005              # intra-AZ cache RPC
    local_latency_s: float = 0.00005           # local-cache lookup
    # -- retry / backoff (per failed PUT or GET attempt) -------------------
    max_attempts: int = 8              # attempts before a request aborts
    backoff_base_s: float = 0.05       # exponential: base × 2^(attempt-1)
    backoff_max_s: float = 5.0
    backoff_jitter: float = 0.5        # uniform [0, jitter] × backoff extra
    throttle_penalty_s: float = 0.25   # lane parallelism → 1 after a 503
    # -- hedged GETs --------------------------------------------------------
    hedge_quantile: Optional[float] = None  # e.g. 95.0; None disables
    hedge_min_samples: int = 20        # observed GETs before hedging arms
    # cross-check the streaming hedge-threshold sketch against an exact
    # np.percentile pass on every refresh (test/debug only: restores the
    # O(n log n) cost the sketch removes)
    hedge_debug_exact: bool = False
    # -- retention ----------------------------------------------------------
    retention_sweep_s: Optional[float] = None  # periodic expiry sweep


@dataclasses.dataclass
class ShuffleMetrics:
    """Per-run measurements: end-to-end record latency = delivery time
    minus source arrival time (includes batching wait, upload-lane
    queueing, PUT, notification, fetch queueing, and GET)."""
    records_in: int = 0
    records_delivered: int = 0
    records_replayed: int = 0
    bytes_delivered: int = 0
    duplicates_delivered: int = 0
    makespan_s: float = 0.0
    record_latencies: List[float] = dataclasses.field(default_factory=list)
    # delivery (virtual) time of each latency sample, index-aligned with
    # record_latencies — lets callers window percentiles (e.g. "p95 during
    # the rebalance") without changing the latency list itself
    record_latency_times: List[float] = dataclasses.field(
        default_factory=list)
    put_latencies: List[float] = dataclasses.field(default_factory=list)
    get_latencies: List[float] = dataclasses.field(default_factory=list)
    # resilience counters
    put_retries: int = 0
    get_retries: int = 0
    uploads_aborted: int = 0           # blobs dropped after max_attempts
    uploads_aborted_bytes: int = 0
    # blobs that died with a crashed instance: queued in its upload lane,
    # or in flight when the epoch bumped (their completion events no-op)
    uploads_lost: int = 0
    uploads_lost_bytes: int = 0
    fetches_aborted: int = 0
    throttle_events: int = 0           # 503 SlowDown responses observed
    hedges_issued: int = 0
    hedges_won: int = 0                # hedge completed before the primary
    retention_sweeps: int = 0
    retention_deleted: int = 0

    def latency_p(self, q: float) -> float:
        if not self.record_latencies:
            return float("nan")
        return float(np.percentile(self.record_latencies, q))

    def summary(self, store: BlobStore) -> Dict[str, float]:
        shuffled_gib = store.stats.put_bytes / GiB
        cost = store.stats.cost_usd(store.costs, store.retention_s)
        return {
            "records": float(self.records_delivered),
            "p50_s": self.latency_p(50),
            "p95_s": self.latency_p(95),
            "p99_s": self.latency_p(99),
            "makespan_s": self.makespan_s,
            "throughput_bytes_s": (self.bytes_delivered / self.makespan_s
                                   if self.makespan_s > 0 else 0.0),
            "cost_usd": cost,
            "cost_per_gib": cost / shuffled_gib if shuffled_gib else 0.0,
        }


@dataclasses.dataclass
class _Fetch:
    note: Notification
    enqueued_at: float
    attempt: int = 0
    done: bool = False      # set by the first completion (primary or hedge)
    # cluster-mode provenance: the notification-log offset being delivered
    # and the worker it was scheduled for (None on the direct fan-out path)
    offset: Optional[int] = None
    worker: Optional[str] = None


class AsyncShuffleEngine:
    """Virtual-clock BlobShuffle topology: n instances × num_az AZs."""

    def __init__(self, cfg: BlobShuffleConfig,
                 engine_cfg: Optional[EngineConfig] = None, *,
                 n_instances: int = 3, store: Optional[BlobStore] = None,
                 seed: int = 0, exactly_once: bool = True,
                 strategy=None, obs=None):
        self.cfg = cfg
        self.ecfg = engine_cfg or EngineConfig()
        self.n_instances = n_instances
        self.exactly_once = exactly_once
        self.loop = EventLoop()
        # opt-in observability (None | True | ObsConfig | Observability):
        # pure side-tables — hooks never schedule events or consume RNG,
        # so observed and unobserved runs are bit-identical
        self.obs = make_observability(obs)
        self.store = store or SimulatedS3(seed=seed,
                                          retention_s=cfg.retention_s)
        self.caches = [
            DistributedCache(az, max(n_instances // cfg.num_az, 1),
                             cfg.distributed_cache_bytes, self.store,
                             cfg.cache_on_write)
            for az in range(cfg.num_az)]
        self.debatchers: List[Debatcher] = []
        for az in range(cfg.num_az):
            local = (LocalCache(cfg.local_cache_bytes, self.caches[az])
                     if cfg.local_cache_bytes else None)
            self.debatchers.append(
                Debatcher(az, self.caches[az], local,
                          exactly_once=exactly_once))
        if self.obs is not None:
            for c in self.caches:
                c.obs = self.obs
            for d in self.debatchers:
                d.obs = self.obs
        # elastic-cluster hook: when an ``ElasticCluster`` is attached,
        # notification fan-out routes through its durable log instead of
        # the fixed-delay direct delivery, and instances can join/leave
        self.cluster = None
        # pluggable shuffle policy (None | registered name | instance);
        # DefaultStrategy makes every hook the identity — bit-identical
        # to the pre-seam engine
        self.strategy = make_strategy(strategy)
        self.strategy.bind(self)
        # per-instance state: the instance set is DYNAMIC — every list
        # below grows via add_instance() and entries deactivate (but are
        # never removed, so indices stay stable) via remove_instance/_fail
        self.batchers: List[Batcher] = []
        self.coordinators: List[CommitCoordinator] = []
        self._inst_az: List[int] = []
        self.active: List[bool] = []
        # producer side: per-instance bounded upload lanes
        # queue entries are (blob, notes, attempt)
        self._upload_q: List[Deque[Tuple[Blob, List[Notification], int]]] = []
        self._uploads_inflight: List[int] = []
        self._epoch: List[int] = []        # bumped on failure injection
        self._upload_penalty: List[float] = []
        # consumer side: per-AZ fetch queues + single-flight tracking
        self._fetch_q: List[Deque[_Fetch]] = [deque()
                                              for _ in range(cfg.num_az)]
        self._fetch_inflight = [0] * cfg.num_az
        # (az, blob_id) -> waiters parked behind the leading GET; key
        # presence marks a leader in flight (kept across leader retries)
        self._get_waiters: Dict[Tuple[int, str], List[_Fetch]] = {}
        # throttle backpressure: lane parallelism collapses to 1 until t
        self._fetch_penalty = [0.0] * cfg.num_az
        # deterministic jitter for retry backoff (separate stream from the
        # store's latency RNG so adding retries never perturbs latencies)
        self._retry_rng = np.random.default_rng(
            np.random.SeedSequence([seed, 0x5E7]))
        self._hedge_cached: Optional[Tuple[int, float]] = None
        # streaming GET-latency sketch backing the hedge threshold —
        # maintained only when hedging can read it, so the no-hedge hot
        # path is untouched
        self._get_sketch = (QuantileSketch()
                            if self.ecfg.hedge_quantile is not None
                            else None)
        # source arrival bookkeeping for end-to-end latency
        self._arrivals: Dict[Tuple[int, int], Deque[float]] = \
            defaultdict(deque)
        self._blob_arrivals: Dict[Tuple[str, int], List[float]] = {}
        self._flush_timers: Set[Tuple[int, int]] = set()
        self._pending_ingests = 0
        self._rr = 0
        self._t_done = 0.0
        self._started = False
        self.out: Dict[int, List[Record]] = defaultdict(list)
        self.published: List[Notification] = []
        self.metrics = ShuffleMetrics()
        for _ in range(n_instances):
            self.add_instance()

    def partition_to_az(self, partition: int) -> int:
        return partition % self.cfg.num_az

    def _partition_target_az(self, partition: int) -> int:
        """Destination AZ for buffering/blob placement — routed through
        the strategy so policies like push-based shuffle can follow the
        cluster assignor instead of the static layout."""
        return self.strategy.partition_target_az(partition)

    def on_assignment_changed(self) -> None:
        """Cluster hook: the partition→worker assignment changed. The
        batchers' cached partition→AZ tables may now be stale (a
        strategy can route by owner AZ), so drop them for lazy
        recompute; then let the strategy re-snapshot."""
        for b in self.batchers:
            b._az_table = None
        self.strategy.on_assignment_changed()

    # -- elastic instance set ---------------------------------------------
    def add_instance(self, az: Optional[int] = None) -> int:
        """Provision one more batcher instance (elastic scale-out). The
        new instance joins the ingest round-robin immediately; its AZ
        defaults to the round-robin AZ layout. Returns the instance id."""
        cfg = self.cfg
        i = len(self.batchers)
        if az is None:
            az = i % cfg.num_az
        self._inst_az.append(az)
        self.active.append(True)
        b = Batcher(cfg, self._partition_target_az,
                    lambda key: default_partitioner(
                        key, cfg.num_partitions),
                    self.caches[az], uploader=self._make_uploader(i),
                    name=f"i{i}",
                    partitioner_batch=lambda batch: (
                        default_partitioner_batch(
                            batch, cfg.num_partitions)))
        b.obs = self.obs
        self.batchers.append(b)
        self.coordinators.append(
            CommitCoordinator(b, self.debatchers, self._make_publisher(i)))
        self._upload_q.append(deque())
        self._uploads_inflight.append(0)
        self._epoch.append(0)
        self._upload_penalty.append(0.0)
        self.n_instances = len(self.batchers)
        return i

    def remove_instance(self, i: int) -> None:
        """Gracefully drain instance ``i`` (elastic scale-in): it leaves
        the ingest round-robin now, flushes its buffers, and commits once
        its outstanding uploads are durable."""
        self.active[i] = False
        c = self.coordinators[i]
        c.begin_commit(self.loop.now)
        if c.try_finish_commit(self.loop.now):
            self._t_done = max(self._t_done, self.loop.now)

    def attach_cluster(self, cluster) -> None:
        self.cluster = cluster

    def _make_publisher(self, i: int) -> Callable[[Notification], None]:
        def publish(note: Notification) -> None:
            self._publish(note, i)
        return publish

    def _next_inst(self) -> int:
        n = self.n_instances
        for _ in range(n):
            i = self._rr
            self._rr = (self._rr + 1) % n
            if self.active[i]:
                return i
        return self._rr    # no active instance left: route anywhere

    # -- ingest -----------------------------------------------------------
    def submit(self, t: float, rec: Record,
               inst: Optional[int] = None) -> None:
        """Schedule one source record to arrive at instance ``inst`` (or
        round-robin over the instances ACTIVE at arrival time) at virtual
        time ``t``."""
        self._pending_ingests += 1
        self.metrics.records_in += 1
        if inst is not None:
            self.loop.at(t, self._ingest, inst, rec)
        else:
            self.loop.at(t, self._ingest_rr, rec)

    def _ingest_rr(self, rec: Record) -> None:
        # the instance is picked when the record ARRIVES, not when it was
        # scheduled — a load balancer routes around left/crashed instances
        # and onto ones that joined mid-stream
        self._ingest(self._next_inst(), rec)

    def _ingest(self, i: int, rec: Record) -> None:
        now = self.loop.now
        b = self.batchers[i]
        part = b.partitioner(rec.key)
        az = self._partition_target_az(part)
        # arrival enters the FIFO before Batcher.process so a size-triggered
        # finalize inside process() already sees it
        self._arrivals[(i, part)].append(now)
        self.coordinators[i].process(rec, now)
        self._arm_flush_timer(i, az)
        if self.obs is not None:
            self.obs.on_ingest(self._inst_az[i], 1, now)
        self._note_ingested(1)

    def submit_batch(self, t: float, batch: RecordBatch,
                     inst: Optional[int] = None,
                     times: Optional[np.ndarray] = None) -> None:
        """Schedule a whole ``RecordBatch`` to arrive at instance ``inst``
        (or round-robin) at virtual time ``t`` — the columnar ingest lane.

        ``times`` optionally carries each record's true source arrival
        time (for end-to-end latency accounting); the batch itself is
        processed when it is delivered at ``t``, like an upstream consumer
        poll that hands over one micro-batch."""
        self._pending_ingests += len(batch)
        self.metrics.records_in += len(batch)
        self.loop.at(t, self._ingest_batch, inst, batch, times)

    def _ingest_batch(self, inst: Optional[int], batch: RecordBatch,
                      times: Optional[np.ndarray]) -> None:
        i = self._next_inst() if inst is None else inst
        now = self.loop.now
        n0 = len(batch)
        if n0 == 0:
            self._note_ingested(0)
            return
        # strategy hook: map-side combining shrinks the batch (and its
        # aligned arrival times) BEFORE partitioning and the arrival
        # FIFOs, so latency bookkeeping tracks the surviving records
        batch, times = self.strategy.prepare_batch(batch, times)
        n = len(batch)
        b = self.batchers[i]
        parts = b.compute_partitions(batch)
        # arrivals enter the per-partition FIFOs (in row = arrival order)
        # before ingest so finalizes inside ingest() already see them;
        # the (AZ, partition) grouping is computed once and cached on the
        # batch — Batcher.ingest reuses it instead of re-sorting
        order, starts = b._group(batch)
        for s, e in zip(starts[:-1], starts[1:]):
            g = order[s:e]
            part = int(parts[g[0]])
            fifo = self._arrivals[(i, part)]
            if times is None:
                fifo.extend([now] * len(g))
            else:
                fifo.extend(float(times[j]) for j in g)
        self.coordinators[i].ingest(batch, now)
        az_table = b._partition_az_table()
        for az in dict.fromkeys(int(a) for a in az_table[parts]):
            self._arm_flush_timer(i, az)
        if self.obs is not None:
            self.obs.on_ingest(self._inst_az[i], n, now)
        self._note_ingested(n0)

    def _arm_flush_timer(self, i: int, az: int) -> None:
        if (self.batchers[i].buffer_bytes.get(az, 0) > 0
                and (i, az) not in self._flush_timers):
            self._flush_timers.add((i, az))
            self.loop.after(self.cfg.max_interval_s + 1e-9,
                            self._flush_check, i, az)

    def _note_ingested(self, n: int) -> None:
        self._pending_ingests -= n
        if self._pending_ingests == 0:
            # sources drained: flush + commit whatever remains
            self.loop.after(1e-6, self._commit_all)

    def _flush_check(self, i: int, az: int) -> None:
        b = self.batchers[i]
        self._flush_timers.discard((i, az))
        if b.buffer_bytes.get(az, 0) <= 0:
            return
        due = b.last_finalize.get(az, self.loop.now) + b.cfg.max_interval_s
        if self.loop.now >= due - 1e-12:
            b.flush_due(self.loop.now)
        else:
            self._flush_timers.add((i, az))
            self.loop.at(due + 1e-9, self._flush_check, i, az)

    # -- retry/backoff helpers --------------------------------------------
    def _backoff(self, attempt: int, err: StoreError) -> float:
        """Exponential backoff with deterministic jitter; 503 responses
        additionally honor the server's retry-after hint."""
        base = min(self.ecfg.backoff_max_s,
                   self.ecfg.backoff_base_s * 2.0 ** max(attempt - 1, 0))
        jit = base * self.ecfg.backoff_jitter * float(self._retry_rng.random())
        return max(base + jit, err.retry_after_s)

    def _note_throttle(self, penalties: List[float], lane: int,
                       err: StoreError) -> None:
        if isinstance(err, SlowDownError):
            self.metrics.throttle_events += 1
            penalties[lane] = max(penalties[lane],
                                  self.loop.now + self.ecfg.throttle_penalty_s)

    def _lane_cap(self, penalties: List[float], lane: int,
                  cap: int) -> int:
        return 1 if self.loop.now < penalties[lane] else max(1, cap)

    # -- upload lane ------------------------------------------------------
    def _make_uploader(self, i: int) -> Callable:
        def uploader(blob: Blob, notes: List[Notification],
                     counts: Dict[int, int], now: float) -> None:
            for part, cnt in counts.items():
                q = self._arrivals.get((i, part))
                n = min(cnt, len(q)) if q else 0
                self._blob_arrivals[(blob.blob_id, part)] = \
                    [q.popleft() for _ in range(n)]
            self.coordinators[i].note_upload_started(blob.blob_id)
            self._upload_q[i].append((blob, notes, 0))
            if self.obs is not None:
                first = min(
                    (a[0] for part in counts
                     if (a := self._blob_arrivals[(blob.blob_id, part)])),
                    default=None)
                self.obs.on_blob_handed_off(blob, self._inst_az[i],
                                            first, now)
            self._pump_uploads(i)
        return uploader

    def _pump_uploads(self, i: int) -> None:
        cap = self._lane_cap(self._upload_penalty, i,
                             self.ecfg.upload_parallelism)
        while self._uploads_inflight[i] < cap and self._upload_q[i]:
            blob, notes, attempt = self._upload_q[i].popleft()
            self._uploads_inflight[i] += 1
            self._start_put(i, blob, notes, attempt)

    def _start_put(self, i: int, blob: Blob, notes: List[Notification],
                   attempt: int) -> None:
        # placement hook: push-based strategies PUT into the blob's
        # destination AZ so zonal stores home it next to its consumer
        az = self.strategy.put_az(blob, self._inst_az[i])
        try:
            lat = self.store.begin_put(blob.blob_id, blob.size,
                                       now=self.loop.now, az=az)
        except StoreError as e:
            self._note_throttle(self._upload_penalty, i, e)
            delay = self._backoff(attempt + 1, e)
            self.loop.after(e.detect_after_s, self._upload_failed, i, blob,
                            notes, attempt, delay, self._epoch[i])
            return
        self.loop.after(lat, self._upload_done, i, blob, notes, lat,
                        self._epoch[i])

    def _upload_failed(self, i: int, blob: Blob, notes: List[Notification],
                       attempt: int, delay: float, epoch: int) -> None:
        """Failure observed: release the lane slot and either requeue the
        blob after backoff or abort it past ``max_attempts``."""
        if epoch != self._epoch[i]:
            self.metrics.uploads_lost += 1
            self.metrics.uploads_lost_bytes += blob.size
            return
        self._uploads_inflight[i] -= 1
        if attempt + 1 >= self.ecfg.max_attempts:
            # persistent failure: drop the blob so commits don't hang (the
            # loss is visible in uploads_aborted and records_delivered)
            self.metrics.uploads_aborted += 1
            self.metrics.uploads_aborted_bytes += blob.size
            c = self.coordinators[i]
            c.note_upload_aborted(blob.blob_id)
            if c.try_finish_commit(self.loop.now):
                self._t_done = max(self._t_done, self.loop.now)
        else:
            self.metrics.put_retries += 1
            self.loop.after(delay, self._requeue_upload, i, blob, notes,
                            attempt + 1, epoch)
        self._pump_uploads(i)

    def _requeue_upload(self, i: int, blob: Blob,
                        notes: List[Notification], attempt: int,
                        epoch: int) -> None:
        if epoch != self._epoch[i]:
            self.metrics.uploads_lost += 1
            self.metrics.uploads_lost_bytes += blob.size
            return
        self._upload_q[i].appendleft((blob, notes, attempt))
        self._pump_uploads(i)

    def _upload_done(self, i: int, blob: Blob, notes: List[Notification],
                     lat: float, epoch: int) -> None:
        if epoch != self._epoch[i]:
            # instance crashed mid-upload: connection died with it
            self.metrics.uploads_lost += 1
            self.metrics.uploads_lost_bytes += blob.size
            return
        now = self.loop.now
        inst_az = self._inst_az[i]
        put_az = self.strategy.put_az(blob, inst_az)
        self.store.finish_put(blob.blob_id, blob.payload, now, az=put_az)
        if put_az != inst_az:
            # zonal stores only see the placement AZ; surface the bytes
            # the producer routed cross-AZ so the cost model can price
            # the push (once per durable blob, not per attempt)
            self.strategy.stats.push_cross_az_bytes += blob.size
        self.metrics.put_latencies.append(lat)
        if self.obs is not None:
            self.obs.on_blob_durable(blob.blob_id, blob.size, put_az, lat,
                                     now)
        self._uploads_inflight[i] -= 1
        if self.cfg.cache_on_write:
            # write-through lands in the WRITER's AZ cluster (paper §3.3):
            # same-AZ consumers hit it; cross-AZ consumers still lead one
            # store GET into their own cluster (model's 2/3 GET ratio).
            # Push-based strategies redirect the fill to the destination
            # AZ's cluster instead, making consumer reads zonal.
            self.loop.after(self.ecfg.cache_fill_latency_s,
                            self.caches[
                                self.strategy.fill_az(blob, inst_az)].fill,
                            blob.blob_id, blob.payload)
        c = self.coordinators[i]
        c.note_upload_complete(blob.blob_id, notes,
                               publish_now=not self.exactly_once)
        if c.try_finish_commit(now):
            self._t_done = max(self._t_done, now)
        self._pump_uploads(i)

    # -- notification fan-out + prefetching fetch lane --------------------
    def _publish(self, note: Notification, inst: Optional[int] = None) -> None:
        if self.strategy.on_publish(note, inst):
            # intercepted (e.g. parked for a two-round merge): the
            # strategy now owns eventual delivery, and the note does not
            # count as published downstream
            return
        self.published.append(note)
        if self.obs is not None:
            self.obs.on_note_published(note, self.loop.now)
        if self.cluster is not None:
            # elastic mode: the notification becomes a durable log entry
            # and is delivered to the partition's current OWNER (which may
            # sit in any AZ) — or replayed later if ownership is in flux
            self.cluster.publish(
                note, None if inst is None else self._inst_az[inst])
            return
        delay = self.ecfg.notification_latency_s
        if (inst is not None
                and self._inst_az[inst] != note.target_az):
            delay += self.ecfg.cross_az_notification_extra_s
        self.loop.after(delay, self._notify, note)

    def _notify(self, note: Notification) -> None:
        az = note.target_az
        if not self.debatchers[az].begin(note):
            return  # duplicate claimed/dropped before any fetch is issued
        self._fetch_q[az].append(_Fetch(note, self.loop.now))
        self._pump_fetches(az)

    def cluster_deliver(self, az: int, note: Notification, offset: int,
                        worker: str) -> None:
        """Cluster-mode delivery of one notification-log entry to the
        owning worker's AZ fetch lane. Dedup moves from
        ``Debatcher.begin`` (claim-on-admit) to delivery completion
        (``ElasticCluster.on_delivery`` — by log offset AND (blob,
        partition)): a crashed owner's claimed-but-undelivered entries
        must REPLAY to the next owner instead of being dropped."""
        if (self.cluster is not None
                and not self.cluster.membership.is_alive_now(worker)):
            self.cluster.stats.stale_drops += 1
            return      # the owner died in transit: replay covers this
        self.debatchers[az].stats.notifications += 1
        self._fetch_q[az].append(_Fetch(note, self.loop.now, offset=offset,
                                        worker=worker))
        self._pump_fetches(az)

    def _pump_fetches(self, az: int) -> None:
        cap = self._lane_cap(self._fetch_penalty, az,
                             self.ecfg.fetch_parallelism)
        while self._fetch_inflight[az] < cap and self._fetch_q[az]:
            f = self._fetch_q[az].popleft()
            self._fetch_inflight[az] += 1
            self._issue_fetch(az, f)

    def _issue_fetch(self, az: int, f: _Fetch) -> None:
        blob_id = f.note.blob_id
        d = self.debatchers[az]
        cache = self.caches[az]
        if d.local is not None:
            hit = d.local.probe(blob_id)
            if hit is not None:
                self.loop.after(self.ecfg.local_latency_s,
                                self._fetch_done, az, f, hit, "local")
                return
        hit = cache.probe(blob_id)
        if hit is not None:
            self.loop.after(self.ecfg.rpc_latency_s,
                            self._fetch_done, az, f, hit, "cache")
            return
        key = (az, blob_id)
        waiters = self._get_waiters.get(key)
        if waiters is not None:
            # single-flight: park behind the in-flight leader (the slot
            # stays held) and complete when the leader's download lands —
            # robust to the leader retrying or aborting in between
            cache.note_miss(coalesced=True)
            waiters.append(f)
            return
        cache.note_miss(coalesced=False)
        self._get_waiters[key] = []
        self._lead_get(az, f)

    def _note_get_latency(self, lat: float) -> None:
        """Record one issued store GET's latency (lead, hedge, or merge
        compactor read): the list feeds end-of-run summaries, the sketch
        feeds the streaming hedge threshold."""
        self.metrics.get_latencies.append(lat)
        if self._get_sketch is not None:
            self._get_sketch.add(lat)

    def _lead_get(self, az: int, f: _Fetch) -> None:
        """Issue (or re-issue after a failure) the leading store GET."""
        try:
            _, lat = self.caches[az].begin_store_get(f.note.blob_id,
                                                     now=self.loop.now)
        except StoreError as e:
            self._note_throttle(self._fetch_penalty, az, e)
            delay = self._backoff(f.attempt + 1, e)
            self.loop.after(e.detect_after_s, self._get_failed, az, f,
                            delay)
            return
        except KeyError:
            # blob expired (retention) or was never durable: permanent
            # miss — retrying cannot help, abort the whole flight
            self._abort_flight(az, f)
            return
        self._note_get_latency(lat)
        done = self.loop.now + lat
        self.loop.after(lat, self._store_get_done, az, f)
        hedge_at = self._hedge_threshold()
        if hedge_at is not None and lat > hedge_at:
            self.loop.after(hedge_at, self._hedge_fire, az, f, done)

    def _hedge_threshold(self) -> Optional[float]:
        q = self.ecfg.hedge_quantile
        if q is None:
            return None
        sk = self._get_sketch
        n = sk.count
        if n < self.ecfg.hedge_min_samples:
            return None
        # the threshold comes from the streaming sketch: O(1) per
        # observed GET, O(bins) per refresh — the full-list
        # np.percentile pass this used to take grew O(n log n) with the
        # run. Refreshing every 32 samples keeps the threshold stable
        # between refreshes (same cadence as before).
        bucket = n // 32
        if self._hedge_cached is None or self._hedge_cached[0] != bucket:
            est = float(sk.percentile(q))
            if self.ecfg.hedge_debug_exact:
                exact = float(np.percentile(self.metrics.get_latencies, q))
                if exact > 0.0 and abs(est - exact) > 0.02 * exact:
                    raise AssertionError(
                        f"hedge sketch diverged from exact percentile: "
                        f"sketch {est:.6g} vs exact {exact:.6g} at "
                        f"q={q} (n={n})")
            self._hedge_cached = (bucket, est)
        return self._hedge_cached[1]

    def _hedge_fire(self, az: int, f: _Fetch, primary_done: float) -> None:
        """The primary GET exceeded the hedge quantile: race a second
        request against it; the first completion wins (``f.done``)."""
        if f.done:
            return
        self.metrics.hedges_issued += 1
        try:
            _, lat = self.caches[az].begin_store_get(f.note.blob_id,
                                                     now=self.loop.now)
        except (StoreError, KeyError):
            return      # hedge hit a fault: the primary is still running
        self._note_get_latency(lat)
        if self.loop.now + lat < primary_done:
            self.metrics.hedges_won += 1
            self.loop.after(lat, self._store_get_done, az, f)

    def _abort_flight(self, az: int, f: _Fetch) -> None:
        """Permanently fail a leader fetch and every parked waiter (the
        object is gone — expired before delivery): release their lane
        slots and surface the loss in ``fetches_aborted``."""
        f.done = True
        waiters = self._get_waiters.pop((az, f.note.blob_id), [])
        self.metrics.fetches_aborted += 1 + len(waiters)
        self._fetch_inflight[az] -= 1 + len(waiters)
        self._pump_fetches(az)

    def _get_failed(self, az: int, f: _Fetch, delay: float) -> None:
        """Leader GET failure observed: back off and retry, or abort past
        ``max_attempts`` (promoting a parked waiter to leader)."""
        if f.done:
            return      # a hedge completed the fetch meanwhile
        f.attempt += 1
        if f.attempt >= self.ecfg.max_attempts:
            f.done = True
            self.metrics.fetches_aborted += 1
            key = (az, f.note.blob_id)
            waiters = self._get_waiters.pop(key, [])
            self._fetch_inflight[az] -= 1
            if waiters:
                leader, rest = waiters[0], waiters[1:]
                self._get_waiters[key] = rest
                self._lead_get(az, leader)
            self._pump_fetches(az)
            return
        self.metrics.get_retries += 1
        self.loop.after(delay, self._retry_get, az, f)

    def _retry_get(self, az: int, f: _Fetch) -> None:
        if f.done:
            return
        self._lead_get(az, f)

    def _store_get_done(self, az: int, f: _Fetch) -> None:
        if f.done:
            return      # the other of primary/hedge completed it first
        blob_id = f.note.blob_id
        try:
            payload = self.store.payload(blob_id)
        except KeyError:
            # expired between GET issue and completion: permanent loss
            self._abort_flight(az, f)
            return
        f.done = True
        self.caches[az].fill(blob_id, payload)
        waiters = self._get_waiters.pop((az, blob_id), [])
        for w in waiters:
            self.loop.after(self.ecfg.rpc_latency_s, self._fetch_done,
                            az, w, payload, "coalesced")
        self._fetch_done(az, f, payload, "store")

    def _fetch_done(self, az: int, f: _Fetch, payload: bytes,
                    src: str) -> None:
        now = self.loop.now
        if f.offset is not None:
            # cluster mode: the delivery point is the exactly-once gate —
            # stale owners (crashed/reassigned mid-fetch) and replayed
            # duplicates are dropped here, releasing the lane slot
            if not self.cluster.on_delivery(f.note, f.offset, f.worker):
                self._fetch_inflight[az] -= 1
                self._pump_fetches(az)
                return
        d = self.debatchers[az]
        if d.local is not None and src != "local":
            d.local.fill(f.note.blob_id, payload)
        recs = d.complete(f.note, payload, 0.0, src, now)
        self.out[f.note.partition].extend(recs)
        self.metrics.records_delivered += len(recs)
        self.metrics.bytes_delivered += f.note.byte_range.length
        arrivals = self._blob_arrivals.pop(
            (f.note.blob_id, f.note.partition), None)
        if arrivals is None:
            self.metrics.duplicates_delivered += len(recs)
            if self.obs is not None:
                self.obs.on_duplicate_delivery(az, len(recs), now)
        else:
            for t0 in arrivals:
                self.metrics.record_latencies.append(now - t0)
                self.metrics.record_latency_times.append(now)
            if self.obs is not None:
                self.obs.on_delivery(f.note, f.enqueued_at, arrivals,
                                     src, az, now)
        self._t_done = max(self._t_done, now)
        self._fetch_inflight[az] -= 1
        self._pump_fetches(az)

    # -- commits + failure injection --------------------------------------
    def commit_at(self, t: float) -> None:
        self.loop.at(t, self._commit_all)

    def _commit_all(self) -> None:
        now = self.loop.now
        for c in self.coordinators:
            if (c.batcher.buffered_bytes() == 0 and not c.outstanding
                    and not c.unpublished and not c.uncommitted
                    and c._commit_started is None):
                continue    # nothing to commit: don't extend the makespan
            if c._commit_started is not None and not c.uncommitted \
                    and c.batcher.buffered_bytes() == 0:
                continue    # in-flight commit already covers everything
            c.begin_commit(now)
            if c.try_finish_commit(now):
                self._t_done = max(self._t_done, now)
        if self.cluster is not None:
            # consumer-group offsets commit on the same cadence as the
            # engine's commit protocol (Kafka Streams commits source and
            # consumer offsets inside one commit)
            self.cluster.commit_offsets(now)

    def _commit_tick(self, interval: float) -> None:
        self._commit_all()
        if (self._pending_ingests > 0
                or any(b.buffered_bytes() for b in self.batchers)):
            self.loop.after(interval, self._commit_tick, interval)

    # -- retention ---------------------------------------------------------
    def _work_pending(self) -> bool:
        return (self._pending_ingests > 0
                or any(self._uploads_inflight)
                or any(self._upload_q)
                or any(self._fetch_inflight)
                or any(self._fetch_q)
                or any(b.buffered_bytes() for b in self.batchers)
                or self.strategy.work_pending())

    def _retention_tick(self, interval: float) -> None:
        """Periodic expiry sweep (paper §3.2): deletes blobs past the
        retention period and accrues their byte·seconds; reschedules
        itself while shuffle work is still in flight."""
        self.metrics.retention_sweeps += 1
        self.metrics.retention_deleted += \
            self.store.run_retention(self.loop.now)
        if self._work_pending():
            self.loop.after(interval, self._retention_tick, interval)

    def fail_at(self, t: float, inst: int, permanent: bool = False) -> None:
        """Inject a crash of ``inst`` at time ``t``: queued/in-flight
        uploads and buffers are lost, uncommitted records replay.
        ``permanent`` removes the instance from the round-robin (the
        elastic-cluster fail-stop model) instead of restarting it."""
        self.loop.at(t, self._fail, inst, permanent)

    def _fail(self, i: int, permanent: bool = False) -> None:
        now = self.loop.now
        self._epoch[i] += 1
        for blob, _notes, _attempt in self._upload_q[i]:
            # queued blobs die with the lane (in-flight ones are counted
            # when their completion events observe the stale epoch)
            self.metrics.uploads_lost += 1
            self.metrics.uploads_lost_bytes += blob.size
        self._upload_q[i].clear()
        self._uploads_inflight[i] = 0
        if self.obs is not None:
            self.obs.mark(f"crash:i{i}", now)
        if permanent:
            self.active[i] = False
        replay = self.coordinators[i].fail_and_restart(now)
        for key in [k for k in self._arrivals if k[0] == i]:
            self._arrivals[key].clear()   # buffered records were lost
        self.metrics.records_replayed += len(replay)
        for k, rec in enumerate(replay):
            self.submit(now + (k + 1) * 1e-6, rec)

    # -- driver ------------------------------------------------------------
    def start(self) -> None:
        """Arm the periodic commit/retention timers without running the
        loop. Idempotent. Callers that drive the clock incrementally
        (``loop.run(until=...)`` — e.g. the training input pipeline in
        ``repro_torch.train_input``) need the commit cadence armed up front;
        otherwise, under exactly-once, nothing becomes visible until the
        sources fully drain."""
        if self._started:
            return
        self._started = True
        ci = self.ecfg.commit_interval_s
        if ci:
            self.loop.after(ci, self._commit_tick, ci)
        rs = self.ecfg.retention_sweep_s
        if rs:
            self.loop.after(rs, self._retention_tick, rs)

    def run(self, until: Optional[float] = None) -> ShuffleMetrics:
        """Run the event loop to completion (all submitted records
        delivered, all commits finished) and return the metrics."""
        self.start()
        self.loop.run(until)
        if self.cluster is not None:
            self.cluster.finalize(self.loop.now)
        # storage-cost correctness: fold still-live objects into the
        # byte·seconds integral so cost_usd(explicit_storage=True) is
        # exact even when nothing expired within the run
        self.store.accrue_storage(self.loop.now)
        self.metrics.makespan_s = self._t_done
        if self.obs is not None:
            self.obs.finalize_run(self)
        return self.metrics
