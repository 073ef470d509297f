"""Discrete-event simulator of the full BlobShuffle pipeline (paper §5).

Simulates at blob granularity (events: blob fill → PUT completion →
notification → GET / cache → debatch) with per-record latencies sampled
within each blob's fill window — this reproduces the paper's latency
distributions (Fig. 5) and all sweeps (Figs. 6–9) in seconds of CPU time
instead of hours of cluster time.

Throughput uses the calibrated capacity model (ad-hoc throughput method:
offered load above capacity, processed rate = capacity).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np

from repro_torch.core.analytical import ModelParams
from repro_torch.core.batcher import BlobShuffleConfig
from repro_torch.core.capacity import CapacityModel
from repro_torch.core.costs import (AwsPrices,
                              actual_batch_frac,
                              blobshuffle_cost_per_hour,
                              kafka_shuffle_cost_per_hour)
from repro_torch.core.engine import AsyncShuffleEngine, EngineConfig
from repro_torch.core.stores import BlobStore, LatencyModel, SimulatedS3
from repro_torch.core.workload import WorkloadConfig, drive, generate

MiB = 1024 ** 2
GiB = 1024 ** 3


@dataclasses.dataclass(frozen=True)
class SimConfig:
    n_nodes: int = 12
    inst_per_node: int = 2
    n_az: int = 3
    partitions_factor: int = 9          # partitions = factor × instances
    record_bytes: int = 1024
    batch_bytes: int = 16 * MiB
    max_interval_s: float = 5.0
    commit_interval_s: float = 30.0     # Kafka Streams default commit cadence
    duration_s: float = 540.0           # steady-state window (paper: 9 min)
    warmup_s: float = 60.0
    latency_samples_per_blob: int = 4
    cache_on_write: bool = True
    seed: int = 0
    offered_gib_s: float = 3.16         # load generators (3.24M rec/s × 1KiB)
    wire_format: str = "raw-v1"         # registered blob wire format

    @property
    def n_inst(self) -> int:
        return self.n_nodes * self.inst_per_node

    @property
    def partitions(self) -> int:
        return self.partitions_factor * self.n_inst


@dataclasses.dataclass
class SimResult:
    throughput_bytes_s: float
    shuffle_latencies: np.ndarray      # sampled per-record latencies
    put_latencies: np.ndarray
    get_latencies: np.ndarray
    puts_per_s: float
    gets_per_s: float
    notifications_per_s: float
    cache_reads_per_s: float
    mean_actual_batch: float
    s3_cost_per_hour: float            # at simulated throughput, 1h retention
    s3_cost_per_hour_at_1gib: float    # normalized to 1 GiB/s
    infra_cost_per_hour_at_1gib: float
    kafka_cost_per_hour_at_1gib: float

    def latency_p(self, q: float) -> float:
        return float(np.percentile(self.shuffle_latencies, q))

    @property
    def total_cost_at_1gib(self) -> float:
        return self.s3_cost_per_hour_at_1gib + self.infra_cost_per_hour_at_1gib


def simulate_async(cfg: SimConfig, *, engine_cfg: Optional[EngineConfig]
                   = None, scale: float = 0.01, exactly_once: bool = False,
                   key_skew: float = 0.5,
                   latency: Optional[LatencyModel] = None,
                   store: Optional[BlobStore] = None,
                   ingest_batch_records: Optional[int] = None,
                   strategy=None, obs=None
                   ) -> "tuple[AsyncShuffleEngine, dict]":
    """Measured (not modeled) run of a ``SimConfig`` workload through the
    event-driven engine, scaled down by ``scale`` in offered rate and
    batch size so the per-record simulation stays cheap. Returns the
    engine (for store/cache stats) and its metrics summary — the async
    counterpart of ``simulate``'s analytical percentiles.

    ``store`` swaps the storage backend (any ``BlobStore``: another
    tier, or a ``FaultyStore``-wrapped one for degraded-store runs);
    default is ``SimulatedS3`` with the calibrated ``latency`` model.

    ``ingest_batch_records`` switches the driver to the columnar ingest
    lane: records enter as ``RecordBatch`` micro-batches of that many
    consecutive arrivals (vectorized partition + binning in the Batcher)
    instead of one event per record.

    ``strategy`` selects a shuffle policy (None | registered name |
    ``ShuffleStrategy`` instance — see ``repro_torch.core.strategy``):
    "combining" pre-aggregates hot keys map-side, "push" places blobs
    destination-AZ-local, "merge" runs the two-round compactor.

    ``obs`` enables the observability layer (None | True | ObsConfig |
    Observability — see ``repro_torch.obs``); read it back as ``engine.obs``.
    """
    bcfg = BlobShuffleConfig(
        batch_bytes=max(int(cfg.batch_bytes * scale), 64 * 1024),
        max_interval_s=cfg.max_interval_s,
        num_partitions=cfg.partitions, num_az=cfg.n_az,
        cache_on_write=cfg.cache_on_write, wire_format=cfg.wire_format)
    wl = WorkloadConfig(
        arrival_rate=cfg.offered_gib_s * GiB * scale / cfg.record_bytes,
        duration_s=min(cfg.duration_s, 10.0),
        record_bytes=cfg.record_bytes, key_skew=key_skew, seed=cfg.seed)
    if store is None:
        store = SimulatedS3(latency=latency or LatencyModel(),
                            seed=cfg.seed)
    eng = AsyncShuffleEngine(
        bcfg, engine_cfg or EngineConfig(
            commit_interval_s=cfg.commit_interval_s),
        n_instances=cfg.n_inst, store=store, seed=cfg.seed,
        exactly_once=exactly_once, strategy=strategy, obs=obs)
    drive(eng, wl, batch_records=ingest_batch_records)
    metrics = eng.run()
    return eng, metrics.summary(store)


def simulate_elastic(cfg: SimConfig, *,
                     engine_cfg: Optional[EngineConfig] = None,
                     scale: float = 0.01, mode: str = "cooperative",
                     autoscale: bool = True, policy=None,
                     spike_factor: float = 3.0,
                     phases: Optional[List[tuple]] = None,
                     crash_at: Optional[float] = None,
                     crash_worker: str = "w1",
                     az_outage_at: Optional[float] = None,
                     az_outage: int = 0,
                     heartbeat_timeout_s: float = 0.25,
                     exactly_once: bool = True,
                     store: Optional[BlobStore] = None,
                     max_sim_s: float = 10.0,
                     strategy=None, obs=None
                     ) -> "tuple[AsyncShuffleEngine, object, dict]":
    """Elastic scenario through the cluster subsystem: phased offered
    load (default steady → ``spike_factor``× spike → steady, driving the
    autoscaler), plus optional worker crash and AZ outage. Returns
    (engine, cluster, summary) where the summary extends
    ``simulate_async``'s with elasticity metrics (workers, rebalances,
    partitions moved, replayed entries, infra $).

    ``phases`` overrides the load shape: a list of ``(rate_factor,
    duration_s)`` segments at the scaled base rate. Like
    ``simulate_async``, the per-record simulation clamps the scenario to
    ``max_sim_s`` seconds of virtual load — raise it explicitly for
    long-horizon scenarios.
    """
    from repro_torch.cluster import AutoscalePolicy, ElasticCluster
    bcfg = BlobShuffleConfig(
        batch_bytes=max(int(cfg.batch_bytes * scale), 64 * 1024),
        max_interval_s=cfg.max_interval_s,
        num_partitions=cfg.partitions, num_az=cfg.n_az,
        cache_on_write=cfg.cache_on_write, wire_format=cfg.wire_format)
    base_rate = cfg.offered_gib_s * GiB * scale / cfg.record_bytes
    duration = min(cfg.duration_s, max_sim_s)
    if phases is None:
        phases = [(1.0, 0.3 * duration), (spike_factor, 0.4 * duration),
                  (1.0, 0.3 * duration)]
    if store is None:
        store = SimulatedS3(latency=LatencyModel(), seed=cfg.seed)
    eng = AsyncShuffleEngine(
        bcfg, engine_cfg or EngineConfig(
            commit_interval_s=min(cfg.commit_interval_s, 1.0)),
        n_instances=cfg.n_inst, store=store, seed=cfg.seed,
        exactly_once=exactly_once, strategy=strategy, obs=obs)
    cluster = ElasticCluster(
        eng, mode=mode, heartbeat_timeout_s=heartbeat_timeout_s,
        autoscale=(policy or AutoscalePolicy()) if autoscale else None)
    t0 = 0.0
    for k, (factor, dur) in enumerate(phases):
        wl = WorkloadConfig(arrival_rate=base_rate * factor,
                            duration_s=dur,
                            record_bytes=cfg.record_bytes,
                            seed=cfg.seed + k)
        for t, rec in generate(wl):
            eng.submit(t0 + t, rec)
        t0 += dur
    if crash_at is not None:
        cluster.crash_worker_at(crash_at, crash_worker)
    if az_outage_at is not None:
        cluster.az_outage_at(az_outage_at, az_outage)
    metrics = eng.run()
    s = metrics.summary(store)
    events = [e for e in cluster.rebalancer.events if not e.superseded]
    s.update({
        "workers_final": float(len(cluster.membership.alive())),
        "rebalances": float(len(events)),
        "partitions_moved": float(cluster.rebalancer.partitions_moved),
        "replayed_entries": float(cluster.stats.replayed_entries),
        "handoff_duplicates_dropped":
            float(cluster.stats.handoff_duplicates_dropped),
        "lag_final": float(cluster.total_lag()),
        "infra_cost_usd": cluster.infra_cost_usd(),
        "scale_decisions": float(
            len(cluster.autoscaler.decisions) if cluster.autoscaler
            else 0),
    })
    return eng, cluster, s


def simulate(cfg: SimConfig, capacity: Optional[CapacityModel] = None,
             latency: Optional[LatencyModel] = None) -> SimResult:
    cap = capacity or CapacityModel()
    lat = latency or LatencyModel()
    rng = np.random.default_rng(cfg.seed)

    # --- steady-state throughput: ad-hoc = min(offered, capacity) -------
    tput = min(cfg.offered_gib_s * GiB,
               cap.max_throughput(cfg.batch_bytes / MiB, cfg.partitions,
                                  cfg.n_inst, cfg.n_az))
    b_inst = tput / cfg.n_inst                      # bytes/s per instance
    fill_rate_per_az = b_inst / cfg.n_az            # bytes/s per AZ buffer

    # --- blob-level event simulation -----------------------------------
    t_end = cfg.duration_s
    shuffle_lat: List[float] = []
    put_lat: List[float] = []
    get_lat: List[float] = []
    n_blobs = 0
    n_gets = 0
    n_notes = 0
    n_cache_reads = 0
    blob_sizes: List[int] = []
    parts_per_az = max(cfg.partitions // cfg.n_az, 1)

    # per (instance, target_az) buffer state advances deterministically;
    # we iterate blob completions instance-by-instance for the window.
    for inst in range(cfg.n_inst):
        my_az = inst % cfg.n_az
        for target_az in range(cfg.n_az):
            t = cfg.warmup_s + rng.uniform(0, 1)     # desynchronize
            next_commit = (math.floor(t / cfg.commit_interval_s) + 1) \
                * cfg.commit_interval_s
            while t < t_end:
                t_fill_full = cfg.batch_bytes / fill_rate_per_az
                # commits finalize early (Fig. 6g: actual < target)
                fill_end = t + min(t_fill_full, cfg.max_interval_s)
                if fill_end > next_commit:
                    fill_end = next_commit
                    next_commit += cfg.commit_interval_s
                fill_time = fill_end - t
                size = int(fill_rate_per_az * fill_time)
                if size <= 0:
                    t = fill_end + 1e-3
                    continue
                blob_sizes.append(size)
                n_blobs += 1
                tp = lat.sample_put(size, rng)
                put_lat.append(tp)
                # notifications: one per partition present in the blob
                n_notes += parts_per_az
                n_cache_reads += parts_per_az
                # cross-AZ consumers GET once (single-flight); same-AZ hits
                # the cache-on-write copy.
                crosses = target_az != my_az
                if crosses:
                    tg = lat.sample_get(size, rng)
                    get_lat.append(tg)
                    n_gets += 1
                else:
                    tg = 0.0005
                # sample record latencies: record arrives uniformly in the
                # fill window; waits (fill_end - arrival) + put + get
                for _ in range(cfg.latency_samples_per_blob):
                    wait = rng.uniform(0, fill_time)
                    shuffle_lat.append(wait + tp + tg + 0.01)
                t = fill_end
    window = t_end - cfg.warmup_s

    p = ModelParams(n_inst=cfg.n_inst, n_az=cfg.n_az,
                    rate=tput / cfg.record_bytes, s_rec=cfg.record_bytes,
                    s_batch=cfg.batch_bytes)
    frac = float(np.mean(blob_sizes)) / cfg.batch_bytes if blob_sizes else 1.0
    bs_cost = blobshuffle_cost_per_hour(p, actual_batch_frac=frac)
    # normalized to 1 GiB/s processing rate (paper Figs. 6h/6i/7)
    p1 = ModelParams(n_inst=cfg.n_inst, n_az=cfg.n_az,
                     rate=GiB / cfg.record_bytes, s_rec=cfg.record_bytes,
                     s_batch=cfg.batch_bytes)
    bs_cost_1g = blobshuffle_cost_per_hour(p1, actual_batch_frac=frac)
    prices = AwsPrices()
    node_cost = cfg.n_nodes * prices.ec2_r6in_xlarge_hour
    infra_1g = node_cost / (tput / GiB)
    kafka_1g = kafka_shuffle_cost_per_hour(p1)

    return SimResult(
        throughput_bytes_s=tput,
        shuffle_latencies=np.asarray(shuffle_lat),
        put_latencies=np.asarray(put_lat),
        get_latencies=np.asarray(get_lat),
        puts_per_s=n_blobs / window,
        gets_per_s=n_gets / window,
        notifications_per_s=n_notes / window,
        cache_reads_per_s=n_cache_reads / window,
        mean_actual_batch=frac,
        s3_cost_per_hour=bs_cost.s3_total,
        s3_cost_per_hour_at_1gib=bs_cost_1g.s3_total,
        infra_cost_per_hour_at_1gib=infra_1g,
        kafka_cost_per_hour_at_1gib=kafka_1g,
    )
