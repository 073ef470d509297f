"""BlobShuffle's engine on the host, through the port's copy of the
engine layer (``repro_torch.core``, ``.obs``, ``.cluster``): numpy and
Python on a virtual clock, no tensor and no kernel.

Two runs, each gated on exactly-once delivery (every produced record
delivered once, in the partition its key maps to) and each returned as
one JSON-ready dict:

* ``paper_run``: the paper's deployment, ``SimConfig()`` (12 nodes x 2
  instances, 216 partitions, 3 AZs, 1 KiB records at 3.16 GiB/s
  offered), through ``simulate_async`` with exactly-once commits and the
  columnar ingest lane (``INGEST_BATCH_RECORDS``), at ``PAPER_SCALE``
  (1%) of the offered rate and the batch size for the simulator's 10
  virtual seconds: the scale of the JAX package's measured lane
  (``simulate_async``'s default), 331,350 records. The records it
  checks are generated from the very ``WorkloadConfig`` that
  ``simulate_async`` drives.
* ``faulty_elastic_run``: the training input's engine, built as the JAX
  package's training benchmark builds it: ``FaultyStore`` (2% transient
  errors) over the zonal ``ExpressOneZoneStore``, 9 partitions over 3
  instances, exactly-once, a cooperative ``ElasticCluster`` with AZ 1
  out at 0.30 s; fed ``ELASTIC_RECORDS`` ShuffleBench records over
  ``ELASTIC_SPAN_S``.

Latencies and makespans are virtual seconds, outputs of the engine's
model; ``wall_s`` is the host's clock. ``digest`` is ``records_digest``
of the delivered records.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import Counter
from typing import Dict, Iterable, List, Tuple

from repro_torch.cluster import ElasticCluster
from repro_torch.core import simulator
from repro_torch.core.batcher import BlobShuffleConfig
from repro_torch.core.engine import AsyncShuffleEngine, EngineConfig
from repro_torch.core.records import Record, default_partitioner
from repro_torch.core.simulator import SimConfig, simulate_async
from repro_torch.core.stores import ExpressOneZoneStore, FaultyStore
from repro_torch.core.workload import WorkloadConfig, drive, generate
from repro_torch.data.generator import shufflebench_records
from repro_torch.utils import stable_hash64

PAPER_SCALE = 0.01
INGEST_BATCH_RECORDS = 1024
ELASTIC_PARTITIONS = 9
ELASTIC_OUTAGE_S = 0.30
ELASTIC_RECORDS = 6000
ELASTIC_SPAN_S = 0.6


def _identity(rec: Record) -> Tuple:
    return bytes(rec.key), bytes(rec.value), rec.timestamp_us, rec.headers


def delivered_once(produced: Iterable[Record], out: Dict[int, List[Record]],
                   partitions: int) -> int:
    """Raises unless every produced record was delivered exactly once, in
    the partition of its key, and nothing else was; returns the count."""
    want: Dict[int, Counter] = {}
    for rec in produced:
        want.setdefault(default_partitioner(rec.key, partitions), Counter())[
            _identity(rec)] += 1
    n = 0
    for p in set(want) | set(out):
        got = Counter(map(_identity, out.get(p, ())))
        mine = want.get(p, Counter())
        if got != mine:
            missing, extra = mine - got, got - mine
            raise RuntimeError(
                f"partition {p}: {sum(missing.values())} produced records not "
                f"delivered, {sum(extra.values())} delivered beyond once or "
                f"never produced")
        n += sum(mine.values())
    return n


def records_digest(out: Dict[int, List[Record]]) -> int:
    """``stable_hash64`` of the delivered records, partitions in order and
    each partition's records in delivery order, a record standing as the
    8-byte BLAKE2b of its partition (u32), key, timestamp (u64) and
    value."""
    parts = []
    for p in sorted(out):
        head = p.to_bytes(4, "little")
        for rec in out[p]:
            parts.append(hashlib.blake2b(
                head + bytes(rec.key) + rec.timestamp_us.to_bytes(8, "little")
                + bytes(rec.value), digest_size=8).digest())
    return stable_hash64(b"".join(parts))


def paper_run(seed: int = 0) -> dict:
    """The paper's deployment through ``simulate_async``; the simulator's
    ``drive`` is wrapped for the call to keep the ``WorkloadConfig`` it
    builds, so the gate checks the records that were driven."""
    cfg = SimConfig(seed=seed)
    driven: List[WorkloadConfig] = []

    def drive_recorded(eng, wl, batch_records=None):
        driven.append(wl)
        drive(eng, wl, batch_records=batch_records)

    simulator.drive = drive_recorded
    try:
        t0 = time.perf_counter()
        eng, summary = simulate_async(cfg, scale=PAPER_SCALE, exactly_once=True,
                                      ingest_batch_records=INGEST_BATCH_RECORDS)
        wall = time.perf_counter() - t0
    finally:
        simulator.drive = drive
    (wl,) = driven
    produced = [rec for _, rec in generate(wl)]
    n = delivered_once(produced, eng.out, cfg.partitions)
    return {"run": "paper", "scale": PAPER_SCALE, "seed": seed, "nodes": cfg.n_nodes,
            "instances": cfg.n_inst, "partitions": cfg.partitions, "azs": cfg.n_az,
            "records_produced": len(produced), "records_delivered_once": n,
            "summary": summary, "store": dataclasses.asdict(eng.store.stats),
            "wall_s": wall, "digest": f"{records_digest(eng.out):016x}"}


def faulty_elastic_engine():
    """(engine, cluster, store), built as the training benchmark's
    engine factory: the zonal express tier behind mild fault injection,
    an elastic cluster with an AZ-1 outage mid-stream."""
    store = FaultyStore(ExpressOneZoneStore(seed=7, num_az=3), seed=11, transient_p=0.02)
    bcfg = BlobShuffleConfig(batch_bytes=4096, max_interval_s=0.02,
                             num_partitions=ELASTIC_PARTITIONS, num_az=3)
    eng = AsyncShuffleEngine(bcfg, EngineConfig(commit_interval_s=0.15), n_instances=3,
                             store=store, seed=5, exactly_once=True)
    cluster = ElasticCluster(eng, mode="cooperative")
    cluster.az_outage_at(ELASTIC_OUTAGE_S, 1)
    return eng, cluster, store


def submit_evenly(eng, records: List[Record], span_s: float) -> None:
    """Record i arrives at ``i * span_s / len(records)``."""
    dt = span_s / len(records)
    for i, rec in enumerate(records):
        eng.submit(i * dt, rec)


def faulty_elastic_run(seed: int = 0) -> dict:
    records = shufflebench_records(ELASTIC_RECORDS, seed=seed)
    eng, cluster, store = faulty_elastic_engine()
    t0 = time.perf_counter()
    submit_evenly(eng, records, ELASTIC_SPAN_S)
    metrics = eng.run()
    wall = time.perf_counter() - t0
    n = delivered_once(records, eng.out, ELASTIC_PARTITIONS)
    events = [e for e in cluster.rebalancer.events if not e.superseded]
    return {"run": "faulty_elastic", "seed": seed, "records_produced": len(records),
            "records_delivered_once": n, "summary": metrics.summary(store),
            "rebalances": len(events), "cluster": dataclasses.asdict(cluster.stats),
            "faults": dataclasses.asdict(store.faults), "store": dataclasses.asdict(store.stats),
            "wall_s": wall, "digest": f"{records_digest(eng.out):016x}"}

