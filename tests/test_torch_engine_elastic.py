"""The port's engine launcher (``repro_torch.launch.engine``) against the
JAX package's engine, and the columnar wire format as a property.

    PYTHONPATH=src python -m pytest -q tests/test_torch_engine_elastic.py

* The training input's faulty elastic engine, built in both packages as
  the JAX package's training benchmark builds it
  (``benchmarks/train_input.py``, ``make_engine``): ``FaultyStore`` with
  2% transient errors over ``ExpressOneZoneStore``, 9 partitions over 3
  instances, exactly-once, a cooperative ``ElasticCluster`` with AZ 1
  out at 0.30 s, fed the same ``shufflebench_records``. Equal outputs,
  metrics, ``ClusterStats`` and ``FaultStats`` (``==``), and every
  produced record delivered once.
* The launcher's two runs, as ``chip_smoke.py``'s ``engine`` phase runs
  them. The paper's deployment (``paper_run``: ``SimConfig()`` at 1% of
  the offered load, 331,350 records, exactly-once, ingest batches of
  1,024): the JAX package's summary and ``records_digest`` equal the
  port's, and the digest is ``PAPER_DIGEST`` (under numpy 2.0.2; the
  H100 machine's, under its numpy, is in ``PERF.md``).
* Hypothesis: random ``RecordBatch``es encode to the same ``columnar-v2``
  bytes in both packages, and decode back to their rows.
"""

import dataclasses

import pytest

from repro.cluster import ElasticCluster as JElasticCluster
from repro.core import (AsyncShuffleEngine as JEngine, BlobShuffleConfig as JConfig,
                        EngineConfig as JEngineConfig, ExpressOneZoneStore as JExpress,
                        FaultyStore as JFaulty, SimConfig as JSimConfig)
from repro.core.recordbatch import RecordBatch as JRecordBatch
from repro.core.records import Record as JRecord
from repro.core.formats import COLUMNAR_V2 as J_COLUMNAR_V2
from repro.core.simulator import simulate_async as jsimulate_async
from repro.data.generator import shufflebench_records as jshufflebench_records
from repro_torch.core.formats import COLUMNAR_V2, detect_format
from repro_torch.core.recordbatch import RecordBatch
from repro_torch.core.records import Record
from repro_torch.launch import engine as launcher

#: ``records_digest`` of the paper run at seed 0 (numpy 2.0.2)
PAPER_DIGEST = "a8ccd5a003a939a6"


def _jax_faulty_elastic():
    """``benchmarks/train_input.py``'s engine factory, in the JAX package."""
    store = JFaulty(JExpress(seed=7, num_az=3), seed=11, transient_p=0.02)
    bcfg = JConfig(batch_bytes=4096, max_interval_s=0.02, num_partitions=9, num_az=3)
    eng = JEngine(bcfg, JEngineConfig(commit_interval_s=0.15), n_instances=3,
                  store=store, seed=5, exactly_once=True)
    cluster = JElasticCluster(eng, mode="cooperative")
    cluster.az_outage_at(0.30, 1)
    return eng, cluster, store


def _records(out):
    return {p: [(bytes(r.key), bytes(r.value), r.timestamp_us) for r in recs]
            for p, recs in sorted(out.items())}


def test_the_faulty_elastic_engine_matches_jax():
    n = launcher.ELASTIC_RECORDS
    jrecs, recs = jshufflebench_records(n, seed=0), launcher.shufflebench_records(n, seed=0)
    assert [(r.key, r.value, r.timestamp_us) for r in recs] == \
        [(r.key, r.value, r.timestamp_us) for r in jrecs]
    jeng, jcluster, jstore = _jax_faulty_elastic()
    eng, cluster, store = launcher.faulty_elastic_engine()
    launcher.submit_evenly(jeng, jrecs, launcher.ELASTIC_SPAN_S)
    launcher.submit_evenly(eng, recs, launcher.ELASTIC_SPAN_S)
    jm, m = jeng.run(), eng.run()
    asdict = dataclasses.asdict
    assert _records(eng.out) == _records(jeng.out)
    assert asdict(m) == asdict(jm) and m.summary(store) == jm.summary(jstore)
    assert asdict(cluster.stats) == asdict(jcluster.stats)
    assert asdict(store.faults) == asdict(jstore.faults)
    assert asdict(store.stats) == asdict(jstore.stats)
    assert [asdict(e) for e in cluster.rebalancer.events] == \
        [asdict(e) for e in jcluster.rebalancer.events]
    # the run exercises what it is built for: faults, the outage's
    # rebalance and replay, and exactly-once delivery through them
    assert store.faults.transients > 0 and cluster.rebalancer.events
    assert cluster.stats.replayed_entries > 0
    assert launcher.delivered_once(recs, eng.out, launcher.ELASTIC_PARTITIONS) == n
    assert m.duplicates_delivered == 0


def test_delivered_once_refuses_a_lost_or_repeated_record():
    recs = launcher.shufflebench_records(40, value_bytes=16, seed=1)
    out = {}
    for r in recs:
        out.setdefault(launcher.default_partitioner(r.key, 3), []).append(r)
    assert launcher.delivered_once(recs, out, 3) == 40
    p = next(iter(out))
    for broken in ({**out, p: out[p][1:]}, {**out, p: out[p] + out[p][:1]}):
        with pytest.raises(RuntimeError, match=f"partition {p}"):
            launcher.delivered_once(recs, broken, 3)


def test_the_launcher_matches_jax_and_its_digest():
    """The launcher's paper run against the JAX engine's run of the same
    deployment, then its faulty elastic run."""
    jeng, jsummary = jsimulate_async(JSimConfig(), scale=launcher.PAPER_SCALE,
                                     exactly_once=True,
                                     ingest_batch_records=launcher.INGEST_BATCH_RECORDS)
    jdigest = f"{launcher.records_digest(jeng.out):016x}"
    jstore = dataclasses.asdict(jeng.store.stats)
    del jeng
    paper, elastic = launcher.paper_run(0), launcher.faulty_elastic_run(0)
    assert paper["records_produced"] == paper["records_delivered_once"] == 331_350
    assert paper["summary"] == jsummary and paper["store"] == jstore
    assert paper["digest"] == jdigest == PAPER_DIGEST
    assert (paper["instances"], paper["partitions"], paper["azs"]) == (24, 216, 3)
    assert elastic["run"] == "faulty_elastic" and elastic["rebalances"] >= 1
    assert elastic["records_delivered_once"] == launcher.ELASTIC_RECORDS


# ---------------------------------------------------------------------------
# columnar-v2, as a property
# ---------------------------------------------------------------------------

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

_FIELDS = st.tuples(
    # keys from a small pool or random; values runs of one byte (they
    # compress, so the framed encoding runs) or random (the raw fallback)
    st.one_of(st.sampled_from([b"k" * 8, b"hot-key1", b""]), st.binary(max_size=24)),
    st.one_of(st.builds(lambda b, n: bytes([b]) * n, st.integers(0, 255), st.integers(0, 96)),
              st.binary(max_size=96)),
    st.integers(min_value=0, max_value=2 ** 64 - 1))


@settings(max_examples=60, deadline=None, database=None)
@given(rows=st.lists(_FIELDS, max_size=40))
def test_columnar_v2_bytes_match_jax(rows):
    jbatch = JRecordBatch.from_records([JRecord(k, v, t) for k, v, t in rows])
    batch = RecordBatch.from_records([Record(k, v, t) for k, v, t in rows])
    wire = bytes(batch.serialize_rows())
    assert bytes(jbatch.serialize_rows()) == wire
    jblock = b"".join(bytes(c) for c in J_COLUMNAR_V2.encode_block([wire]))
    block = b"".join(bytes(c) for c in COLUMNAR_V2.encode_block([wire]))
    assert block == jblock
    back = detect_format(block).decode_block_batch(block)
    assert bytes(back.serialize_rows()) == wire
    assert [(bytes(r.key), bytes(r.value), r.timestamp_us) for r in back.to_records()] == \
        [(k, v, t) for k, v, t in rows]
