"""Seeded runs of both engines: the JAX package's (``repro.core``,
``repro.obs``, ``repro.cluster``) and the port's copy (``repro_torch``),
on the same configuration and seed, compared with ``==`` and no
tolerance: the same code on the same numpy gives the same floats.

    PYTHONPATH=src python -m pytest -q tests/test_torch_engine.py

Each run compares ``engine.out`` (per partition, every record's key,
value, timestamp and headers, in delivery order), ``metrics.summary``,
the whole ``ShuffleMetrics`` (every latency sample), the store's stats,
each distributed cache's and its members' stats, and the batchers',
debatchers' and strategy's counters. The runs:

* ``simulate_async(SimConfig(), scale=0.001)``, exactly-once off and on,
  record by record and in ``RecordBatch``es of 256;
* each registered strategy (``STRATEGIES``) on the strategy benchmark's
  geometry (six instances, Zipf 1.2 keys, the zonal express store);
* on that geometry, each wire format, ``raw-v1`` and ``columnar-v2``,
  and ``obs=True``: the conservation report, the metrics registry's
  snapshot, the blob trace and the stage decomposition;
* ``simulate(SimConfig())``, the paper's analytical model: every
  ``SimResult`` field;
* ``simulate_elastic`` at the cluster tests' smallest geometry (4
  instances, 12 partitions, 0.1% of the paper's load): the autoscaled
  spike, a worker crash and an AZ outage, each of which rebalances;
  the summary, ``ClusterStats``, the rebalances and scale decisions.
"""

import dataclasses
import importlib

import numpy as np
import pytest

PKGS = ("repro", "repro_torch")
SCALE = 0.001
#: the strategy benchmark's geometry (``benchmarks/strategies.py``) for
#: 1.5 s, as ``tests/test_strategies.py`` runs it
STRATEGY_CFG = dict(n_nodes=3, inst_per_node=2, n_az=3, duration_s=1.5,
                    commit_interval_s=0.5, seed=13)
STRATEGY_SCALE, STRATEGY_SKEW, STRATEGY_BATCH = 0.002, 1.2, 256
#: ``tests/test_cluster.py``'s ``elastic_cfg``
ELASTIC_CFG = dict(n_nodes=2, inst_per_node=2, partitions_factor=3, duration_s=3.0,
                   max_interval_s=0.25, commit_interval_s=0.25, seed=3)


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _records(out):
    return {p: [(bytes(r.key), bytes(r.value), r.timestamp_us, r.headers) for r in recs]
            for p, recs in sorted(out.items())}


def _state(eng) -> dict:
    asdict = dataclasses.asdict
    return {
        "out": _records(eng.out),
        "metrics": asdict(eng.metrics),
        "summary": eng.metrics.summary(eng.store),
        "store": asdict(eng.store.stats),
        "caches": [(asdict(c.stats), [asdict(m.stats) for m in c.members])
                   for c in eng.caches],
        "batchers": [asdict(b.stats) for b in eng.batchers],
        "debatchers": [asdict(d.stats) for d in eng.debatchers],
        "strategy": asdict(eng.strategy.stats),
        "now": eng.loop.now,
    }


def _same(jax_side: dict, port_side: dict) -> None:
    assert jax_side.keys() == port_side.keys()
    for k in jax_side:
        assert jax_side[k] == port_side[k], k


def _async(pkg, cfg_kw=None, **kw):
    sim = _mod(pkg, "core.simulator")
    eng, summary = sim.simulate_async(sim.SimConfig(**(cfg_kw or {})), **kw)
    assert summary == eng.metrics.summary(eng.store)
    return eng


@pytest.mark.parametrize("batch", [None, 256], ids=["records", "batches256"])
@pytest.mark.parametrize("exactly_once", [False, True], ids=["at_least_once", "exactly_once"])
def test_simulate_async_matches_jax(exactly_once, batch):
    jeng, eng = (_async(pkg, scale=SCALE, exactly_once=exactly_once,
                        ingest_batch_records=batch) for pkg in PKGS)
    assert eng.metrics.records_delivered > 30_000
    _same(_state(jeng), _state(eng))


@pytest.mark.parametrize("name", list(_mod("repro_torch", "core.strategy").STRATEGIES))
def test_each_strategy_matches_jax(name):
    def run(pkg):
        store = _mod(pkg, "core.stores").ExpressOneZoneStore(
            seed=STRATEGY_CFG["seed"], num_az=STRATEGY_CFG["n_az"])
        return _async(pkg, STRATEGY_CFG, scale=STRATEGY_SCALE, exactly_once=True,
                      key_skew=STRATEGY_SKEW, store=store,
                      ingest_batch_records=STRATEGY_BATCH, strategy=name)
    jeng, eng = run("repro"), run("repro_torch")
    assert type(eng.strategy).__name__ == type(jeng.strategy).__name__
    assert eng.metrics.records_delivered > 0
    _same(_state(jeng), _state(eng))


@pytest.mark.parametrize("wire_format", ["raw-v1", "columnar-v2"])
def test_each_wire_format_matches_jax(wire_format):
    jeng, eng = (_async(pkg, {**STRATEGY_CFG, "wire_format": wire_format},
                        scale=STRATEGY_SCALE, exactly_once=True, key_skew=STRATEGY_SKEW,
                        ingest_batch_records=STRATEGY_BATCH) for pkg in PKGS)
    assert eng.batchers[0].cfg.wire_format == wire_format
    _same(_state(jeng), _state(eng))


def test_observability_matches_jax():
    jeng, eng = (_async(pkg, STRATEGY_CFG, scale=STRATEGY_SCALE, exactly_once=True,
                        key_skew=STRATEGY_SKEW, ingest_batch_records=STRATEGY_BATCH,
                        obs=True) for pkg in PKGS)
    _same(_state(jeng), _state(eng))
    jrep, rep = jeng.obs.report, eng.obs.report
    assert rep.checked > 0 and not rep.violations
    assert [str(r) for r in rep.results] == [str(r) for r in jrep.results]
    assert rep.to_dict() == jrep.to_dict() and rep.summary() == jrep.summary()
    assert eng.obs.registry.snapshot() == jeng.obs.registry.snapshot()
    assert eng.obs.tracer.to_chrome() == jeng.obs.tracer.to_chrome()
    assert eng.obs.tracer.events
    assert eng.obs.stage_decomposition() == jeng.obs.stage_decomposition()


def test_simulate_matches_jax():
    jres, res = (_mod(pkg, "core.simulator").simulate(_mod(pkg, "core.simulator").SimConfig())
                 for pkg in PKGS)
    fields = [f.name for f in dataclasses.fields(res)]
    assert fields == [f.name for f in dataclasses.fields(jres)]
    for name in fields:
        a, b = getattr(jres, name), getattr(res, name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        else:
            assert a == b, name
    assert res.latency_p(95) == jres.latency_p(95)
    assert res.total_cost_at_1gib == jres.total_cost_at_1gib


@pytest.mark.parametrize("scenario", [{}, {"crash_at": 2.0}, {"az_outage_at": 1.0}],
                         ids=["autoscaled_spike", "crash", "az_outage"])
def test_simulate_elastic_matches_jax(scenario):
    out = []
    for pkg in PKGS:
        sim = _mod(pkg, "core.simulator")
        out.append(sim.simulate_elastic(sim.SimConfig(**ELASTIC_CFG), scale=SCALE, **scenario))
    (jeng, jcluster, js), (eng, cluster, s) = out
    assert s["rebalances"] >= 1 and s["lag_final"] == 0
    assert s == js
    _same(_state(jeng), _state(eng))
    asdict = dataclasses.asdict
    assert asdict(cluster.stats) == asdict(jcluster.stats)
    assert [asdict(e) for e in cluster.rebalancer.events] == \
        [asdict(e) for e in jcluster.rebalancer.events]
    assert [asdict(d) for d in cluster.autoscaler.decisions] == \
        [asdict(d) for d in jcluster.autoscaler.decisions]
    assert cluster.assignment() == jcluster.assignment()
