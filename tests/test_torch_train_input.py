"""The port's shuffle-fed training input (``repro_torch.train_input``
``tokens`` and ``ShuffleFedInput``) against the JAX package's, with no
model.

    PYTHONPATH=src python -m pytest -q tests/test_torch_train_input.py

* The token codec: ``step_tokens``, every key and value byte of
  ``step_records``, ``decode_record``, ``assemble_batch`` and
  ``reference_batch`` equal JAX's.
* The port's ``ShuffleFedInput`` over the port's engine against JAX's over
  JAX's engine, built from the same settings in each package: the served
  ``(step, batch, prefetched)`` triples, the counters (``requests``,
  ``prefetch_hits``, ``duplicate_rows``, ``late_rows``), the committed
  ``offsets()`` and the engine's delivery metrics are equal, for (a) the
  plain engine of ``tests/test_train_input.py``, (b) its engine with
  faults and an AZ outage, and (c) the training benchmark's faulty
  elastic engine (``repro_torch.launch.engine.faulty_elastic_engine``)
  at the card's stream: batch 4 of 4,096 tokens (16,388-byte records),
  12 steps.
* ``fast_forward`` to a committed step gives JAX's offsets and batches,
  and its refusals (a divergent manifest, a pipeline already consumed)
  and ``commit``'s carry JAX's messages.
* A mesh without ``model_cfg`` is refused; a ``StackedMesh`` puts the
  global batch as int32 tensors on the pipeline's device (the put over a
  ``ProcessGroupMesh``: ``tests/test_torch_pg_shuffle_fed.py``).
"""

import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.train_input import pipeline as jpipeline
from repro.train_input import tokens as jtokens
from repro_torch.launch import engine as launcher
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.train_input import pipeline, tokens

STREAMS = {
    "test": (997, 4, 16, 3),            # tests/test_train_input.py's STREAM
    "card": (102400, 4, 4096, 0),       # chip_smoke.py's: deepseek-v2-lite's vocab
    "bench": (102400, 8, 32, 0),        # benchmarks/train_input.py --quick
}


def _streams(name):
    args = STREAMS[name]
    return jtokens.TokenStreamConfig(*args), tokens.TokenStreamConfig(*args)


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _plain_engine(pkg, store=None):
    """``tests/test_train_input.py``'s ``_engine``, in package ``pkg``."""
    core, stores = _mod(pkg, "core"), _mod(pkg, "core.stores")
    bcfg = core.BlobShuffleConfig(batch_bytes=2048, max_interval_s=0.02,
                                  num_partitions=5, num_az=3)
    return core.AsyncShuffleEngine(
        bcfg, core.EngineConfig(commit_interval_s=0.05), n_instances=2,
        store=store or stores.SimulatedS3(seed=1), seed=2, exactly_once=True)


def _outage_engine(pkg):
    """``tests/test_train_input.py``'s engine with faults and an AZ outage."""
    stores = _mod(pkg, "core.stores")
    store = stores.FaultyStore(stores.ExpressOneZoneStore(seed=5, num_az=3), seed=7,
                               transient_p=0.05)
    eng = _plain_engine(pkg, store=store)
    cluster = _mod(pkg, "cluster").ElasticCluster(eng, mode="cooperative")
    cluster.az_outage_at(0.12, 1)
    return eng


def _faulty_elastic_engine(pkg):
    """The training benchmark's engine factory: the port's launcher, and
    ``benchmarks/train_input.py``'s ``make_engine`` in the JAX package."""
    if pkg == "repro_torch":
        return launcher.faulty_elastic_engine()[0]
    core, stores = _mod(pkg, "core"), _mod(pkg, "core.stores")
    store = stores.FaultyStore(stores.ExpressOneZoneStore(seed=7, num_az=3), seed=11,
                               transient_p=0.02)
    bcfg = core.BlobShuffleConfig(batch_bytes=4096, max_interval_s=0.02,
                                  num_partitions=9, num_az=3)
    eng = core.AsyncShuffleEngine(bcfg, core.EngineConfig(commit_interval_s=0.15),
                                  n_instances=3, store=store, seed=5, exactly_once=True)
    _mod(pkg, "cluster").ElasticCluster(eng, mode="cooperative").az_outage_at(0.30, 1)
    return eng


# (engine factory, stream, steps, prefetch_steps)
SETTINGS = {
    "plain": (_plain_engine, "test", 6, 3),
    "faults_and_outage": (_outage_engine, "test", 8, 2),
    "faulty_elastic_card_stream": (_faulty_elastic_engine, "card", 12, 2),
}


def _same_batch(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


# -- the token codec -----------------------------------------------------

@pytest.mark.parametrize("stream", ["test", "bench", "card"])
@pytest.mark.parametrize("step", [0, 7])
def test_the_token_codec_matches_jax(stream, step):
    jcfg, cfg = _streams(stream)
    toks = tokens.step_tokens(cfg, step)
    assert toks.dtype == np.int32
    assert toks.tobytes() == jtokens.step_tokens(jcfg, step).tobytes()
    jrecs = jtokens.step_records(jcfg, step).to_records()
    recs = tokens.step_records(cfg, step).to_records()
    assert [(bytes(r.key), bytes(r.value), r.timestamp_us) for r in recs] == \
        [(bytes(r.key), bytes(r.value), r.timestamp_us) for r in jrecs]
    assert all(len(r.value) == cfg.record_value_bytes for r in recs)
    rows = {}
    for rec, jrec in zip(recs, jrecs):
        s, r, vals = tokens.decode_record(rec)
        js, jr, jvals = jtokens.decode_record(jrec)
        assert (s, r) == (js, jr) == (step, r)
        assert vals.dtype == jvals.dtype and vals.tobytes() == jvals.tobytes()
        rows[r] = vals
    _same_batch(tokens.assemble_batch(cfg, rows), jtokens.assemble_batch(jcfg, rows))
    _same_batch(tokens.reference_batch(cfg, step), jtokens.reference_batch(jcfg, step))
    _same_batch(tokens.assemble_batch(cfg, rows), tokens.reference_batch(cfg, step))


def test_an_incomplete_batch_is_refused_as_in_jax():
    jcfg, cfg = _streams("test")
    rows = {0: tokens.step_tokens(cfg, 0)[0]}
    with pytest.raises(ValueError) as got:
        tokens.assemble_batch(cfg, rows)
    with pytest.raises(ValueError) as want:
        jtokens.assemble_batch(jcfg, rows)
    assert str(got.value) == str(want.value)


# -- the pipeline against JAX's ------------------------------------------

def _serve(pkg, setting):
    factory, stream, steps, prefetch = SETTINGS[setting]
    mod = jpipeline if pkg == "repro" else pipeline
    cfg = _streams(stream)[pkg == "repro_torch"]
    pipe = mod.ShuffleFedInput(factory(pkg), cfg, steps=steps, prefetch_steps=prefetch,
                               step_interval_s=0.05)
    pipe.submit()
    served = [pipe.next_batch() for _ in range(steps)]
    with pytest.raises(StopIteration):
        pipe.next_batch()
    pipe.commit(steps)
    metrics = pipe.finish()
    counters = {k: getattr(pipe, k) for k in ("requests", "prefetch_hits", "duplicate_rows",
                                              "late_rows", "skipped_rows")}
    return served, counters, pipe.offsets(), dataclasses.asdict(metrics)


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_the_pipeline_serves_what_jax_serves(setting):
    served, counters, offsets, metrics = _serve("repro_torch", setting)
    jserved, jcounters, joffsets, jmetrics = _serve("repro", setting)
    steps = SETTINGS[setting][2]
    assert [(s, hit) for s, _, hit in served] == [(s, hit) for s, _, hit in jserved]
    assert [s for s, _, _ in served] == list(range(steps))
    cfg = _streams(SETTINGS[setting][1])[1]
    for (s, batch, _), (_, jbatch, _) in zip(served, jserved):
        _same_batch(batch, jbatch)
        _same_batch(batch, tokens.reference_batch(cfg, s))
    assert counters == jcounters
    assert offsets == joffsets and sum(offsets.values()) == steps * cfg.batch
    assert metrics == jmetrics


def test_the_settings_exercise_prefetch_replays_and_the_outage():
    """What each setting is there for: the double buffer hits; the faulty
    elastic engine replays records after the outage; the other faulty
    engine retries a put and holds records back over its outage (seconds
    of virtual latency); the card stream's records are 16,388 bytes."""
    _, counters, _, metrics = _serve("repro_torch", "faulty_elastic_card_stream")
    assert counters["prefetch_hits"] >= 6 and metrics["records_replayed"] > 0
    assert tokens.TokenStreamConfig(*STREAMS["card"]).record_value_bytes == 16388
    _, counters, _, metrics = _serve("repro_torch", "faults_and_outage")
    assert counters["prefetch_hits"] >= 3 and metrics["put_retries"] > 0
    assert max(metrics["record_latencies"]) > 1.0


# -- commit and fast_forward ---------------------------------------------

def _fresh(pkg, steps=6):
    mod = jpipeline if pkg == "repro" else pipeline
    pipe = mod.ShuffleFedInput(_plain_engine(pkg), _streams("test")[pkg == "repro_torch"],
                               steps=steps, step_interval_s=0.05)
    pipe.submit()
    return pipe


@pytest.mark.parametrize("resume_step", [2, 4])
def test_fast_forward_gives_jax_offsets(resume_step):
    out = {}
    for pkg in ("repro", "repro_torch"):
        first = _fresh(pkg)
        batches = [first.next_batch()[1] for _ in range(6)]
        first.commit(resume_step)
        second = _fresh(pkg)
        second.fast_forward(resume_step, first.offsets())
        rest = [second.next_batch() for _ in range(resume_step, 6)]
        for (s, batch, _), want in zip(rest, batches[resume_step:]):
            _same_batch(batch, want)
        out[pkg] = (first.offsets(), second.offsets(), second.skipped_rows,
                    [(s, hit) for s, _, hit in rest], batches)
    assert out["repro_torch"][:4] == out["repro"][:4]
    assert out["repro_torch"][2] == resume_step * 4
    for a, b in zip(out["repro_torch"][4], out["repro"][4]):
        _same_batch(a, b)


def _message(pkg, exc, fn):
    with pytest.raises(exc) as got:
        fn(_fresh(pkg))
    return str(got.value)


@pytest.mark.parametrize("case", ["divergent_manifest", "consumed", "commit_ahead"])
def test_refusals_carry_jax_messages(case):
    def divergent(p):
        p.fast_forward(4, {0: 9999})

    def consumed(p):
        p.next_batch()
        p.fast_forward(2)

    def commit_ahead(p):
        p.next_batch()
        p.commit(3)
    exc, fn = {"divergent_manifest": (RuntimeError, divergent),
               "consumed": (RuntimeError, consumed),
               "commit_ahead": (ValueError, commit_ahead)}[case]
    assert _message("repro_torch", exc, fn) == _message("repro", exc, fn)


# -- the put ---------------------------------------------------------------

def test_a_mesh_without_model_cfg_is_refused():
    with pytest.raises(ValueError, match="without model_cfg"):
        pipeline.ShuffleFedInput(_plain_engine("repro_torch"), _streams("test")[1], steps=1,
                                 mesh=make_test_mesh(devices=8), device="cpu")


def test_a_stacked_mesh_puts_the_global_batch_on_the_device():
    from repro_torch.configs import get_config
    cfg = get_config("deepseek-v2-lite-16b", smoke=True)
    stream = tokens.TokenStreamConfig(cfg.vocab_size, 4, 16, 0)
    pipe = pipeline.ShuffleFedInput(_plain_engine("repro_torch"), stream, steps=2,
                                    mesh=make_test_mesh(devices=8), model_cfg=cfg,
                                    device="cpu", step_interval_s=0.05)
    pipe.submit()
    for s in range(2):
        got, batch, _ = pipe.next_batch()
        want = tokens.reference_batch(stream, s)
        assert got == s and sorted(batch) == ["labels", "tokens"]
        for k, t in batch.items():
            assert isinstance(t, torch.Tensor) and t.dtype == torch.int32
            assert t.device == torch.device("cpu")
            assert t.numpy().tobytes() == want[k].tobytes()
    assert pipe.shape.global_batch == 4 and pipe.shape.seq_len == 16
    assert {k: str(s.spec) for k, s in pipe.shardings.items()} == {
        "tokens": "PartitionSpec(('pod', 'data'), None)",
        "labels": "PartitionSpec(('pod', 'data'), None)"}
