"""The port's shuffle-fed training loop (``repro_torch.train_input.loop``,
``train_shuffle_fed`` with ``ckpt=None``) against the JAX package's, on
deepseek-v2-lite SMOKE, its parameters JAX's own initial ones carried
over by ``interop.params_from_jax`` (``loop.init_model`` swapped).

    PYTHONPATH=src python -m pytest -q tests/test_torch_shuffle_fed_loop.py

(a) No mesh, the plain step (2 microbatches, f32 compute), 8 steps fed by
    the faults-and-outage engine of ``tests/test_train_input.py``: the
    trained steps and every ``input_stats`` counter equal, every loss
    within ``LOSS_RTOL`` of JAX's (the bound of
    ``test_train_step_matches_jax``; no step drifts past it).
(b) The benchmark's mesh (pod 2 x data 2 x model 2; shuffle ``blob``,
    capacity factor 2.0) with the ``blob`` and the ``blob_int8``
    gradient sync, 4 steps of the benchmark's stream (batch 8 of 32) fed
    by its faulty elastic engine, against JAX's on 8 host devices (one
    subprocess, started with the module so that it overlaps the rest):
    the same checks, step 0's loss within ``LOSS_RTOL``, later ones
    within ``MESH_RTOL`` (``LOSS_RTOL`` for the exact sync, 1e-3 for
    int8, whose losses drift from step 1 on); the real mesh's ``input_spec_report`` and
    ``validate_device_batch`` report equal the port's. Two microbatches:
    with one, JAX 0.9's SPMD partitioner aborts on the sharded batch.
(c) ``crash_at_step`` gives ``crashed`` and JAX's trained prefix.
(d) ``resume=True`` without a checkpointer is refused with JAX's
    ``ValueError`` and message (the resume path itself:
    ``tests/test_torch_shuffle_fed_resume.py``).
(e) The four CI gates of ``.github/workflows/ci.yml`` that need no
    checkpoint, on the port alone at the benchmark's ``--quick``
    settings (``benchmarks/train_input.py``): the loss decreasing, no
    batch skipped or duplicated, the input specs valid, overlap >= 0.5.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.models import lm as jlm
from repro.models.common import init_params as jinit_params
from repro.train_input import TokenStreamConfig as JStream
from repro.train_input import train_shuffle_fed as jtrain_shuffle_fed
from repro.training import OptConfig as JOptConfig
from repro.training import TrainConfig as JTrainConfig
from repro.training import make_train_step as jmake_train_step
from repro_torch.configs import get_config
from repro_torch.interop import params_from_jax
from repro_torch.launch.engine import faulty_elastic_engine
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.shuffle.api import ShuffleConfig
from repro_torch.train_input import (ShuffleFedInput, TokenStreamConfig,
                                     input_spec_report, loop, lower_train_step,
                                     validate_device_batch)
from repro_torch.training import OptConfig, TrainConfig
# tests/test_train_input.py's engine with faults and an AZ outage, in
# either package
from test_torch_train_input import _outage_engine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "deepseek-v2-lite-16b"
LOSS_RTOL = 1e-5
# the losses after step 0 on the mesh: the exact sync holds LOSS_RTOL; the
# int8 sync is within two f32 ulps of JAX's (tests/test_torch_grad_sync.py),
# and an entry that quantizes the other way moves its parameter by a
# whole AdamW step, so from step 1 on its losses drift (2.1e-4 at most
# over the 4 steps, on the CPU)
MESH_RTOL = {"blob": LOSS_RTOL, "blob_int8": 1e-3}
COUNTERS = ("records_delivered", "bytes_delivered", "records_replayed", "engine_duplicates",
            "duplicate_rows_filtered", "skipped_rows", "requests", "prefetch_hits",
            "overlap_fraction")
OPT = dict(learning_rate=1e-3, warmup_steps=2, total_steps=8)
# benchmarks/train_input.py --quick, at the test mesh
BENCH_STEPS = 12
BENCH_STREAM = (8, 32, 0)
BENCH_OPT = dict(learning_rate=3e-3, warmup_steps=5, total_steps=BENCH_STEPS)
BENCH_SHUFFLE = dict(mode="blob", token_axes=("pod", "data", "model"),
                     expert_axes=("pod", "model"), capacity_factor=2.0)
BENCH_PIPE = {"step_interval_s": 0.05, "prefetch_steps": 2}
MESH_STEPS = 4
SYNCS = ("blob", "blob_int8")

JAX_MESH_RUN = """
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.cluster import ElasticCluster
from repro.configs import get_config
from repro.core import AsyncShuffleEngine, BlobShuffleConfig, EngineConfig
from repro.core.stores import ExpressOneZoneStore, FaultyStore
from repro.launch import make_test_mesh
from repro.models import lm
from repro.models.common import init_params
from repro.shuffle import ShuffleConfig
from repro.train_input import (ShuffleFedInput, TokenStreamConfig, input_spec_report,
                               train_shuffle_fed, validate_device_batch)
from repro.training import OptConfig, TrainConfig
folder, steps, syncs = sys.argv[1], int(sys.argv[2]), sys.argv[3].split(",")

def make_engine():
    # benchmarks/train_input.py's make_engine
    store = FaultyStore(ExpressOneZoneStore(seed=7, num_az=3), seed=11, transient_p=0.02)
    bcfg = BlobShuffleConfig(batch_bytes=4096, max_interval_s=0.02, num_partitions=9,
                             num_az=3)
    eng = AsyncShuffleEngine(bcfg, EngineConfig(commit_interval_s=0.15), n_instances=3,
                             store=store, seed=5, exactly_once=True)
    ElasticCluster(eng, mode="cooperative").az_outage_at(0.30, 1)
    return eng

cfg = dataclasses.replace(get_config(ARCH, smoke=True), compute_dtype=jnp.float32)
mesh = make_test_mesh(devices=8)
stream = TokenStreamConfig(cfg.vocab_size, *STREAM)
leaves = jax.tree.leaves(init_params(lm.param_defs(cfg), jax.random.key(0)))
np.savez(f"{folder}/params.npz", **{f"p{i}": np.asarray(l) for i, l in enumerate(leaves)})
out = {}
for sync in syncs:
    tcfg = TrainConfig(opt=OptConfig(learning_rate=3e-3, warmup_steps=5, total_steps=steps),
                       microbatches=2, shuffle=ShuffleConfig(**SHUFFLE), grad_sync=sync,
                       grad_sync_blob_bytes=1 << 16)
    r = train_shuffle_fed(cfg, tcfg, mesh, stream, steps=steps, engine_factory=make_engine,
                          pipeline_kwargs=PIPE)
    out[sync] = {"steps": r.steps, "losses": r.losses, "crashed": r.crashed,
                 "input_stats": r.input_stats, "offsets": r.pipeline.offsets()}
p3 = ShuffleFedInput(make_engine(), stream, steps=1, mesh=mesh, model_cfg=cfg,
                     step_interval_s=0.05)
p3.submit()
_, batch, _ = p3.next_batch()
out["validated"] = validate_device_batch(batch, cfg, p3.shape, mesh)
out["report"] = input_spec_report(cfg, p3.shape, mesh)
with open(f"{folder}/out.json", "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def jax_mesh_run(tmp_path_factory):
    """JAX's loop on pod 2 x data 2 x model 2 host devices, one run per
    sync, in a subprocess started with the module; the fixture's value
    waits for it and returns (initial parameter leaves, results)."""
    folder = tmp_path_factory.mktemp("shuffle_fed_mesh")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = (textwrap.dedent(JAX_MESH_RUN).replace("ARCH", repr(ARCH))
            .replace("*STREAM", f"*{BENCH_STREAM!r}").replace("**SHUFFLE", f"**{BENCH_SHUFFLE!r}")
            .replace("=PIPE", f"={BENCH_PIPE!r}"))
    proc = subprocess.Popen([sys.executable, "-c", code, str(folder), str(MESH_STEPS),
                             ",".join(SYNCS)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)

    def result():
        if not hasattr(result, "value"):
            log, _ = proc.communicate(timeout=600)
            assert proc.returncode == 0, log[-4000:]
            with open(folder / "out.json") as f:
                out = json.load(f)
            params = np.load(folder / "params.npz")
            result.value = [params[f"p{i}"] for i in range(len(params.files))], out
        return result.value
    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _cfgs():
    return (dataclasses.replace(jget_config(ARCH, smoke=True), compute_dtype=jnp.float32),
            dataclasses.replace(get_config(ARCH, smoke=True), compute_dtype=torch.float32))


@pytest.fixture(scope="module")
def jax_plain():
    """JAX's plain step, jitted once, its initial parameters, and its
    loop's result over 8 steps with no mesh."""
    jcfg, _ = _cfgs()
    step = jax.jit(jmake_train_step(jcfg, JTrainConfig(opt=JOptConfig(**OPT), microbatches=2)))
    jparams = jinit_params(jlm.param_defs(jcfg), jax.random.key(0))
    res = jtrain_shuffle_fed(jcfg, None, None, JStream(jcfg.vocab_size, 4, 16, 0), steps=8,
                             engine_factory=lambda: _outage_engine("repro"), step_fn=step)
    return step, jparams, res


def _carry(monkeypatch, params_tree):
    monkeypatch.setattr(loop, "init_model",
                        lambda cfg, seed, device: params_from_jax(cfg, params_tree,
                                                                  device=device))


def _same_run(res, want_steps, want_losses, want_stats, step0_rtol, rtol):
    assert res.steps == want_steps and not res.crashed
    assert {k: res.input_stats[k] for k in COUNTERS} == {k: want_stats[k] for k in COUNTERS}
    np.testing.assert_allclose(res.losses[:1], want_losses[:1], rtol=step0_rtol)
    np.testing.assert_allclose(res.losses, want_losses, rtol=rtol)
    assert res.pipeline.offsets() == {}       # no checkpoint, no commit


def test_the_plain_loop_matches_jax(monkeypatch, jax_plain):
    _, jparams, jres = jax_plain
    _, cfg = _cfgs()
    _carry(monkeypatch, jparams)
    res = loop.train_shuffle_fed(cfg, TrainConfig(opt=OptConfig(**OPT), microbatches=2), None,
                                 TokenStreamConfig(cfg.vocab_size, 4, 16, 0), steps=8,
                                 engine_factory=lambda: _outage_engine("repro_torch"),
                                 device="cpu")
    _same_run(res, jres.steps, jres.losses, jres.input_stats, LOSS_RTOL, LOSS_RTOL)
    assert res.steps == list(range(8)) and res.start_step == 0
    assert res.input_stats["prefetch_hits"] >= 4


@pytest.mark.parametrize("sync", SYNCS)
def test_the_mesh_loop_matches_jax(monkeypatch, jax_mesh_run, sync):
    leaves, out = jax_mesh_run()
    jcfg, cfg = _cfgs()
    treedef = jax.tree.structure(jinit_params(jlm.param_defs(jcfg), jax.random.key(0)))
    _carry(monkeypatch, jax.tree.unflatten(treedef, leaves))
    mesh = make_test_mesh(devices=8)
    tcfg = TrainConfig(opt=OptConfig(learning_rate=3e-3, warmup_steps=5, total_steps=MESH_STEPS),
                       microbatches=2, shuffle=ShuffleConfig(**BENCH_SHUFFLE), grad_sync=sync,
                       grad_sync_blob_bytes=1 << 16)
    stream = TokenStreamConfig(cfg.vocab_size, *BENCH_STREAM)
    factory = lambda: faulty_elastic_engine()[0]                     # noqa: E731
    res = loop.train_shuffle_fed(cfg, tcfg, mesh, stream, steps=MESH_STEPS,
                                 engine_factory=factory, pipeline_kwargs=BENCH_PIPE,
                                 device="cpu")
    want = out[sync]
    _same_run(res, want["steps"], want["losses"], want["input_stats"], LOSS_RTOL,
              MESH_RTOL[sync])
    assert {str(k): v for k, v in res.pipeline.offsets().items()} == want["offsets"]
    # the real 8-device mesh's report and validated batch
    pipe = ShuffleFedInput(factory(), stream, steps=1, mesh=mesh, model_cfg=cfg,
                           step_interval_s=0.05, device="cpu")
    pipe.submit()
    _, batch, _ = pipe.next_batch()
    assert validate_device_batch(batch, cfg, pipe.shape, mesh, device="cpu") == \
        out["validated"] == out["report"] == input_spec_report(cfg, pipe.shape, mesh)


def test_a_crash_keeps_jax_s_trained_prefix(monkeypatch, jax_plain):
    step, jparams, _ = jax_plain
    jcfg, cfg = _cfgs()
    jres = jtrain_shuffle_fed(jcfg, None, None, JStream(jcfg.vocab_size, 4, 16, 0), steps=8,
                              engine_factory=lambda: _outage_engine("repro"), step_fn=step,
                              crash_at_step=3)
    _carry(monkeypatch, jparams)
    res = loop.train_shuffle_fed(cfg, TrainConfig(opt=OptConfig(**OPT), microbatches=2), None,
                                 TokenStreamConfig(cfg.vocab_size, 4, 16, 0), steps=8,
                                 engine_factory=lambda: _outage_engine("repro_torch"),
                                 crash_at_step=3, device="cpu")
    assert res.crashed and jres.crashed
    assert res.steps == jres.steps == [0, 1, 2]
    np.testing.assert_allclose(res.losses, jres.losses, rtol=LOSS_RTOL)
    # the crash came after step 3's batch was fetched, before its step
    assert res.input_stats["requests"] == jres.input_stats["requests"] == 4


def test_resume_without_a_checkpointer_is_refused_as_in_jax():
    _, cfg = _cfgs()
    stream = TokenStreamConfig(cfg.vocab_size, 4, 16, 0)
    with pytest.raises(ValueError) as got:
        loop.train_shuffle_fed(cfg, TrainConfig(), None, stream, steps=2, resume=True,
                               engine_factory=lambda: _outage_engine("repro_torch"),
                               device="cpu")
    jcfg, _ = _cfgs()
    with pytest.raises(ValueError) as want:
        jtrain_shuffle_fed(jcfg, JTrainConfig(), None, JStream(jcfg.vocab_size, 4, 16, 0),
                           steps=2, engine_factory=lambda: _outage_engine("repro"),
                           resume=True)
    assert str(got.value) == str(want.value)


def test_the_checkpoint_free_ci_gates_hold_at_the_benchmark_s_settings():
    """``benchmarks/train_input.py --quick`` on the port: deepseek-v2-lite
    SMOKE (bf16 compute), the test mesh, 12 steps of 8 x 32 tokens from
    its faulty elastic engine, lr 3e-3 with 5 warmup steps, the blob
    shuffle and the int8 blob sync with 64 KiB blobs."""
    cfg = get_config(ARCH, smoke=True)
    mesh = make_test_mesh(devices=8)
    stream = TokenStreamConfig(cfg.vocab_size, *BENCH_STREAM)
    tcfg = TrainConfig(opt=OptConfig(**BENCH_OPT), shuffle=ShuffleConfig(**BENCH_SHUFFLE),
                       grad_sync="blob_int8", grad_sync_blob_bytes=1 << 16)
    factory = lambda: faulty_elastic_engine()[0]                     # noqa: E731
    base = loop.train_shuffle_fed(cfg, tcfg, mesh, stream, steps=BENCH_STEPS,
                                  engine_factory=factory, pipeline_kwargs=BENCH_PIPE,
                                  device="cpu")
    losses = base.losses
    assert float(np.mean(losses[-3:])) < float(np.mean(losses[:3])), losses
    timeline = base.steps
    assert set(range(BENCH_STEPS)) - set(timeline) == set()               # none skipped
    assert sum(n - 1 for n in np.unique(timeline, return_counts=True)[1] if n > 1) == 0
    assert base.input_stats["overlap_fraction"] >= 0.5
    p3 = ShuffleFedInput(factory(), stream, steps=1, mesh=mesh, model_cfg=cfg,
                         step_interval_s=0.05, device="cpu")
    p3.submit()
    _, batch, _ = p3.next_batch()
    report = validate_device_batch(batch, cfg, p3.shape, mesh, device="cpu")
    lower_train_step(cfg, tcfg, mesh, p3.shape, device="cpu")
    assert report == input_spec_report(cfg, p3.shape, mesh)
