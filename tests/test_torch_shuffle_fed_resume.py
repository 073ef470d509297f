"""The resume path of the port's shuffle-fed training loop
(``repro_torch.train_input.loop.train_shuffle_fed`` with a checkpointer)
and its launcher (``repro_torch.launch.shuffle_train``), against itself
and against the JAX package's loop, on deepseek-v2-lite SMOKE.

    PYTHONPATH=src python -m pytest -q tests/test_torch_shuffle_fed_resume.py

(a) The port against itself, exactly: a crash followed by a resume gives
    the uninterrupted run's steps and losses (``==``), its final
    parameters and its last manifest's blobs bit for bit; the resumed
    run starts at the last manifest and checks its offsets; the
    manifests' steps and ``extra`` are the uninterrupted run's. With no
    mesh (the plain step, f32 compute, 8 steps, a manifest every 3, a
    crash at step 5) and on the test mesh with the ``blob_int8`` sync
    (the runs of (c)).
(b) Across packages: JAX's crashed run's store, its blobs moved into the
    port's ``SimulatedS3``, is resumed by the port: JAX's resume step and
    offsets, losses within ``LOSS_RTOL`` of JAX's uninterrupted run (on
    the mesh: the first resumed step within ``LOSS_RTOL``, the rest
    within ``MESH_RTOL``, ``tests/test_torch_shuffle_fed_loop.py``'s
    bounds), the port's manifests' ``extra`` JAX's; the port's
    uninterrupted run, from JAX's initial parameters carried over by
    ``interop.params_from_jax``, writes JAX's step-0 blobs byte for byte
    and JAX's ``extra`` in every manifest. With no mesh (JAX in this
    process) and on the test mesh with the ``blob_int8`` sync, 4 steps, a
    manifest every 2 and a crash at step 3 (JAX on 8 host devices, in a
    subprocess started with the module).
(c) The four CI resume gates of ``.github/workflows/ci.yml`` (the loss
    trajectory bit-identical, no batch skipped, none duplicated, the
    offsets equal to the manifest's) on the port alone at
    ``benchmarks/train_input.py --quick``'s settings: 12 steps of its
    faulty elastic engine, a manifest every 4, a crash at step 6, the
    crash lane's faulty ``SimulatedS3`` under ``TieredCheckpointStore``
    with synchronous uploads.
(d) The launcher across three ``--device cpu`` processes under their own
    temporary directories: uninterrupted, ``--crash-at 6``, ``--resume``.

A resume refuses a manifest whose offsets the engine's replay does not
give, and one from a store with no committed manifest raises JAX's
``RuntimeError`` with JAX's message.
"""

import dataclasses
import json
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.checkpoint import BlobCheckpointer as JBlobCheckpointer
from repro.checkpoint import TieredCheckpointStore as JTieredCheckpointStore
from repro.configs import get_config as jget_config
from repro.core.stores import SimulatedS3 as JSimulatedS3
from repro.models import lm as jlm
from repro.models.common import init_params as jinit_params
from repro.train_input import TokenStreamConfig as JStream
from repro.train_input import train_shuffle_fed as jtrain_shuffle_fed
from repro.training import OptConfig as JOptConfig
from repro.training import TrainConfig as JTrainConfig
from repro.training import make_train_step as jmake_train_step
from repro_torch.checkpoint import BlobCheckpointer, TieredCheckpointStore
from repro_torch.configs import get_config
from repro_torch.core.stores import FaultyStore, SimulatedS3
from repro_torch.interop import assert_same_bits, params_from_jax
from repro_torch.launch.engine import faulty_elastic_engine
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.shuffle.api import ShuffleConfig
from repro_torch.train_input import TokenStreamConfig, loop
from repro_torch.training import OptConfig, TrainConfig, make_train_step
# tests/test_train_input.py's engine with faults and an AZ outage, in
# either package
from test_torch_train_input import _outage_engine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "deepseek-v2-lite-16b"
LOSS_RTOL = 1e-5
MESH_RTOL = 1e-3          # the int8 sync (tests/test_torch_shuffle_fed_loop.py)
# (a), (b) with no mesh
PLAIN = dict(steps=8, ckpt_every=3, crash_at=5)
PLAIN_OPT = dict(learning_rate=1e-3, warmup_steps=2, total_steps=8)
PLAIN_STREAM = (4, 16, 0)
# (b) on the mesh
MESH = dict(steps=4, ckpt_every=2, crash_at=3)
# (c): benchmarks/train_input.py --quick, at the test mesh
BENCH = dict(steps=12, ckpt_every=4, crash_at=12 - 6)
BENCH_STREAM = (8, 32, 0)
BENCH_SHUFFLE = dict(mode="blob", token_axes=("pod", "data", "model"),
                     expert_axes=("pod", "model"), capacity_factor=2.0)
BENCH_PIPE = {"step_interval_s": 0.05, "prefetch_steps": 2}

JAX_MESH_RUN = """
import dataclasses, json, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.checkpoint import BlobCheckpointer, TieredCheckpointStore
from repro.cluster import ElasticCluster
from repro.configs import get_config
from repro.core import AsyncShuffleEngine, BlobShuffleConfig, EngineConfig
from repro.core.stores import ExpressOneZoneStore, FaultyStore, SimulatedS3
from repro.launch import make_test_mesh
from repro.models import lm
from repro.models.common import init_params
from repro.shuffle import ShuffleConfig
from repro.train_input import TokenStreamConfig, train_shuffle_fed
from repro.training import OptConfig, TrainConfig, make_train_step
folder = sys.argv[1]
steps, ckpt_every, crash_at = STEPS, EVERY, CRASH

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
tcfg = TrainConfig(opt=OptConfig(learning_rate=3e-3, warmup_steps=5, total_steps=steps),
                   microbatches=2, shuffle=ShuffleConfig(**SHUFFLE), grad_sync="blob_int8",
                   grad_sync_blob_bytes=1 << 16)
kw = dict(steps=steps, engine_factory=make_engine, ckpt_every=ckpt_every,
          step_fn=jax.jit(make_train_step(cfg, tcfg, mesh=mesh)), pipeline_kwargs=PIPE)

def ckpt(store):
    return BlobCheckpointer(TieredCheckpointStore(store), async_upload=False)

def extras(ck):
    return {n[4:12]: ck.manifest(int(n[4:12]))["extra"] for n in ck.store.manifests()}

out = {}
full = ckpt(SimulatedS3(seed=21))
r = train_shuffle_fed(cfg, tcfg, mesh, stream, ckpt=full, **kw)
out["full"] = {"steps": r.steps, "losses": r.losses, "extras": extras(full)}
s3 = SimulatedS3(seed=31)
crashed = ckpt(s3)
r = train_shuffle_fed(cfg, tcfg, mesh, stream, ckpt=crashed, crash_at_step=crash_at, **kw)
assert r.crashed
with open(f"{folder}/crashed_store.pkl", "wb") as f:
    pickle.dump({k: o.data for k, o in s3.objects.items()}, f)
r = train_shuffle_fed(cfg, tcfg, mesh, stream, ckpt=crashed, resume=True, **kw)
out["resumed"] = {"start_step": r.start_step, "steps": r.steps, "losses": r.losses,
                  "offsets_checked": r.offsets_checked,
                  "offsets": {str(k): v for k, v in r.pipeline.offsets().items()}}
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
    """JAX's loop on pod 2 x data 2 x model 2 host devices, uninterrupted,
    crashed and resumed, in a subprocess started with the module; the
    fixture's value waits for it and returns (initial parameter leaves,
    the crashed run's store objects, results)."""
    folder = tmp_path_factory.mktemp("shuffle_fed_resume_mesh")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = (textwrap.dedent(JAX_MESH_RUN).replace("ARCH", repr(ARCH))
            .replace("STEPS, EVERY, CRASH",
                     f"{MESH['steps']}, {MESH['ckpt_every']}, {MESH['crash_at']}")
            .replace("*STREAM", f"*{BENCH_STREAM!r}").replace("**SHUFFLE", f"**{BENCH_SHUFFLE!r}")
            .replace("=PIPE", f"={BENCH_PIPE!r}"))
    proc = subprocess.Popen([sys.executable, "-c", code, str(folder)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def result():
        if not hasattr(result, "value"):
            log, _ = proc.communicate(timeout=600)
            assert proc.returncode == 0, log[-4000:]
            with open(folder / "out.json") as f:
                out = json.load(f)
            with open(folder / "crashed_store.pkl", "rb") as f:
                objects = pickle.load(f)
            params = np.load(folder / "params.npz")
            result.value = ([params[f"p{i}"] for i in range(len(params.files))], objects,
                            out)
        return result.value
    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _cfgs():
    return (dataclasses.replace(jget_config(ARCH, smoke=True), compute_dtype=jnp.float32),
            dataclasses.replace(get_config(ARCH, smoke=True), compute_dtype=torch.float32))


def _ckpt(store, pkg="repro_torch"):
    if pkg == "repro":
        return JBlobCheckpointer(JTieredCheckpointStore(store), async_upload=False)
    return BlobCheckpointer(TieredCheckpointStore(store), async_upload=False)


def _extras(ckpt) -> dict:
    """Each committed manifest's ``extra``, by its step (``%08d``)."""
    return {n[4:12]: ckpt.manifest(int(n[4:12]))["extra"] for n in ckpt.store.manifests()}


def _blobs(ckpt, step: int) -> list:
    return [ckpt.store.get(e["blob"]) for e in ckpt.manifest(step)["leaves"]]


def _port_store(objects: dict) -> SimulatedS3:
    """The port's ``SimulatedS3`` holding another store's objects."""
    store = SimulatedS3(seed=31)
    for key, data in objects.items():
        store.put(key, data)
    return store


class _Run:
    """One port run of ``train_shuffle_fed``: its result, its checkpointer
    and the model its last step returned."""

    def __init__(self, cfg, tcfg, mesh, stream, ckpt, *, steps, ckpt_every, step,
                 engine_factory, pipeline_kwargs=None, **kw):
        self.model = None

        def recording_step(params, opt, batch):
            out = step(params, opt, batch)
            self.model = out[0]
            return out

        self.ckpt = ckpt
        self.res = loop.train_shuffle_fed(
            cfg, tcfg, mesh, stream, steps=steps, engine_factory=engine_factory, ckpt=ckpt,
            ckpt_every=ckpt_every, step_fn=recording_step, pipeline_kwargs=pipeline_kwargs,
            device="cpu", **kw)


def _lane(cfg, tcfg, mesh, stream, store_of, *, steps, ckpt_every, crash_at, **kw):
    """The crash lane: uninterrupted, crashed at ``crash_at``, resumed."""
    base = _Run(cfg, tcfg, mesh, stream, _ckpt(store_of("base")), steps=steps,
                ckpt_every=ckpt_every, **kw)
    ckpt = _ckpt(store_of("lane"))
    broken = _Run(cfg, tcfg, mesh, stream, ckpt, steps=steps, ckpt_every=ckpt_every,
                  crash_at_step=crash_at, **kw)
    resumed = _Run(cfg, tcfg, mesh, stream, ckpt, steps=steps, ckpt_every=ckpt_every,
                   resume=True, **kw)
    return base, broken, resumed


def _carried(jparams):
    """``loop.init_model`` drawing JAX's initial parameters."""
    def init_model(cfg, seed, device):
        return params_from_jax(cfg, jparams, device=device)
    return init_model


@pytest.fixture(scope="module")
def plain():
    """No mesh, the plain step: JAX's loop uninterrupted, crashed and
    resumed; the port's lane from JAX's initial parameters, and the port
    resuming JAX's crashed store."""
    jcfg, cfg = _cfgs()
    n = PLAIN["steps"]
    jstep = jax.jit(jmake_train_step(jcfg, JTrainConfig(opt=JOptConfig(**PLAIN_OPT),
                                                        microbatches=2)))
    jparams = jinit_params(jlm.param_defs(jcfg), jax.random.key(0))
    jkw = dict(steps=n, engine_factory=lambda: _outage_engine("repro"), step_fn=jstep,
               ckpt_every=PLAIN["ckpt_every"])
    jstream = JStream(jcfg.vocab_size, *PLAIN_STREAM)
    jfull = _ckpt(JSimulatedS3(seed=21), "repro")
    jbase = jtrain_shuffle_fed(jcfg, None, None, jstream, ckpt=jfull, **jkw)
    js3 = JSimulatedS3(seed=31)
    jlane = _ckpt(js3, "repro")
    jbroken = jtrain_shuffle_fed(jcfg, None, None, jstream, ckpt=jlane,
                                 crash_at_step=PLAIN["crash_at"], **jkw)
    crashed_objects = {k: o.data for k, o in js3.objects.items()}
    jresumed = jtrain_shuffle_fed(jcfg, None, None, jstream, ckpt=jlane, resume=True, **jkw)

    tcfg = TrainConfig(opt=OptConfig(**PLAIN_OPT), microbatches=2)
    kw = dict(step=make_train_step(cfg, tcfg), steps=n, ckpt_every=PLAIN["ckpt_every"],
              engine_factory=lambda: _outage_engine("repro_torch"))
    stream = TokenStreamConfig(cfg.vocab_size, *PLAIN_STREAM)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, "init_model", _carried(jax.tree.map(np.asarray, jparams)))
        lane = _lane(cfg, tcfg, None, stream, lambda _: SimulatedS3(seed=31),
                     crash_at=PLAIN["crash_at"], **kw)
        from_jax = _Run(cfg, tcfg, None, stream, _ckpt(_port_store(crashed_objects)),
                        resume=True, **kw)
    return {"jax": (jbase, jbroken, jresumed, jfull, crashed_objects), "lane": lane,
            "from_jax": from_jax, "expect": (PLAIN["crash_at"], PLAIN["ckpt_every"]),
            "first_rtol": LOSS_RTOL, "rtol": LOSS_RTOL}


@pytest.fixture(scope="module")
def bench():
    """(c)'s crash lane on the port: the benchmark's settings, each run's
    checkpoints in the crash lane's faulty ``SimulatedS3``."""
    cfg = get_config(ARCH, smoke=True)
    tcfg = TrainConfig(opt=OptConfig(learning_rate=3e-3, warmup_steps=5,
                                     total_steps=BENCH["steps"]),
                       shuffle=ShuffleConfig(**BENCH_SHUFFLE), grad_sync="blob_int8",
                       grad_sync_blob_bytes=1 << 16)
    mesh = make_test_mesh(devices=8)
    seeds = {"base": (21, 23), "lane": (31, 33)}

    def store_of(run):
        seed, fault_seed = seeds[run]
        return FaultyStore(SimulatedS3(seed=seed), seed=fault_seed, transient_p=0.05)

    lane = _lane(cfg, tcfg, mesh, TokenStreamConfig(cfg.vocab_size, *BENCH_STREAM), store_of,
                 step=make_train_step(cfg, tcfg, mesh=mesh), steps=BENCH["steps"],
                 ckpt_every=BENCH["ckpt_every"], crash_at=BENCH["crash_at"],
                 engine_factory=lambda: faulty_elastic_engine()[0],
                 pipeline_kwargs=BENCH_PIPE)
    return {"lane": lane, "expect": (BENCH["crash_at"], BENCH["ckpt_every"])}


@pytest.fixture(scope="module")
def mesh(jax_mesh_run):
    """(b) on the mesh: the port's uninterrupted run from JAX's initial
    parameters, and the port resuming JAX's crashed store."""
    leaves, crashed_objects, out = jax_mesh_run()
    jcfg, cfg = _cfgs()
    treedef = jax.tree.structure(jinit_params(jlm.param_defs(jcfg), jax.random.key(0)))
    mesh = make_test_mesh(devices=8)
    tcfg = TrainConfig(opt=OptConfig(learning_rate=3e-3, warmup_steps=5,
                                     total_steps=MESH["steps"]),
                       microbatches=2, shuffle=ShuffleConfig(**BENCH_SHUFFLE),
                       grad_sync="blob_int8", grad_sync_blob_bytes=1 << 16)
    kw = dict(step=make_train_step(cfg, tcfg, mesh=mesh), steps=MESH["steps"],
              ckpt_every=MESH["ckpt_every"], engine_factory=lambda: faulty_elastic_engine()[0],
              pipeline_kwargs=BENCH_PIPE)
    stream = TokenStreamConfig(cfg.vocab_size, *BENCH_STREAM)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, "init_model", _carried(jax.tree.unflatten(treedef, leaves)))
        base = _Run(cfg, tcfg, mesh, stream, _ckpt(SimulatedS3(seed=21)), **kw)
        from_jax = _Run(cfg, tcfg, mesh, stream, _ckpt(_port_store(crashed_objects)),
                        resume=True, **kw)
    return {"base": base, "from_jax": from_jax, "crashed_objects": crashed_objects,
            "out": out, "first_rtol": LOSS_RTOL, "rtol": MESH_RTOL}


# ---------------------------------------------------------------------------
# (a) the port against itself
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["plain", "bench"])
def test_a_crash_and_resume_equal_the_uninterrupted_run(request, case):
    base, broken, resumed = request.getfixturevalue(case)["lane"]
    crash_at, every = request.getfixturevalue(case)["expect"]
    steps = len(base.res.steps)
    start = crash_at // every * every
    assert base.res.steps == list(range(steps)) and not base.res.crashed
    assert broken.res.crashed and broken.res.steps == list(range(crash_at))
    assert not broken.res.offsets_checked and broken.res.start_step == 0
    assert resumed.res.start_step == start and resumed.res.offsets_checked
    assert not resumed.res.crashed and resumed.res.steps == list(range(start, steps))
    assert broken.res.losses[:start] + resumed.res.losses == base.res.losses
    for (name, got), (_, want) in zip(resumed.model.named_parameters(),
                                      base.model.named_parameters()):
        assert_same_bits(got.detach(), want.detach())
    # the last manifest (parameters, moments, count) is the same bytes
    assert _blobs(resumed.ckpt, steps) == _blobs(base.ckpt, steps)
    # the manifests: the uninterrupted run's steps and extra
    want = sorted({0, *range(every, steps + 1, every), steps})
    assert [int(s) for s in _extras(base.ckpt)] == want
    assert _extras(resumed.ckpt) == _extras(base.ckpt)
    assert _extras(base.ckpt)[f"{0:08d}"] == {"next_step": 0, "offsets": {}}
    for s, extra in _extras(base.ckpt).items():
        assert extra["next_step"] == int(s)
    assert {str(p): n for p, n in resumed.res.pipeline.offsets().items()} == \
        _extras(base.ckpt)[f"{steps:08d}"]["offsets"]


# ---------------------------------------------------------------------------
# (b) across packages
# ---------------------------------------------------------------------------

def test_the_plain_port_resumes_jax_s_crashed_run(plain):
    jbase, jbroken, jresumed, jfull, _ = plain["jax"]
    res = plain["from_jax"].res
    assert jbroken.crashed and jresumed.offsets_checked
    assert res.start_step == jresumed.start_step == 3 and res.offsets_checked
    assert res.steps == jresumed.steps
    assert res.pipeline.offsets() == jresumed.pipeline.offsets()
    np.testing.assert_allclose(res.losses, jbase.losses[res.start_step:], rtol=LOSS_RTOL)
    # the manifests the port wrote into JAX's store carry JAX's extra
    assert _extras(plain["from_jax"].ckpt) == _extras(jfull)


def test_the_mesh_port_resumes_jax_s_crashed_run(mesh):
    out, run = mesh["out"], mesh["from_jax"]
    want = out["resumed"]
    assert want["offsets_checked"] and run.res.offsets_checked
    assert run.res.start_step == want["start_step"] == 2
    assert run.res.steps == want["steps"]
    assert {str(k): v for k, v in run.res.pipeline.offsets().items()} == want["offsets"]
    full = out["full"]["losses"][run.res.start_step:]
    np.testing.assert_allclose(run.res.losses[:1], full[:1], rtol=LOSS_RTOL)
    np.testing.assert_allclose(run.res.losses, full, rtol=MESH_RTOL)
    assert _extras(run.ckpt) == out["full"]["extras"]


@pytest.mark.parametrize("case", ["plain", "mesh"])
def test_the_port_s_manifests_are_jax_s(request, case):
    """The port's uninterrupted run from JAX's initial parameters: every
    manifest's ``extra`` JAX's, and the step-0 manifest's blobs JAX's
    byte for byte; its losses within the tolerance of JAX's."""
    got = request.getfixturevalue(case)
    if case == "plain":
        jbase, _, _, jfull, crashed_objects = got["jax"]
        base = got["lane"][0]
        want_extras, want_losses = _extras(jfull), jbase.losses
    else:
        base, crashed_objects = got["base"], got["crashed_objects"]
        want_extras, want_losses = got["out"]["full"]["extras"], got["out"]["full"]["losses"]
    assert _extras(base.ckpt) == want_extras
    jax_ckpt = _ckpt(_port_store(crashed_objects))
    assert _blobs(base.ckpt, 0) == _blobs(jax_ckpt, 0)
    assert base.ckpt.manifest(0)["leaves"] == jax_ckpt.manifest(0)["leaves"]
    np.testing.assert_allclose(base.res.losses[:1], want_losses[:1], rtol=got["first_rtol"])
    np.testing.assert_allclose(base.res.losses, want_losses, rtol=got["rtol"])


# ---------------------------------------------------------------------------
# (c) the CI resume gates at the benchmark's settings
# ---------------------------------------------------------------------------

def test_the_ci_resume_gates_hold_at_the_benchmark_s_settings(bench):
    """``benchmarks/train_input.py --quick``'s crash lane and its four
    gates (``.github/workflows/ci.yml``), computed as the benchmark
    computes them."""
    base, broken, resumed = (r.res for r in bench["lane"])
    steps = BENCH["steps"]
    assert broken.crashed
    resume_step = resumed.start_step
    timeline = broken.steps[:resume_step] + resumed.steps
    spliced = broken.losses[:resume_step] + resumed.losses
    assert timeline == list(range(steps)) and spliced == base.losses  # bit-identical
    assert len(set(range(steps)) - set(timeline)) == 0                 # none skipped
    assert sum(n - 1 for n in np.unique(timeline, return_counts=True)[1] if n > 1) == 0
    assert resumed.offsets_checked                                     # offsets == manifest
    # the outage replayed records, and the faulty store was retried
    assert broken.input_stats["records_replayed"] + resumed.input_stats["records_replayed"] > 0
    assert bench["lane"][2].ckpt.store.retries > 0


# ---------------------------------------------------------------------------
# (d) the launcher across processes
# ---------------------------------------------------------------------------

def test_the_launcher_crashes_and_resumes_across_processes(tmp_path):
    def launch(tmpdir, *args):
        tmpdir.mkdir(exist_ok=True)
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), TMPDIR=str(tmpdir),
                   OMP_NUM_THREADS="1")
        return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.shuffle_train",
                                 "--device", "cpu", *args], cwd=ROOT, env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def done(proc):
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-4000:]
        return out.splitlines()

    full = launch(tmp_path / "full")
    crash = launch(tmp_path / "lane", "--crash-at", "6")
    full, crashed = done(full), done(crash)
    assert not (tmp_path / "full" / "repro_torch_shuffle_train_ckpt.pkl").exists()
    assert (tmp_path / "lane" / "repro_torch_shuffle_train_ckpt.pkl").exists()
    resumed = done(launch(tmp_path / "lane", "--resume"))
    assert crashed[-1].startswith("CRASHED mid-step 6")
    assert full[-1].startswith("OK mode=blob grad_sync=auto start_step=0 ")
    assert resumed[-1].startswith("OK mode=blob grad_sync=auto start_step=4 ")
    # the uninterrupted run's last loss, and its step lines from step 4 on
    assert full[-1].split()[-1] == resumed[-1].split()[-1]
    steps_after = [line for line in full if line.startswith("step") and int(line.split()[1]) >= 4]
    assert [line for line in resumed if line.startswith("step")] == steps_after
    assert [line for line in crashed if line.startswith("step")] == \
        [line for line in full if line.startswith("step") and int(line.split()[1]) < 6]


def test_a_resume_refuses_offsets_that_differ_from_the_manifest():
    """The resume cross-checks the replayed offsets against the manifest's:
    a manifest whose offsets the engine's replay does not give is refused."""
    _, cfg = _cfgs()
    tcfg = TrainConfig(opt=OptConfig(**PLAIN_OPT), microbatches=2)
    stream = TokenStreamConfig(cfg.vocab_size, *PLAIN_STREAM)
    ckpt = _ckpt(SimulatedS3(seed=31))
    kw = dict(steps=4, ckpt_every=2, engine_factory=lambda: _outage_engine("repro_torch"),
              ckpt=ckpt, device="cpu")
    assert loop.train_shuffle_fed(cfg, tcfg, None, stream, crash_at_step=3, **kw).crashed
    m = ckpt.manifest(2)
    part = sorted(m["extra"]["offsets"])[0]
    m["extra"]["offsets"][part] += 1
    ckpt.store.put_manifest("step00000002.json", m)
    with pytest.raises(RuntimeError, match="resume offsets diverged from the committed manifest"):
        loop.train_shuffle_fed(cfg, tcfg, None, stream, resume=True, **kw)


def test_resume_from_an_empty_store_is_refused_as_in_jax():
    jcfg, cfg = _cfgs()
    with pytest.raises(RuntimeError) as got:
        loop.train_shuffle_fed(cfg, TrainConfig(), None,
                               TokenStreamConfig(cfg.vocab_size, 4, 16, 0), steps=2, engine_factory=lambda: _outage_engine("repro_torch"),
                               ckpt=_ckpt(SimulatedS3(seed=1)), resume=True, device="cpu")
    with pytest.raises(RuntimeError) as want:
        jtrain_shuffle_fed(jcfg, JTrainConfig(), None, JStream(jcfg.vocab_size, 4, 16, 0),
                           steps=2, engine_factory=lambda: _outage_engine("repro"),
                           ckpt=_ckpt(JSimulatedS3(seed=1), "repro"), resume=True)
    assert str(got.value) == str(want.value) == "resume requested but no committed manifest"
