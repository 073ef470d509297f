"""The shuffle-fed training input and loop over a ``ProcessGroupMesh`` (4
gloo processes, pod 2 x model 2) against the reference batches, the
stacked back end and the JAX package.

    PYTHONPATH=src python -m pytest -q tests/test_torch_pg_shuffle_fed.py

deepseek-v2-lite SMOKE in f32, ``train_shuffle_fed`` fed by the training
benchmark's faulty elastic engine (``launch.engine.faulty_elastic_engine``)
over ``PG_MESH`` of ``tests/test_torch_pg_train_step.py``, the benchmark's
stream (batch 8 of 32 tokens), ``ShuffleConfig(mode="blob")`` over the
mesh's axes, the ``blob_int8`` gradient sync, ``STEPS`` steps with a
manifest every 2 into each process's own in-memory store.

(a) The put: on every process each batch the trainer gets is
    ``reference_batch``'s bits (the global batch: the port's step takes
    the whole batch on every process), ``validate_device_batch`` passes
    and its report is ``input_spec_report``'s and JAX's, and each
    process's block (``exchange.shard`` over the batch spec's axes) is
    bit for bit the shard that JAX's ``ShuffleFedInput`` puts on the
    device of the same linear index of a JAX mesh of the same axes over
    4 host devices (one subprocess): the mapping from process rank to
    JAX device.
(b) The training: the losses, final parameters and moments the same
    bits on the four processes, and the same bits as the loop over
    ``stacked_mesh(**PG_MESH)`` in this process (both at one thread).
(c) Crash and resume: each process crashes mid-step 2 and resumes from
    manifest 2 of its own store: on every process the resumed losses and
    final parameters are the uninterrupted run's bits, its replayed
    offsets were checked against the manifest, and its final offsets
    are the uninterrupted run's.
(d) The digest: one process's token stream with another seed makes
    every process raise, naming step 0. (An engine with another seed
    would not do: the records are step-keyed and assembled by row, so the
    batch is the same bits whatever the delivery order.)

The gloo processes run once for the module (``run_gloo``: a file
rendezvous, killed at the time limit).
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

from repro_torch.configs import get_config
from repro_torch.launch.engine import faulty_elastic_engine
from repro_torch.launch.mesh import stacked_mesh
from repro_torch.shuffle.api import ShuffleConfig
from repro_torch.train_input import (TokenStreamConfig, input_spec_report, loop,
                                     reference_batch)
from repro_torch.training import OptConfig, TrainConfig, make_train_step
from test_torch_pg_autograd import run_gloo
from test_torch_pg_train_step import PG_MESH

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "deepseek-v2-lite-16b"
STEPS, CKPT_EVERY, CRASH_AT = 4, 2, 2
STREAM = (8, 32, 0)                 # benchmarks/train_input.py --quick: batch, seq, seed
PIPE = {"step_interval_s": 0.05, "prefetch_steps": 2}
OPT = dict(learning_rate=3e-3, warmup_steps=2, total_steps=STEPS)
SYNC = "blob_int8"
BLOB_BYTES = 4096
MUTANT_RANK = 3

WORKER = """
import dataclasses, json, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.checkpoint import BlobCheckpointer, TieredCheckpointStore
from repro_torch.configs import get_config
from repro_torch.core.stores import SimulatedS3
from repro_torch.distributed.sharding import DEFAULT_RULES, batch_specs
from repro_torch.launch.engine import faulty_elastic_engine
from repro_torch.launch.mesh import process_group_mesh
from repro_torch.launch.specs import input_specs
from repro_torch.models.common import ShapeConfig
from repro_torch.shuffle import exchange
from repro_torch.shuffle.api import ShuffleConfig
from repro_torch.train_input import (ShuffleFedInput, TokenStreamConfig, input_spec_report,
                                     train_shuffle_fed, validate_device_batch)
from repro_torch.training import OptConfig, TrainConfig, make_train_step

rank, folder = int(sys.argv[1]), sys.argv[2]
arch, sizes, stream_args, pipe, opt, sync, blob_bytes, every, crash_at, mutant_rank = (
    json.loads(a) for a in sys.argv[3:13])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{folder}/rendezvous", rank=rank,
                        world_size=4)
mesh = process_group_mesh(**sizes)
cfg = dataclasses.replace(get_config(arch, smoke=True), compute_dtype=torch.float32)
stream = TokenStreamConfig(cfg.vocab_size, *stream_args)
steps = opt["total_steps"]
tcfg = TrainConfig(opt=OptConfig(**opt), microbatches=2, shuffle=ShuffleConfig(mode="blob"),
                   grad_sync=sync, grad_sync_blob_bytes=blob_bytes)
ex = exchange.for_mesh(mesh)
out = {}


def factory():
    return faulty_elastic_engine()[0]


def ckpt():
    # this process's own in-memory store
    return BlobCheckpointer(TieredCheckpointStore(SimulatedS3(seed=21)), async_upload=False)


shape = ShapeConfig("shuffle_fed", stream.seq_len, stream.batch, "train")
axes = {}
for k, sh in batch_specs(input_specs(cfg, shape), DEFAULT_RULES, mesh).items():
    part = sh.spec[0]
    axes[k] = (part,) if isinstance(part, str) else tuple(part or ())


def run(tag, store, **kw):
    # the loop's step, recording each batch it gets (with this process's
    # block and the validated report) and the last step's state
    step, seen = make_train_step(cfg, tcfg, mesh=mesh), []

    def recording(params, opt_state, batch):
        blocks = {k: ex.shard(t, axes[k])[0].numpy().copy() for k, t in batch.items()}
        report = validate_device_batch(batch, cfg, shape, mesh, device="cpu")
        seen.append(({k: t.numpy().copy() for k, t in batch.items()}, blocks, report))
        params, opt_state, m = step(params, opt_state, batch)
        for n, p in params.named_parameters():
            # copies: the next step writes them in place
            out[f"{tag}|p|{n}"] = p.detach().numpy().copy()
            out[f"{tag}|m|{n}"] = opt_state["m"][n].numpy().copy()
            out[f"{tag}|v|{n}"] = opt_state["v"][n].numpy().copy()
        return params, opt_state, m
    res = train_shuffle_fed(cfg, tcfg, mesh, stream, steps=steps, engine_factory=factory,
                            ckpt=store, ckpt_every=every, step_fn=recording,
                            pipeline_kwargs=pipe, device="cpu", **kw)
    for s, (batch, blocks, report) in zip(res.steps, seen):
        for k in batch:
            out[f"{tag}|batch{s}|{k}"], out[f"{tag}|block{s}|{k}"] = batch[k], blocks[k]
        out[f"{tag}|report{s}"] = np.str_(json.dumps(report))
    out[f"{tag}|losses"] = np.asarray(res.losses, dtype=np.float64)
    out[f"{tag}|steps"] = np.asarray(res.steps)
    out[f"{tag}|crashed"] = np.bool_(res.crashed)
    out[f"{tag}|offsets_checked"] = np.bool_(res.offsets_checked)
    out[f"{tag}|offsets"] = np.str_(json.dumps(res.pipeline.offsets()))
    out[f"{tag}|shape"] = np.asarray([res.pipeline.shape.global_batch,
                                      res.pipeline.shape.seq_len])
    out[f"{tag}|report"] = np.str_(json.dumps(input_spec_report(cfg, res.pipeline.shape,
                                                                mesh)))


# (a), (b): the uninterrupted run; (c): crash mid-step and resume over one store
run("full", ckpt())
store = ckpt()
run("crashed", store, crash_at_step=crash_at)
run("resumed", store, resume=True)


# (d): one process's stream with another seed; the put raises on every process
other = dataclasses.replace(stream, seed=stream.seed + (rank == mutant_rank))
p3 = ShuffleFedInput(factory(), other, steps=2, mesh=mesh, model_cfg=cfg, device="cpu", **pipe)
p3.submit()
try:
    p3.next_batch()
    out["mutant"] = np.str_("")
except RuntimeError as e:
    out["mutant"] = np.str_(str(e))
np.savez(f"{folder}/out{rank}.npz", **out)
dist.destroy_process_group()
"""

JAX_PUT = """
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.cluster import ElasticCluster
from repro.configs import get_config
from repro.core import AsyncShuffleEngine, BlobShuffleConfig, EngineConfig
from repro.core.stores import ExpressOneZoneStore, FaultyStore
from repro.launch.mesh import _mesh
from repro.train_input import ShuffleFedInput, TokenStreamConfig, input_spec_report
folder, arch, sizes, stream_args, pipe, steps = sys.argv[1], *(json.loads(a)
                                                               for a in sys.argv[2:7])

def make_engine():
    # benchmarks/train_input.py's make_engine
    store = FaultyStore(ExpressOneZoneStore(seed=7, num_az=3), seed=11, transient_p=0.02)
    bcfg = BlobShuffleConfig(batch_bytes=4096, max_interval_s=0.02, num_partitions=9,
                             num_az=3)
    eng = AsyncShuffleEngine(bcfg, EngineConfig(commit_interval_s=0.15), n_instances=3,
                             store=store, seed=5, exactly_once=True)
    ElasticCluster(eng, mode="cooperative").az_outage_at(0.30, 1)
    return eng

cfg = dataclasses.replace(get_config(arch, smoke=True), compute_dtype=jnp.float32)
mesh = _mesh(tuple(sizes.values()), tuple(sizes))
devices = list(mesh.devices.flat)
p = ShuffleFedInput(make_engine(), TokenStreamConfig(cfg.vocab_size, *stream_args),
                    steps=steps, mesh=mesh, model_cfg=cfg, **pipe)
p.submit()
out = {"report": np.str_(json.dumps(input_spec_report(cfg, p.shape, mesh)))}
for s in range(steps):
    _, batch, _ = p.next_batch()
    for k, arr in batch.items():
        for sh in arr.addressable_shards:
            out[f"{s}|{k}|{devices.index(sh.device)}"] = np.asarray(sh.data)
np.savez(f"{folder}/out.npz", **out)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return dataclasses.replace(get_config(ARCH, smoke=True), compute_dtype=torch.float32)


def _tcfg():
    return TrainConfig(opt=OptConfig(**OPT), microbatches=2, shuffle=ShuffleConfig(mode="blob"),
                       grad_sync=SYNC, grad_sync_blob_bytes=BLOB_BYTES)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each rank's outputs of ``WORKER``, JAX's shards by step, input and
    device linear index): the JAX subprocess runs beside the gloo
    processes."""
    folder = tmp_path_factory.mktemp("pg_shuffle_fed")
    jfolder = tmp_path_factory.mktemp("pg_shuffle_fed_jax")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jproc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_PUT), str(jfolder), json.dumps(ARCH),
         json.dumps(PG_MESH), json.dumps(STREAM), json.dumps(PIPE), json.dumps(STEPS)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        outs = run_gloo(folder, textwrap.dedent(WORKER), *(json.dumps(a) for a in (
            ARCH, PG_MESH, STREAM, PIPE, OPT, SYNC, BLOB_BYTES, CKPT_EVERY, CRASH_AT,
            MUTANT_RANK)), timeout=240)
        log, _ = jproc.communicate(timeout=240)
    finally:
        if jproc.poll() is None:
            jproc.kill()
            jproc.communicate()
    assert jproc.returncode == 0, log[-4000:]
    return outs, dict(np.load(jfolder / "out.npz"))


@pytest.fixture(scope="module")
def stacked():
    """The same loop over ``stacked_mesh(**PG_MESH)`` in this process:
    (losses, final parameters, first and second moments)."""
    cfg, tcfg = _cfg(), _tcfg()
    mesh = stacked_mesh(**PG_MESH)
    step, last = make_train_step(cfg, tcfg, mesh=mesh), []

    def recording(params, opt, batch):
        out = step(params, opt, batch)
        last[:] = [out]
        return out
    res = loop.train_shuffle_fed(cfg, tcfg, mesh, TokenStreamConfig(cfg.vocab_size, *STREAM),
                                 steps=STEPS, engine_factory=lambda: faulty_elastic_engine()[0],
                                 step_fn=recording, pipeline_kwargs=PIPE, device="cpu")
    params, opt, _ = last[0]
    return (res.losses, {n: p.detach().clone() for n, p in params.named_parameters()},
            {n: t.clone() for n, t in opt["m"].items()},
            {n: t.clone() for n, t in opt["v"].items()})


def _part(o, prefix):
    return {k[len(prefix):]: v for k, v in o.items() if k.startswith(prefix)}


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_every_process_gets_the_reference_batch_and_jax_s_shard_as_its_block(runs):
    outs, jax_out = runs
    stream = TokenStreamConfig(_cfg().vocab_size, *STREAM)
    for rank, o in enumerate(outs):
        for s in range(STEPS):
            want = reference_batch(stream, s)
            for k in ("tokens", "labels"):
                got = o[f"full|batch{s}|{k}"]
                assert got.dtype == np.int32 and _same_bits(got, want[k]), (rank, s, k)
                assert _same_bits(o[f"full|block{s}|{k}"], jax_out[f"{s}|{k}|{rank}"]), \
                    (rank, s, k)
    # the batch spec splits over the pod axis: the two pods' blocks differ
    assert not _same_bits(outs[0]["full|block0|tokens"], outs[2]["full|block0|tokens"])
    assert _same_bits(outs[0]["full|block0|tokens"], outs[1]["full|block0|tokens"])


def test_every_batch_validates_and_its_report_is_input_spec_report_s_and_jax_s(runs):
    outs, jax_out = runs
    jreport = json.loads(str(jax_out["report"]))
    for o in outs:
        report = json.loads(str(o["full|report"]))
        assert report == jreport
        assert report["tokens"]["partition_spec"] == "PartitionSpec('pod', None)"
        assert report["tokens"]["per_device_shape"] == [STREAM[0] // PG_MESH["pod"], STREAM[1]]
        for s in range(STEPS):
            assert json.loads(str(o[f"full|report{s}"])) == report
        assert list(o["full|shape"]) == [STREAM[0], STREAM[1]]


@pytest.mark.parametrize("kind", ["p", "m", "v"])
def test_the_processes_train_the_stacked_loop_s_bits(runs, stacked, kind):
    outs, _ = runs
    losses, params, m, v = stacked
    want = {"p": params, "m": m, "v": v}[kind]
    for rank, o in enumerate(outs):
        assert list(o["full|steps"]) == list(range(STEPS)) and not o["full|crashed"]
        assert _same_bits(o["full|losses"], np.asarray(losses, dtype=np.float64)), \
            (rank, list(o["full|losses"]), losses)
        got = _part(o, f"full|{kind}|")
        assert set(got) == set(want)
        bad = [n for n in want if not _same_bits(got[n], want[n].numpy())]
        assert not bad, (rank, bad[:5])
    assert np.all(np.isfinite(losses))


def test_each_process_resumes_from_its_own_store_to_the_uninterrupted_bits(runs):
    outs, _ = runs
    for rank, o in enumerate(outs):
        assert o["crashed|crashed"] and list(o["crashed|steps"]) == list(range(CRASH_AT))
        assert _same_bits(o["crashed|losses"], o["full|losses"][:CRASH_AT])
        assert o["resumed|offsets_checked"] and not o["resumed|crashed"]
        assert list(o["resumed|steps"]) == list(range(CRASH_AT, STEPS))
        assert _same_bits(o["resumed|losses"], o["full|losses"][CRASH_AT:]), rank
        assert json.loads(str(o["resumed|offsets"])) == json.loads(str(o["full|offsets"]))
        assert json.loads(str(o["full|offsets"]))           # the run committed offsets
        for kind in ("p", "m", "v"):
            full, resumed = _part(o, f"full|{kind}|"), _part(o, f"resumed|{kind}|")
            assert set(full) == set(resumed)
            assert all(_same_bits(resumed[n], full[n]) for n in full), (rank, kind)
        # the resumed run's batches are the uninterrupted run's
        for s in range(CRASH_AT, STEPS):
            assert _same_bits(o[f"resumed|batch{s}|tokens"], o[f"full|batch{s}|tokens"])


def test_a_process_with_another_stream_makes_every_process_raise_at_step_0(runs):
    outs, _ = runs
    for rank, o in enumerate(outs):
        msg = str(o["mutant"])
        assert msg.startswith("step 0's batches differ between the processes"), (rank, msg)
