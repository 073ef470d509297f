"""The port's input specs and their sharding report
(``repro_torch.launch.specs``, ``distributed.sharding``,
``train_input.specs_check``) against the JAX package's.

    PYTHONPATH=src python -m pytest -q tests/test_torch_input_specs.py

* ``input_specs``: shape, dtype name and logical axes equal JAX's for
  all ten configs on the train, prefill and decode shape cells.
* ``input_spec_report`` equals JAX's dict (``PartitionSpec`` strings
  included) for all ten configs at ``train_4k``, and for the decode
  cell, on meshes of 1, (data 2, model 2) and (pod 2, data 2, model 2)
  ranks. The report reads only ``mesh.shape``: JAX's side takes its
  1-device test mesh and, as this process has one CPU device, an
  ``AbstractMesh`` of 4 and 8 ranks (the real 8-device mesh is held in
  ``tests/test_torch_shuffle_fed_loop.py``'s JAX subprocess).
* ``validate_device_batch`` accepts a pipeline's batch and raises
  ``AssertionError`` on a missing key, a wrong shape, a wrong dtype and
  a tensor on another device.
* ``lower_train_step`` runs deepseek-v2-lite SMOKE's loss and gradients
  on the CPU: the plain step on one rank, and the benchmark's blob step
  over pod 2 x data 2 x model 2 (one pod's block at a time).
"""

import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.launch import make_test_mesh as jmake_test_mesh
from repro.launch.specs import input_specs as jinput_specs
from repro.models import common as jcommon
from repro.train_input import input_spec_report as jinput_spec_report
from repro_torch import configs
from repro_torch.core import AsyncShuffleEngine, BlobShuffleConfig, EngineConfig
from repro_torch.core.stores import SimulatedS3
from repro_torch.distributed import DEFAULT_RULES, PartitionSpec, partition_spec
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.specs import input_specs
from repro_torch.models import common, lm
from repro_torch.shuffle.api import ShuffleConfig
from repro_torch.train_input import (ShuffleFedInput, TokenStreamConfig,
                                     input_spec_report, lower_train_step,
                                     validate_device_batch)
from repro_torch.training import OptConfig, TrainConfig

SHAPES = ("train_4k", "prefill_32k", "decode_32k")
RANKS = (1, 4, 8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shape(pkg_common, name):
    (s,) = [s for s in pkg_common.ALL_SHAPES if s.name == name]
    return s


def _jax_mesh(ranks):
    if ranks == 1:
        return jmake_test_mesh(devices=1)
    sizes = {4: ((2, 2), ("data", "model")), 8: ((2, 2, 2), ("pod", "data", "model"))}
    return AbstractMesh(*sizes[ranks])


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype) else dt.__name__


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_input_specs_match_jax(arch, shape):
    mine = input_specs(configs.get_config(arch), _shape(common, shape))
    want = jinput_specs(jconfigs.get_config(arch), _shape(jcommon, shape))
    assert list(mine) == list(want)
    for k, s in mine.items():
        w = want[k]
        assert (tuple(s.shape), _dtype_name(s.dtype), tuple(s.axes)) == \
            (tuple(w.shape), _dtype_name(w.dtype), tuple(w.axes)), k


def test_the_partition_spec_prints_as_jax_s():
    from jax.sharding import PartitionSpec as P
    for parts in [(("pod", "data"), None), (), ("data",), (None,), ("data", None, None)]:
        assert str(PartitionSpec(*parts)) == str(P(*parts)) == repr(PartitionSpec(*parts))
    assert PartitionSpec("data", None) == ("data", None)


@pytest.mark.parametrize("ranks", RANKS)
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_input_spec_report_matches_jax(arch, ranks):
    mine = input_spec_report(configs.get_config(arch), _shape(common, "train_4k"),
                             make_test_mesh(devices=ranks))
    want = jinput_spec_report(jconfigs.get_config(arch), _shape(jcommon, "train_4k"),
                              _jax_mesh(ranks))
    assert mine == want


@pytest.mark.parametrize("ranks", RANKS)
def test_the_decode_report_matches_jax(ranks):
    arch = "deepseek-v2-lite-16b"
    mine = input_spec_report(configs.get_config(arch), _shape(common, "decode_32k"),
                             make_test_mesh(devices=ranks))
    assert mine == jinput_spec_report(jconfigs.get_config(arch),
                                      _shape(jcommon, "decode_32k"), _jax_mesh(ranks))
    assert mine["pos"]["partition_spec"] == "PartitionSpec()"


def test_a_rule_falls_back_where_the_dimension_does_not_divide():
    spec = common.ArraySpec((6, 8), torch.int32, ("batch", "seq"))
    mesh = make_test_mesh(devices=8)
    # 6 rows split over pod 2 but not further over data 2
    assert str(partition_spec(spec, DEFAULT_RULES, mesh)) == "PartitionSpec('pod', None)"


# -- validate_device_batch -------------------------------------------------

def _pipeline_batch(ranks):
    cfg = configs.get_config("deepseek-v2-lite-16b", smoke=True)
    stream = TokenStreamConfig(vocab_size=cfg.vocab_size, batch=4, seq_len=16, seed=0)
    mesh = make_test_mesh(devices=ranks)
    eng = AsyncShuffleEngine(
        BlobShuffleConfig(batch_bytes=2048, max_interval_s=0.02, num_partitions=5, num_az=3),
        EngineConfig(commit_interval_s=0.05), n_instances=2, store=SimulatedS3(seed=1),
        seed=2, exactly_once=True)
    pipe = ShuffleFedInput(eng, stream, steps=1, mesh=mesh, model_cfg=cfg,
                           step_interval_s=0.05, device="cpu")
    pipe.submit()
    _, batch, _ = pipe.next_batch()
    return cfg, pipe.shape, mesh, batch


@pytest.mark.parametrize("ranks", RANKS)
def test_a_pipeline_batch_validates(ranks):
    cfg, shape, mesh, batch = _pipeline_batch(ranks)
    report = validate_device_batch(batch, cfg, shape, mesh, device="cpu")
    assert report == input_spec_report(cfg, shape, mesh)
    assert report["tokens"]["global_shape"] == [4, 16]
    # the batch splits over the pod and data axes, not over model
    assert report["tokens"]["per_device_shape"] == [4 // {1: 1, 4: 2, 8: 4}[ranks], 16]


@pytest.mark.parametrize("drift", ["missing_key", "shape", "dtype", "device"])
def test_a_drifted_batch_is_refused(drift):
    cfg, shape, mesh, batch = _pipeline_batch(8)
    t = batch["tokens"]
    bad = {"missing_key": {"tokens": t},
           "shape": {**batch, "tokens": t[:, :8]},
           "dtype": {**batch, "tokens": t.to(torch.int64)},
           "device": {**batch, "tokens": torch.empty(t.shape, dtype=t.dtype, device="meta")},
           }[drift]
    with pytest.raises(AssertionError, match={"missing_key": "keys", "shape": "shape",
                                              "dtype": "dtype", "device": "meta"}[drift]):
        validate_device_batch(bad, cfg, shape, mesh, device="cpu")


# -- lower_train_step -----------------------------------------------------

@pytest.mark.parametrize("setting", ["one_rank_plain", "pods_blob_int8"])
def test_lower_train_step_runs_on_the_cpu(setting):
    cfg = configs.get_config("deepseek-v2-lite-16b", smoke=True)
    if setting == "one_rank_plain":
        mesh, tcfg = make_test_mesh(devices=1), TrainConfig()
    else:
        # benchmarks/train_input.py's step
        mesh = make_test_mesh(devices=8)
        tcfg = TrainConfig(opt=OptConfig(learning_rate=3e-3, warmup_steps=5, total_steps=12),
                           shuffle=ShuffleConfig(mode="blob", capacity_factor=2.0),
                           grad_sync="blob_int8", grad_sync_blob_bytes=1 << 16)
    shape = common.ShapeConfig("shuffle_fed", 32, 8, "train")
    head = lower_train_step(cfg, tcfg, mesh, shape, device="cpu")
    spec = {"one_rank_plain": "PartitionSpec(None, None)",
            "pods_blob_int8": "PartitionSpec(('pod', 'data'), None)"}[setting]
    n_params = len(list(lm.LM(cfg, device="meta").parameters()))
    assert head.splitlines() == [f"tokens: [8, 32] int32 {spec}",
                                 f"labels: [8, 32] int32 {spec}",
                                 "loss: [] float32", f"gradients: {n_params} tensors"]
