"""The port's blob checkpointer (``repro_torch.checkpoint``) against the
JAX package's (``repro.checkpoint``).

* The five cases of ``tests/test_checkpoint.py``, on the port's stores:
  the commit protocol (blobs first, manifest last) over ``FileStore``
  and ``TieredCheckpointStore`` with and without fault injection.
* The cross-package oracle, for deepseek-v2-lite SMOKE (MoE + MLA) and
  granite-3-2b SMOKE (dense), from a train state one JAX train step in
  (count 1, nonzero moments): a checkpoint either package writes into a
  ``FileStore`` restores in the other bit for bit, and both write the
  same store for the same state (byte-identical blobs, equal manifests
  but for ``time``).
* The in-place hazard: the port's train step writes the model's tensors
  in place, so ``save`` copies them off the device before it returns; a
  save still uploading when the tensors change keeps the old bits.
* The elastic restore: a JAX-written train state restored with
  ``shardings=`` from ``elastic_restore_plan`` on the 4-rank test mesh,
  bit for bit.
* The refusals, each the JAX package's exception for the same case, and
  the ``shardings=`` trees that cannot place ``like`` (another
  structure, a leaf that is no ``NamedSharding``, a spec longer than the
  leaf's rank, a dim that does not divide, an axis the mesh lacks or
  names twice, a ``ProcessGroupMesh``): each ``ValueError`` before any
  blob is read.

    PYTHONPATH=src python -m pytest -q tests/test_torch_checkpoint.py
"""

import ast
import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import BlobCheckpointer as JBlobCheckpointer
from repro.checkpoint import FileStore as JFileStore
from repro.configs import get_config as jget_config
from repro.models import lm as jlm
from repro.models.common import init_params as jinit_params
from repro.training import TrainConfig as JTrainConfig
from repro.training import adamw_init as jadamw_init
from repro.training import make_train_step as jmake_train_step
from repro_torch.checkpoint import (BlobCheckpointer, FileStore,
                                    TieredCheckpointStore, latest_step)
from repro_torch.configs import get_config
from repro_torch.core.stores import (ExpressOneZoneStore, FaultyStore,
                                     SimulatedS3)
from repro_torch.distributed import DEFAULT_RULES, NamedSharding, PartitionSpec
from repro_torch.interop import (assert_same_bits, params_from_jax,
                                 train_state_from_jax, train_state_to_jax,
                                 train_state_tree)
from repro_torch.launch.mesh import ProcessGroupMesh, make_test_mesh, stacked_mesh
from repro_torch.models import lm
from repro_torch.models.common import init_params
from repro_torch.runtime import elastic_restore_plan
from repro_torch.training import TrainConfig, adamw_init, make_train_step

ROOT = Path(__file__).resolve().parents[1]
ORACLE_ARCHS = ["deepseek-v2-lite-16b", "granite-3-2b"]


# ---------------------------------------------------------------------------
# (a) tests/test_checkpoint.py's cases on the port
# ---------------------------------------------------------------------------

def _tree(seed, n=3):
    rng = np.random.default_rng(seed)
    return {"w": [rng.standard_normal((4, 5)).astype(np.float32)
                  for _ in range(n)],
            "count": np.asarray(seed, np.int32)}


def _stores(tmp_path):
    return {
        "file": FileStore(str(tmp_path / "ckpt")),
        "tiered-s3": TieredCheckpointStore(SimulatedS3(seed=1)),
        "tiered-faulty": TieredCheckpointStore(
            FaultyStore(ExpressOneZoneStore(seed=2, num_az=3), seed=3,
                        transient_p=0.25)),
    }


@pytest.mark.parametrize("kind", ["file", "tiered-s3", "tiered-faulty"])
def test_crash_before_manifest_is_invisible_and_collected(tmp_path, kind):
    store = _stores(tmp_path)[kind]
    ck = BlobCheckpointer(store, async_upload=False)
    ck.save(1, _tree(1))
    ck.save(2, _tree(2), crash_before_manifest=True)  # orphaned blobs

    assert latest_step(store) == 1
    assert ck.manifest(2) is None
    with pytest.raises(FileNotFoundError):
        ck.restore(2, _tree(0))

    removed = store.run_retention()
    assert removed == len(_tree(2)["w"]) + 1
    restored = ck.restore(1, _tree(0))
    for a, b in zip(restored["w"], _tree(1)["w"]):
        np.testing.assert_array_equal(a, b)
    assert store.run_retention() == 0  # idempotent


def test_restore_trusts_manifests_only(tmp_path):
    store = FileStore(str(tmp_path / "ckpt"))
    ck = BlobCheckpointer(store, async_upload=False)
    ck.save(5, _tree(5))
    store.put("step00000007_leaf00000.npy", b"\x00" * 80)
    store.put("unrelated-junk.bin", b"junk")
    assert latest_step(store) == 5
    with pytest.raises(FileNotFoundError):
        ck.restore(7, _tree(0))
    removed = store.run_retention()
    assert removed == 2  # both strays collected, step-5 blobs kept
    restored = ck.restore(5, _tree(0))
    np.testing.assert_array_equal(restored["count"], np.asarray(5, np.int32))


def test_async_save_then_crash_restores_previous(tmp_path):
    store = TieredCheckpointStore(SimulatedS3(seed=9))
    ck = BlobCheckpointer(store, async_upload=True)
    ck.save(1, _tree(1))
    ck.wait()
    ck.save(2, _tree(2), crash_before_manifest=True)
    ck.wait()

    ck2 = BlobCheckpointer(store, async_upload=True)  # "restarted" process
    assert latest_step(store) == 1
    restored = ck2.restore(1, _tree(0))
    for a, b in zip(restored["w"], _tree(1)["w"]):
        np.testing.assert_array_equal(a, b)


def test_tiered_store_retries_transient_faults_and_bills_time():
    base = SimulatedS3(seed=11)
    store = TieredCheckpointStore(FaultyStore(base, seed=13,
                                              transient_p=0.4),
                                  clock=lambda: 42.0)
    ck = BlobCheckpointer(store, async_upload=False)
    tree = {"x": np.arange(12, dtype=np.float32).reshape(3, 4)}
    for step in range(1, 4):
        ck.save(step, tree, extra={"next_step": step, "offsets": {0: 7}})
        ck.restore(step, {"x": np.zeros((3, 4), np.float32)})
    ck.save(3, tree, extra={"next_step": 3, "offsets": {0: 7}})
    assert store.retries > 0  # fault injection was actually live
    m = ck.manifest(3)
    assert m["extra"]["next_step"] == 3
    restored = ck.restore(3, {"x": np.zeros((3, 4), np.float32)})
    np.testing.assert_array_equal(restored["x"], tree["x"])


def test_manifest_extra_roundtrip_and_default(tmp_path):
    store = FileStore(str(tmp_path / "ckpt"))
    ck = BlobCheckpointer(store, async_upload=False)
    ck.save(1, _tree(1))
    ck.save(2, _tree(2), extra={"offsets": {"3": 14}})
    assert ck.manifest(1)["extra"] == {}
    assert ck.manifest(2)["extra"] == {"offsets": {"3": 14}}


# ---------------------------------------------------------------------------
# (b) the cross-package oracle: a train state one JAX step in
# ---------------------------------------------------------------------------

_STATES: dict = {}


def _jax_state(arch):
    """JAX's train state ``{"opt": {"count", "m", "v"}, "params"}`` after
    one train step of ``arch`` SMOKE, leaves as numpy."""
    if arch not in _STATES:
        jcfg = jget_config(arch, smoke=True)
        params = jinit_params(jlm.param_defs(jcfg), jax.random.key(0))
        rng = np.random.default_rng(5)
        toks = rng.integers(0, jcfg.vocab_size, (2, 17)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        step = jax.jit(jmake_train_step(jcfg, JTrainConfig()))
        p, o, _ = step(params, jadamw_init(params), batch)
        _STATES[arch] = jax.tree.map(np.asarray, {"params": p, "opt": o})
    return _STATES[arch]


def _fresh(arch):
    """The port's model and AdamW state for ``arch`` SMOKE, drawn from
    another seed than any checkpoint here."""
    model = init_params(lm.LM(get_config(arch, smoke=True), device="cpu"),
                        torch.Generator().manual_seed(7))
    return model, adamw_init(model)


def _same_tree(got, want):
    gl, gdef = jax.tree.flatten(got)
    wl, wdef = jax.tree.flatten(want)
    assert gdef == wdef
    for a, b in zip(gl, wl):
        assert_same_bits(np.asarray(a), np.asarray(b))


def test_the_jax_state_is_one_step_in():
    state = _jax_state("deepseek-v2-lite-16b")
    assert state["opt"]["count"].shape == () and int(state["opt"]["count"]) == 1
    assert all(np.any(m != 0) for m in jax.tree.leaves(state["opt"]["m"]))


@pytest.mark.parametrize("arch", ORACLE_ARCHS)
def test_train_state_tree_is_the_jax_tree(arch):
    """``train_state_to_jax`` of ``train_state_from_jax`` gives the JAX
    state back, leaf for leaf and bit for bit, in JAX's tree."""
    state = _jax_state(arch)
    model, opt = train_state_from_jax(get_config(arch, smoke=True), state, device="cpu")
    _same_tree(train_state_to_jax(model, opt), state)
    assert opt["count"].dtype == torch.int32 and opt["count"].shape == ()


@pytest.mark.parametrize("arch", ORACLE_ARCHS)
def test_a_jax_checkpoint_restores_in_the_port(tmp_path, arch):
    state = _jax_state(arch)
    JBlobCheckpointer(JFileStore(str(tmp_path)), async_upload=False).save(3, state)
    model, opt = _fresh(arch)
    BlobCheckpointer(FileStore(str(tmp_path))).restore(3, train_state_tree(model, opt))
    want = params_from_jax(get_config(arch, smoke=True), state["params"], device="cpu")
    for (name, got), (_, w) in zip(model.named_parameters(), want.named_parameters()):
        assert_same_bits(got.detach(), w.detach())
    _same_tree(train_state_to_jax(model, opt)["opt"], state["opt"])


@pytest.mark.parametrize("arch", ORACLE_ARCHS)
def test_a_jax_checkpoint_restores_in_the_port_onto_another_mesh(tmp_path, arch):
    """The elastic restore of a JAX-written train state: the params, m and
    v placed by ``elastic_restore_plan``'s shardings on the 4-rank test
    mesh, the count replicated; bit for bit."""
    state = _jax_state(arch)
    JBlobCheckpointer(JFileStore(str(tmp_path)), async_upload=False).save(3, state)
    cfg = get_config(arch, smoke=True)
    mesh = make_test_mesh(devices=4)
    plan = elastic_restore_plan(lm.param_defs(cfg), DEFAULT_RULES, mesh)
    shardings = {"opt": {"count": NamedSharding(mesh, PartitionSpec()),
                         "m": plan["shardings"], "v": plan["shardings"]},
                 "params": plan["shardings"]}
    model, opt = _fresh(arch)
    BlobCheckpointer(FileStore(str(tmp_path))).restore(
        3, train_state_tree(model, opt), shardings=shardings)
    _same_tree(train_state_to_jax(model, opt), state)


@pytest.mark.parametrize("arch", ORACLE_ARCHS)
def test_a_port_checkpoint_restores_in_jax(tmp_path, arch):
    state = _jax_state(arch)
    model, opt = train_state_from_jax(get_config(arch, smoke=True), state, device="cpu")
    port = BlobCheckpointer(FileStore(str(tmp_path)))
    port.save(3, train_state_tree(model, opt))
    port.wait()
    ck = JBlobCheckpointer(JFileStore(str(tmp_path)))
    like = jax.tree.map(np.zeros_like, state)
    _same_tree(ck.restore(3, like), state)


@pytest.mark.parametrize("arch", ORACLE_ARCHS)
def test_both_packages_write_the_same_store(tmp_path, arch):
    state = _jax_state(arch)
    extra = {"next_step": 1, "offsets": {"0": 12}}
    JBlobCheckpointer(JFileStore(str(tmp_path / "jax")),
                      async_upload=False).save(1, state, extra=extra)
    model, opt = train_state_from_jax(get_config(arch, smoke=True), state, device="cpu")
    ck = BlobCheckpointer(FileStore(str(tmp_path / "port")))
    ck.save(1, train_state_tree(model, opt), extra=extra)
    ck.wait()
    objects = {d: sorted(os.listdir(tmp_path / d / "objects")) for d in ("jax", "port")}
    assert objects["jax"] == objects["port"]
    assert len(objects["port"]) == len(jax.tree.leaves(state))
    for blob in objects["port"]:
        assert (tmp_path / "jax" / "objects" / blob).read_bytes() == \
            (tmp_path / "port" / "objects" / blob).read_bytes(), blob
    want, got = (json.loads((tmp_path / d / "manifests" / "step00000001.json").read_text())
                 for d in ("jax", "port"))
    assert sorted(got) == sorted(want)
    # the treedef string is written in JAX's format; no restore reads it
    for k in want:
        if k != "time":
            assert got[k] == want[k], k
    count = got["leaves"][0]
    assert (count["shape"], count["dtype"]) == ([], "int32")


def test_bf16_crosses_as_its_bits_both_ways(tmp_path):
    """bf16 leaves go through a ``uint16`` view: the port's blobs restore
    in JAX as ``ml_dtypes`` bfloat16 with the same bits, and JAX's in the
    port as ``torch.bfloat16``."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((3, 7)).astype(np.float32)).to(torch.bfloat16)
    ck = BlobCheckpointer(FileStore(str(tmp_path / "port")), async_upload=False)
    ck.save(1, {"b": x})
    assert ck.manifest(1)["leaves"][0]["dtype"] == "bfloat16"
    jx = JBlobCheckpointer(JFileStore(str(tmp_path / "port"))).restore(
        1, {"b": np.zeros((3, 7), np.float32)})["b"]
    assert jx.dtype.name == "bfloat16"
    assert_same_bits(jx, x)
    JBlobCheckpointer(JFileStore(str(tmp_path / "jax")), async_upload=False).save(2, {"b": jx})
    back = BlobCheckpointer(FileStore(str(tmp_path / "jax"))).restore(
        2, {"b": torch.zeros((3, 7), dtype=torch.bfloat16)})["b"]
    assert_same_bits(back, x)


# ---------------------------------------------------------------------------
# (c) the in-place hazard
# ---------------------------------------------------------------------------

def test_async_save_keeps_the_bits_of_tensors_changed_after_it():
    store = TieredCheckpointStore(SimulatedS3(seed=4))
    ck = BlobCheckpointer(store, async_upload=True)
    tree = {"w": torch.arange(20, dtype=torch.float32).reshape(4, 5),
            "b": torch.ones(6, dtype=torch.bfloat16)}
    want = {k: v.clone() for k, v in tree.items()}
    ck.save(1, tree)
    tree["w"].add_(100.0)        # the step after the save, in place
    tree["b"].mul_(3.0)
    ck.wait()
    got = ck.restore(1, {"w": torch.zeros(4, 5), "b": torch.zeros(6, dtype=torch.bfloat16)})
    for k in want:
        assert_same_bits(got[k], want[k])


def test_async_save_of_the_train_state_survives_the_next_step():
    """The port's step writes the model and returns new moments; a save
    started before it restores the state from before it."""
    arch = "deepseek-v2-lite-16b"
    cfg = get_config(arch, smoke=True)
    model, opt = _fresh(arch)
    step = make_train_step(cfg, TrainConfig())
    rng = np.random.default_rng(6)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 17)).astype(np.int32))
    batch = {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}
    model, opt, _ = step(model, opt, batch)           # nonzero moments
    before = train_state_to_jax(model, opt)
    ck = BlobCheckpointer(TieredCheckpointStore(SimulatedS3(seed=5)), async_upload=True)
    ck.save(1, train_state_tree(model, opt))
    model, opt, _ = step(model, opt, batch)           # in place
    ck.wait()
    after = train_state_to_jax(model, opt)
    assert not any(np.array_equal(a, b) for a, b in
                   zip(jax.tree.leaves(after["params"]), jax.tree.leaves(before["params"])))
    ck.restore(1, train_state_tree(model, opt))
    _same_tree(train_state_to_jax(model, opt), before)


# ---------------------------------------------------------------------------
# (d) refusals
# ---------------------------------------------------------------------------

def _refusal_cases():
    base = {"w": np.ones((4, 5), np.float32), "c": np.zeros((), np.int32)}
    return {
        "missing manifest": (9, base, FileNotFoundError),
        "leaf count": (1, {**base, "x": np.zeros(2, np.float32)}, AssertionError),
        "shape": (1, {"w": np.ones((5, 4), np.float32), "c": np.zeros((), np.int32)},
                  AssertionError),
    }


@pytest.mark.parametrize("case", sorted(_refusal_cases()))
def test_restore_refuses_as_jax_does(tmp_path, case):
    step, like, exc = _refusal_cases()[case]
    saved = {"w": np.arange(20, dtype=np.float32).reshape(4, 5), "c": np.ones((), np.int32)}
    BlobCheckpointer(FileStore(str(tmp_path)), async_upload=False).save(1, saved)
    with pytest.raises(exc):
        JBlobCheckpointer(JFileStore(str(tmp_path))).restore(step, like)
    torch_like = {k: torch.from_numpy(v.copy()) for k, v in like.items()}
    with pytest.raises(exc):
        BlobCheckpointer(FileStore(str(tmp_path))).restore(step, torch_like)
    # refused before any write: like is as it was
    for k, v in like.items():
        assert np.array_equal(torch_like[k].numpy(), v)


class _CountingStore(FileStore):
    """A ``FileStore`` that counts the blobs read."""
    gets = 0

    def get(self, blob_id):
        self.gets += 1
        return super().get(blob_id)


def _sharding_refusals():
    mesh = stacked_mesh(data=2, model=2)
    ok = NamedSharding(mesh, PartitionSpec())
    return {
        "structure": ({"w": ok}, "structure"),
        "not a NamedSharding": ({"w": mesh, "c": ok}, "NamedSharding"),
        "rank": ({"w": NamedSharding(mesh, PartitionSpec("data", None, None)), "c": ok},
                 "rank"),
        "divisibility": ({"w": NamedSharding(mesh, PartitionSpec(None, ("data", "model"))),
                          "c": ok}, "divide"),
        "unknown axis": ({"w": NamedSharding(mesh, PartitionSpec("pod")), "c": ok}, "axes"),
        "repeated axis": ({"w": NamedSharding(mesh, PartitionSpec("data", "data")),
                           "c": ok}, "axes"),
        "process group": ({"w": NamedSharding(ProcessGroupMesh(("data", "model"), (2, 2)),
                                              PartitionSpec("data")), "c": ok},
                          "queue 1 item 6"),
    }


@pytest.mark.parametrize("case", sorted(_sharding_refusals()))
def test_restore_refuses_shardings_that_cannot_place_like(tmp_path, case):
    """Each refusal raises ``ValueError`` before any blob is read or any
    leaf written; the valid sharding restores whole."""
    shardings, match = _sharding_refusals()[case]
    saved = {"w": np.arange(24, dtype=np.float32).reshape(4, 6), "c": np.asarray(3, np.int32)}
    BlobCheckpointer(FileStore(str(tmp_path)), async_upload=False).save(1, saved)
    store = _CountingStore(str(tmp_path))
    like = {"w": torch.zeros(4, 6), "c": torch.zeros((), dtype=torch.int32)}
    with pytest.raises(ValueError, match=match):
        BlobCheckpointer(store).restore(1, like, shardings=shardings)
    assert store.gets == 0
    assert not like["w"].any() and int(like["c"]) == 0
    mesh = stacked_mesh(data=2, model=2)
    good = {"w": NamedSharding(mesh, PartitionSpec("data", "model")),
            "c": NamedSharding(mesh, PartitionSpec())}
    out = BlobCheckpointer(store).restore(1, like, shardings=good)
    assert out["w"] is like["w"] and store.gets == 2
    for k in saved:
        assert_same_bits(like[k], saved[k])


def test_restore_writes_only_into_tensors_and_arrays(tmp_path):
    ck = BlobCheckpointer(FileStore(str(tmp_path)), async_upload=False)
    ck.save(1, {"w": np.ones(3, np.float32)})
    ro = np.zeros(3, np.float32)
    ro.flags.writeable = False
    with pytest.raises(ValueError, match="writable"):
        ck.restore(1, {"w": ro})


def test_the_checkpoint_code_imports_no_ml_dtypes_jax_or_repro():
    for path in sorted((ROOT / "src" / "repro_torch" / "checkpoint").glob("*.py")) + \
            sorted((ROOT / "src" / "repro_torch" / "runtime").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not any(n.split(".")[0] in ("ml_dtypes", "jax", "jaxlib", "repro")
                           for n in names), f"{path.name}:{node.lineno} {names}"
