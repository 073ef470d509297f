"""The port's runtime layer against the JAX package's: checkpoint/restart
through ``FaultTolerantTrainer``, straggler hedging, and the train
launcher's ``--ckpt-dir`` / ``--ckpt-every``.

* ``tests/test_fault_tolerance.py``'s roundtrip/async, crash-before-
  manifest and restart-bit-identical cases, ported.
* The port's trainer with ``fail_at`` gives JAX's trainer's losses on the
  same batches, to ``test_train_step_matches_jax``'s bound (rtol 1e-5).
* The hedged fetch on the port's copy of ``runtime/stragglers.py``.
* The launcher commits manifests 0, 2 and 4, which JAX's
  ``BlobCheckpointer`` restores into JAX's own train state tree.
* ``test_elastic_restore_different_mesh``'s twin: granite-3-2b SMOKE
  placed by the 8-rank test mesh's plan, saved, and restored by the
  4-rank mesh's plan, bit for bit; both plans' ``dp_degree``, device
  count and every leaf's ``PartitionSpec`` are JAX's own, read from a
  JAX subprocess on 8 forced host devices.

    PYTHONPATH=src python -m pytest -q tests/test_torch_fault_tolerance.py
"""

import dataclasses
import gc
import json
import os
import subprocess
import sys
import textwrap
import weakref
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import BlobCheckpointer as JBlobCheckpointer
from repro.checkpoint import FileStore as JFileStore
from repro.configs import get_config as jget_config
from repro.models import lm as jlm
from repro.models.common import init_params as jinit_params
from repro.runtime import FaultTolerantTrainer as JFaultTolerantTrainer
from repro.training import OptConfig as JOptConfig
from repro.training import TrainConfig as JTrainConfig
from repro.training import adamw_init as jadamw_init
from repro.training import make_train_step as jmake_train_step
from repro_torch.checkpoint import BlobCheckpointer, FileStore, latest_step
from repro_torch.configs import get_config
from repro_torch.distributed import DEFAULT_RULES
from repro_torch.interop import (assert_same_bits, params_from_jax,
                                 train_state_to_jax, train_state_tree)
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import lm
from repro_torch.models.common import init_params
from repro_torch.runtime import FaultTolerantTrainer, HedgedFetcher, elastic_restore_plan
from repro_torch.runtime.fault_tolerance import InjectedFailure
from repro_torch.training import (OptConfig, TrainConfig, adamw_init,
                                  make_train_step)

LOSS_RTOL = 1e-5   # test_train_step_matches_jax's
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_setup(arch="granite-3-2b"):
    cfg = get_config(arch, smoke=True)
    params = init_params(lm.LM(cfg, device="cpu"), torch.Generator().manual_seed(0))
    step = make_train_step(cfg, TrainConfig(opt=OptConfig(learning_rate=1e-3)))

    def batch_fn(i):  # deterministic, step-keyed
        rng = np.random.default_rng(1000 + i)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16), dtype=np.int32))
        return {"tokens": toks, "labels": toks}

    return cfg, params, step, batch_fn


def test_checkpoint_roundtrip_and_async(tmp_path):
    store = FileStore(str(tmp_path / "s"))
    ckpt = BlobCheckpointer(store, async_upload=True)
    tree = {"w": torch.arange(12.0).reshape(3, 4),
            "b": torch.ones((5,), dtype=torch.bfloat16)}
    ckpt.save(7, tree)
    ckpt.wait()
    out = ckpt.restore(7, {"w": torch.zeros(3, 4), "b": torch.zeros(5, dtype=torch.bfloat16)})
    for k in tree:
        assert_same_bits(out[k], tree[k])
    assert latest_step(store) == 7


def test_crash_before_manifest_leaves_no_checkpoint(tmp_path):
    """Blobs without a manifest are invisible (commit protocol) and are
    collected as orphans by retention."""
    store = FileStore(str(tmp_path / "s"))
    ckpt = BlobCheckpointer(store, async_upload=False)
    tree = {"w": torch.ones((4,))}
    ckpt.save(1, tree)
    ckpt.save(2, tree, crash_before_manifest=True)
    assert latest_step(store) == 1
    with pytest.raises(FileNotFoundError):
        ckpt.restore(2, tree)
    removed = store.run_retention()
    assert removed == 1  # step-2 orphan blob GC'd
    ckpt.restore(1, tree)  # step-1 untouched


def _fresh_run(tmp_path, name, fail_at=None, arch="granite-3-2b", async_upload=False):
    cfg, params, step, batch_fn = make_setup(arch)
    trainer = FaultTolerantTrainer(FileStore(str(tmp_path / name)), step, batch_fn,
                                   ckpt_every=4, async_upload=async_upload)
    p, opt, losses = trainer.run(params, adamw_init(params), steps=12, fail_at=fail_at)
    return p, opt, losses


@pytest.mark.parametrize("async_upload", [False, True])
def test_restart_is_bit_identical(tmp_path, async_upload):
    """Training with injected failures reproduces the no-failure run, bit
    for bit: the losses, the parameters and the AdamW state."""
    p_ref, o_ref, losses_ref = _fresh_run(tmp_path, "a")
    p_ft, o_ft, losses_ft = _fresh_run(tmp_path, "b", fail_at={6: 1, 10: 2},
                                       async_upload=async_upload)
    assert losses_ft == losses_ref
    ref, ft = train_state_to_jax(p_ref, o_ref), train_state_to_jax(p_ft, o_ft)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(ft)):
        assert_same_bits(a, b)


def test_restarts_are_capped(tmp_path):
    cfg, params, step, batch_fn = make_setup()
    trainer = FaultTolerantTrainer(FileStore(str(tmp_path / "c")), step, batch_fn,
                                   ckpt_every=2, async_upload=False)
    with pytest.raises(InjectedFailure):
        trainer.run(params, adamw_init(params), steps=4, fail_at={1: 3}, max_restarts=2)


def test_trainer_keeps_one_optimizer_state_alive(tmp_path):
    """The step returns new moments; the trainer must not keep the first
    ones alive (on the card a second set of moments is 13 GB for
    deepseek-v2-lite's 3 layers)."""
    cfg, params, step, batch_fn = make_setup()
    first = []

    def watching_step(p, o, batch):
        if not first:
            first.append(weakref.ref(next(iter(o["m"].values()))))
        else:
            gc.collect()
            assert first[0]() is None, "the first moments are still alive"
        return step(p, o, batch)

    trainer = FaultTolerantTrainer(FileStore(str(tmp_path / "w")), watching_step, batch_fn,
                                   ckpt_every=2, async_upload=False)
    trainer.run(params, adamw_init(params), steps=3)


def test_trainer_matches_jax_trainer_with_failures(tmp_path):
    """Both packages' trainers on the same parameters and batches, with a
    failure at step 3 rolled back to the step-2 manifest: the same losses
    (rtol 1e-5), the same committed manifests, and the port's final state
    within the same bound of JAX's last manifest."""
    arch = "deepseek-v2-lite-16b"
    ocfg = dict(learning_rate=1e-3, warmup_steps=2, total_steps=8)
    jcfg = dataclasses.replace(jget_config(arch, smoke=True), compute_dtype=jnp.float32)
    cfg = dataclasses.replace(get_config(arch, smoke=True), compute_dtype=torch.float32)
    jparams = jax.tree.map(np.asarray, jinit_params(jlm.param_defs(jcfg), jax.random.key(0)))

    def np_batch(i):
        rng = np.random.default_rng(2000 + i)
        toks = rng.integers(0, cfg.vocab_size, (4, 33)).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    jstep = jax.jit(jmake_train_step(jcfg, JTrainConfig(opt=JOptConfig(**ocfg),
                                                        microbatches=2)))
    jt = JFaultTolerantTrainer(JFileStore(str(tmp_path / "jax")), jstep,
                               lambda i: jax.tree.map(jnp.asarray, np_batch(i)),
                               ckpt_every=2)
    _, _, jlosses = jt.run(jparams, jadamw_init(jparams), steps=4, fail_at={3: 1})

    params = params_from_jax(cfg, jparams, device="cpu")
    step = make_train_step(cfg, TrainConfig(opt=OptConfig(**ocfg), microbatches=2))
    store = FileStore(str(tmp_path / "port"))
    trainer = FaultTolerantTrainer(
        store, step, lambda i: {k: torch.from_numpy(v) for k, v in np_batch(i).items()},
        ckpt_every=2)
    params, opt, losses = trainer.run(params, adamw_init(params), steps=4, fail_at={3: 1})
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    assert len(losses) == 4
    assert store.manifests() == JFileStore(str(tmp_path / "jax")).manifests() == \
        ["step00000000.json", "step00000002.json", "step00000004.json"]
    # the step-0 manifests are the same bits: both start from JAX's params
    for blob in (e["blob"] for e in store.get_manifest("step00000000.json")["leaves"]):
        assert store.get(blob) == JFileStore(str(tmp_path / "jax")).get(blob)
    got = train_state_to_jax(params, opt)
    want = JBlobCheckpointer(JFileStore(str(tmp_path / "jax"))).restore(
        4, jax.tree.map(np.zeros_like, got))
    assert int(got["opt"]["count"]) == int(want["opt"]["count"]) == 4
    # four AdamW steps from the same start: the parameters agree to the
    # step's bound on each update (lr 1e-3 a step)
    for a, b in zip(jax.tree.leaves(got["params"]), jax.tree.leaves(want["params"])):
        np.testing.assert_allclose(a, b, atol=4e-5, rtol=LOSS_RTOL)


_JAX_PLANS = textwrap.dedent("""
    import os
    os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=8'
    import json
    from repro.configs import get_config
    from repro.distributed.sharding import DEFAULT_RULES
    from repro.launch.mesh import make_test_mesh
    from repro.models import lm
    from repro.runtime import elastic_restore_plan

    def specs(tree, prefix=''):
        if isinstance(tree, dict):
            return {p: s for k, v in tree.items() for p, s in specs(v, prefix + '/' + k).items()}
        return {prefix: str(tree.spec)}

    defs = lm.param_defs(get_config('granite-3-2b', smoke=True))
    out = {}
    for n in (8, 4):
        plan = elastic_restore_plan(defs, DEFAULT_RULES, make_test_mesh(devices=n))
        out[n] = {'dp_degree': plan['dp_degree'], 'devices': plan['devices'],
                  'specs': specs(plan['shardings'])}
    print('PLANS', json.dumps(out))
    """)


def _shardings(tree, prefix=""):
    """A nested dict of NamedShardings -> {key path: sharding}."""
    if isinstance(tree, dict):
        return {p: s for k, v in tree.items() for p, s in _shardings(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


def test_elastic_restore_different_mesh(tmp_path):
    """Save on one topology, restore onto another (8 -> 4 ranks)."""
    r = subprocess.run([sys.executable, "-c", _JAX_PLANS],
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    jplans = json.loads(r.stdout.split("PLANS", 1)[1])
    cfg = get_config("granite-3-2b", smoke=True)
    defs = lm.param_defs(cfg)
    plans = {n: elastic_restore_plan(defs, DEFAULT_RULES, make_test_mesh(devices=n))
             for n in (8, 4)}
    for n, plan in plans.items():
        want = jplans[str(n)]
        assert (plan["dp_degree"], plan["devices"]) == (want["dp_degree"], want["devices"])
        assert {p: str(s.spec) for p, s in _shardings(plan["shardings"]).items()} == \
            want["specs"]

    def model_of(seed):
        model = init_params(lm.LM(cfg, device="cpu"), torch.Generator().manual_seed(seed))
        return model, train_state_tree(model, adamw_init(model))["params"]

    source, source_tree = model_of(0)
    ck = BlobCheckpointer(FileStore(str(tmp_path / "e")), async_upload=False)
    ck.save(1, source_tree)
    on8, on8_tree = model_of(1)          # the model placed on the 8-rank mesh
    ck.restore(1, on8_tree, shardings=plans[8]["shardings"])
    ck.save(3, on8_tree)
    on4, on4_tree = model_of(2)          # a different topology
    restored = ck.restore(3, on4_tree, shardings=plans[4]["shardings"])
    assert restored is not None and sorted(restored) == sorted(source_tree)
    for (name, a), (_, b) in zip(on4.named_parameters(), source.named_parameters()):
        assert_same_bits(a.detach(), b.detach())
    assert {s.mesh.size for s in _shardings(plans[4]["shardings"]).values()} == {4}


def test_hedged_fetch_improves_heavy_tail():
    """Hedging pays off under degraded-store incidents (heavy tail σ=0.8),
    on the port's copy of the JAX package's module."""
    from repro_torch.core.stores import LatencyModel
    h = HedgedFetcher(LatencyModel(sigma=0.8), hedge_quantile=0.95, seed=0)
    base, hedged = h.tail_improvement(16 * 1024 * 1024, n=30000, pct=99.9)
    assert hedged < base * 0.75                   # ≥25% p99.9 cut
    assert h.stats.hedges / h.stats.requests < 0.12  # ≤12% extra requests


def test_hedged_fetch_equals_jax_draw_for_draw():
    from repro.core.stores import LatencyModel as JLatencyModel
    from repro.runtime import HedgedFetcher as JHedgedFetcher
    from repro_torch.core.stores import LatencyModel
    h = HedgedFetcher(LatencyModel(sigma=0.8), seed=3)
    jh = JHedgedFetcher(JLatencyModel(sigma=0.8), seed=3)
    assert h.tail_improvement(1 << 20, n=2000) == jh.tail_improvement(1 << 20, n=2000)
    assert dataclasses.asdict(h.stats) == dataclasses.asdict(jh.stats)


def test_launcher_commits_manifests_jax_restores(tmp_path):
    from repro_torch.launch import train
    arch = "deepseek-v2-lite-16b"
    ckpt_dir = tmp_path / "ckpt"
    losses = train.main(["--arch", arch, "--device", "cpu", "--ckpt-dir", str(ckpt_dir),
                         "--steps", "4", "--ckpt-every", "2", "--batch", "2", "--seq", "16"])
    assert len(losses) == 4 and all(np.isfinite(losses))
    store = JFileStore(str(ckpt_dir))
    assert store.manifests() == ["step00000000.json", "step00000002.json",
                                 "step00000004.json"]
    jcfg = jget_config(arch, smoke=True)
    params = jinit_params(jlm.param_defs(jcfg), jax.random.key(0))
    like = {"params": params, "opt": jadamw_init(params)}
    out = JBlobCheckpointer(store).restore(4, like)
    assert jax.tree.structure(out) == jax.tree.structure(like)
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(like)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert int(out["opt"]["count"]) == 4
    assert all(np.isfinite(np.asarray(a)).all() for a in jax.tree.leaves(out))
    # the port reads the same manifest back into the model it trains
    model = lm.LM(get_config(arch, smoke=True), device="cpu")
    opt = adamw_init(model)
    BlobCheckpointer(FileStore(str(ckpt_dir))).restore(4, train_state_tree(model, opt))
    for a, b in zip(jax.tree.leaves(train_state_to_jax(model, opt)), jax.tree.leaves(out)):
        assert_same_bits(a, np.asarray(b))
