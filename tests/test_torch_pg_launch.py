"""The train launcher (``repro_torch.launch.train``) over 4 gloo processes,
and the test mesh's axes over processes (``launch.mesh``).

    PYTHONPATH=src python -m pytest -q tests/test_torch_pg_launch.py

The run: each of 4 processes initialises the default process group
through a file rendezvous and calls ``launch.train.main`` with ``--device
cpu``, deepseek-v2-lite SMOKE, ``--moe-mode blob``, ``STEPS`` steps and
a checkpoint every 2. The launcher lays ``make_test_mesh(devices=4)``'s
axes (data 2 x model 2) over the processes, so the MoE layers dispatch
their tokens over the processes (``blob`` with no pod axis runs
``direct``). Held:

* the four processes' losses are the same bits, and within
  ``METRIC_TOL`` of ``make_train_step`` over the stacked
  ``make_test_mesh(devices=4)`` in this process, from the same seed and
  batches (the launcher's own draw: the two packages' launchers draw
  different weights and batches, so JAX enters through the mesh's axes
  here and through the stacked-against-JAX tests);
* each process wrote its committed manifests into its own directory,
  ``<ckpt-dir>/process<rank>``, and no other path;
* a one-process ``BlobCheckpointer.restore`` of process 0's last
  manifest into a fresh model gives that process's final parameters bit
  for bit;
* ``main`` leaves a process group that the caller initialised as it was.

The pure case, with no processes: ``axes_of_test_mesh`` for 1, 2, 4 and
8 ranks is ``make_test_mesh``'s, and for every count the JAX package's
``make_test_mesh`` (its ``_mesh`` read, no device built);
``process_group_test_mesh`` refuses an uninitialised group by name.
"""

import json
import os
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import mesh as jmesh
from repro_torch.checkpoint import BlobCheckpointer, FileStore, latest_step
from repro_torch.configs import get_config
from repro_torch.data import lm_batch_stream
from repro_torch.interop import train_state_tree
from repro_torch.launch import mesh as M
from repro_torch.models import lm
from repro_torch.models.common import init_params
from repro_torch.shuffle.api import ShuffleConfig
from repro_torch.training import OptConfig, TrainConfig, adamw_init, make_train_step
from test_torch_pg_autograd import run_gloo
from test_torch_pg_train_step import METRIC_TOL

ARCH = "deepseek-v2-lite-16b"
STEPS, CKPT_EVERY, BATCH, SEQ = 3, 2, 8, 32
ARGS = ["--arch", ARCH, "--smoke", "--device", "cpu", "--moe-mode", "blob",
        "--steps", str(STEPS), "--ckpt-every", str(CKPT_EVERY), "--batch", str(BATCH),
        "--seq", str(SEQ)]

WORKER = """
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.launch import train
from repro_torch.runtime import FaultTolerantTrainer

rank, folder, args = int(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{folder}/rendezvous", rank=rank,
                        world_size=4)
ran = []
real = FaultTolerantTrainer.run


def run(self, *a, **k):
    # the trainer's final state, which main does not return
    ran.append(real(self, *a, **k))
    return ran[-1]


FaultTolerantTrainer.run = run
losses = train.main(args + ["--ckpt-dir", f"{folder}/ckpt"])
params, _, _ = ran[0]
out = {f"p|{n}": p.detach().numpy().copy() for n, p in params.named_parameters()}
out["losses"] = np.asarray(losses, dtype=np.float64)
out["still_initialised"] = np.bool_(dist.is_initialized())
np.savez(f"{folder}/out{rank}.npz", **out)
dist.destroy_process_group()
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The launcher in 4 gloo processes: (folder, each rank's outputs)."""
    folder = tmp_path_factory.mktemp("pg_launch")
    outs = run_gloo(folder, textwrap.dedent(WORKER), json.dumps(ARGS), timeout=240)
    return folder, outs


def _fresh(cfg):
    return init_params(lm.LM(cfg, device="cpu"), torch.Generator(device="cpu").manual_seed(0))


def test_the_processes_losses_are_the_same_bits_and_the_stacked_step_s(launched):
    _, outs = launched
    losses = [o["losses"] for o in outs]
    assert all(len(l) == STEPS and l.tobytes() == losses[0].tobytes() for l in losses), losses
    assert all(bool(o["still_initialised"]) for o in outs)
    # the launcher's step, stacked: the same config, seed and batches
    cfg = get_config(ARCH, smoke=True)
    tcfg = TrainConfig(opt=OptConfig(learning_rate=3e-4, total_steps=STEPS), microbatches=1,
                       shuffle=ShuffleConfig(mode="blob"), grad_sync="auto")
    mesh = M.make_test_mesh(devices=4)
    assert mesh.shape == {"data": 2, "model": 2}
    params = _fresh(cfg)
    opt = adamw_init(params)
    step = make_train_step(cfg, tcfg, mesh=mesh)
    batch_fn = lm_batch_stream(cfg.vocab_size, BATCH, SEQ, device="cpu")
    want = []
    for s in range(STEPS):
        params, opt, m = step(params, opt, batch_fn(s))
        want.append(float(m["loss"]))
    np.testing.assert_allclose(losses[0], want, **METRIC_TOL)
    assert np.all(np.isfinite(want))


def test_each_process_checkpoints_into_its_own_directory(launched):
    folder, _ = launched
    root = folder / "ckpt"
    assert sorted(p.name for p in root.iterdir()) == [f"process{r}" for r in range(4)]
    want = ["objects", "manifests"]
    for r in range(4):
        d = root / f"process{r}"
        assert sorted(p.name for p in d.iterdir()) == sorted(want)
        store = FileStore(str(d))
        assert latest_step(store) == STEPS
        steps = sorted(int(n[4:12]) for n in store.manifests())
        assert steps == [0, CKPT_EVERY, STEPS], steps
    # no path shared: each process's files lie under its own directory only
    files = [p.relative_to(root) for p in root.rglob("*") if p.is_file()]
    assert files and all(f.parts[0].startswith("process") for f in files)
    assert not any(p.name.endswith(".tmp") for p in root.rglob("*"))


def test_process_0_s_last_manifest_restores_its_final_parameters(launched):
    folder, outs = launched
    cfg = get_config(ARCH, smoke=True)
    model = _fresh(cfg)
    ck = BlobCheckpointer(FileStore(str(folder / "ckpt" / "process0")))
    ck.restore(STEPS, train_state_tree(model, adamw_init(model)))
    got = {n: p.detach().numpy() for n, p in model.named_parameters()}
    want = {k[2:]: v for k, v in outs[0].items() if k.startswith("p|")}
    assert set(got) == set(want)
    bad = [n for n in want if got[n].tobytes() != want[n].tobytes()]
    assert not bad, bad[:5]
    # and the restore moved them: the fresh draw is not the final state
    assert any(_fresh(cfg).state_dict()[n].numpy().tobytes() != want[n].tobytes()
               for n in want)


@pytest.mark.parametrize("ranks", [1, 2, 4, 8])
def test_the_test_mesh_axes_over_processes_are_make_test_mesh_s_and_jax_s(monkeypatch, ranks):
    axes = M.axes_of_test_mesh(ranks)
    stacked = M.make_test_mesh(devices=ranks)
    assert axes == stacked.shape and tuple(axes) == stacked.axis_names
    # JAX's table, read through its _mesh with no device built
    monkeypatch.setattr(jmesh, "_mesh", lambda shape, names: dict(zip(names, shape)))
    want = jmesh.make_test_mesh(devices=ranks)
    assert axes == want and list(axes) == list(want)


def test_the_process_group_test_mesh_refuses_an_uninitialised_group():
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="process_group_test_mesh needs the default process "
                                         "group initialised"):
        M.process_group_test_mesh()
