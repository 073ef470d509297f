"""``make_train_step`` over a ``ProcessGroupMesh`` (4 gloo processes, pod 2
x model 2) against the stacked back end and the JAX package.

    PYTHONPATH=src python -m pytest -q tests/test_torch_pg_train_step.py

One step of deepseek-v2-lite SMOKE in f32, two microbatches, remat
``full``, ``ShuffleConfig(mode="blob")``, from the parameters and batch
of ``tests/test_torch_grad_sync.py``'s ``jax_blob_steps`` (JAX's draw,
``params_from_jax``), in every sync mode:

(c) ``auto``: every process takes the whole batch and dispatches its MoE
    layers over the processes (``ep_moe_ffn`` through the exchange's
    autograd Functions). Against the stacked ``auto`` step on the same
    mesh and against JAX's (``jax.jit(make_train_step(...))`` on 4 host
    devices over the same mesh, one subprocess): the metrics within
    1e-5, the first moment over ``1 - beta1`` (the step's gradient)
    within ``GRAD_TOL`` atol and rtol; the four processes' updated
    parameters and moments the same bits. With the router's weight read
    without ``shard(w, ())``, the step raises on all four processes.
(d) ``blob`` and ``blob_int8``: each process takes its pod's block of the
    batch (JAX's ``P("pod")``), the pod region's loss gets no mesh, and
    the pods' gradients meet in the blob sync over the processes. Bit for
    bit the stacked step on ``make_test_mesh(devices=8)`` (only the pod
    count enters the step; both at one thread, as a GEMM's bits can
    follow the thread count), and against JAX's ``jax_blob_steps`` with
    ``test_blob_train_step_matches_jax``'s bounds.

The gloo processes run once for the module (``run_gloo``: a file
rendezvous, killed at the time limit).
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax
import numpy as np

from repro_torch.configs import get_config
from repro_torch.interop import params_from_jax
from repro_torch.launch import mesh as M
from repro_torch.shuffle import api
from repro_torch.training import OptConfig, TrainConfig, adamw_init, make_train_step
import test_torch_grad_sync as grad_sync_tests
from test_torch_grad_sync import (GRAD_TOL, INT8_STEPS, STEP_ARCH, STEP_METRICS, STEP_OPT,
                                  _first_adamw_step)
from test_torch_pg_autograd import run_gloo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PG_MESH = {"pod": 2, "model": 2}
SYNCS = ("auto", "blob", "blob_int8")
METRIC_TOL = dict(rtol=1e-5, atol=1e-7)
# JAX's blob steps, the parameters and the batch: the fixture, run for this module too
jax_blob_steps = grad_sync_tests.jax_blob_steps


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return dataclasses.replace(get_config(STEP_ARCH, smoke=True), compute_dtype=torch.float32)


def _tcfg(sync):
    return TrainConfig(opt=OptConfig(**STEP_OPT), microbatches=2, remat="full",
                       shuffle=api.ShuffleConfig(mode="blob"), grad_sync=sync,
                       grad_sync_blob_bytes=4096)


def _step(sync, mesh, jparams, batch):
    """One step of ``sync`` from JAX's parameters: (parameters, first
    moment, metrics), keyed by parameter name."""
    cfg = _cfg()
    params = params_from_jax(cfg, jparams, device="cpu")
    params, opt, m = make_train_step(cfg, _tcfg(sync), mesh=mesh)(
        params, adamw_init(params), {k: torch.from_numpy(v) for k, v in batch.items()})
    return ({n: p.detach() for n, p in params.named_parameters()}, opt["m"],
            {k: float(v) for k, v in m.items()})


WORKER = """
import dataclasses, json, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.launch.mesh import process_group_mesh
from repro_torch.models import lm
from repro_torch.shuffle import exchange
from repro_torch.shuffle.api import ShuffleConfig
from repro_torch.training import OptConfig, TrainConfig, adamw_init, make_train_step

rank, folder = int(sys.argv[1]), sys.argv[2]
arch, opt, sizes, syncs = sys.argv[3], *(json.loads(a) for a in sys.argv[4:7])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{folder}/rendezvous", rank=rank,
                        world_size=4)
mesh = process_group_mesh(**sizes)
cfg = dataclasses.replace(get_config(arch, smoke=True), compute_dtype=torch.float32)
start = torch.load(f"{folder}/params.pt")
batch = {k: torch.from_numpy(v) for k, v in np.load(f"{folder}/batch.npz").items()}
model = lm.LM(cfg, device="cpu")
out = {}


def step(sync):
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(start[n])
    tcfg = TrainConfig(opt=OptConfig(**opt), microbatches=2, remat="full",
                       shuffle=ShuffleConfig(mode="blob"), grad_sync=sync,
                       grad_sync_blob_bytes=4096)
    return make_train_step(cfg, tcfg, mesh=mesh)(model, adamw_init(model), batch)


for sync in syncs:
    params, o, m = step(sync)
    for n, p in params.named_parameters():
        # a copy: the next sync writes the same parameters in place
        out[f"{sync}|p|{n}"], out[f"{sync}|m|{n}"] = p.detach().numpy().copy(), o["m"][n].numpy()
    out.update({f"{sync}|{k}": np.float64(float(v)) for k, v in m.items()})
# the router's weight read without shard(w, ()): each process keeps only
# its own tokens' share of its gradient, which the step must refuse
shard = exchange.ProcessGroups.shard
exchange.ProcessGroups.shard = lambda ex, x, axes: (x[None] if not tuple(axes)
                                                    else shard(ex, x, axes))
try:
    step("auto")
    out["unshared"] = np.str_("")
except RuntimeError as e:
    out["unshared"] = np.str_(str(e))
np.savez(f"{folder}/out{rank}.npz", **out)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def pg_steps(tmp_path_factory, jax_blob_steps):
    """One step of each sync on 4 gloo processes: {sync: [(parameters,
    first moment, metrics) of each rank]}, and under ``"unshared"`` each
    rank's error from an ``auto`` step whose router weight skips
    ``shard(w, ())`` ("" had it not raised)."""
    import json

    jparams, batch, _ = jax_blob_steps
    folder = tmp_path_factory.mktemp("pg_steps")
    start = params_from_jax(_cfg(), jparams, device="cpu")
    torch.save({n: p.detach() for n, p in start.named_parameters()}, folder / "params.pt")
    np.savez(folder / "batch.npz", **batch)
    outs = run_gloo(folder, textwrap.dedent(WORKER), STEP_ARCH, json.dumps(STEP_OPT),
                    json.dumps(PG_MESH), json.dumps(SYNCS), timeout=600)

    def part(o, sync, kind):
        prefix = f"{sync}|{kind}|"
        return {k[len(prefix):]: torch.from_numpy(v) for k, v in o.items()
                if k.startswith(prefix)}
    runs = {sync: [(part(o, sync, "p"), part(o, sync, "m"),
                    {k.split("|")[1]: float(v) for k, v in o.items()
                     if k.startswith(f"{sync}|") and k.count("|") == 1})
                   for o in outs] for sync in SYNCS}
    runs["unshared"] = [str(o["unshared"]) for o in outs]
    return runs


JAX_AUTO = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.launch.mesh import _mesh
from repro.models import lm
from repro.models.common import init_params
from repro.shuffle.api import ShuffleConfig
from repro.training import OptConfig, TrainConfig, adamw_init, make_train_step
folder = sys.argv[1]
cfg = dataclasses.replace(get_config(ARCH, smoke=True), compute_dtype=jnp.float32)
treedef = jax.tree.structure(init_params(lm.param_defs(cfg), jax.random.key(0)))
a = np.load(f"{folder}/in.npz")
params = jax.tree.unflatten(treedef, [jnp.asarray(a[f"p{i}"])
                                      for i in range(treedef.num_leaves)])
batch = {"tokens": jnp.asarray(a["tokens"]), "labels": jnp.asarray(a["labels"])}
tcfg = TrainConfig(opt=OptConfig(**OPT), microbatches=2, shuffle=ShuffleConfig(mode="blob"),
                   grad_sync="auto")
step = jax.jit(make_train_step(cfg, tcfg, mesh=_mesh((2, 2), ("pod", "model"))))
p2, o2, m = step(params, adamw_init(params), batch)
out = {f"m{i}": np.asarray(l) for i, l in enumerate(jax.tree.leaves(o2["m"]))}
out.update({k: np.asarray(v) for k, v in m.items()})
np.savez(f"{folder}/out.npz", **out)
"""


@pytest.fixture(scope="module")
def jax_auto_step(tmp_path_factory, jax_blob_steps):
    """JAX's ``auto`` step with the ``blob`` shuffle over pod 2 x model 2
    host devices, in one subprocess: (first moment as the port's
    parameters, metrics)."""
    jparams, batch, _ = jax_blob_steps
    folder = tmp_path_factory.mktemp("jax_auto")
    leaves, treedef = jax.tree.flatten(jparams)
    np.savez(folder / "in.npz", **batch,
             **{f"p{i}": np.asarray(l) for i, l in enumerate(leaves)})
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    code = (textwrap.dedent(JAX_AUTO).replace("ARCH", repr(STEP_ARCH))
            .replace("**OPT", f"**{STEP_OPT!r}"))
    r = subprocess.run([sys.executable, "-c", code, str(folder)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    out = dict(np.load(folder / "out.npz"))
    jm = jax.tree.unflatten(treedef, [out[f"m{i}"] for i in range(len(leaves))])
    moment = {n: p.detach() for n, p in params_from_jax(_cfg(), jm, device="cpu")
              .named_parameters()}
    return moment, {k: float(out[k]) for k in STEP_METRICS}


def _check_replicated(runs):
    """The four processes' parameters and first moments, the same bits."""
    p0, m0, _ = runs[0]
    for p, m, _ in runs[1:]:
        for n in p0:
            assert torch.equal(p[n], p0[n]) and torch.equal(m[n], m0[n]), n


def _check_auto(runs, moment, metrics):
    ocfg = OptConfig(**STEP_OPT)
    for _, m, got in runs:
        for k in STEP_METRICS:
            np.testing.assert_allclose(got[k], metrics[k], err_msg=k, **METRIC_TOL)
        for n, want in moment.items():
            np.testing.assert_allclose((m[n] / (1 - ocfg.beta1)).numpy(),
                                       (want / (1 - ocfg.beta1)).numpy(), atol=GRAD_TOL,
                                       rtol=GRAD_TOL, err_msg=n)


# ---------------------------------------------------------------------------
# (c) the auto step: expert parallelism over the processes
# ---------------------------------------------------------------------------

def test_auto_step_over_processes_matches_the_stacked_step(pg_steps, jax_blob_steps):
    jparams, batch, _ = jax_blob_steps
    runs = pg_steps["auto"]
    _check_replicated(runs)
    _, moment, metrics = _step("auto", M.stacked_mesh(**PG_MESH), jparams, batch)
    _check_auto(runs, moment, metrics)
    assert "grad_sync_bytes" not in runs[0][2]


def test_auto_step_over_processes_matches_jax(pg_steps, jax_auto_step):
    moment, metrics = jax_auto_step
    _check_auto(pg_steps["auto"], moment, metrics)


def test_auto_step_over_processes_refuses_a_weight_read_unshared(pg_steps):
    """Every process raises alike, so none is left waiting on the others."""
    for err in pg_steps["unshared"]:
        assert "gradient norms differ" in err, err


# ---------------------------------------------------------------------------
# (d) the blob syncs: each process its pod's block of the batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sync", ["blob", "blob_int8"])
def test_blob_step_over_processes_is_the_stacked_step(pg_steps, jax_blob_steps, sync):
    jparams, batch, _ = jax_blob_steps
    runs = pg_steps[sync]
    _check_replicated(runs)
    params, moment, metrics = _step(sync, M.make_test_mesh(devices=8), jparams, batch)
    for p, m, got in runs:
        assert got == metrics
        for n in params:
            assert torch.equal(p[n], params[n]) and torch.equal(m[n], moment[n]), n


@pytest.mark.parametrize("sync", ["blob", "blob_int8"])
def test_blob_step_over_processes_matches_jax(pg_steps, jax_blob_steps, sync):
    """``test_blob_train_step_matches_jax``'s bounds, on each process."""
    jparams, _, ref = jax_blob_steps
    jp, jm, jmetrics = ref[sync]
    cfg = _cfg()
    start = {n: p.detach() for n, p in params_from_jax(cfg, jparams, device="cpu")
             .named_parameters()}
    ocfg = OptConfig(**STEP_OPT)
    want_g = {n: p.detach() / (1 - ocfg.beta1)
              for n, p in params_from_jax(cfg, jm, device="cpu").named_parameters()}
    want_p = {n: p.detach() for n, p in params_from_jax(cfg, jp, device="cpu")
              .named_parameters()}
    largest = max(float(g.abs().max()) for g in want_g.values())
    for params, moment, metrics in pg_steps[sync]:
        for k in STEP_METRICS:
            np.testing.assert_allclose(metrics[k], jmetrics[k], err_msg=k, **METRIC_TOL)
        for name, p in params.items():
            g = moment[name] / (1 - ocfg.beta1)
            if sync == "blob":
                np.testing.assert_allclose(g.numpy(), want_g[name].numpy(), atol=GRAD_TOL,
                                           rtol=GRAD_TOL, err_msg=name)
            else:
                err = float((g - want_g[name]).abs().max())
                assert err <= INT8_STEPS * largest / 127, (name, err / largest)
            w = want_p[name]
            bound = 1e-5 + 1e-5 * w.abs()
            own = (want_g[name].abs() < 1e-5) | (sync == "blob_int8")
            got = torch.where(own, p - _first_adamw_step(start[name], g, metrics["lr"], ocfg),
                              p - w)
            assert bool((got.abs() <= bound).all()), (name, float((got.abs() - bound).max()))
