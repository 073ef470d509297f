"""repro_torch.distributed.gpipe_apply against the JAX package's
gpipe_apply and the sequential stack: (a) JAX's case (2 stages, d 32, B
16, 4 microbatches) on 8 host devices against the port on the stacked
test mesh, same numpy-made inputs, the output and ``jax.grad`` of
``(y * g).sum()`` with respect to the parameters and x, within 1e-5;
(b) 4 stacked stages at 1, 3 and 8 microbatches against the sequential
stack; (c) gradients through the stacked pipeline against those through
the sequential stack; (d) gloo processes (pod 2; pod 2 x model 2; pod 4)
against the stacked pipeline: the output bit for bit, the process-group
``ppermute`` and its gradient (the reverse hop) bit for bit, the
pipeline's gradients at 1 and 4 microbatches (the stacked pipeline's
bits, within 1e-5 of the sequential stack's and of JAX's, the same bits
on every process), and a ``stage_fn`` that closes over a weight that
requires grad in stage 1 only, which every process differentiates
through to the end; (e) the refusals.

    PYTHONPATH=src python -m pytest -q tests/test_torch_pipeline_parallel.py
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.distributed import gpipe_apply
from repro_torch.launch import mesh as M
from repro_torch.shuffle.exchange import for_mesh
from test_torch_pg_autograd import run_gloo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-5, rtol=1e-5)       # tests/test_pipeline_parallel.py's


def stage_fn(p, xm):
    return torch.tanh(xm @ p["w"] + p["b"])


def make_inputs(n_stages, d, B, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n_stages, d, d)) / np.sqrt(d)).astype(np.float32)
    b = (rng.standard_normal((n_stages, d)) * 0.1).astype(np.float32)
    x = rng.standard_normal((B, d)).astype(np.float32)
    return {"w": w, "b": b}, x


def sequential(params, x):
    for s in range(params["w"].shape[0]):
        x = stage_fn({k: v[s] for k, v in params.items()}, x)
    return x


def tensors(params, x):
    return {k: torch.from_numpy(v) for k, v in params.items()}, torch.from_numpy(x)


def cotangent(shape, seed=3):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def grads(fn, params, x, g):
    """[dw, db, dx] of ``(fn(params, x) * g).sum()``."""
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    xx = x.clone().requires_grad_()
    (fn(p, xx) * g).sum().backward()
    return [p["w"].grad, p["b"].grad, xx.grad]


# ---------------------------------------------------------------------------
# (a) against JAX on 8 host devices
# ---------------------------------------------------------------------------

JAX_GPIPE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.distributed.pipeline_parallel import gpipe_apply
from repro.launch.mesh import make_test_mesh

a = np.load(sys.argv[1])
mesh = make_test_mesh(devices=8)          # pod=2 -> 2 pipeline stages
assert mesh.shape["pod"] == 2

def stage_fn(p, xm):
    return jnp.tanh(xm @ p["w"] + p["b"])

def apply(p, x):
    return gpipe_apply(stage_fn, p, x, mesh=mesh, n_micro=4)

params = {"w": a["w"], "b": a["b"]}
out = jax.jit(apply)(params, a["x"])
dp, dx = jax.jit(jax.grad(lambda p, x: (apply(p, x) * a["g"]).sum(), argnums=(0, 1)))(
    params, a["x"])
np.savez(sys.argv[2], y=np.asarray(out), dw=np.asarray(dp["w"]), db=np.asarray(dp["b"]),
         dx=np.asarray(dx))
"""


@pytest.fixture(scope="module")
def jax_gpipe(tmp_path_factory):
    """JAX's output and [dw, db, dx] on 8 host devices, for the inputs of
    ``make_inputs(2, 32, 16)`` and the cotangent ``cotangent((16, 32))``."""
    folder = tmp_path_factory.mktemp("jax_gpipe")
    params, x = make_inputs(2, 32, 16)
    np.savez(folder / "in.npz", x=x, g=cotangent(x.shape), **params)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_GPIPE),
                        str(folder / "in.npz"), str(folder / "out.npz")],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    out = dict(np.load(folder / "out.npz"))
    return out["y"], [out["dw"], out["db"], out["dx"]]


def test_gpipe_matches_jax_on_8_host_devices(jax_gpipe):
    params, x = make_inputs(2, 32, 16)
    want = jax_gpipe[0]
    y = gpipe_apply(stage_fn, *tensors(params, x), mesh=M.make_test_mesh(devices=8),
                    n_micro=4)
    np.testing.assert_allclose(y.numpy(), want, **TOL)
    np.testing.assert_allclose(y.numpy(), sequential(*tensors(params, x)).numpy(), **TOL)


@pytest.mark.parametrize("n_micro", [1, 4])
def test_stacked_gpipe_gradients_match_jax(jax_gpipe, n_micro):
    params, x = make_inputs(2, 32, 16)
    got = grads(lambda p, xx: gpipe_apply(stage_fn, p, xx, n_micro=n_micro,
                                          mesh=M.make_test_mesh(devices=8)),
                *tensors(params, x), torch.from_numpy(cotangent(x.shape)))
    for a, want in zip(got, jax_gpipe[1]):
        np.testing.assert_allclose(a.numpy(), want, **TOL)


# ---------------------------------------------------------------------------
# (b), (c) the stacked back end against the sequential stack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_micro", [1, 3, 8])
@pytest.mark.parametrize("mesh", [M.stacked_mesh(pod=4),
                                  M.stacked_mesh(data=2, pod=4, model=2)],
                         ids=["pod4", "data2-pod4-model2"])
def test_stacked_gpipe_matches_the_sequential_stack(n_micro, mesh):
    params, x = tensors(*make_inputs(4, 32, 24))
    y = gpipe_apply(stage_fn, params, x, mesh=mesh, n_micro=n_micro)
    assert y.shape == x.shape
    torch.testing.assert_close(y, sequential(params, x), **TOL)


@pytest.mark.parametrize("n_micro", [1, 3, 8])
def test_stacked_gpipe_gradients_match_the_sequential_stack(n_micro):
    params, x = tensors(*make_inputs(4, 32, 24))
    g = torch.from_numpy(cotangent(x.shape))
    got = grads(lambda p, xx: gpipe_apply(stage_fn, p, xx, mesh=M.stacked_mesh(pod=4),
                                          n_micro=n_micro), params, x, g)
    for a, b in zip(got, grads(sequential, params, x, g)):
        torch.testing.assert_close(a, b, **TOL)


def test_stacked_ppermute_shifts_one_hop_along_the_axis():
    mesh = M.stacked_mesh(pod=3, data=2, model=2)
    ex = for_mesh(mesh)
    x = torch.arange(mesh.size * 5, dtype=torch.float32).reshape(mesh.size, 5)
    coords = np.array(np.unravel_index(np.arange(mesh.size), mesh.sizes)).T
    for i, axis in enumerate(mesh.axis_names):
        y = ex.ppermute(x, axis)
        for r, c in enumerate(coords):
            src = c.copy()
            src[i] = (c[i] - 1) % mesh.sizes[i]
            assert torch.equal(y[r], x[np.ravel_multi_index(src, mesh.sizes)])


# ---------------------------------------------------------------------------
# (d) process groups against the stacked pipeline
# ---------------------------------------------------------------------------

PG_WORKER = """
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.distributed import gpipe_apply
from repro_torch.launch.mesh import process_group_mesh
from repro_torch.shuffle.exchange import for_mesh

rank, folder, sizes = int(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{folder}/rendezvous", rank=rank,
                        world_size=int(np.prod(list(sizes.values()))))
mesh = process_group_mesh(**sizes)
a = np.load(f"{folder}/in.npz")
params = {"w": torch.from_numpy(a["w"]), "b": torch.from_numpy(a["b"])}
x, g = torch.from_numpy(a["x"]), torch.from_numpy(a["g"])

def stage_fn(p, xm):
    return torch.tanh(xm @ p["w"] + p["b"])

out = {f"y{n}": gpipe_apply(stage_fn, params, x, mesh=mesh, n_micro=n).numpy()
       for n in (1, 4)}
ex = for_mesh(mesh)
t = torch.arange(6, dtype=torch.float32)[None] + 10 * rank
for axis in mesh.axis_names:
    out["perm_" + axis] = ex.ppermute(t, axis).numpy()
    # the gradient of <ppermute(t), c>: the cotangent one hop back
    tg = t.clone().requires_grad_()
    (ex.ppermute(tg, axis) * torch.from_numpy(a["c"][rank:rank + 1])).sum().backward()
    out["dperm_" + axis] = tg.grad.numpy()
for n in (1, 4):
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    xx = x.clone().requires_grad_()
    (gpipe_apply(stage_fn, p, xx, mesh=mesh, n_micro=n) * g).sum().backward()
    out[f"dw{n}"], out[f"db{n}"], out[f"dx{n}"] = (p["w"].grad.numpy(),
                                                   p["b"].grad.numpy(), xx.grad.numpy())
# a weight that requires grad, closed over by stage 1 alone: every stage
# records alike, so the loss requires grad and backward ends everywhere
stage = mesh.coords["pod"]
w_closed = params["w"][stage].clone().requires_grad_(stage == 1)
loss = (gpipe_apply(lambda p, xm: torch.tanh(xm @ w_closed + p["b"]), params, x,
                    mesh=mesh, n_micro=4) * g).sum()
out["closed_records"] = np.int64(loss.requires_grad)
loss.backward()
if stage == 1:
    out["dw_closed"] = w_closed.grad.numpy()
np.savez(f"{folder}/out{rank}.npz", **out)
dist.destroy_process_group()
"""
PG_SIZES = [{"pod": 2}, {"pod": 2, "model": 2}, {"pod": 4}]


def bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.uint32)


@pytest.mark.parametrize("sizes", PG_SIZES, ids=["pod2", "pod2-model2", "pod4"])
def test_process_groups_match_the_stacked_pipeline(tmp_path, sizes, jax_gpipe):
    world, n_stages = int(np.prod(list(sizes.values()))), sizes["pod"]
    params, x = make_inputs(n_stages, 32, 16)
    g = cotangent(x.shape)
    c = cotangent((world, 6), seed=5)
    np.savez(tmp_path / "in.npz", x=x, g=g, c=c, **params)
    got = run_gloo(tmp_path, textwrap.dedent(PG_WORKER), json.dumps(sizes), n=world,
                   timeout=120)
    mesh = M.stacked_mesh(**sizes)
    for n in (1, 4):
        want = gpipe_apply(stage_fn, *tensors(params, x), mesh=mesh, n_micro=n).numpy()
        for r in range(world):
            assert np.array_equal(got[r][f"y{n}"].view(np.uint32), want.view(np.uint32))
    ex = for_mesh(mesh)
    t = torch.arange(6, dtype=torch.float32)[None] + 10 * torch.arange(world * 1.0)[:, None]
    for axis in mesh.axis_names:
        want = ex.ppermute(t, axis)
        tg = t.clone().requires_grad_()
        (ex.ppermute(tg, axis) * torch.from_numpy(c)).sum().backward()
        for r in range(world):
            assert np.array_equal(got[r]["perm_" + axis][0], want[r].numpy())
            assert np.array_equal(bits(got[r]["dperm_" + axis][0]), bits(tg.grad[r]))
    g = torch.from_numpy(g)
    seq = grads(sequential, *tensors(params, x), g)
    for n in (1, 4):
        stacked = grads(lambda p, xx: gpipe_apply(stage_fn, p, xx, mesh=mesh, n_micro=n),
                        *tensors(params, x), g)
        for i, name in enumerate(("dw", "db", "dx")):
            mine = got[0][f"{name}{n}"]
            for r in range(1, world):             # the same bits on every process
                assert np.array_equal(bits(got[r][f"{name}{n}"]), bits(mine)), (name, n, r)
            np.testing.assert_allclose(mine, stacked[i].numpy(), atol=1e-6, rtol=1e-6)
            assert np.array_equal(bits(mine), bits(stacked[i])), (name, n)
            np.testing.assert_allclose(mine, seq[i].numpy(), **TOL)
            if n_stages == 2:                     # JAX's case
                np.testing.assert_allclose(mine, jax_gpipe[1][i], **TOL)
    closed = [r for r in range(world) if "dw_closed" in got[r]]
    assert all(int(o["closed_records"]) == 1 for o in got)
    assert len(closed) == world // n_stages
    for r in closed:
        np.testing.assert_allclose(got[r]["dw_closed"], seq[0][1].numpy(), **TOL)


# ---------------------------------------------------------------------------
# (e) refusals
# ---------------------------------------------------------------------------

def test_gpipe_refusals():
    params, x = tensors(*make_inputs(2, 8, 12))
    mesh = M.stacked_mesh(pod=2, model=2)
    with pytest.raises(ValueError, match="does not split into 5 microbatches"):
        gpipe_apply(stage_fn, params, x, mesh=mesh, n_micro=5)
    with pytest.raises(ValueError, match=r"params\['w'\] of shape \(2, 8, 8\) needs a "
                       r"leading dim of the 4 stages"):
        gpipe_apply(stage_fn, params, x, mesh=M.stacked_mesh(pod=4), n_micro=2)
    with pytest.raises(ValueError, match="has no 'stage' axis"):
        gpipe_apply(stage_fn, params, x, mesh=mesh, n_micro=2, stage_axis="stage")
    with pytest.raises(ValueError, match="not in the mesh"):
        for_mesh(mesh).ppermute(torch.zeros(4, 3), "stage")
