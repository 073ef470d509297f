"""repro_torch.distributed.gpipe_apply against the JAX package's
gpipe_apply and the sequential stack: (a) JAX's case (2 stages, d 32, B
16, 4 microbatches) on 8 host devices against the port on the stacked
test mesh, same numpy-made inputs, within 1e-5; (b) 4 stacked stages at
1, 3 and 8 microbatches against the sequential stack; (c) gradients
through the stacked pipeline against those through the sequential
stack; (d) gloo processes (pod 2; pod 2 x model 2) against the stacked
pipeline bit for bit, the process-group ``ppermute``, and refusals of
gradients that every stage makes alike, also where only one stage's
``stage_fn`` closes over a weight that requires grad; (e) the
refusals."""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.distributed import gpipe_apply
from repro_torch.launch import mesh as M
from repro_torch.shuffle.exchange import for_mesh

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

out = jax.jit(lambda p, x: gpipe_apply(stage_fn, p, x, mesh=mesh, n_micro=4))(
    {"w": a["w"], "b": a["b"]}, a["x"])
np.save(sys.argv[2], np.asarray(out))
"""


def test_gpipe_matches_jax_on_8_host_devices(tmp_path):
    params, x = make_inputs(2, 32, 16)
    np.savez(tmp_path / "in.npz", x=x, **params)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_GPIPE),
                        str(tmp_path / "in.npz"), str(tmp_path / "out.npy")],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    want = np.load(tmp_path / "out.npy")
    y = gpipe_apply(stage_fn, *tensors(params, x), mesh=M.make_test_mesh(devices=8),
                    n_micro=4)
    np.testing.assert_allclose(y.numpy(), want, **TOL)
    np.testing.assert_allclose(y.numpy(), sequential(*tensors(params, x)).numpy(), **TOL)


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
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(x.shape)
                         .astype(np.float32))

    def grads(fn):
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        xx = x.clone().requires_grad_()
        (fn(p, xx) * g).sum().backward()
        return [p["w"].grad, p["b"].grad, xx.grad]

    got = grads(lambda p, xx: gpipe_apply(stage_fn, p, xx, mesh=M.stacked_mesh(pod=4),
                                          n_micro=n_micro))
    for a, b in zip(got, grads(sequential)):
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
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.distributed import gpipe_apply
from repro_torch.launch.mesh import process_group_mesh
from repro_torch.shuffle.exchange import for_mesh

rank, world, port, folder = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                        world_size=world)
mesh = process_group_mesh(**({"pod": 2} if world == 2 else {"pod": 2, "model": 2}))
a = np.load(f"{folder}/in.npz")
params = {"w": torch.from_numpy(a["w"]), "b": torch.from_numpy(a["b"])}
x = torch.from_numpy(a["x"])

def stage_fn(p, xm):
    return torch.tanh(xm @ p["w"] + p["b"])

out = {f"y{n}": gpipe_apply(stage_fn, params, x, mesh=mesh, n_micro=n).numpy()
       for n in (1, 4)}
ex = for_mesh(mesh)
t = torch.arange(6, dtype=torch.float32)[None] + 10 * rank
for axis in mesh.axis_names:
    out["perm_" + axis] = ex.ppermute(t, axis).numpy()
refused = 0
try:
    ex.ppermute(torch.ones((1, 3), requires_grad=True), "pod")
except ValueError as e:
    refused += "does not differentiate" in str(e)
try:
    gpipe_apply(stage_fn, {k: v.clone().requires_grad_() for k, v in params.items()},
                x, mesh=mesh, n_micro=4)
except ValueError as e:
    refused += "does not differentiate" in str(e)
# a weight that requires grad, closed over by stage 1 alone: stage 0 must
# refuse with it rather than wait on it
stage = mesh.coords["pod"]
w_closed = params["w"][stage].clone().requires_grad_(stage == 1)
try:
    gpipe_apply(lambda p, xm: torch.tanh(xm @ w_closed + p["b"]), params, x,
                mesh=mesh, n_micro=4)
except ValueError as e:
    refused += "does not differentiate" in str(e)
out["refused"] = np.int64(refused)
np.savez(f"{folder}/out{rank}.npz", **out)
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("sizes", [{"pod": 2}, {"pod": 2, "model": 2}],
                         ids=["pod2", "pod2-model2"])
def test_process_groups_match_the_stacked_pipeline(tmp_path, sizes):
    world = int(np.prod(list(sizes.values())))
    params, x = make_inputs(2, 32, 16)
    np.savez(tmp_path / "in.npz", x=x, **params)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", textwrap.dedent(PG_WORKER), str(r),
                               str(world), port, str(tmp_path)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:        # a process stuck in a collective is ended
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    got = [dict(np.load(tmp_path / f"out{r}.npz")) for r in range(world)]
    mesh = M.stacked_mesh(**sizes)
    for n in (1, 4):
        want = gpipe_apply(stage_fn, *tensors(params, x), mesh=mesh, n_micro=n).numpy()
        for r in range(world):
            assert np.array_equal(got[r][f"y{n}"].view(np.uint32), want.view(np.uint32))
    ex = for_mesh(mesh)
    t = torch.arange(6, dtype=torch.float32)[None] + 10 * torch.arange(world * 1.0)[:, None]
    for axis in mesh.axis_names:
        want = ex.ppermute(t, axis)
        for r in range(world):
            assert np.array_equal(got[r]["perm_" + axis][0], want[r].numpy())
    assert all(int(g["refused"]) == 3 for g in got)


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
