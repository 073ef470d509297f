"""Gradients through the process-group exchange (``shuffle.exchange``'s
autograd Functions) against the stacked back end and the JAX package.

    PYTHONPATH=src python -m pytest -q tests/test_torch_pg_autograd.py

Every process computes the same loss on its own copy of what the
collectives replicate; its gradient must be the stacked graph's for the
ranks it holds (``exchange``'s module docstring gives the rule).

(a) Each differentiated collective on 4 gloo processes (pod 2 x model
    2) against the stacked back end: ``all_to_all``, ``psum``,
    ``all_gather``, ``unshard`` and ``shard`` over several axis tuples,
    each under ``sum(tanh(out) * w)``, read once where the output is
    replicated (a psum's or gather's once per group, an unshard's once);
    the output bit for bit (a psum's within f32 rounding: gloo sums in
    another order), each process's input gradient within f32
    rounding of the stacked graph's for its rank, and a replicated
    gradient (``shard``'s) the same bits on all four. One case runs
    shard, all-to-all, unshard and psum under ``torch.utils.checkpoint``,
    whose recompute issues the all-to-all again in the backward pass.
(b) ``ep_moe_ffn``'s gradients over the 4 processes on pod 2 x model 2
    and on pod 2 x data 2 (the data axis a spectator of the experts) in
    ``tests/test_torch_autograd.py``'s ``EP_GRAD_CASES`` (``direct`` and
    ``blob``, without and with drops), loss ``sum(tanh(y)) + aux``:
    within 2e-4 atol and rtol of JAX's on 4 host devices over the same
    mesh (one subprocess), within f32 1e-5 of the stacked back end's,
    and the same bits on all four processes.

Each mesh shape is launched once for the module; the workers rendezvous
through a file under the test's temporary folder (no TCP port), and a
worker still running at the time limit is killed.
"""

import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import mesh as M
from repro_torch.shuffle import api
from repro_torch.shuffle.exchange import for_mesh
from test_torch_autograd import EP_GRAD_CASES, GRAD_TOL, K, _ep_grad_inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"pod_model": {"pod": 2, "model": 2}, "pod_data": {"pod": 2, "data": 2}}
STACKED_TOL = 1e-5      # the stacked back end's gradients (atol and rtol)
F32_TOL = 1e-6          # one collective's gradient: f32 rounding (atol and rtol)
# (collective, axes) on pod 2 x model 2
COLLECTIVES = {
    "all_to_all-pod": ("all_to_all", ("pod",)),
    "all_to_all-model": ("all_to_all", ("model",)),
    "all_to_all-model_pod": ("all_to_all", ("model", "pod")),
    "psum-pod": ("psum", ("pod",)),
    "psum-pod_model": ("psum", ("pod", "model")),
    "all_gather-model": ("all_gather", ("model",)),
    "all_gather-model_pod": ("all_gather", ("model", "pod")),
    "unshard-pod_model": ("unshard", ("pod", "model")),
    "unshard-model": ("unshard", ("model",)),
    "unshard-none": ("unshard", ()),
    "shard-pod_model": ("shard", ("pod", "model")),
    "shard-model": ("shard", ("model",)),
    "shard-none": ("shard", ()),
}
CKPT_ROWS, C = 16, 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_gloo(folder, code: str, *args: str, n: int = 4, timeout: float = 300.0) -> list:
    """Run ``code`` in n gloo processes (argv: rank, folder, *args) that
    rendezvous through a file in ``folder``; kill them all if they are
    not done within ``timeout`` seconds. Returns each rank's
    ``out{rank}.npz``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    logs = [folder / f"log{r}.txt" for r in range(n)]
    procs = []
    for r, log in enumerate(logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen([sys.executable, "-c", code, str(r), str(folder),
                                           *args], env=env, stdout=f,
                                          stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
    text = "\n".join(f"rank {r}:\n{log.read_text()}" for r, log in enumerate(logs))
    assert all(p.returncode == 0 for p in procs), f"codes {[p.returncode for p in procs]}\n{text}"
    return [dict(np.load(folder / f"out{r}.npz")) for r in range(n)]


WORKER = """
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint
from repro_torch.launch.mesh import process_group_mesh
from repro_torch.shuffle import api
from repro_torch.shuffle.exchange import for_mesh

rank, folder = int(sys.argv[1]), sys.argv[2]
sizes, collectives, ep_cases = (json.loads(a) for a in sys.argv[3:6])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{folder}/rendezvous", rank=rank,
                        world_size=4)
mesh = process_group_mesh(**sizes)
ex = for_mesh(mesh)
a = dict(np.load(f"{folder}/in.npz"))
out = {}


def reader(axes):
    # the rank that reads a copy replicated over ``axes``: this one's
    # coordinates with those along ``axes`` at 0
    c = dict(mesh.coords, **{ax: 0 for ax in axes})
    return int(np.ravel_multi_index([c[n] for n in mesh.axis_names], mesh.sizes))


for name, (op, axes) in collectives.items():
    axes, xa, w = tuple(axes), a[f"{name}_x"], a[f"{name}_w"]
    x = torch.from_numpy(xa if op == "shard" else xa[rank:rank + 1]).requires_grad_()
    y = getattr(ex, op)(x, axes)
    if op == "unshard":
        mine, wt = y, w
    else:
        mine, wt = y[0], w[reader(axes) if op in ("psum", "all_gather") else rank]
    g, = torch.autograd.grad((torch.tanh(mine) * torch.from_numpy(wt)).sum(), x)
    out[f"{name}_y"], out[f"{name}_g"] = y.detach(), g

if collectives:
    calls, real = [], ex._all_to_all

    def counting(*args):
        calls.append(1)
        return real(*args)
    ex._all_to_all = counting

    def composite(X):
        s = ex.shard(X, ("pod", "model"))
        t = torch.tanh(ex.all_to_all(s.reshape(1, 2, s.shape[1] // 2, -1), ("pod",)))
        y = ex.unshard(t.reshape(s.shape), ("pod", "model"))
        return y, ex.psum((s * s).sum(dim=1), ("pod", "model"))

    X = torch.from_numpy(a["ckpt_x"]).requires_grad_()
    y, z = checkpoint(composite, X, use_reentrant=False)
    loss = (torch.tanh(y) * torch.from_numpy(a["ckpt_wy"])).sum() \\
        + (z[0] * torch.from_numpy(a["ckpt_wz"])).sum()
    out["ckpt_g"], = torch.autograd.grad(loss, X)
    out["ckpt_all_to_alls"] = torch.tensor(len(calls))

for name, (mode, cf) in ep_cases.items():
    leaves = [torch.from_numpy(a[n]).requires_grad_() for n in ("x", "wr", "wg", "wu", "wd")]
    y, aux, dg = api.ep_moe_ffn(*leaves, top_k=2, cfg=api.ShuffleConfig(
        mode=mode, capacity_factor=cf), mesh=mesh, compute_dtype=torch.float32)
    loss = torch.tanh(y).sum() + aux
    grads = torch.autograd.grad(loss, leaves)
    out[f"{name}_loss"], out[f"{name}_dropped"] = loss.detach(), dg.dropped
    out.update({f"{name}_g{i}": g for i, g in enumerate(grads)})
np.savez(f"{folder}/out{rank}.npz", **{k: v.numpy() for k, v in out.items()})
dist.destroy_process_group()
"""


def _collective_inputs(seed=11):
    """Per case: the input (stacked ranks, or the global array for
    ``shard``) and the loss weights, shaped as the stacked output."""
    rng = np.random.default_rng(seed)
    ex = for_mesh(M.stacked_mesh(**MESHES["pod_model"]))
    inputs = {}
    for name, (op, axes) in COLLECTIVES.items():
        if op == "all_to_all":
            x = rng.standard_normal((4, ex.axis_size(axes), 3, C))
        elif op == "shard":
            x = rng.standard_normal((8, C))
        else:
            x = rng.standard_normal((4, 6, C))
        if op == "unshard":
            # the same on the ranks that differ only along the other
            # axes, which the stacked version reads at coordinate 0
            x = x.reshape(2, 2, 6, C)
            for i, a in enumerate(ex.mesh.axis_names):
                if a not in axes:
                    x = np.repeat(x.take([0], axis=i), 2, axis=i)
            x = x.reshape(4, 6, C)
        x = x.astype(np.float32)
        shape = getattr(ex, op)(torch.from_numpy(x), axes).shape
        inputs[name] = (x, rng.standard_normal(shape).astype(np.float32))
    ckpt = {"ckpt_x": rng.standard_normal((CKPT_ROWS, C)),
            "ckpt_wy": rng.standard_normal((CKPT_ROWS, C)),
            "ckpt_wz": rng.standard_normal((C,))}
    return inputs, {k: v.astype(np.float32) for k, v in ckpt.items()}


def _readers(mesh, axes) -> list:
    """The ranks at coordinate 0 along ``axes``: each reads its group's copy."""
    coords = np.indices(mesh.sizes).reshape(len(mesh.sizes), -1).T
    return [r for r, c in enumerate(coords)
            if all(c[mesh.axis_names.index(a)] == 0 for a in axes)]


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    """Each mesh shape's 4 gloo processes, once: {mesh name: each rank's
    outputs}; the collectives' cases run on pod 2 x model 2 only."""
    inputs, ckpt = _collective_inputs()
    arrays = dict(zip(("x", "wr", "wg", "wu", "wd"), _ep_grad_inputs()), **ckpt)
    for name, (x, w) in inputs.items():
        arrays[f"{name}_x"], arrays[f"{name}_w"] = x, w
    runs = {}
    for mesh_name, sizes in MESHES.items():
        folder = tmp_path_factory.mktemp(f"pg_{mesh_name}")
        np.savez(folder / "in.npz", **arrays)
        cases = COLLECTIVES if mesh_name == "pod_model" else {}
        runs[mesh_name] = run_gloo(folder, textwrap.dedent(WORKER), json.dumps(sizes),
                                   json.dumps(cases), json.dumps(EP_GRAD_CASES))
    return runs


JAX_EP_GRADS = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.launch.mesh import _mesh
from repro.shuffle.api import ShuffleConfig, ep_moe_ffn
meshes, cases, folder = json.loads(sys.argv[1]), json.loads(sys.argv[2]), sys.argv[3]
a = np.load(f"{folder}/in.npz")
args = [jnp.asarray(a[n]) for n in ("x", "wr", "wg", "wu", "wd")]
for mesh_name, sizes in meshes.items():
    mesh = _mesh(tuple(sizes.values()), tuple(sizes))
    for name, (mode, cf) in cases.items():
        cfg = ShuffleConfig(mode=mode, capacity_factor=cf)
        def loss(x, wr, wg, wu, wd):
            y, aux, dg = ep_moe_ffn(x, wr, wg, wu, wd, top_k=2, cfg=cfg, mesh=mesh,
                                    compute_dtype=jnp.float32)
            return jnp.sum(jnp.tanh(y)) + aux, dg.dropped
        (l, dropped), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4),
                                                     has_aux=True))(*args)
        np.savez(f"{folder}/{mesh_name}-{name}.npz", loss=np.asarray(l),
                 dropped=np.asarray(dropped), **{f"g{i}": np.asarray(t) for i, t in enumerate(g)})
"""


@pytest.fixture(scope="module")
def jax_ep_grads(tmp_path_factory):
    """JAX's ``ep_moe_ffn`` gradients on 4 host devices over each mesh, in
    one subprocess: {(mesh name, case): arrays}."""
    folder = tmp_path_factory.mktemp("jax_ep_grads")
    np.savez(folder / "in.npz", **dict(zip(("x", "wr", "wg", "wu", "wd"), _ep_grad_inputs())))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_EP_GRADS),
                        json.dumps(MESHES), json.dumps(EP_GRAD_CASES), str(folder)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return {(m, c): dict(np.load(folder / f"{m}-{c}.npz"))
            for m in MESHES for c in EP_GRAD_CASES}


# ---------------------------------------------------------------------------
# (a) each collective against the stacked back end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(COLLECTIVES))
def test_collective_gradients_match_the_stacked_back_end(gloo_runs, name):
    op, axes = COLLECTIVES[name]
    got = gloo_runs["pod_model"]
    mesh = M.stacked_mesh(**MESHES["pod_model"])
    inputs, _ = _collective_inputs()
    xa, w = inputs[name]
    x = torch.from_numpy(xa).requires_grad_()
    y = getattr(for_mesh(mesh), op)(x, axes)
    w = torch.from_numpy(w)
    if op in ("psum", "all_gather"):
        read = _readers(mesh, axes)
        loss = (torch.tanh(y[read]) * w[read]).sum()
    else:
        loss = (torch.tanh(y) * w).sum()
    g, = torch.autograd.grad(loss, x)
    for r in range(4):
        mine = got[r][f"{name}_y"] if op == "unshard" else got[r][f"{name}_y"][0]
        want = y.detach().numpy() if op == "unshard" else y[r].detach().numpy()
        if op == "psum":         # gloo sums in another order than torch
            np.testing.assert_allclose(mine, want, atol=F32_TOL, rtol=F32_TOL)
        else:
            assert np.array_equal(mine, want)
        want = g.numpy() if op == "shard" else g[r:r + 1].numpy()
        np.testing.assert_allclose(got[r][f"{name}_g"], want, atol=F32_TOL, rtol=F32_TOL,
                                   err_msg=f"rank {r}")
        if op == "shard":        # the global input's gradient, whole on every process
            assert np.array_equal(got[r][f"{name}_g"], got[0][f"{name}_g"])
    if op == "unshard" and axes != ("pod", "model"):
        # only the ranks that the stacked version reads get a cotangent
        other = tuple(a for a in mesh.axis_names if a not in axes)
        zero = [r for r in range(4) if r not in _readers(mesh, other)]
        assert zero and all(not got[r][f"{name}_g"].any() for r in zero)


def test_checkpointed_collectives_rerun_and_match_the_stacked_back_end(gloo_runs):
    got = gloo_runs["pod_model"]
    ex = for_mesh(M.stacked_mesh(**MESHES["pod_model"]))
    _, ckpt = _collective_inputs()
    X = torch.from_numpy(ckpt["ckpt_x"]).requires_grad_()
    s = ex.shard(X, ("pod", "model"))
    t = torch.tanh(ex.all_to_all(s.reshape(4, 2, s.shape[1] // 2, -1), ("pod",)))
    y = ex.unshard(t.reshape(s.shape), ("pod", "model"))
    z = ex.psum((s * s).sum(dim=1), ("pod", "model"))
    loss = (torch.tanh(y) * torch.from_numpy(ckpt["ckpt_wy"])).sum() \
        + (z[0] * torch.from_numpy(ckpt["ckpt_wz"])).sum()
    g, = torch.autograd.grad(loss, X)
    for r in range(4):
        # the forward's all-to-all, the recompute's, and the adjoint's
        assert int(got[r]["ckpt_all_to_alls"]) == 3
        np.testing.assert_allclose(got[r]["ckpt_g"], g.numpy(), atol=F32_TOL, rtol=F32_TOL)
        assert np.array_equal(got[r]["ckpt_g"], got[0]["ckpt_g"])


# ---------------------------------------------------------------------------
# (b) ep_moe_ffn's gradients over processes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("case", sorted(EP_GRAD_CASES))
def test_ep_moe_ffn_gradients_over_processes_match_jax(gloo_runs, jax_ep_grads, mesh_name,
                                                       case):
    mode, cf = EP_GRAD_CASES[case]
    got = gloo_runs[mesh_name]
    want = jax_ep_grads[(mesh_name, case)]
    leaves = [torch.from_numpy(a).requires_grad_() for a in _ep_grad_inputs()]
    y, aux, dg = api.ep_moe_ffn(*leaves, top_k=K, cfg=api.ShuffleConfig(
        mode=mode, capacity_factor=cf), mesh=M.stacked_mesh(**MESHES[mesh_name]),
        compute_dtype=torch.float32)
    loss = torch.tanh(y).sum() + aux
    stacked = torch.autograd.grad(loss, leaves)
    assert (int(want["dropped"]) > 0) == (cf == 1.0)
    for r in range(4):
        np.testing.assert_allclose(float(got[r][f"{case}_loss"]), float(want["loss"]),
                                   rtol=1e-5)
        assert int(got[r][f"{case}_dropped"]) == int(want["dropped"]) == int(dg.dropped)
        for i, s in enumerate(stacked):
            g = got[r][f"{case}_g{i}"]
            assert np.array_equal(g, got[0][f"{case}_g{i}"]), (r, i)
            np.testing.assert_allclose(g, want[f"g{i}"], atol=GRAD_TOL, rtol=GRAD_TOL,
                                       err_msg=f"rank {r}, leaf {i} against JAX")
            np.testing.assert_allclose(g, s.numpy(), atol=STACKED_TOL, rtol=STACKED_TOL,
                                       err_msg=f"rank {r}, leaf {i} against stacked ranks")
