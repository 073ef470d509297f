"""The port's cross-pod gradient sync and pod-local regions against the
JAX package's.

    PYTHONPATH=src python -m pytest -q tests/test_torch_grad_sync.py

(a) ``exchange.all_gather`` on a stacked mesh against its definition.
(b) ``grad_sync.blob_allreduce_grads`` on stacked pods against JAX's
    inside ``shard_map`` manual over the pod axis on 8 host devices (one
    subprocess), the cases of ``tests/test_multidevice.py:152`` and
    ``:195``: exact, int8, int8 with error feedback, and without the
    average. Exact: bit for bit (the same f32 sums). int8 and its
    residual: within two f32 ulps, as XLA contracts the dequantize-and-add
    into fused multiply-adds, one rounding fewer than torch; the scales
    come from the same divide-form quantizer. Beside it the multidevice
    test's own bounds (exact within 1e-6 of the mean, int8 within 2% of
    the largest entry).
(c) ``ShuffleConfig.pod_local`` (``use_context_mesh``): ``ep_moe_ffn``
    on each pod's own mesh of 4 ranks (``launch.mesh.pod_submesh``)
    against JAX's ``ep_moe_ffn`` inside the pod-manual region on pod 2 x
    model 4, at a capacity that drops: y within f32 1e-5, the loads and
    drops summed over the pods exact; the pod's own aux loss (1e-5
    relative) and diagnostics (exact) against JAX's dispatch of that pod's
    block over 4 ranks. Before the port ran the region, it took the dense
    dispatch. A mesh that keeps the pod axis is refused.
(d) The process-group back end (gloo, 4 processes, pod 2 x model 2)
    against the stacked one: ``all_gather`` and the gradient sync bit for
    bit, and the gradients through its psum, all-to-all, all-gather and
    unshard (each read once where it is replicated, as the exchange's
    autograd Functions take it; ``tests/test_torch_pg_autograd.py`` holds
    them in full). The train step over a process group is
    ``tests/test_torch_pg_train_step.py``'s.
(e) The train step's ``blob`` and ``blob_int8`` sync against ``auto`` on
    granite-3-2b SMOKE, which ``tests/test_multidevice.py:217`` trains,
    with that test's bounds, and on mamba2-130m SMOKE with the same
    bounds; and the blob step on deepseek-v2-lite SMOKE, its MoE layers
    on the dense dispatch in the pod region.
(f) One ``blob`` and one ``blob_int8`` step of deepseek-v2-lite SMOKE
    (f32 compute) against JAX's ``make_train_step`` on pod 2 x data 2 x
    model 2 host devices (one subprocess), from the same parameters and
    batch (bounds at ``test_blob_train_step_matches_jax``).
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro.models.common import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.interop import params_from_jax
from repro_torch.launch import mesh as M
from repro_torch.models import lm
from repro_torch.models import moe as moe_module
from repro_torch.models.common import init_params
from repro_torch.shuffle import api
from repro_torch.shuffle import grad_sync as GS
from repro_torch.shuffle.exchange import for_mesh
from repro_torch.training import OptConfig, TrainConfig, adamw_init, make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = 2
BLOB_BYTES = 512
# int8: XLA contracts the dequantize-and-add (and the residual's
# subtract) into fused multiply-adds, one rounding fewer than torch's
ULPS = 2
E, K, D, DE, T = 8, 2, 16, 32, 256


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grad_tree(seed=0):
    """Per-pod gradients (leading pod axis): pod p holds (1 + p) times a
    shared tree plus its own noise, at several magnitudes."""
    rng = np.random.default_rng(seed)
    base = {"a": np.arange(1000, dtype=np.float32).reshape(10, 100),
            "b": np.ones((37,), np.float32),
            "c": {"d": rng.standard_normal((3, 5)).astype(np.float32) * 1e-3,
                  "e": rng.standard_normal((129,)).astype(np.float32)}}

    def stack(x):
        return np.stack([x * (1 + p) + 0.01 * rng.standard_normal(x.shape).astype(np.float32)
                         for p in range(P)])
    return {"a": stack(base["a"]), "b": stack(base["b"]),
            "c": {"d": stack(base["c"]["d"]), "e": stack(base["c"]["e"])}}


def _flat(tree):
    return [tree["a"], tree["b"], tree["c"]["d"], tree["c"]["e"]]


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


SYNC_CASES = {"exact": (False, False, True), "int8": (True, False, True),
              "int8_ef": (True, True, True), "exact_sum": (False, False, False)}


def _ep_inputs(seed=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, D)).astype(np.float32)
    wr = (0.5 * rng.standard_normal((D, E))).astype(np.float32)
    wr[:, 0] += 0.8                                      # skewed: drops at 1.0
    w = [(rng.standard_normal(s) / np.sqrt(s[1])).astype(np.float32)
         for s in ((E, D, DE), (E, D, DE), (E, DE, D))]
    return [x, wr, *w]


JAX_REF = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as PS
from repro import jaxcompat
from repro.shuffle import grad_sync as GS
from repro.shuffle.api import ShuffleConfig, ep_moe_ffn
cases, folder = json.loads(sys.argv[1]), sys.argv[2]
mesh = jaxcompat.make_mesh((2, 4), ("pod", "model"))
g = dict(np.load(f"{folder}/grads.npz"))
tree = {"a": g["a"], "b": g["b"], "c": {"d": g["d"], "e": g["e"]}}
out = {}
for name, (compress, ef, average) in cases.items():
    def pod_fn(t):
        t = jax.tree.map(lambda x: x[0], t)
        res = GS.residual_init(t, BLOB_BYTES) + 0.01 if ef else None
        synced, new_res = GS.blob_allreduce_grads(t, blob_bytes=BLOB_BYTES, compress=compress,
                                                  residual=res, average=average)
        new_res = jnp.zeros((1,)) if new_res is None else new_res
        return jax.tree.map(lambda x: x[None], synced), new_res[None]
    specs = jax.tree.map(lambda _: PS("pod"), tree)
    synced, res = jax.jit(jax.shard_map(pod_fn, mesh=mesh, in_specs=(specs,),
                                        out_specs=(specs, PS("pod")), check_vma=False,
                                        axis_names={"pod"}))(tree)
    leaves = [synced["a"], synced["b"], synced["c"]["d"], synced["c"]["e"]]
    out.update({f"{name}_{i}": np.asarray(l) for i, l in enumerate(leaves)})
    out[f"{name}_res"] = np.asarray(res)

# the pod-local region: JAX's ep_moe_ffn inside the pod-manual shard_map.
# Its inner shard_map is built with check_vma on, under which this JAX
# refuses the psum over the manual pod axis; build it with check_vma off,
# as the outer region is.
_shard_map = jaxcompat.shard_map
def shard_map(f, **kw):
    if kw.get("check_vma") is None:
        kw["check_vma"] = False
    return _shard_map(f, **kw)
jaxcompat.shard_map = shard_map
a = np.load(f"{folder}/ep.npz")
args = [jnp.asarray(a[n]) for n in ("x", "wr", "wg", "wu", "wd")]
for mode in ("direct", "blob"):
    cfg = ShuffleConfig(mode=mode, capacity_factor=1.0).pod_local()
    def region(x):
        y, aux, dg = ep_moe_ffn(x, *args[1:], top_k=2, cfg=cfg, mesh=None,
                                compute_dtype=jnp.float32)
        return y, aux, dg.dropped, dg.expert_load, dg.dcn_bytes
    res = jax.jit(jax.shard_map(region, mesh=mesh, in_specs=(PS("pod"),),
                                out_specs=(PS("pod"), PS(), PS(), PS(), PS()),
                                check_vma=False, axis_names={"pod"}))(args[0])
    for key, v in zip(("y", "aux", "dropped", "load", "dcn"), res):
        out[f"pod_local_{mode}_{key}"] = np.asarray(v)
    # each pod's block alone over a mesh of 4 ranks: the aux loss and the
    # diagnostics of one pod, which the nested region sums over both
    pod_mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("model",))
    half = args[0].shape[0] // 2
    for p in range(2):
        y, aux, dg = jax.jit(lambda x: ep_moe_ffn(
            x, *args[1:], top_k=2, cfg=ShuffleConfig(mode=mode, capacity_factor=1.0),
            mesh=pod_mesh, compute_dtype=jnp.float32))(args[0][p * half:(p + 1) * half])
        for key, v in zip(("y", "aux", "dropped", "load", "dcn"),
                          (y, aux, dg.dropped, dg.expert_load, dg.dcn_bytes)):
            out[f"pod{p}_{mode}_{key}"] = np.asarray(v)
np.savez(f"{folder}/out.npz", **out)
"""


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    folder = tmp_path_factory.mktemp("grad_sync")
    tree = _grad_tree()
    np.savez(folder / "grads.npz", a=tree["a"], b=tree["b"], d=tree["c"]["d"],
             e=tree["c"]["e"])
    x, wr, wg, wu, wd = _ep_inputs()
    np.savez(folder / "ep.npz", x=x, wr=wr, wg=wg, wu=wu, wd=wd)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = textwrap.dedent(JAX_REF).replace("BLOB_BYTES", str(BLOB_BYTES))
    r = subprocess.run([sys.executable, "-c", code, json.dumps(SYNC_CASES), str(folder)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return dict(np.load(folder / "out.npz"))


def _port_sync(name, tree=None, exchange=None):
    compress, ef, average = SYNC_CASES[name]
    tree = _to_torch(_grad_tree()) if tree is None else tree
    exchange = exchange or GS.pod_exchange(M.stacked_mesh(pod=P, model=4))
    res = GS.residual_init(tree, BLOB_BYTES) + 0.01 if ef else None
    return GS.blob_allreduce_grads(tree, exchange=exchange, blob_bytes=BLOB_BYTES,
                                   compress=compress, residual=res, average=average)


# ---------------------------------------------------------------------------
# (a) all_gather
# ---------------------------------------------------------------------------

def test_stacked_all_gather_gathers_along_the_named_axes():
    mesh = M.stacked_mesh(pod=2, data=3, model=2)
    ex = for_mesh(mesh)
    x = torch.arange(12 * 5, dtype=torch.float32).reshape(12, 5)
    coords = np.indices(mesh.sizes).reshape(3, -1).T                 # (pod, data, model)
    for axes in (("pod",), ("model",), ("data", "pod"), ("pod", "data", "model")):
        got = ex.all_gather(x, axes)
        assert got.shape == (12, ex.axis_size(axes), 5)
        for r, c in enumerate(coords):
            for j, sub in enumerate(np.ndindex(*[mesh.shape[a] for a in axes])):
                cc = dict(zip(mesh.axis_names, c))
                cc.update(dict(zip(axes, sub)))
                src = np.ravel_multi_index([cc[a] for a in mesh.axis_names], mesh.sizes)
                assert torch.equal(got[r, j], x[src])


# ---------------------------------------------------------------------------
# (b) the gradient sync against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SYNC_CASES))
def test_blob_allreduce_grads_matches_jax(jax_ref, name):
    synced, res, nbytes = _port_sync(name)
    compress, ef, average = SYNC_CASES[name]
    for i, leaf in enumerate(_flat(synced)):
        want = jax_ref[f"{name}_{i}"]
        if compress:
            assert (np.abs(leaf.numpy() - want) <= ULPS * np.spacing(np.abs(want))).all()
        else:
            assert np.array_equal(leaf.numpy(), want), (name, i)
    if ef:
        want = jax_ref[f"{name}_res"]
        target = GS._flatten_to_blobs(_to_torch(_grad_tree()), BLOB_BYTES)[0].numpy() + 0.01
        assert (np.abs(res.numpy() - want) <= ULPS * np.spacing(np.abs(target))).all()
    else:
        assert res is None
    # the multidevice test's bounds, on this tree
    tree = _grad_tree()
    largest = max(np.abs(w.sum(axis=0)).max() for w in _flat(tree)) / (P if average else 1)
    for leaf, want in zip(_flat(synced), _flat(tree)):
        total = want.sum(axis=0)
        mean = total / P if average else total
        if compress:
            assert np.abs(leaf.numpy() - mean).max() / largest < 0.02
        else:
            np.testing.assert_allclose(leaf.numpy()[0], mean, rtol=1e-6)
            assert np.array_equal(leaf.numpy()[0], leaf.numpy()[1])
    n = sum(a[0].size for a in _flat(tree))
    blobs = min(-(-n // (BLOB_BYTES // 4)), GS.MAX_BLOBS)
    per = -(-n // blobs)
    want_bytes = blobs * (per + per % P) * (1 if compress else 4) * 2 * (P - 1) / P
    assert nbytes == want_bytes + (blobs * 2 * (P - 1) * 4 if compress else 0)


def test_blobs_are_capped_and_round_trip():
    tree = {"w": torch.randn(2, 100, 7), "b": torch.randn(2, 3)}
    blobs, meta = GS._flatten_to_blobs(tree, 16)
    assert blobs.shape[:2] == (2, GS.MAX_BLOBS)
    back = GS._unflatten_from_blobs(blobs, meta)
    assert all(torch.equal(back[k], tree[k]) for k in tree)
    one = GS.pod_exchange(M.stacked_mesh(pod=1, model=2))
    synced, _, nbytes = GS.blob_allreduce_grads(tree, exchange=one)
    assert torch.equal(synced["w"], tree["w"]) and nbytes == 0.0


# ---------------------------------------------------------------------------
# (c) the pod-local region
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["direct", "blob"])
def test_pod_local_ep_moe_ffn_matches_jax(jax_ref, mode):
    """Each pod's block of the tokens on its own mesh of 4 ranks against
    JAX's nested region (pod 2 x model 4): y within f32 1e-5, the loads
    and the drops summed over the pods exact; against JAX's dispatch of
    that block over 4 ranks, the pod's own aux loss (1e-5 relative) and
    diagnostics (exact)."""
    x, wr, *w = map(torch.from_numpy, _ep_inputs())
    cfg = api.ShuffleConfig(mode=mode, capacity_factor=1.0).pod_local()
    nested = {k: jax_ref[f"pod_local_{mode}_{k}"] for k in ("y", "dropped", "load")}
    sub = M.pod_submesh(M.stacked_mesh(pod=2, model=4))
    dropped, load = 0, 0
    for p in range(2):
        half = slice(p * T // 2, (p + 1) * T // 2)
        y, aux, dg = api.ep_moe_ffn(x[half], wr, *w, top_k=K, cfg=cfg, mesh=sub,
                                    compute_dtype=torch.float32)
        np.testing.assert_allclose(y.numpy(), nested["y"][half], atol=1e-5, rtol=0)
        want = {k: jax_ref[f"pod{p}_{mode}_{k}"] for k in ("aux", "dropped", "load", "dcn")}
        np.testing.assert_allclose(float(aux), float(want["aux"]), rtol=1e-5)
        assert int(dg.dropped) == int(want["dropped"])
        assert np.array_equal(dg.expert_load.numpy(), want["load"])
        assert float(dg.dcn_bytes) == float(want["dcn"]) == 0.0   # nothing crosses pods
        dropped, load = dropped + int(dg.dropped), load + dg.expert_load.numpy()
    assert dropped == int(nested["dropped"]) > 0
    assert np.array_equal(load, nested["load"])
    # the whole mesh, pod axis and all, is not a pod-local region's mesh
    with pytest.raises(ValueError, match="pod_submesh"):
        api.ep_moe_ffn(x, wr, *w, top_k=K, cfg=cfg, mesh=M.stacked_mesh(pod=2, model=4),
                       compute_dtype=torch.float32)


def test_pod_submesh_drops_the_pod_axis():
    assert M.pod_submesh(M.stacked_mesh(pod=2, data=2, model=4)) == M.stacked_mesh(
        data=2, model=4)
    with pytest.raises(ValueError, match="no 'pod' axis"):
        M.pod_submesh(M.stacked_mesh(data=2, model=4))
    with pytest.raises(ValueError, match="StackedMesh"):
        M.pod_submesh(M.ProcessGroupMesh(("pod", "model"), (2, 2)))


# ---------------------------------------------------------------------------
# (d) process groups against stacked ranks
# ---------------------------------------------------------------------------

PG_WORKER = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.launch.mesh import process_group_mesh
from repro_torch.shuffle import grad_sync as GS
from repro_torch.shuffle.exchange import for_mesh

rank, port, folder = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                        world_size=4)
mesh = process_group_mesh(pod=2, model=2)
pod = mesh.coords["pod"]
ex = for_mesh(mesh)
g = np.load(f"{folder}/grads.npz")
tree = {"a": g["a"], "b": g["b"], "c": {"d": g["d"], "e": g["e"]}}
tree = {k: ({kk: torch.from_numpy(vv[pod:pod + 1]) for kk, vv in v.items()}
            if isinstance(v, dict) else torch.from_numpy(v[pod:pod + 1]))
        for k, v in tree.items()}
out = {}
for name, (compress, ef, average) in CASES.items():
    res = GS.residual_init(tree, BLOB_BYTES) + 0.01 if ef else None
    synced, new_res, nbytes = GS.blob_allreduce_grads(
        tree, exchange=GS.pod_exchange(mesh), blob_bytes=BLOB_BYTES, compress=compress,
        residual=res, average=average)
    leaves = [synced["a"], synced["b"], synced["c"]["d"], synced["c"]["e"]]
    out.update({f"{name}_{i}": l.numpy() for i, l in enumerate(leaves)})
    out[f"{name}_bytes"] = np.float64(nbytes)
    if new_res is not None:
        out[f"{name}_res"] = new_res.numpy()
x = torch.arange(6, dtype=torch.float32)[None] + 10 * rank
for axes in (("pod",), ("model",), ("model", "pod")):
    out["gather_" + "_".join(axes)] = ex.all_gather(x, axes).numpy()
for op in GRAD_OPS:
    t = (torch.arange(6.0).reshape(1, 2, 3) + 10 * rank).requires_grad_()
    y = getattr(ex, op)(t, ("pod",))
    out[f"grad_{op}"], = torch.autograd.grad((y * y).sum(), t)
np.savez(f"{folder}/out{rank}.npz", **out)
dist.destroy_process_group()
"""


GRAD_OPS = ("psum", "all_to_all", "all_gather", "unshard")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_process_groups_match_stacked_pods(tmp_path):
    tree = _grad_tree()
    np.savez(tmp_path / "grads.npz", a=tree["a"], b=tree["b"], d=tree["c"]["d"],
             e=tree["c"]["e"])
    code = (textwrap.dedent(PG_WORKER).replace("BLOB_BYTES", str(BLOB_BYTES))
            .replace("CASES.items()", f"{SYNC_CASES!r}.items()")
            .replace("GRAD_OPS", repr(GRAD_OPS)))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), port, str(tmp_path)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(4)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    got = [dict(np.load(tmp_path / f"out{r}.npz")) for r in range(4)]
    for name in SYNC_CASES:
        synced, res, nbytes = _port_sync(name)
        for r in range(4):
            pod = r // 2
            for i, leaf in enumerate(_flat(synced)):
                assert np.array_equal(got[r][f"{name}_{i}"][0], leaf[pod].numpy()), (name, i)
            assert float(got[r][f"{name}_bytes"]) == nbytes
            if res is not None:
                assert np.array_equal(got[r][f"{name}_res"][0], res[pod].numpy())
    ex = for_mesh(M.stacked_mesh(pod=2, model=2))
    xs = torch.arange(6, dtype=torch.float32)[None] + 10 * torch.arange(4.0)[:, None]
    for axes in (("pod",), ("model",), ("model", "pod")):
        want = ex.all_gather(xs, axes)
        for r in range(4):
            assert np.array_equal(got[r]["gather_" + "_".join(axes)][0], want[r].numpy())
    # each process's gradient is the stacked graph's for its rank, where
    # the loss reads a psum's or a gather's output once per group (at pod
    # 0) and the unshard's once (at model 0), each process its own copy
    for op in GRAD_OPS:
        t = (torch.arange(6.0).reshape(1, 2, 3) + 10 * torch.arange(4.0)[:, None, None]
             ).requires_grad_()
        y = getattr(ex, op)(t, ("pod",))
        read = y if op in ("all_to_all", "unshard") else y[:2]
        g, = torch.autograd.grad((read * read).sum(), t)
        for r in range(4):
            assert np.array_equal(got[r][f"grad_{op}"][0], g[r].numpy()), (op, r)


# ---------------------------------------------------------------------------
# (e) the train step's gradient sync
# ---------------------------------------------------------------------------

def _train_setup(arch, B=8, S=16):
    cfg = get_config(arch, smoke=True)
    gen = torch.Generator().manual_seed(0)
    params = init_params(lm.LM(cfg, device="cpu"), gen)
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                                        .astype(np.int32))}
    return cfg, params, batch


def test_train_step_blob_grad_sync_matches_auto():
    _blob_grad_sync_matches_auto("mamba2-130m")


def test_train_step_blob_grad_sync_matches_auto_on_granite():
    _blob_grad_sync_matches_auto("granite-3-2b")


def _blob_grad_sync_matches_auto(arch):
    """One step of each sync from the same parameters and batch (B 8, S
    16, bf16 compute, pod 2 x data 2 x model 2): the loss within 1e-4 and
    the gradient norm within 1e-3 of ``auto``'s, the exact sync's updated
    parameters within 5e-5 + 5e-4 |p|, the int8 sync's gradient norm
    within 5%; int8 sends under a third of the exact sync's bytes."""
    cfg, params, batch = _train_setup(arch)
    mesh = M.make_test_mesh(devices=8)
    start = {n: p.detach().clone() for n, p in params.named_parameters()}
    outs = {}
    for sync in ("auto", "blob", "blob_int8"):
        with torch.no_grad():
            for n, p in params.named_parameters():
                p.copy_(start[n])
        tcfg = TrainConfig(opt=OptConfig(learning_rate=1e-3), grad_sync=sync,
                           grad_sync_blob_bytes=4096)
        p2, _, m = make_train_step(cfg, tcfg, mesh=mesh)(params, adamw_init(params), batch)
        outs[sync] = (float(m["loss"]), float(m["grad_norm"]),
                      {n: p.detach().clone() for n, p in p2.named_parameters()}, m)
    np.testing.assert_allclose(outs["blob"][0], outs["auto"][0], rtol=1e-4)
    np.testing.assert_allclose(outs["blob"][1], outs["auto"][1], rtol=1e-3)
    for n, a in outs["auto"][2].items():
        np.testing.assert_allclose(outs["blob"][2][n].numpy(), a.numpy(), atol=5e-5,
                                   rtol=5e-4, err_msg=n)
    np.testing.assert_allclose(outs["blob_int8"][1], outs["auto"][1], rtol=0.05)
    # int8 sends a quarter of the f32 bytes, plus two f32 scales a blob
    assert outs["blob"][3]["grad_sync_bytes"] > 3 * outs["blob_int8"][3]["grad_sync_bytes"] > 0
    assert "grad_sync_bytes" not in outs["auto"][3]


def test_blob_train_step_runs_the_moe_layers_pod_local(monkeypatch):
    """deepseek-v2-lite SMOKE on pod 2 x model 4: each pod's half of the
    batch through the dense dispatch (the loss gets no mesh in the pod
    region, as in the JAX package, whatever the shuffle mode), and the
    step trains."""
    cfg, params, batch = _train_setup("deepseek-v2-lite-16b", B=4, S=8)
    mesh = M.stacked_mesh(pod=2, model=4)
    seen = []
    real = moe_module.moe_apply

    def recording(*args, mesh=None, shuffle=None, **kw):
        seen.append((mesh, shuffle.use_context_mesh))
        return real(*args, mesh=mesh, shuffle=shuffle, **kw)
    monkeypatch.setattr(moe_module, "moe_apply", recording)
    monkeypatch.setattr(moe_module, "ep_moe_ffn", None)     # never reached
    tcfg = TrainConfig(opt=OptConfig(learning_rate=3e-3, warmup_steps=1, total_steps=10),
                       microbatches=2, shuffle=api.ShuffleConfig(mode="blob"),
                       grad_sync="blob_int8")
    step = make_train_step(cfg, tcfg, mesh=mesh)
    opt = adamw_init(params)
    losses = []
    for _ in range(6):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    # 6 steps x 2 pods x 2 microbatches x (forward + recompute) x 2 MoE layers
    assert len(seen) == 6 * 2 * 2 * 2 * (cfg.num_layers - cfg.moe.first_dense_layers)
    assert all(ms is None and ctx for ms, ctx in seen)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


# ---------------------------------------------------------------------------
# (f) one blob-synced train step against JAX's
# ---------------------------------------------------------------------------

STEP_ARCH = "deepseek-v2-lite-16b"
STEP_OPT = dict(learning_rate=1e-3, warmup_steps=2, total_steps=8)
STEP_METRICS = ("loss", "aux_loss", "grad_norm", "lr")
GRAD_TOL = 2e-4
# the int8 sync against JAX's, in steps of the largest entry over 127: an
# entry that rounds the other way moves by one step of its blob's scale
# in each of the two stages, and the first stage's scale is one pod's,
# which can be up to twice the mean's largest entry
INT8_STEPS = 3

JAX_STEP = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.launch.mesh import make_test_mesh
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
out = {}
for sync in ("blob", "blob_int8"):
    tcfg = TrainConfig(opt=OptConfig(**OPT), microbatches=2, shuffle=ShuffleConfig(mode="blob"),
                       grad_sync=sync, grad_sync_blob_bytes=4096)
    step = jax.jit(make_train_step(cfg, tcfg, mesh=make_test_mesh(devices=8)))
    p2, o2, m = step(params, adamw_init(params), batch)
    out.update({f"{sync}_p{i}": np.asarray(l) for i, l in enumerate(jax.tree.leaves(p2))})
    out.update({f"{sync}_m{i}": np.asarray(l) for i, l in enumerate(jax.tree.leaves(o2["m"]))})
    out.update({f"{sync}_{k}": np.asarray(v) for k, v in m.items()})
np.savez(f"{folder}/out.npz", **out)
"""


@pytest.fixture(scope="module")
def jax_blob_steps(tmp_path_factory):
    """JAX's blob and blob_int8 steps on deepseek-v2-lite SMOKE (f32
    compute) over pod 2 x data 2 x model 2 host devices, in one
    subprocess: (initial parameters, batch, {sync: (parameters, first
    moment, metrics)})."""
    folder = tmp_path_factory.mktemp("blob_step")
    jcfg = dataclasses.replace(jax_get_config(STEP_ARCH, smoke=True), compute_dtype=jnp.float32)
    jparams = jax_init_params(jlm.param_defs(jcfg), jax.random.key(0))
    leaves, treedef = jax.tree.flatten(jparams)
    rng = np.random.default_rng(3)
    tokens, labels = (rng.integers(0, jcfg.vocab_size, (8, 16)).astype(np.int32)
                      for _ in range(2))
    np.savez(folder / "in.npz", tokens=tokens, labels=labels,
             **{f"p{i}": np.asarray(l) for i, l in enumerate(leaves)})
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = (textwrap.dedent(JAX_STEP).replace("ARCH", repr(STEP_ARCH))
            .replace("**OPT", f"**{STEP_OPT!r}"))
    r = subprocess.run([sys.executable, "-c", code, str(folder)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    out = dict(np.load(folder / "out.npz"))

    def tree(prefix):
        return jax.tree.unflatten(treedef, [out[f"{prefix}{i}"] for i in range(len(leaves))])
    return jparams, {"tokens": tokens, "labels": labels}, {
        sync: (tree(f"{sync}_p"), tree(f"{sync}_m"),
               {k: float(out[f"{sync}_{k}"]) for k in STEP_METRICS})
        for sync in ("blob", "blob_int8")}


def _first_adamw_step(p0, g, lr, ocfg):
    """The parameter after AdamW's first step on the (clipped) gradient
    g: the moments' bias corrections cancel, leaving lr * g / (|g| + eps)."""
    return p0 - lr * (g / (g.abs() + ocfg.eps) + ocfg.weight_decay * p0)


@pytest.mark.parametrize("sync", ["blob", "blob_int8"])
def test_blob_train_step_matches_jax(jax_blob_steps, sync):
    """One step of deepseek-v2-lite SMOKE, two microbatches a pod, each
    pod's MoE layers through the dense dispatch in both packages. The
    metrics (pod means) within 1e-5; the synced gradient (the first
    moment over 1 - beta1) within 2e-4 atol and rtol in ``blob`` and
    ``INT8_STEPS`` int8 steps of the largest entry in ``blob_int8``; the
    parameters within 1e-5 of JAX's in ``blob`` where JAX's gradient is
    above 1e-5, and elsewhere (and everywhere in ``blob_int8``) within
    1e-5 of AdamW's first step from the port's own synced gradient."""
    jparams, batch, ref = jax_blob_steps
    jp, jm, jmetrics = ref[sync]
    cfg = dataclasses.replace(get_config(STEP_ARCH, smoke=True), compute_dtype=torch.float32)
    params = params_from_jax(cfg, jparams, device="cpu")
    start = {n: p.detach().clone() for n, p in params.named_parameters()}
    ocfg = OptConfig(**STEP_OPT)
    step = make_train_step(cfg, TrainConfig(
        opt=ocfg, microbatches=2, shuffle=api.ShuffleConfig(mode="blob"), grad_sync=sync,
        grad_sync_blob_bytes=4096), mesh=M.make_test_mesh(devices=8))
    params, opt, m = step(params, adamw_init(params),
                          {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in STEP_METRICS:
        np.testing.assert_allclose(float(m[k]), jmetrics[k], rtol=1e-5, atol=1e-7, err_msg=k)
    want_g = {n: p.detach() / (1 - ocfg.beta1)
              for n, p in params_from_jax(cfg, jm, device="cpu").named_parameters()}
    want_p = dict(params_from_jax(cfg, jp, device="cpu").named_parameters())
    largest = max(float(g.abs().max()) for g in want_g.values())
    lr = float(m["lr"])
    for name, p in params.named_parameters():
        g = opt["m"][name] / (1 - ocfg.beta1)
        if sync == "blob":
            np.testing.assert_allclose(g.numpy(), want_g[name].numpy(), atol=GRAD_TOL,
                                       rtol=GRAD_TOL, err_msg=name)
        else:
            err = float((g - want_g[name]).abs().max())
            assert err <= INT8_STEPS * largest / 127, (name, err / largest)
        w = want_p[name].detach()
        bound = 1e-5 + 1e-5 * w.abs()
        # int8 leaves entries at 0 that a rounding the other way keeps,
        # and lr * g / (|g| + eps) turns that into a whole step of lr
        own = (want_g[name].abs() < 1e-5) | (sync == "blob_int8")
        got = torch.where(own, p.detach() - _first_adamw_step(start[name], g, lr, ocfg),
                          p.detach() - w)
        assert bool((got.abs() <= bound).all()), (name, float((got.abs() - bound).max()))
