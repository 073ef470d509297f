"""The port's expert-parallel dispatch against the JAX package.

    PYTHONPATH=src python -m pytest -q tests/test_torch_dispatch.py

(a) ``flat_dispatch_combine`` and ``blob_dispatch_combine`` (with and
    without the int8 pod leg) on a stacked mesh against the JAX functions
    under nested ``jax.vmap`` with axis names (the same collectives as
    ``shard_map`` over a mesh, in one process), at P 2 x M 2 and P 2 x M 4;
(b) the one-launch stacked pack and unpack against each rank's
    index-based ``bin_pack``/``scatter_to_bins``/``gather_from_bins``, the
    (U, 1) int32 metadata rows and the drop bin included, and the whole
    dispatch through them;
(c) ``ep_moe_ffn`` with a mesh against the JAX package's on 8 host
    devices (a spectator axis, blob falling back to direct without pods,
    padded experts, a token mask), run once in a subprocess;
(d) ``moe_apply`` and the serving steps with a stacked mesh at
    deepseek-v2-lite SMOKE, against the dense path at a capacity factor at
    which no unit drops, with token counts that need padding;
(e) the process-group back end (gloo, 4 processes, P 2 x M 2) against the
    stacked back end, bit for bit.

Sizes: E 8 experts, top-2, d 16, d_e 32, 16 tokens a rank; inputs from a
numpy seed. Tolerances: f32 1e-5 (the same math in another order), bf16
1e-1 (products rounded to 8 bits of mantissa at places the two
frameworks do not share). ``expert_load``, ``dropped`` and ``dcn_bytes``
are equal exactly: they come from the routing and the buffer shapes.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.shuffle import api as japi
from repro.shuffle import dispatch as jdispatch
from repro_torch.configs import get_config
from repro_torch.interop import to_numpy
from repro_torch.launch import mesh as M
from repro_torch.launch.serve import generate
from repro_torch.models import lm
from repro_torch.models import moe
from repro_torch.models.common import init_params
from repro_torch.serving import ServeConfig, make_prefill_step
from repro_torch.shuffle import api, binning, dispatch
from repro_torch.shuffle.exchange import for_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E, K, D, DE, T_LOC = 8, 2, 16, 32, 16
TOL = {"float32": 1e-5, "bfloat16": 1e-1}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# 16.0 drops no unit at these sizes; 1.0 drops in every mode (skewed keys)
NO_DROP, DROPS = 16.0, 1.0
MODES = ["flat", "blob", "blob_int8"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(P, Mm, seed=0):
    """Each rank's tokens, its top-2 experts (skewed towards low ids, so
    that a capacity factor of 1.0 drops in every mode) and weights, and
    the expert weights."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((P, Mm, T_LOC, D)).astype(np.float32)
    logits = rng.standard_normal((P, Mm, T_LOC, E)) - 0.4 * np.arange(E)
    sel_idx = np.argsort(-logits, axis=-1)[..., :K].astype(np.int32)
    sel_w = rng.random((P, Mm, T_LOC, K)).astype(np.float32)
    w = [(rng.standard_normal(s) / np.sqrt(s[1])).astype(np.float32)
         for s in ((E, D, DE), (E, D, DE), (E, DE, D))]
    return x, sel_idx, sel_w, w


def _jax_dispatch(mode, P, Mm, cf, dtype, inputs):
    x, sel_idx, sel_w, w = inputs
    jd = DTYPES[dtype][0]
    E_loc = E // (P * Mm)

    def local(x, si, sw, g, u, dd):
        fn = japi._expert_ffn(g, u, dd, jd)
        if mode == "flat":
            return jdispatch.flat_dispatch_combine(
                x, si, sw, fn, num_experts=E, ep_axes=("pod", "model"),
                capacity_factor=cf, d_out=D)
        return jdispatch.blob_dispatch_combine(
            x, si, sw, fn, num_experts=E, pod_axis="pod", inner_axes=("model",),
            capacity_factor=cf, d_out=D, compress_dcn=mode == "blob_int8")

    f = jax.jit(jax.vmap(jax.vmap(local, axis_name="model"), axis_name="pod"))
    y, dg = f(jnp.asarray(x, jd), jnp.asarray(sel_idx), jnp.asarray(sel_w),
              *(jnp.asarray(a.reshape(P, Mm, E_loc, *a.shape[1:])) for a in w))
    return (np.asarray(y.astype(jnp.float32)).reshape(P * Mm, T_LOC, D),
            dispatch.DispatchDiagnostics(*(np.asarray(a).reshape(P * Mm, *a.shape[2:])
                                           for a in dg)))


def _port_dispatch(mode, mesh, cf, dtype, inputs, device="cpu"):
    x, sel_idx, sel_w, w = inputs
    td = DTYPES[dtype][1]
    R = mesh.size
    ws = [torch.from_numpy(a).to(device) for a in w]
    ffn = api._expert_ffn(*ws, td)

    def expert_fn(t):
        return ffn(t.reshape(-1, *t.shape[2:])).view(*t.shape[:3], -1)

    args = (torch.from_numpy(x).to(device, td).reshape(R, T_LOC, D),
            torch.from_numpy(sel_idx).to(device).reshape(R, T_LOC, K),
            torch.from_numpy(sel_w).to(device).reshape(R, T_LOC, K), expert_fn)
    common = dict(exchange=for_mesh(mesh), num_experts=E, capacity_factor=cf, d_out=D)
    if mode == "flat":
        return dispatch.flat_dispatch_combine(*args, ep_axes=("pod", "model"), **common)
    return dispatch.blob_dispatch_combine(*args, pod_axis="pod", inner_axes=("model",),
                                          compress_dcn=mode == "blob_int8", **common)


def _same_diagnostics(got, want):
    assert got.dropped.dtype == got.expert_load.dtype == torch.int32
    assert got.dcn_bytes.dtype == torch.float32
    for g, w in zip(got, want):
        assert np.array_equal(to_numpy(g), np.asarray(w)), (g, w)


# ---------------------------------------------------------------------------
# (a) the dispatch functions against JAX's under vmap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", [NO_DROP, DROPS], ids=["no-drop", "drops"])
@pytest.mark.parametrize("pm", [(2, 2), (2, 4)], ids=["P2xM2", "P2xM4"])
@pytest.mark.parametrize("mode", MODES)
def test_dispatch_matches_jax_under_vmap(mode, pm, cf):
    inputs = _inputs(*pm)
    y_w, dg_w = _jax_dispatch(mode, *pm, cf, "float32", inputs)
    y, dg = _port_dispatch(mode, M.stacked_mesh(pod=pm[0], model=pm[1]), cf,
                           "float32", inputs)
    np.testing.assert_allclose(y.numpy(), y_w, atol=TOL["float32"], rtol=0)
    _same_diagnostics(dg, dg_w)
    assert (int(dg.dropped[0]) == 0) == (cf == NO_DROP)
    assert int(dg.expert_load[0].sum()) == pm[0] * pm[1] * T_LOC * K


@pytest.mark.parametrize("mode", MODES)
def test_dispatch_matches_jax_under_vmap_bf16(mode):
    inputs = _inputs(2, 2, seed=1)
    y_w, dg_w = _jax_dispatch(mode, 2, 2, DROPS, "bfloat16", inputs)
    y, dg = _port_dispatch(mode, M.stacked_mesh(pod=2, model=2), DROPS, "bfloat16",
                           inputs)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(), y_w, atol=TOL["bfloat16"], rtol=0)
    _same_diagnostics(dg, dg_w)


def test_dcn_bytes_are_the_buffer_sizes():
    """Per rank: flat sends (ep, E_loc * cap, d) and blob (P, cap2, d),
    int8 with one f32 scale a row; half of each crosses the pods."""
    inputs = _inputs(2, 2)
    mesh = M.stacked_mesh(pod=2, model=2)
    cap = dispatch._cap(T_LOC * K / E, DROPS)
    cap2 = dispatch._cap(T_LOC * K / 2, dispatch.pooled_capacity_factor(DROPS, 2))
    want = {"flat": 4 * (E * cap * D * 4) / 2, "blob": 4 * (2 * cap2 * D * 4) / 2,
            "blob_int8": 4 * (2 * cap2 * (D + 4)) / 2}
    for mode in MODES:
        assert float(_port_dispatch(mode, mesh, DROPS, "float32", inputs)[1]
                     .dcn_bytes[0]) == want[mode]


@pytest.mark.parametrize("axes", [("pod", "model"), ("model", "pod"), ("data",), ()])
def test_stacked_exchange_follows_its_definition(axes):
    """all_to_all, psum, shard and unshard on a stacked (pod 2, data 3,
    model 2) mesh against their definitions, rank by rank."""
    mesh = M.stacked_mesh(pod=2, data=3, model=2)
    ex = for_mesh(mesh)
    names, sizes = mesh.axis_names, mesh.sizes
    coords = [dict(zip(names, np.unravel_index(r, sizes))) for r in range(mesh.size)]

    def index(c, over):          # linear index of c along ``over``
        return int(np.ravel_multi_index([c[a] for a in over], [mesh.shape[a] for a in over])) \
            if over else 0

    n = ex.axis_size(axes)
    x = torch.arange(mesh.size * n * 3, dtype=torch.float32).view(mesh.size, n, 3)
    got = ex.all_to_all(x, axes)
    for r, c in enumerate(coords):
        for j in range(n):   # chunk j came from the peer at index j along axes
            peer = [p for p, cp in enumerate(coords) if index(cp, axes) == j
                    and all(cp[a] == c[a] for a in names if a not in axes)]
            assert torch.equal(got[r, j], x[peer[0], index(c, axes)])
    total = ex.psum(x, axes)
    for r, c in enumerate(coords):
        group = [p for p, cp in enumerate(coords)
                 if all(cp[a] == c[a] for a in names if a not in axes)]
        assert torch.equal(total[r], x[group].sum(0))
    g = torch.arange(n * 4 * 2, dtype=torch.float32).view(n * 4, 2)
    local = ex.shard(g, axes)
    for r, c in enumerate(coords):
        assert torch.equal(local[r], g.view(n, 4, 2)[index(c, axes)])
    assert torch.equal(ex.unshard(local, axes), g)


# ---------------------------------------------------------------------------
# (b) one pack and one unpack launch over every rank
# ---------------------------------------------------------------------------

def test_stacked_binning_is_each_ranks_index_based_binning():
    rng = np.random.default_rng(5)
    R, U, T, nb, cap = 4, 48, 24, 5, 7
    keys = torch.from_numpy(rng.integers(0, nb, (R, U)).astype(np.int32))
    keys[1] = 4                            # a rank whose units all go to the drop bin
    rows = torch.from_numpy(rng.standard_normal((R, T, D)).astype(np.float32))
    unit_row = torch.from_numpy(rng.integers(0, T, U).astype(np.int32))
    meta = keys + 1                        # 1-D int32 values, as the metadata
    got, want = dispatch.StackedBinning(keys, nb, cap), binning.IndexedBinning(keys, nb, cap)
    assert torch.equal(got.counts, want.counts)
    for bins in (None, nb - 1):            # all bins; the drop bin left out
        a = got.scatter(rows, unit_row, bins=bins)
        b = want.scatter(rows, unit_row, bins=bins)
        assert a.shape == (R, bins or nb, cap, D) and torch.equal(a, b)
        m = got.scatter(meta, bins=bins)
        assert m.dtype == torch.int32 and m.shape == (R, bins or nb, cap)
        assert torch.equal(m, want.scatter(meta, bins=bins))
        assert torch.equal(got.dropped(bins), want.dropped(bins))
    buf = torch.from_numpy(rng.standard_normal((R, nb, cap, D)).astype(np.float32))
    assert torch.equal(got.gather(buf), want.gather(buf))
    # the packing is each rank's bin_pack, offset by the rank's layout
    for r in range(R):
        p = binning.bin_pack(keys[r], nb, cap)
        assert torch.equal(got.pack.slot[r * U:(r + 1) * U], p.slot + r * nb * cap)
        assert torch.equal(got.pack.valid[r * U:(r + 1) * U], p.valid)


@pytest.mark.parametrize("mode", MODES)
def test_dispatch_through_the_pack_ops_is_the_index_based_dispatch(mode, monkeypatch):
    inputs = _inputs(2, 4)
    mesh = M.stacked_mesh(pod=2, model=4)
    got = _port_dispatch(mode, mesh, DROPS, "bfloat16", inputs)
    monkeypatch.setattr(dispatch, "StackedBinning", binning.IndexedBinning)
    want = _port_dispatch(mode, mesh, DROPS, "bfloat16", inputs)
    assert torch.equal(got[0].view(torch.int16), want[0].view(torch.int16))
    for g, w in zip(got[1], want[1]):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# (c) ep_moe_ffn with a mesh against the JAX package on 8 host devices
# ---------------------------------------------------------------------------

# name: (mesh, mode, compress_dcn, capacity factor, experts, masked tokens)
EP_CASES = {
    "direct": ("test8", "direct", False, 1.0, 8, 0),
    "blob": ("test8", "blob", False, 1.0, 8, 0),
    "blob_int8": ("test8", "blob", True, 1.0, 8, 0),
    "blob_no_drop": ("test8", "blob", False, NO_DROP, 8, 0),
    "blob_without_pods": ("test4", "blob", False, 1.0, 8, 0),
    "padded_experts": ("test8", "blob", False, 1.0, 6, 0),
    "token_mask": ("test8", "blob", True, 1.0, 8, 20),
}
EP_T = 128


def _ep_inputs(name):
    _, _, _, _, n_exp, masked = EP_CASES[name]
    rng = np.random.default_rng(sorted(EP_CASES).index(name))
    x = rng.standard_normal((EP_T, D)).astype(np.float32)
    wr = (rng.standard_normal((D, n_exp)) * 0.5).astype(np.float32)
    wr[:, 0] += 0.3                        # skew the router: drops at 1.0
    w = [(rng.standard_normal(s) / np.sqrt(s[1])).astype(np.float32)
         for s in ((n_exp, D, DE), (n_exp, D, DE), (n_exp, DE, D))]
    mask = np.ones(EP_T, np.float32)
    mask[rng.choice(EP_T, masked, replace=False)] = 0.0
    return x, wr, w, mask


JAX_EP = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro import jaxcompat
from repro.shuffle.api import ShuffleConfig, ep_moe_ffn
cases, folder = json.loads(sys.argv[1]), sys.argv[2]
meshes = {"test8": jaxcompat.make_mesh((2, 2, 2), ("pod", "data", "model")),
          "test4": jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                                     ("data", "model"))}
for name, (mesh, mode, compress, cf, _, _) in cases.items():
    a = np.load(f"{folder}/{name}.in.npz")
    cfg = ShuffleConfig(mode=mode, compress_dcn=compress, capacity_factor=cf)
    y, aux, dg = jax.jit(lambda x, m, wr, g, u, d: ep_moe_ffn(
        x, wr, g, u, d, top_k=2, cfg=cfg, mesh=meshes[mesh],
        compute_dtype=jnp.float32, token_mask=m))(
        a["x"], a["mask"], a["wr"], a["wg"], a["wu"], a["wd"])
    np.savez(f"{folder}/{name}.out.npz", y=np.asarray(y), aux=np.asarray(aux),
             dropped=np.asarray(dg.dropped), load=np.asarray(dg.expert_load),
             dcn=np.asarray(dg.dcn_bytes))
"""


@pytest.fixture(scope="module")
def jax_ep(tmp_path_factory):
    """JAX's ``ep_moe_ffn`` on every case, on 8 host devices, run once."""
    folder = tmp_path_factory.mktemp("ep_moe_ffn")
    for name in EP_CASES:
        x, wr, (wg, wu, wd), mask = _ep_inputs(name)
        np.savez(folder / f"{name}.in.npz", x=x, wr=wr, wg=wg, wu=wu, wd=wd, mask=mask)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_EP),
                        json.dumps(EP_CASES), str(folder)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return {name: dict(np.load(folder / f"{name}.out.npz")) for name in EP_CASES}


def _port_ep(name, **overrides):
    mesh_name, mode, compress, cf, _, masked = EP_CASES[name]
    x, wr, w, mask = _ep_inputs(name)
    mesh = M.make_test_mesh(devices=8 if mesh_name == "test8" else 4)
    cfg = api.ShuffleConfig(mode=mode, compress_dcn=compress, capacity_factor=cf)
    cfg = dataclasses.replace(cfg, **overrides)
    return api.ep_moe_ffn(torch.from_numpy(x), torch.from_numpy(wr),
                          *map(torch.from_numpy, w), top_k=K, cfg=cfg, mesh=mesh,
                          compute_dtype=torch.float32,
                          token_mask=torch.from_numpy(mask))


@pytest.mark.parametrize("name", sorted(EP_CASES))
def test_ep_moe_ffn_with_a_mesh_matches_jax(jax_ep, name):
    want = jax_ep[name]
    y, aux, dg = _port_ep(name)
    np.testing.assert_allclose(y.numpy(), want["y"], atol=TOL["float32"], rtol=0)
    np.testing.assert_allclose(float(aux), float(want["aux"]), rtol=1e-5)
    assert int(dg.dropped) == int(want["dropped"])
    assert np.array_equal(dg.expert_load.numpy(), want["load"])
    assert float(dg.dcn_bytes) == float(want["dcn"])
    n_exp, masked = EP_CASES[name][4], EP_CASES[name][5]
    assert dg.expert_load.shape == (n_exp,)       # the pad experts left out
    assert int(dg.expert_load.sum()) == EP_T * K  # the masked tokens are routed
    if masked:
        rows = np.flatnonzero(_ep_inputs(name)[3] == 0)
        assert not y[rows].any()
    if name in ("direct", "blob", "blob_int8"):   # the spectator axis is summed
        assert float(dg.dcn_bytes) > 0 and int(dg.dropped) > 0


def test_blob_without_pods_runs_direct(jax_ep):
    y, aux, dg = _port_ep("blob_without_pods")
    y_d, aux_d, dg_d = _port_ep("blob_without_pods", mode="direct")
    assert torch.equal(y, y_d) and torch.equal(aux, aux_d)
    for g, w in zip(dg, dg_d):
        assert torch.equal(g, w)
    assert float(dg.dcn_bytes) == 0.0        # no pod axis, nothing crosses


def test_shuffle_config_resolve_matches_jax():
    class Named:
        def __init__(self, names):
            self.axis_names = names

    for names in (("pod", "data", "model"), ("data", "model"), ("model",), ()):
        mesh = M.stacked_mesh(**{n: 2 for n in names})
        for kw in ({}, {"token_axes": ("data", "pod"), "expert_axes": ("model",)}):
            want = dataclasses.asdict(japi.ShuffleConfig(**kw).resolve(Named(names)))
            assert dataclasses.asdict(api.ShuffleConfig(**kw).resolve(mesh)) == want


# ---------------------------------------------------------------------------
# (d) moe_apply and the serving steps at deepseek-v2-lite SMOKE
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def deepseek():
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b", smoke=True),
                              compute_dtype=torch.float32)
    params = init_params(lm.LM(cfg, device="cpu"), torch.Generator().manual_seed(0))
    return cfg, params


def _no_drop(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))


@pytest.mark.parametrize("tokens", [(2, 12), (1, 5)], ids=["24", "5-padded"])
@pytest.mark.parametrize("mode", ["direct", "blob", "blob_int8"])
def test_moe_apply_with_a_mesh_matches_the_dense_layer(deepseek, mode, tokens):
    cfg, params = deepseek
    p = params.blocks[0].ffn
    E = cfg.moe.num_experts
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (*tokens, cfg.d_model)).astype(np.float32))
    shuf = api.ShuffleConfig(mode=mode.split("_")[0], compress_dcn=mode == "blob_int8",
                             capacity_factor=float(E))
    y, aux, diag = moe.moe_apply(cfg, p, x, shuffle=shuf, mesh=M.make_test_mesh())
    y_w, aux_w, diag_w = moe.moe_apply(_no_drop(cfg), p, x,
                                       shuffle=api.ShuffleConfig(mode="dense"))
    assert y.shape == x.shape
    # the int8 pod leg rounds each row to 8 bits
    tol = 5e-2 if mode == "blob_int8" else TOL["float32"]
    np.testing.assert_allclose(y.numpy(), y_w.numpy(), atol=tol, rtol=0)
    # the pad tokens (zero rows) are routed and counted, as in the JAX
    # package; only their combine weights are masked. So the loads are the
    # dense layer's plus the pad rows', and the aux loss counts the pad
    # rows' units over the real tokens' probabilities
    T, k = tokens[0] * tokens[1], cfg.moe.top_k
    pad = (-T) % 8
    pads = api._route(torch.zeros(max(pad, 1), cfg.d_model), p.router, k, True)[1]
    pad_load = torch.bincount(pads[:pad].reshape(-1).long(), minlength=E).to(torch.int32)
    assert torch.equal(diag["expert_load"], diag_w["expert_load"] + pad_load)
    pbar = api._route(x.reshape(T, -1), p.router, k, True)[2].mean(dim=0)
    aux_pad = E * torch.sum(pad_load.float() / (T * k) * pbar) * cfg.moe.aux_loss_coef
    np.testing.assert_allclose(float(aux), float(aux_w + aux_pad), rtol=1e-5)
    assert int(diag["dropped"]) == 0


@pytest.mark.parametrize("mode", ["direct", "blob"])
def test_serving_steps_with_a_mesh_match_the_dense_path(deepseek, mode):
    cfg, params = deepseek
    cfg_nd = _no_drop(cfg)
    scfg = ServeConfig(shuffle=api.ShuffleConfig(
        mode=mode, capacity_factor=float(cfg.moe.num_experts)))
    mesh = M.make_test_mesh()
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 7)).astype(np.int32))             # 14 tokens: padded to 16
    got = make_prefill_step(cfg, scfg, mesh)(params, {"tokens": tokens})
    want = make_prefill_step(cfg_nd, ServeConfig())(params, {"tokens": tokens})
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=0)
    # decode: 2 tokens a step, padded to 8
    dec = generate(cfg, params, tokens[:, :4], 2, scfg=scfg, mesh=mesh)
    dec_w = generate(cfg_nd, params, tokens[:, :4], 2)
    np.testing.assert_allclose(dec["logits"].numpy(), dec_w["logits"].numpy(),
                               atol=1e-4, rtol=0)
    assert torch.equal(dec["generated"], dec_w["generated"])


# ---------------------------------------------------------------------------
# (e) the process-group back end against the stacked one
# ---------------------------------------------------------------------------

PG_WORKER = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.launch.mesh import process_group_mesh
from repro_torch.shuffle import api, dispatch
from repro_torch.shuffle.exchange import for_mesh

rank, port, folder = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                        world_size=4)
a = {n: torch.from_numpy(v) for n, v in np.load(f"{folder}/in.npz").items()}
out = {}
mesh = process_group_mesh(pod=2, model=2)
E, E_loc = a["wg"].shape[0], a["wg"].shape[0] // 4
ffn = api._expert_ffn(*(a[n][rank * E_loc:(rank + 1) * E_loc] for n in ("wg", "wu", "wd")),
                      torch.float32)
expert_fn = lambda t: ffn(t.reshape(-1, *t.shape[2:])).view(*t.shape[:3], -1)
args = [a[n].reshape(4, *a[n].shape[2:])[rank:rank + 1] for n in ("x", "sel_idx", "sel_w")]
common = dict(exchange=for_mesh(mesh), num_experts=E, capacity_factor=1.0,
              d_out=args[0].shape[-1])
for mode in ("flat", "blob", "blob_int8"):
    if mode == "flat":
        y, dg = dispatch.flat_dispatch_combine(*args, expert_fn, ep_axes=("pod", "model"),
                                               **common)
    else:
        y, dg = dispatch.blob_dispatch_combine(*args, expert_fn, pod_axis="pod",
                                               inner_axes=("model",),
                                               compress_dcn=mode == "blob_int8", **common)
    out.update({f"{mode}_y": y, f"{mode}_dropped": dg.dropped,
                f"{mode}_load": dg.expert_load, f"{mode}_dcn": dg.dcn_bytes})
# ep_moe_ffn on the global tokens, with the data axis a spectator
for name, m in (("ep_pm", process_group_mesh(pod=2, model=2)),
                ("ep_pd", process_group_mesh(pod=2, data=2))):
    y, aux, dg = api.ep_moe_ffn(a["gx"], a["wr"], a["wg"], a["wu"], a["wd"], top_k=2,
                                cfg=api.ShuffleConfig(mode="blob", capacity_factor=1.0),
                                mesh=m, compute_dtype=torch.float32, token_mask=a["mask"])
    out.update({f"{name}_y": y, f"{name}_aux": aux, f"{name}_dropped": dg.dropped,
                f"{name}_load": dg.expert_load, f"{name}_dcn": dg.dcn_bytes})
np.savez(f"{folder}/out{rank}.npz", **{n: t.numpy() for n, t in out.items()})
dist.destroy_process_group()
"""


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_process_groups_match_stacked_ranks(tmp_path):
    inputs = _inputs(2, 2, seed=3)
    x, sel_idx, sel_w, w = inputs
    gx, wr, _, mask = _ep_inputs("token_mask")
    np.savez(tmp_path / "in.npz", x=x, sel_idx=sel_idx, sel_w=sel_w, wg=w[0], wu=w[1],
             wd=w[2], gx=gx, wr=wr, mask=mask)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", textwrap.dedent(PG_WORKER), str(r),
                               port, str(tmp_path)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(4)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    got = [dict(np.load(tmp_path / f"out{r}.npz")) for r in range(4)]
    mesh = M.stacked_mesh(pod=2, model=2)
    for mode in MODES:
        y, dg = _port_dispatch(mode, mesh, DROPS, "float32", inputs)
        for r in range(4):
            assert np.array_equal(got[r][f"{mode}_y"][0], y[r].numpy())
            for name, t in zip(("dropped", "load", "dcn"), dg):
                assert np.array_equal(got[r][f"{mode}_{name}"][0], t[r].numpy())
    # the same layer on the global tokens: the routing product has another
    # shape a process than over the stacked ranks, so y is within f32 1e-5
    wts = [torch.from_numpy(a) for a in (wr, *w)]
    for name, m in (("ep_pm", M.stacked_mesh(pod=2, model=2)),
                    ("ep_pd", M.stacked_mesh(pod=2, data=2))):
        y, aux, dg = api.ep_moe_ffn(
            torch.from_numpy(gx), *wts, top_k=K,
            cfg=api.ShuffleConfig(mode="blob", capacity_factor=1.0), mesh=m,
            compute_dtype=torch.float32, token_mask=torch.from_numpy(mask))
        for r in range(4):
            np.testing.assert_allclose(got[r][f"{name}_y"], y.numpy(), atol=TOL["float32"],
                                       rtol=0)
            np.testing.assert_allclose(got[r][f"{name}_aux"], float(aux), rtol=1e-6)
            for key, t in zip(("dropped", "load", "dcn"), dg):
                assert np.array_equal(got[r][f"{name}_{key}"], t.numpy())
