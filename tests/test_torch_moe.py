"""The port's single-device MoE against the JAX package at
``qwen2-moe-smoke`` size: the capacity arithmetic, the router, the dense
dispatch, the padding of experts, the aux loss, ``ep_moe_ffn`` without a
mesh and ``moe_apply`` with shared experts. Inputs are made with numpy
from a seed; parameters cross with ``interop.params_from_jax``.

The dense dispatch scatters with the blob pack op and gathers with the
blob unpack op; on the same units that is the byte movement of the
index-based ``binning.scatter_to_bins``/``gather_from_bins``, so the
layer must be bit for bit the one that calls those (on the CPU here, and
through the kernels in the ``cuda`` test).

Tolerances: in f32 the two packages run the same math in another order,
so the routed FFN agrees to ~1e-7 on values of size ~1; 1e-5 is stated.
In bf16 (the configs' compute dtype) each product and the SwiGLU round
to 8 bits of mantissa at places the two frameworks do not share; 1e-1
is stated, as for the model tests, on values of size ~1-3. The router is
f32 in both packages, so on the same inputs the selected experts and
the loads are equal exactly.
"""

import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models.common import init_params as jax_init_params
from repro.shuffle import api as japi
from repro.shuffle import dispatch as jdispatch
from repro_torch.configs import get_config
from repro_torch.interop import assert_same_bits, params_from_jax, to_numpy, to_torch
from repro_torch.kernels.blob_pack.ops import blob_pack
from repro_torch.kernels.blob_unpack.ops import blob_unpack
from repro_torch.models import moe
from repro_torch.shuffle import api, binning, dispatch

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 1e-1}
# capacity factors: 4.0 drops no unit at these sizes, 0.25 drops many
NO_DROP, DROPS = 4.0, 0.25


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(dtype="bfloat16"):
    jd, td = DTYPES[dtype]
    jcfg = dataclasses.replace(jax_get_config("qwen2-moe-a2.7b", smoke=True), compute_dtype=jd)
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b", smoke=True), compute_dtype=td)
    return jcfg, cfg


@pytest.fixture(scope="module")
def layer():
    """Layer 1 of the smoke model: the JAX parameters and the port's."""
    jcfg, cfg = _configs()
    jparams = jax.tree.map(np.asarray, jax_init_params(jlm.param_defs(jcfg),
                                                       jax.random.key(0)))
    model = params_from_jax(cfg, jparams, device="cpu")
    return jax.tree.map(lambda a: a[1], jparams["blocks"]["ffn"]), model.blocks[1].ffn


def _x(T, d, dtype, seed=3):
    x = np.random.default_rng(seed).standard_normal((T, d)).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), to_torch(x, "cpu").to(td)


def _close(got, want, tol):
    np.testing.assert_allclose(to_numpy(got.float()), np.asarray(want, np.float32),
                               atol=tol, rtol=0)


def _weights(p):
    return p.router, p.we_gate, p.we_up, p.we_down


def _jweights(jp):
    return jp["router"], jp["we_gate"], jp["we_up"], jp["we_down"]


EXPECTED = [0.1, 1.0, 1.5, 7.9, 8.0, 8.01, 21.333333333333332, 1092.2666666666667,
            1365.3333333333333, 65536 / 60, 16 / 60, 256 / 60, 1e5 / 3]
FACTORS = [0.25, 1.0, 1.1, 1.25, 1.5, 2.0, 4.0, 60.0]


def test_capacity_arithmetic_matches_jax():
    for expected in EXPECTED:
        for factor in FACTORS:
            for align in (1, 8, 128):
                got = dispatch._cap(expected, factor, align)
                assert isinstance(got, int)
                assert got == jdispatch._cap(expected, factor, align), (expected, factor, align)
    for base in FACTORS:
        for pool in (0, 1, 2, 3, 8, 64, 1000):
            got = dispatch.pooled_capacity_factor(base, pool)
            assert isinstance(got, float)
            assert got == jdispatch.pooled_capacity_factor(base, pool)
    # the full model's prefill and decode capacities
    assert dispatch._cap(4 * 4096 * 4 / 60, 1.25) == 1368
    assert dispatch._cap(4 * 4 / 60, 1.25) == 8


@pytest.mark.parametrize("norm_topk", [True, False])
@pytest.mark.parametrize("num_real", [None, 4])
def test_route_matches_jax(layer, norm_topk, num_real):
    jp, p = layer
    jx, x = _x(96, 64, "float32")
    want = japi._route(jx, jp["router"], 2, norm_topk, num_real=num_real)
    got = api._route(x, p.router, 2, norm_topk, num_real=num_real)
    assert got[1].dtype == torch.int32 and got[0].dtype == got[2].dtype == torch.float32
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    if num_real is not None:
        assert int(got[1].max()) < num_real
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)


def _dense(p, x, factor, cd):
    return api.dense_moe_ffn(x, *_weights(p), top_k=2, capacity_factor=factor,
                             compute_dtype=cd)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("factor", [NO_DROP, DROPS], ids=["no-drop", "drops"])
def test_dense_moe_ffn_matches_jax(layer, dtype, factor):
    jp, p = layer
    jx, x = _x(64, 64, dtype)
    jd, td = DTYPES[dtype]
    y_want, aux_want, load_want = japi.dense_moe_ffn(
        jx, *_jweights(jp), top_k=2, capacity_factor=factor, compute_dtype=jd)
    y, aux, load = _dense(p, x, factor, td)
    assert y.dtype == td and load.dtype == torch.int32
    assert np.array_equal(load.numpy(), np.asarray(load_want))
    cap = dispatch._cap(64 * 2 / 6, factor)
    dropped = int(torch.clamp(load - cap, min=0).sum())
    assert (dropped == 0) == (factor == NO_DROP)
    _close(y, y_want, TOL[dtype])
    np.testing.assert_allclose(float(aux), float(aux_want), rtol=1e-6)
    # dropped units read 0: a token whose every unit was dropped gets 0
    _, sel_idx, _ = api._route(x, p.router, 2, True)
    valid = binning.bin_pack(sel_idx.reshape(-1), 6, cap).valid.reshape(64, 2)
    lost = ~valid.any(dim=1)
    assert bool(lost.any()) == (factor == DROPS)
    assert float(y[lost].abs().sum()) == 0.0


def _dense_indexed(x, w_router, we_gate, we_up, we_down, top_k, factor, cd):
    """``dense_moe_ffn`` as the JAX package writes it, with the index-based
    binning helpers: the plain reference of the pack/unpack path."""
    T, d = x.shape
    E = w_router.shape[1]
    sel_w, sel_idx, probs = api._route(x, w_router, top_k, True)
    U = T * top_k
    cap = dispatch._cap(U / E, factor)
    unit_tok = torch.arange(T, dtype=torch.int32, device=x.device).repeat_interleave(top_k)
    pack = binning.bin_pack(sel_idx.reshape(-1), E, cap)
    ebuf = binning.scatter_to_bins(x[unit_tok], pack, E, cap)
    eout = api._expert_ffn(we_gate, we_up, we_down, cd)(ebuf)
    y_units = binning.gather_from_bins(eout, pack)
    y = torch.einsum("tk,tkd->td", sel_w, y_units.reshape(T, top_k, d).float())
    return y.to(x.dtype), api._aux_loss(probs, pack.counts, U, E), pack.counts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("factor", [NO_DROP, DROPS], ids=["no-drop", "drops"])
def test_pack_and_unpack_ops_are_the_binning_helpers_bit_for_bit(layer, dtype, factor):
    _, p = layer
    _, x = _x(64, 64, dtype)
    cd = DTYPES[dtype][1]
    _, sel_idx, _ = api._route(x, p.router, 2, True)
    keys = sel_idx.reshape(-1)
    cap = dispatch._cap(128 / 6, factor)
    unit_tok = torch.arange(64, dtype=torch.int32).repeat_interleave(2)
    order, starts, counts = binning.sorted_order(keys, 6)
    pack = binning.pack_sorted(keys, order, starts, counts, cap)
    assert_same_bits(tuple(pack), tuple(binning.bin_pack(keys, 6, cap)))
    ebuf = blob_pack(x, unit_tok[order], starts, counts, capacity=cap)
    assert_same_bits(ebuf, binning.scatter_to_bins(x[unit_tok], pack, 6, cap))
    eout = api._expert_ffn(p.we_gate, p.we_up, p.we_down, cd)(ebuf)
    assert_same_bits(blob_unpack(eout, pack.slot, pack.valid),
                     binning.gather_from_bins(eout, pack))
    # the whole layer
    got = _dense(p, x, factor, cd)
    want = _dense_indexed(x, *_weights(p), 2, factor, cd)
    assert_same_bits(tuple(got), tuple(want))


@pytest.mark.cuda
@pytest.mark.parametrize("factor", [1.25, DROPS], ids=["published", "drops"])
def test_moe_layer_through_the_kernels_is_bit_for_bit_the_binning_helpers(factor):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels run only on the card")
    from repro_torch.kernels.blob_pack import kernel as pack_kernel
    from repro_torch.kernels.blob_unpack import kernel as unpack_kernel
    from repro_torch.models.common import init_params
    _, cfg = _configs()
    model = init_params(moe.MoE(cfg, device="cuda"),
                        torch.Generator(device="cuda").manual_seed(0))
    x = torch.randn((512, cfg.d_model), generator=torch.Generator(device="cuda")
                    .manual_seed(1), device="cuda").to(torch.bfloat16)
    before = (pack_kernel.PACK.launches, unpack_kernel.UNPACK.launches)
    got = _dense(model, x, factor, torch.bfloat16)
    assert (pack_kernel.PACK.launches - before[0],
            unpack_kernel.UNPACK.launches - before[1]) == (1, 1)
    assert_same_bits(tuple(got), tuple(_dense_indexed(x, *_weights(model), 2, factor,
                                                      torch.bfloat16)))


def test_pad_experts_matches_jax(layer):
    jp, p = layer
    for ep in (1, 4, 6, 8):
        want = japi._pad_experts(*_jweights(jp), ep)
        got = api._pad_experts(*_weights(p), ep)
        assert got[4] == want[4] == 6
        for g, w in zip(got[:4], want[:4]):
            assert_same_bits(g, np.asarray(w))


def test_aux_loss_matches_jax():
    rng = np.random.default_rng(7)
    probs = rng.dirichlet(np.ones(6), size=40).astype(np.float32)
    load = rng.integers(0, 30, 6).astype(np.int32)
    for units in (0, 80, int(load.sum())):
        want = float(japi._aux_loss(jnp.asarray(probs), jnp.asarray(load), units, 6))
        got = api._aux_loss(torch.from_numpy(probs), torch.from_numpy(load), units, 6)
        assert got.dtype == torch.float32
        assert math.isclose(float(got), want, rel_tol=1e-6)


@pytest.mark.parametrize("mode", ["dense", "direct", "blob"])
def test_ep_moe_ffn_without_a_mesh_is_the_dense_dispatch(layer, mode):
    jp, p = layer
    jx, x = _x(64, 64, "float32")
    scfg = api.ShuffleConfig(mode=mode, capacity_factor=DROPS)
    y_w, aux_w, dg_w = japi.ep_moe_ffn(jx, *_jweights(jp), top_k=2,
                                       cfg=japi.ShuffleConfig(mode=mode, capacity_factor=DROPS),
                                       mesh=None, compute_dtype=jnp.float32)
    y, aux, dg = api.ep_moe_ffn(x, *_weights(p), top_k=2, cfg=scfg, mesh=None,
                                compute_dtype=torch.float32)
    assert isinstance(dg, dispatch.DispatchDiagnostics)
    _close(y, y_w, TOL["float32"])
    np.testing.assert_allclose(float(aux), float(aux_w), rtol=1e-6)
    assert np.array_equal(dg.expert_load.numpy(), np.asarray(dg_w.expert_load))
    assert int(dg.dropped) == int(dg_w.dropped) == 0
    assert float(dg.dcn_bytes) == float(dg_w.dcn_bytes) == 0.0
    assert dg.dropped.dtype == torch.int32 and dg.dcn_bytes.dtype == torch.float32


def test_ep_moe_ffn_refuses_an_unknown_mesh_type_by_name(layer):
    _, p = layer
    _, x = _x(8, 64, "float32")

    class Grid:                 # a mesh's fields, but no exchange runs it
        axis_names = ("pod", "model")
        shape = {"pod": 2, "model": 2}

    for mesh in (object(), ("pod", "model"), Grid()):
        with pytest.raises(TypeError, match=type(mesh).__name__):
            api.ep_moe_ffn(x, *_weights(p), top_k=2, cfg=api.ShuffleConfig(mode="blob"),
                           mesh=mesh)


def test_shuffle_config_pod_local_matches_jax():
    for kw in ({}, {"token_axes": ("data", "pod"), "expert_axes": ("pod",)},
               {"pod_axis": "data", "mode": "blob"}):
        want = dataclasses.asdict(japi.ShuffleConfig(**kw).pod_local())
        assert dataclasses.asdict(api.ShuffleConfig(**kw).pod_local()) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["dense", "blob"])
def test_moe_apply_with_shared_experts_matches_jax(layer, dtype, mode):
    jp, p = layer
    jcfg, cfg = _configs(dtype)
    assert cfg.moe.num_shared == 2 and p.shared.w_gate.shape == (64, 192)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 24, 64)).astype(np.float32)
    jd, td = DTYPES[dtype]
    y_w, aux_w, diag_w = jmoe.moe_apply(jcfg, jp, jnp.asarray(x, jd),
                                        shuffle=japi.ShuffleConfig(mode=mode))
    y, aux, diag = moe.moe_apply(cfg, p, to_torch(x, "cpu").to(td),
                                 shuffle=api.ShuffleConfig(mode=mode))
    assert y.dtype == td and y.shape == (2, 24, 64)
    _close(y, y_w, 1e-4 if dtype == "float32" else TOL[dtype])
    np.testing.assert_allclose(float(aux), float(aux_w), rtol=1e-5)
    assert sorted(diag) == sorted(diag_w)
    for name in diag:
        assert diag[name].dtype == {"expert_load": torch.int32, "dropped": torch.int32,
                                    "dcn_bytes": torch.float32}[name]
        assert np.array_equal(diag[name].numpy(), np.asarray(diag_w[name]))
