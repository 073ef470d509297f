"""The port's ``decoder`` kind with the MoE layer against the JAX package,
at ``qwen2-moe-smoke`` size, with the JAX package's parameters loaded
through ``repro_torch.interop.params_from_jax``: the parameter tree,
``lm.forward`` with the flash branch taken, decode steps from a zero
cache, the cache specs, and the options the port still refuses. Inputs
are made with numpy from a seed. The zero-initialised norms and q/k/v
biases are given values so that they count.

Tolerances (absolute): f32 1e-4 on logits of size ~10, bf16 1e-1, as for
the Zamba2 models (``tests/test_torch_zamba2.py``). The router runs in
f32 in both packages, but in bf16 its input differs between them by
rounding, so an expert whose probability ties the k-th within that
rounding can be picked by one package and not the other. Such a flip is
allowed only where the JAX package's k-th and (k+1)-th probabilities lie
within ``FLIP_MARGIN`` (1e-3: here the two packages' router
probabilities differ by ~1e-4 at the median and up to ~7e-4, on
probabilities of ~1/6). The tokens that depend on a flipped token (its
own and every later position of its row, by the causal mask) are left
out of the bf16 comparison, and need no near tie to flip again; the
rest must hold 1e-1. In f32 there is no flip.
"""

import dataclasses
import re
from functools import partial

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro.models.common import MLAConfig, MultimodalConfig
from repro.models.common import init_params as jax_init_params
from repro.shuffle import api as japi
from repro_torch.configs import get_config
from repro_torch.interop import cache_from_jax, params_from_jax, to_numpy
from repro_torch.models import lm
from repro_torch.models.common import init_params
from repro_torch.shuffle import api

ARCH = "qwen2-moe-a2.7b"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-4, "bfloat16": 1e-1}
FLIP_MARGIN = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(dtype, **kw):
    jd, td = DTYPES[dtype]
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True), compute_dtype=jd, **kw)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), compute_dtype=td, **kw)
    return jcfg, cfg


def _jax_params(jcfg, seed=0):
    params = jax_init_params(jlm.param_defs(jcfg), jax.random.key(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + (0.1 * rng.standard_normal(a.shape)
                                                   .astype(np.float32)
                                                   if np.all(np.asarray(a) == 0) else 0),
                        params)


def _tokens(B, S, seed=5):
    return np.random.default_rng(seed).integers(0, 128, (B, S)).astype(np.int32)


@pytest.fixture
def routes(monkeypatch):
    """Record every router call of both packages: the JAX package's
    selected experts and probabilities (by an ordered callback, through
    ``jit`` and ``scan``), and the port's selected experts."""
    jrec, trec = [], []
    jroute, troute = japi._route, api._route

    def jax_recording(*args, **kwargs):
        out = jroute(*args, **kwargs)
        jax.debug.callback(lambda s, p: jrec.append((np.asarray(s), np.asarray(p))),
                           out[1], out[2], ordered=True)
        return out

    def port_recording(*args, **kwargs):
        out = troute(*args, **kwargs)
        trec.append(out[1].numpy())
        return out

    monkeypatch.setattr(japi, "_route", jax_recording)
    monkeypatch.setattr(api, "_route", port_recording)
    return jrec, trec


def _first_flips(jrec, trec, top_k, where):
    """Replay the router calls of both packages in order. A token whose
    selected experts differ between them must be a near tie in the JAX
    package, unless it already depends on an earlier flip. ``where(i, u)``
    is the (row, position) of token ``u`` of call ``i``. Returns each
    flipped row's first flipped position."""
    jax.effects_barrier()
    assert len(jrec) == len(trec) and trec
    first = {}
    for i, ((jsel, jprobs), tsel) in enumerate(zip(jrec, trec)):
        flip = (np.sort(jsel, axis=1) != np.sort(tsel, axis=1)).any(axis=1)
        p = -np.sort(-jprobs, axis=1)
        margin = p[:, top_k - 1] - p[:, top_k]
        for u in np.nonzero(flip)[0]:
            b, s = where(i, u)
            if s < first.get(b, np.inf):
                assert margin[u] < FLIP_MARGIN, (i, u, margin[u])
                first[b] = s
    return first


def _close(got, want, tol, keep=None):
    g, w = to_numpy(got.float()), np.asarray(want, np.float32)
    if keep is not None:
        g, w = g[keep], w[keep]
    np.testing.assert_allclose(g, w, atol=tol, rtol=0)


def test_params_from_jax_is_bit_exact_and_counts_match():
    jcfg, cfg = _configs("bfloat16")
    jparams = _jax_params(jcfg)
    model = params_from_jax(cfg, jparams, device="cpu")
    blocks = jparams["blocks"]
    for name, want in (("ffn.shared.w_gate", blocks["ffn"]["shared"]["w_gate"]),
                       ("ffn.shared.w_down", blocks["ffn"]["shared"]["w_down"]),
                       ("ffn.router", blocks["ffn"]["router"]),
                       ("ffn.we_up", blocks["ffn"]["we_up"]),
                       ("attn.bq", blocks["attn"]["bq"]), ("attn.bk", blocks["attn"]["bk"]),
                       ("attn.bv", blocks["attn"]["bv"])):
        for layer in range(cfg.num_layers):
            got = model.get_parameter(f"blocks.{layer}.{name}")
            assert torch.equal(got, torch.from_numpy(np.ascontiguousarray(want[layer])))
    assert float(model.blocks[1].attn.bv.abs().sum()) > 0
    n_jax = sum(np.asarray(a).size for a in jax.tree.leaves(jparams))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    # every JAX leaf has its parameter in each layer of the port, and no more
    names = {re.sub(r"^blocks\.\d+\.", "blocks.", n) for n, _ in model.named_parameters()}
    assert names == {".".join(k.key for k in path)
                     for path, _ in jax.tree.leaves_with_path(jparams)}
    assert get_config(ARCH).param_count() == jax_get_config(ARCH).param_count() == 14_315_735_040


def test_init_params_draws_the_specs_distributions():
    cfg = get_config(ARCH, smoke=True)
    model = init_params(lm.LM(cfg, device="cpu"), torch.Generator().manual_seed(0))
    d, de = cfg.d_model, cfg.moe.d_expert
    ffn = model.blocks[0].ffn
    assert abs(float(ffn.router.std()) - 0.02) < 0.004                  # small
    # the experts' fan-in skips their "experts" axis
    assert abs(float(ffn.we_gate.std()) - d ** -0.5) < 0.1 * d ** -0.5
    assert abs(float(ffn.we_down.std()) - de ** -0.5) < 0.1 * de ** -0.5
    assert float(model.blocks[0].attn.bq.abs().max()) == 0.0            # zeros


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax_with_the_flash_branch(dtype, routes):
    # flash_min_seq 16 < S = 64: every layer takes the flash branch
    jcfg, cfg = _configs(dtype, flash_min_seq=16)
    jparams = _jax_params(jcfg)
    model = params_from_jax(cfg, jparams, device="cpu")
    B, S = 2, 64
    tok = _tokens(B, S)
    want, aux_want = jax.jit(partial(jlm.forward, jcfg))(jparams, {"tokens": jnp.asarray(tok)})
    got, aux = lm.forward(cfg, model, {"tokens": torch.from_numpy(tok)})
    assert got.shape == want.shape and got.dtype == cfg.compute_dtype
    assert aux.dtype == torch.float32 and float(aux) > 0
    jrec, trec = routes
    assert len(trec) == cfg.num_layers
    first = _first_flips(jrec, trec, cfg.moe.top_k, lambda i, u: divmod(u, S))
    keep = np.ones((B, S), bool)
    for b, s in first.items():
        keep[b, s:] = False
    if dtype == "float32":
        assert keep.all()
    assert keep.mean() > 0.5, keep.mean()
    _close(got, want, TOL[dtype], keep)
    np.testing.assert_allclose(float(aux), float(aux_want),
                               rtol=1e-5 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_jax(dtype, routes):
    jcfg, cfg = _configs(dtype)
    jparams = _jax_params(jcfg)
    model = params_from_jax(cfg, jparams, device="cpu")
    B, steps = 2, 8
    jcache = jax_init_params(jlm.cache_defs(jcfg, B, steps), jax.random.key(1))
    cache = cache_from_jax(jax.tree.map(np.asarray, jcache), device="cpu")
    tok = _tokens(B, steps)
    jstep = jax.jit(partial(jlm.decode_step, jcfg))
    got, want = [], []
    for t in range(steps):
        w, jcache = jstep(jparams, jcache, {"tokens": jnp.asarray(tok[:, t:t + 1]),
                                            "pos": jnp.int32(t)})
        g, cache = lm.decode_step(cfg, model, cache, {"tokens": torch.from_numpy(
            tok[:, t:t + 1]), "pos": t})
        got.append(g[:, 0])
        want.append(np.asarray(w[:, 0], np.float32))
    jrec, trec = routes
    assert len(trec) == steps * cfg.num_layers
    first = _first_flips(jrec, trec, cfg.moe.top_k,
                         lambda i, u: (u, i // cfg.num_layers))
    keep = np.ones((B, steps), bool)
    for b, t in first.items():
        keep[b, t:] = False
    if dtype == "float32":
        assert keep.all()
    _close(torch.stack(got, dim=1), np.stack(want, axis=1), TOL[dtype], keep)
    rows = keep.all(axis=1)
    for name in ("k", "v"):
        _close(cache["blocks"][name][:, rows], np.asarray(jcache["blocks"][name],
                                                          np.float32)[:, rows], TOL[dtype])


def test_decode_writes_the_kv_cache_in_place():
    cfg = get_config(ARCH, smoke=True)
    model = init_params(lm.LM(cfg, device="cpu"), torch.Generator().manual_seed(0))
    cache = lm.init_cache(cfg, 1, 4, device="cpu")
    k0 = cache["blocks"]["k"]
    logits, cache2 = lm.decode_step(cfg, model, cache, {"tokens": torch.tensor([[3]]),
                                                        "pos": 0})
    assert logits.shape == (1, 1, cfg.vocab_size) and cache2 is cache
    assert cache2["blocks"]["k"] is k0 and k0.shape == (cfg.num_layers, 1, 4, 4, 16)
    assert float(k0[:, :, 0].abs().sum()) > 0 and float(k0[:, :, 1:].abs().sum()) == 0


def test_cache_defs_match_jax():
    jcfg, cfg = _configs("bfloat16")
    jdefs = jlm.cache_defs(jcfg, 3, 20)
    defs = lm.cache_defs(cfg, 3, 20)
    flat = jax.tree.leaves_with_path(jdefs, is_leaf=lambda s: hasattr(s, "shape"))
    assert len(flat) == 2
    for path, spec in flat:
        mine = defs
        for k in path:
            mine = mine[k.key]
        assert tuple(mine.shape) == tuple(spec.shape), path
        assert str(mine.dtype).split(".")[-1] == np.dtype(spec.dtype).name, path


def test_the_decoder_without_moe_runs_the_mlp():
    _, cfg = _configs("float32", moe=None, flash_min_seq=16)
    model = init_params(lm.LM(cfg, device="cpu"), torch.Generator().manual_seed(0))
    assert model.blocks[0].ffn.w_gate.shape == (cfg.d_model, cfg.d_ff)
    logits, aux = lm.forward(cfg, model, {"tokens": torch.from_numpy(_tokens(1, 32))})
    assert logits.shape == (1, 32, cfg.vocab_size) and float(aux) == 0.0


@pytest.mark.parametrize("field,value,name", [
    ("moe.first_dense_layers", 1, "first_dense_layers"), ("mla", MLAConfig(), "mla"),
    ("kind", "encoder", "encoder"), ("mlp", "geglu", "geglu"),
    ("multimodal", MultimodalConfig(), "multimodal")])
def test_what_the_decoder_does_not_run_raises_naming_it(field, value, name):
    cfg = get_config(ARCH, smoke=True)
    if field.startswith("moe."):
        moe = dataclasses.replace(cfg.moe, **{field[4:]: value, "dense_d_ff": 96})
        cfg = dataclasses.replace(cfg, moe=moe)
    else:
        cfg = dataclasses.replace(cfg, **{field: value})
    for call in (lambda: lm.LM(cfg, device="meta"), lambda: lm.cache_defs(cfg, 1, 4),
                 lambda: lm.forward(cfg, None, {})):
        with pytest.raises(ValueError, match=name):
            call()
