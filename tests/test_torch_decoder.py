"""The port's ``decoder`` kind against the JAX package, at the smoke
sizes of qwen2-moe (the MoE layer, q/k/v biases), deepseek-v2-lite (MLA,
a leading dense layer, 8 experts top-2 and 2 shared), gemma-2b (GeGLU,
MQA, sqrt(d)-scaled tied embeddings), granite-3-2b (GQA, tied
embeddings), starcoder2-3b (GELU with biases, q/k/v biases, rope theta
1e5) and qwen2-72b (q/k/v biases, GQA, rope theta 1e6), with the JAX package's
parameters loaded through ``repro_torch.interop.params_from_jax``: the
parameter tree (``dense_blocks`` included), ``lm.forward`` with the
flash branch taken, decode steps from a zero cache carried by
``cache_from_jax``, the cache specs, the GeGLU and GELU MLPs, the
embedding scale bit for bit, and the options the port still refuses.
Inputs are made with numpy from a seed. The zero-initialised norms,
q/k/v biases and MLA ``kv_norm`` are given values so that they count.

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
rest must hold 1e-1. In f32 there is no flip. The kept share of the
prefill's tokens must exceed ``MIN_KEPT``: half for qwen2-moe-smoke (6
experts top-2, 2 MoE layers), a quarter for deepseek-v2-lite-smoke,
whose 8 experts top-2 put the k-th and (k+1)-th probabilities closer
(its seed-0 prefill flips at positions 18 and 29 of its two rows, at
JAX margins under 1e-4), all of them for the dense configs, which have
no router.
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
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models.common import init_params as jax_init_params
from repro.shuffle import api as japi
from repro_torch.configs import get_config
from repro_torch.interop import cache_from_jax, params_from_jax, to_numpy, to_torch
from repro_torch.models import layers, lm
from repro_torch.models.common import MultimodalConfig, init_params
from repro_torch.shuffle import api

ARCH = "qwen2-moe-a2.7b"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-4, "bfloat16": 1e-1}
FLIP_MARGIN = 1e-3
DEEPSEEK, GEMMA = "deepseek-v2-lite-16b", "gemma-2b"
DENSE = ("granite-3-2b", "starcoder2-3b", "qwen2-72b")
MIN_KEPT = {ARCH: 0.5, DEEPSEEK: 0.25, GEMMA: 0.99, **{a: 0.99 for a in DENSE}}
# every arch in both dtypes; qwen2-moe's cases keep the ids they had
# before the other archs came
ARCH_DTYPES = [pytest.param(a, d, id=d if a == ARCH else f"{a}-{d}")
               for a in (ARCH, DEEPSEEK, GEMMA, *DENSE) for d in ("float32", "bfloat16")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(dtype, arch=ARCH, **kw):
    jd, td = DTYPES[dtype]
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), compute_dtype=jd, **kw)
    cfg = dataclasses.replace(get_config(arch, smoke=True), compute_dtype=td, **kw)
    return jcfg, cfg


def _moe_layers(cfg):
    return 0 if cfg.moe is None else cfg.num_layers - cfg.moe.first_dense_layers


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


def test_params_from_jax_maps_the_dense_blocks():
    jcfg, cfg = _configs("bfloat16", DEEPSEEK)
    jparams = _jax_params(jcfg)
    model = params_from_jax(cfg, jparams, device="cpu")
    assert len(model.dense_blocks) == 1 and len(model.blocks) == cfg.num_layers - 1
    dense, blocks = jparams["dense_blocks"], jparams["blocks"]
    for name, want in (("attn.wq", dense["attn"]["wq"]), ("attn.kv_norm", dense["attn"]["kv_norm"]),
                       ("ffn.w_gate", dense["ffn"]["w_gate"])):
        got = model.get_parameter(f"dense_blocks.0.{name}")
        assert torch.equal(got, torch.from_numpy(np.ascontiguousarray(want[0])))
    assert model.dense_blocks[0].ffn.w_up.shape == (cfg.d_model, cfg.moe.dense_d_ff)
    for layer in range(len(model.blocks)):
        assert torch.equal(model.blocks[layer].attn.w_uv,
                           torch.from_numpy(np.ascontiguousarray(blocks["attn"]["w_uv"][layer])))
        assert torch.equal(model.blocks[layer].ffn.we_down,
                           torch.from_numpy(np.ascontiguousarray(blocks["ffn"]["we_down"][layer])))
    n_jax = sum(np.asarray(a).size for a in jax.tree.leaves(jparams))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    names = {re.sub(r"^(dense_blocks|blocks)\.\d+\.", r"\1.", n)
             for n, _ in model.named_parameters()}
    assert names == {".".join(k.key for k in path)
                     for path, _ in jax.tree.leaves_with_path(jparams)}
    for arch, count in ((DEEPSEEK, 15_706_484_224), (GEMMA, 2_506_172_416)):
        assert get_config(arch).param_count() == jax_get_config(arch).param_count() == count


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mlp", ["geglu", "gelu"])
def test_mlp_apply_matches_jax(mlp, dtype):
    jcfg, cfg = _configs(dtype, GEMMA, mlp=mlp)
    jp = jax.tree.map(np.asarray, jax_init_params(jlayers.mlp_defs(jcfg, cfg.d_ff),
                                                  jax.random.key(3)))
    rng = np.random.default_rng(3)
    jp = {k: v + (0.1 * rng.standard_normal(v.shape).astype(np.float32) if k[0] == "b" else 0)
          for k, v in jp.items()}             # the GELU MLP's zero biases
    p = layers.MLP(cfg, cfg.d_ff, device="cpu")
    assert set(p.specs) == set(jp)
    with torch.no_grad():
        for name, v in jp.items():
            getattr(p, name).copy_(to_torch(v, "cpu"))
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    want = jlayers.mlp_apply(jcfg, jp, jnp.asarray(x, jcfg.compute_dtype))
    got = layers.mlp_apply(cfg, p, to_torch(x, "cpu").to(cfg.compute_dtype))
    assert got.dtype == cfg.compute_dtype
    _close(got, want, TOL[dtype])


def test_embed_scale_matches_jax_bit_for_bit():
    """gemma's sqrt(2048) rounds to 45.25 in bf16, and the JAX package
    multiplies by that; the port's scaled rows have the same bits."""
    jcfg, cfg = _configs("bfloat16", GEMMA, d_model=2048)
    tok = np.random.default_rng(9).standard_normal((cfg.vocab_size, 2048)).astype(np.float32)
    tokens = _tokens(3, 17)
    want = jlayers.embed_apply(jcfg, {"tok": jnp.asarray(tok)}, jnp.asarray(tokens))
    emb = layers.Embedding(cfg, device="cpu")
    with torch.no_grad():
        emb.tok.copy_(torch.from_numpy(tok))
    got = layers.embed_apply(cfg, emb, torch.from_numpy(tokens))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(to_numpy(got).view(np.uint16), np.asarray(want).view(np.uint16))
    # a Python float scale would round some products differently
    unscaled = layers.embed_apply(dataclasses.replace(cfg, embed_scale=False), emb,
                                  torch.from_numpy(tokens))
    assert not torch.equal(unscaled * 2048 ** 0.5, got)


def _kept(jrec, trec, cfg, shape, where):
    """The (row, position) mask of the tokens that no router flip reaches
    (all of them for a model without MoE layers)."""
    keep = np.ones(shape, bool)
    if cfg.moe is None:
        assert not jrec and not trec
        return keep
    for b, s in _first_flips(jrec, trec, cfg.moe.top_k, where).items():
        keep[b, s:] = False
    return keep


@pytest.mark.parametrize("arch,dtype", ARCH_DTYPES)
def test_forward_matches_jax_with_the_flash_branch(arch, dtype, routes):
    # flash_min_seq 16 < S = 64: every layer takes the flash branch
    jcfg, cfg = _configs(dtype, arch, flash_min_seq=16)
    jparams = _jax_params(jcfg)
    model = params_from_jax(cfg, jparams, device="cpu")
    B, S = 2, 64
    tok = _tokens(B, S)
    want, aux_want = jax.jit(partial(jlm.forward, jcfg))(jparams, {"tokens": jnp.asarray(tok)})
    got, aux = lm.forward(cfg, model, {"tokens": torch.from_numpy(tok)})
    assert got.shape == want.shape and got.dtype == cfg.compute_dtype
    assert aux.dtype == torch.float32 and (float(aux) > 0) == (cfg.moe is not None)
    jrec, trec = routes
    assert len(trec) == _moe_layers(cfg)
    keep = _kept(jrec, trec, cfg, (B, S), lambda i, u: divmod(u, S))
    if dtype == "float32":
        assert keep.all()
    assert keep.mean() > MIN_KEPT[arch], keep.mean()
    _close(got, want, TOL[dtype], keep)
    np.testing.assert_allclose(float(aux), float(aux_want),
                               rtol=1e-5 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("arch,dtype", ARCH_DTYPES)
def test_decode_steps_match_jax(arch, dtype, routes):
    jcfg, cfg = _configs(dtype, arch)
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
    n_moe = _moe_layers(cfg)
    assert len(trec) == steps * n_moe
    keep = _kept(jrec, trec, cfg, (B, steps), lambda i, u: (u, i // n_moe))
    if dtype == "float32":
        assert keep.all()
    _close(torch.stack(got, dim=1), np.stack(want, axis=1), TOL[dtype], keep)
    rows = keep.all(axis=1)
    flat = jax.tree.leaves_with_path(jcache)
    assert len(flat) == (4 if arch == DEEPSEEK else 2)
    for path, leaf in flat:
        mine = cache
        for k in path:
            mine = mine[k.key]
        _close(mine[:, rows], np.asarray(leaf, np.float32)[:, rows], TOL[dtype])


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
    for arch, n_leaves in ((ARCH, 2), (DEEPSEEK, 4), (GEMMA, 2), *((a, 2) for a in DENSE)):
        jcfg, cfg = _configs("bfloat16", arch)
        jdefs = jlm.cache_defs(jcfg, 3, 20)
        defs = lm.cache_defs(cfg, 3, 20)
        flat = jax.tree.leaves_with_path(jdefs, is_leaf=lambda s: hasattr(s, "shape"))
        assert len(flat) == n_leaves
        assert set(defs) == set(jdefs)
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
    # the ids are those the cases had when MoE ran in the decoder kind only
    pytest.param("kind", "ssm", "moe outside the decoder and encoder kinds",
                 id="kind-ssm-moe outside the decoder kind"),
    pytest.param("kind", "hybrid", "moe outside the decoder and encoder kinds",
                 id="kind-hybrid-moe outside the decoder kind"),
    # the encoder kind runs MoE (tests/test_torch_encoder.py); it has no
    # decode step
    pytest.param("kind", "encoder", "the encoder kind has no decode step",
                 id="kind-encoder-encoder"),
    # the stub frontends are audio and vision (test below)
    pytest.param("multimodal", MultimodalConfig(kind="video"), "multimodal kind 'video'",
                 id="multimodal-value3-multimodal"),
    pytest.param("multimodal", MultimodalConfig(kind="text"), "multimodal kind 'text'",
                 id="multimodal-value4-multimodal")])
def test_what_the_decoder_does_not_run_raises_naming_it(field, value, name):
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), **{field: value})
    calls = (lambda: lm.LM(cfg, device="meta"), lambda: lm.cache_defs(cfg, 1, 4),
             lambda: lm.forward(cfg, None, {}))
    if value == "encoder":
        # a MoE encoder builds; its cache and decode step are refused
        assert len(lm.LM(cfg, device="meta").blocks) == cfg.num_layers
        batch = {"tokens": torch.zeros((1, 1), dtype=torch.int32), "pos": 0}
        calls = (lambda: lm.cache_defs(cfg, 1, 4), lambda: lm.init_cache(cfg, 1, 4, "cpu"),
                 lambda: lm.decode_step(cfg, None, {}, batch))
    for call in calls:
        with pytest.raises(ValueError, match=name):
            call()


@pytest.mark.parametrize("kind", ["audio", "vision"])
def test_the_moe_decoder_takes_the_stub_frontends(kind):
    """qwen2-moe SMOKE with either frontend: frames, or 4 patches before
    the tokens, give logits over the whole sequence; the decode step
    takes tokens."""
    _, cfg = _configs("float32", multimodal=MultimodalConfig(kind=kind, num_patches=4))
    model = init_params(lm.LM(cfg, device="cpu"), torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((1, 12, cfg.d_model)).astype(np.float32))
    batch = ({"frames": x} if kind == "audio" else
             {"patches": x[:, :4], "tokens": torch.from_numpy(_tokens(1, 8))})
    logits, aux = lm.forward(cfg, model, batch)
    assert logits.shape == (1, 12, cfg.vocab_size) and float(aux) > 0
    assert bool(torch.isfinite(logits).all())
    cache = lm.init_cache(cfg, 1, 2, device="cpu")
    out, _ = lm.decode_step(cfg, model, cache, {"tokens": torch.tensor([[3]]), "pos": 0})
    assert out.shape == (1, 1, cfg.vocab_size)
