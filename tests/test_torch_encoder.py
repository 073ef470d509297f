"""The port's ``encoder`` kind and stub frontends against the JAX package:
hubert-xlarge (audio frames plus sinusoidal positions, non-causal
attention, GELU with biases, no decode step) and llava-next-34b (vision
patches before the tokens, GQA), at their SMOKE sizes, with the JAX
package's parameters loaded through ``repro_torch.interop.params_from_jax``.

    PYTHONPATH=src python -m pytest -q tests/test_torch_encoder.py

* ``lm._sinusoidal`` against the JAX package's ``_sinusoidal``: the
  angles bit for bit, the column interleave and the cos columns'
  ``ang[:, :d // 2]`` exactly, every value within one f32 ulp. Not bit
  for bit: the JAX package's f32 sin and cos on the CPU are the C
  library's ``sinf``/``cosf``, which are not correctly rounded; the port
  takes them in f64 and rounds once, and some entries of the two differ
  by one ulp. The bf16 positions are held to one bf16 ulp.
* ``lm.forward`` with the flash branch taken (``flash_min_seq`` 16 < S
  64; non-causal for hubert), f32 1e-4 and bf16 1e-1 absolute on the
  logits, the tolerances of ``tests/test_torch_decoder.py``. There is no
  router, so nothing is left out.
* Two SMOKE encoders with the decoder's FFN and attention variants,
  hubert SMOKE with qwen2-moe SMOKE's MoE layer and with deepseek-v2-lite
  SMOKE's MLA and MoE (one leading dense layer): ``lm.forward``'s logits
  at the same tolerances, and the aux loss at those of
  ``tests/test_torch_decoder.py`` (relative 1e-5 in f32, 1e-2 in bf16).
  In bf16 a router can pick another expert where two tie within the
  packages' rounding; as in the decoder test, such a flip must be a near
  tie in the JAX package (``FLIP_MARGIN``) and the tokens it reaches are
  left out: through the capacity, the later tokens it moves out of or
  into an expert's bin as well. Attention is not causal here: a token
  changed in the last MoE layer reaches itself only, one in an earlier
  layer its whole row. At least ``MIN_KEPT`` of the tokens are compared
  (seed 5 keeps half of the MoE encoder's, whose first layer flips in
  one row, and 123 of the MLA encoder's 128). In f32 there is no flip.
* llava's decode steps (tokens only) against the JAX package's.
* hubert's ``cache_defs``, ``init_cache``, ``decode_step``, the decode
  step of ``repro_torch.serving``, ``launch.serve.generate`` and the
  serve launcher refuse the encoder by name, as the JAX package's
  ``cache_defs`` and launcher do.
* One ``cuda`` case: hubert SMOKE on the card (the wgmma flash kernel,
  non-causal) against the CPU's plain path.

Inputs are made with numpy from a seed; the zero-initialised norms and
biases are given values so that they count.
"""

import dataclasses
from functools import partial

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro.models.common import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.interop import cache_from_jax, params_from_jax, to_numpy, to_torch
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.models.common import init_params
from repro_torch.serving import ServeConfig, make_decode_step, make_prefill_step
from repro_torch.shuffle import api, dispatch
from repro.shuffle import api as japi

HUBERT, LLAVA = "hubert-xlarge", "llava-next-34b"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-4, "bfloat16": 1e-1}
AUX_RTOL = {"float32": 1e-5, "bfloat16": 1e-2}
FLIP_MARGIN = 1e-3
MIN_KEPT = 0.25
B, S = 2, 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, dtype, **kw):
    jd, td = DTYPES[dtype]
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), compute_dtype=jd, **kw)
    cfg = dataclasses.replace(get_config(arch, smoke=True), compute_dtype=td, **kw)
    return jcfg, cfg


def _jax_params(jcfg, seed=0):
    params = jax_init_params(jlm.param_defs(jcfg), jax.random.key(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + (0.1 * rng.standard_normal(a.shape)
                                                   .astype(np.float32)
                                                   if np.all(np.asarray(a) == 0) else 0),
                        params)


def _batch(cfg, b=B, s=S, seed=5):
    """The arch's prefill inputs as numpy: frames (audio), or patches
    and the tokens after them (vision)."""
    rng = np.random.default_rng(seed)
    kind = cfg.multimodal.kind
    if kind == "audio":
        return {"frames": rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)}
    P = cfg.multimodal.num_patches
    return {"patches": rng.standard_normal((b, P, cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (b, s - P)).astype(np.int32)}


def _close(got, want, tol):
    np.testing.assert_allclose(to_numpy(got.float()), np.asarray(want, np.float32),
                               atol=tol, rtol=0)


# ---------------------------------------------------------------------------
# the sinusoidal positions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,d", [(64, 64), (4096, 1280), (100, 80), (5, 7)])
def test_sinusoidal_matches_jax(S, d):
    pos = jnp.arange(S, dtype=jnp.float32)[:, None]
    dim = jnp.arange(0, d, 2, dtype=jnp.float32)[None, :]
    jang = np.asarray(pos / jnp.power(10000.0, dim / d))
    ang = lm._angles(S, d, "cpu")
    assert ang.dtype == torch.float32
    assert np.array_equal(ang.numpy().view(np.uint32), jang.view(np.uint32))
    want = np.asarray(jlm._sinusoidal(S, d, jnp.float32))
    got = lm._sinusoidal(S, d, torch.float32, "cpu")
    assert got.dtype == torch.float32 and got.shape == (S, d)
    # the interleave: sin of every angle in the even columns, cos of the
    # first d // 2 in the odd ones
    a64 = ang.double()
    assert torch.equal(got[:, 0::2], torch.sin(a64).float())
    assert torch.equal(got[:, 1::2], torch.cos(a64[:, :d // 2]).float())
    ulps = np.abs(got.numpy().view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1, ulps.max()
    # the cast at the end: bf16 positions within one bf16 ulp
    wb = np.asarray(jlm._sinusoidal(S, d, jnp.bfloat16))
    gb = lm._sinusoidal(S, d, torch.bfloat16, "cpu")
    assert gb.dtype == torch.bfloat16
    bulps = np.abs(to_numpy(gb).view(np.int16).astype(np.int64)
                   - wb.view(np.int16).astype(np.int64))
    assert bulps.max() <= 1, bulps.max()


# ---------------------------------------------------------------------------
# the forward pass
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [HUBERT, LLAVA])
def test_forward_matches_jax_with_the_flash_branch(arch, dtype, monkeypatch):
    jcfg, cfg = _configs(arch, dtype, flash_min_seq=16)
    jparams = _jax_params(jcfg)
    model = params_from_jax(cfg, jparams, device="cpu")
    batch = _batch(cfg)
    calls = []
    real = lm.A.flash_attention_op
    monkeypatch.setattr(lm.A, "flash_attention_op",
                        lambda *a, **kw: calls.append(kw["causal"]) or real(*a, **kw))
    want, aux_want = jax.jit(partial(jlm.forward, jcfg))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    got, aux = lm.forward(cfg, model, {k: torch.from_numpy(v) for k, v in batch.items()})
    # every layer took the flash branch, causal as the config says
    assert calls == [cfg.causal] * cfg.num_layers
    assert got.shape == want.shape == (B, S, cfg.vocab_size)
    assert got.dtype == cfg.compute_dtype and float(aux) == float(aux_want) == 0.0
    _close(got, want, TOL[dtype])


def test_the_encoder_is_not_causal_and_reads_no_token_table():
    """hubert attends to later frames, and its (untied) embedding table,
    which it holds as the JAX package does, does not move its logits."""
    _, cfg = _configs(HUBERT, "float32")
    model = init_params(lm.LM(cfg, device="cpu"), torch.Generator().manual_seed(0))
    frames = torch.from_numpy(_batch(cfg)["frames"])
    logits, _ = lm.forward(cfg, model, {"frames": frames})
    later = frames.clone()
    later[:, -1] += 1.0
    moved, _ = lm.forward(cfg, model, {"frames": later})
    assert not torch.equal(moved[:, 0], logits[:, 0])       # the first frame sees the last
    assert model.embed.tok.shape == (cfg.vocab_size, cfg.d_model)
    with torch.no_grad():
        model.embed.tok.normal_()
    again, _ = lm.forward(cfg, model, {"frames": frames})
    assert torch.equal(again, logits)


#: the SMOKE config whose MoE (and MLA) config each MoE encoder takes
MOE_SOURCES = {"moe": "qwen2-moe-a2.7b", "mla": "deepseek-v2-lite-16b"}


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


def _within_capacity(sel, E, cap):
    """Each token's experts that keep its unit: units in token-major order,
    an expert's first ``cap`` units kept, the overflow dropped (the dense
    dispatch's stable bin packing)."""
    seen = np.zeros(E, np.int64)
    kept = []
    for row in sel:
        mine = set()
        for e in row:
            if seen[e] < cap:
                mine.add(int(e))
            seen[e] += 1
        kept.append(frozenset(mine))
    return kept


def _kept(jrec, trec, moe, shape):
    """The (row, position) mask of the tokens that no router flip reaches,
    with attention not causal. A token whose experts differ between the
    packages must be a near tie in the JAX package unless its row is
    already reached. Through the capacity, a flip can also move later
    tokens of either row out of (or into) an expert's bin. A token whose
    kept experts differ reaches its whole row in the later layers, and
    only itself in the last MoE layer."""
    jax.effects_barrier()
    assert len(jrec) == len(trec) and trec
    keep = np.ones(shape, bool)
    reached = set()
    E, k = moe.num_experts, moe.top_k
    cap = dispatch._cap(shape[0] * shape[1] * k / E, moe.capacity_factor)
    for i, ((jsel, jprobs), tsel) in enumerate(zip(jrec, trec)):
        flip = (np.sort(jsel, axis=1) != np.sort(tsel, axis=1)).any(axis=1).reshape(shape)
        p = -np.sort(-jprobs, axis=1)
        margin = (p[:, k - 1] - p[:, k]).reshape(shape)
        moved = np.array([a != b for a, b in zip(_within_capacity(jsel, E, cap),
                                                 _within_capacity(tsel, E, cap))])
        rows = set()
        for b, s in zip(*np.nonzero(flip | moved.reshape(shape))):
            if b in reached:
                continue
            if flip[b, s]:
                assert margin[b, s] < FLIP_MARGIN, (i, b, s, margin[b, s])
            keep[b, s] = False
            rows.add(b)
        if i < len(trec) - 1:
            for b in rows:
                keep[b] = False
        reached |= rows
    return keep


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", list(MOE_SOURCES))
def test_moe_and_mla_encoders_match_jax(variant, dtype, routes):
    """hubert SMOKE with qwen2-moe SMOKE's MoE layer (2 MoE layers), or
    with deepseek-v2-lite SMOKE's MLA and MoE (a dense layer, then a MoE
    layer), through the flash branch."""
    jsrc = jax_get_config(MOE_SOURCES[variant], smoke=True)
    src = get_config(MOE_SOURCES[variant], smoke=True)
    jcfg, cfg = _configs(HUBERT, dtype, flash_min_seq=16)
    jcfg = dataclasses.replace(jcfg, moe=jsrc.moe, mla=jsrc.mla)
    cfg = dataclasses.replace(cfg, moe=src.moe, mla=src.mla)
    assert cfg.kind == "encoder" and not cfg.causal and cfg.mlp == "gelu"
    jparams = _jax_params(jcfg)
    model = params_from_jax(cfg, jparams, device="cpu")
    n_dense = cfg.moe.first_dense_layers
    assert (len(model.dense_blocks), len(model.blocks)) == (n_dense, cfg.num_layers - n_dense)
    batch = _batch(cfg)
    want, aux_want = jax.jit(partial(jlm.forward, jcfg))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    got, aux = lm.forward(cfg, model, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.shape == want.shape == (B, S, cfg.vocab_size) and got.dtype == cfg.compute_dtype
    jrec, trec = routes
    assert len(trec) == cfg.num_layers - n_dense
    keep = _kept(jrec, trec, cfg.moe, (B, S))
    if dtype == "float32":
        assert keep.all()
    assert keep.mean() >= MIN_KEPT, keep.mean()
    np.testing.assert_allclose(to_numpy(got.float())[keep],
                               np.asarray(want, np.float32)[keep], atol=TOL[dtype], rtol=0)
    assert aux.dtype == torch.float32 and float(aux_want) > 0
    np.testing.assert_allclose(float(aux), float(aux_want), rtol=AUX_RTOL[dtype])


def test_prefill_step_takes_the_frontend_batches():
    for arch in (HUBERT, LLAVA):
        _, cfg = _configs(arch, "float32")
        model = init_params(lm.LM(cfg, device="cpu"), torch.Generator().manual_seed(0))
        batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
        got = make_prefill_step(cfg, ServeConfig())(model, batch)
        want, _ = lm.forward(cfg, model, batch)
        assert torch.equal(got, want) and got.shape == (B, S, cfg.vocab_size)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vision_decode_takes_tokens_and_matches_jax(dtype):
    jcfg, cfg = _configs(LLAVA, dtype)
    jparams = _jax_params(jcfg)
    model = params_from_jax(cfg, jparams, device="cpu")
    steps = 8
    jcache = jax_init_params(jlm.cache_defs(jcfg, B, steps), jax.random.key(1))
    cache = cache_from_jax(jax.tree.map(np.asarray, jcache), device="cpu")
    tok = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, steps)).astype(np.int32)
    jstep = jax.jit(partial(jlm.decode_step, jcfg))
    got, want = [], []
    for t in range(steps):
        w, jcache = jstep(jparams, jcache, {"tokens": jnp.asarray(tok[:, t:t + 1]),
                                            "pos": jnp.int32(t)})
        g, cache = lm.decode_step(cfg, model, cache, {"tokens": torch.from_numpy(
            tok[:, t:t + 1]), "pos": t})
        got.append(g[:, 0])
        want.append(np.asarray(w[:, 0], np.float32))
    _close(torch.stack(got, dim=1), np.stack(want, axis=1), TOL[dtype])
    for name in ("k", "v"):
        _close(cache["blocks"][name], np.asarray(jcache["blocks"][name], np.float32),
               TOL[dtype])


def test_vision_decode_matches_a_text_only_prefill():
    """Decode has no patch input: its logits over a prompt are those of
    the prefill of the same tokens after no patches."""
    _, cfg = _configs(LLAVA, "float32")
    model = init_params(lm.LM(cfg, device="cpu"), torch.Generator().manual_seed(0))
    prompts = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, 6)).astype(np.int32))
    want, _ = lm.forward(cfg, model, {"tokens": prompts,
                                      "patches": torch.zeros((B, 0, cfg.d_model))})
    out = serve.generate(cfg, model, prompts, 1)
    torch.testing.assert_close(out["logits"], want, atol=5e-5, rtol=0)


def test_the_encoder_has_no_decode_step():
    jcfg, cfg = _configs(HUBERT, "float32")
    with pytest.raises(ValueError, match="has no decode step"):
        jlm.cache_defs(jcfg, 1, 4)
    model = init_params(lm.LM(cfg, device="cpu"), torch.Generator().manual_seed(0))
    step = make_decode_step(cfg, ServeConfig())
    batch = {"tokens": torch.zeros((1, 1), dtype=torch.int32), "pos": 0}
    for call in (lambda: lm.cache_defs(cfg, 1, 4), lambda: lm.init_cache(cfg, 1, 4, "cpu"),
                 lambda: lm.decode_step(cfg, model, {}, batch),
                 lambda: step(model, {}, batch),
                 lambda: serve.generate(cfg, model, batch["tokens"], 2)):
        with pytest.raises(ValueError, match=f"{cfg.name}: the encoder kind has no decode step"):
            call()
    assert not cfg.has_decode and get_config(LLAVA).has_decode
    with pytest.raises(SystemExit, match="hubert-xlarge is encoder-only"):
        serve.main(["--arch", HUBERT, "--device", "cpu"])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_hubert_smoke_on_card_matches_the_cpu():
    """hubert SMOKE in bf16 with the flash branch (S 64 > 16): on the card
    every layer launches the wgmma kernel, non-causal at head dim 16; the
    logits within the bf16 tolerance (1e-1) of the CPU's plain path on the
    same parameters and frames."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the flash kernel runs only on the card")
    from repro_torch.kernels.flash_attention import kernel as flash_kernel

    _, cfg = _configs(HUBERT, "bfloat16", flash_min_seq=16)
    cpu = init_params(lm.LM(cfg, device="cpu"), torch.Generator().manual_seed(0))
    card = lm.LM(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    frames = _batch(cfg)["frames"]
    want, _ = lm.forward(cfg, cpu, {"frames": torch.from_numpy(frames)})
    before = {k.symbol: k.launches for k in flash_kernel.KERNELS}
    with torch.inference_mode():
        got, _ = lm.forward(cfg, card, {"frames": to_torch(frames, "cuda")})
    ran = {k.symbol: k.launches - before[k.symbol] for k in flash_kernel.KERNELS}
    assert ran == {k.symbol: cfg.num_layers * int(k is flash_kernel.FLASH_WGMMA)
                   for k in flash_kernel.KERNELS}
    assert got.is_cuda and got.dtype == torch.bfloat16
    _close(got.cpu(), to_numpy(want.float()), TOL["bfloat16"])
