"""The port's Mamba2 and Zamba2 models against the JAX package, at smoke
width, with the JAX package's parameters loaded through
``repro_torch.interop.params_from_jax``: the Mamba2 block, one shared
attention block, ``lm.forward`` of ``zamba2-smoke`` and
``mamba2-130m-smoke`` (with the flash branch taken), and decode steps
from a zero cache. Inputs are made with numpy from a seed.

Tolerances: in f32 the two packages run the same math in another order
(and the SSD recurrence in chunks on one side where the JAX block scans
associatively), so they agree to ~4e-6 on values of size ~4; 1e-4 is
stated. In bf16 (the configs' compute dtype) every matmul, norm and
activation rounds to 8 bits of mantissa at places the two frameworks do
not share (XLA fuses elementwise chains in f32, PyTorch rounds each op),
so a value of size ~4 may differ by a few bf16 steps (2**-6 each at
that size); the bf16 cases state 1e-1 (measured: 0.03 for the Mamba2
block, 0.0625 for the shared block, 0.07 for the whole models). All
tolerances are absolute.
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
from repro.models import ssm as jssm
from repro.models.common import MLAConfig, MoEConfig
from repro.models.common import init_params as jax_init_params
from repro.shuffle.api import ShuffleConfig as JaxShuffleConfig
from repro_torch.configs import get_config
from repro_torch.interop import cache_from_jax, params_from_jax, to_numpy, to_torch
from repro_torch.models import lm, ssm
from repro_torch.models.common import MultimodalConfig, init_params, zeros_tree

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-4, "bfloat16": 1e-1}


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
    # norms start at zero (weight 1 + w); give them values so they count
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + (0.1 * rng.standard_normal(a.shape)
                                                   .astype(np.float32)
                                                   if np.all(np.asarray(a) == 0) else 0),
                        params)


def _tokens(jcfg, B, S, seed=5):
    return np.random.default_rng(seed).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)


def _close(got, want, tol):
    np.testing.assert_allclose(to_numpy(got.float()), np.asarray(want, np.float32),
                               atol=tol, rtol=0)


def test_params_from_jax_is_bit_exact_and_counts_match():
    jcfg, cfg = _configs("zamba2-2.7b", "bfloat16")
    jparams = _jax_params(jcfg)
    model = params_from_jax(cfg, jparams, device="cpu")
    assert torch.equal(model.blocks[3].mamba.in_proj,
                       torch.from_numpy(jparams["blocks"]["mamba"]["in_proj"][3]))
    assert torch.equal(model.shared_block.attn.wq,
                       torch.from_numpy(jparams["shared_block"]["attn"]["wq"]))
    n_jax = sum(np.asarray(a).size for a in jax.tree.leaves(jparams))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    for arch in ("zamba2-2.7b", "mamba2-130m"):
        assert get_config(arch).param_count() == jax_get_config(arch).param_count()


def test_init_params_draws_the_specs_distributions():
    cfg = get_config("zamba2-2.7b", smoke=True)
    model = init_params(lm.LM(cfg, device="cpu"), torch.Generator().manual_seed(0))
    d = cfg.d_model
    assert torch.equal(model.blocks[0].mamba.D, torch.ones_like(model.blocks[0].mamba.D))
    assert float(model.final_norm.abs().max()) == 0.0
    assert abs(float(model.embed.tok.std()) - 0.02) < 0.002            # small
    assert abs(float(model.blocks[0].mamba.in_proj.std()) - d ** -0.5) < 0.1 * d ** -0.5
    # shared_in's fan-in skips its "stack" axis: 2 d, not n_inv
    assert abs(float(model.shared_in.std()) - (2 * d) ** -0.5) < 0.1 * (2 * d) ** -0.5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_block_matches_jax(dtype):
    jcfg, cfg = _configs("zamba2-2.7b", dtype)
    jparams = _jax_params(jcfg)
    model = params_from_jax(cfg, jparams, device="cpu")
    x = np.random.default_rng(2).standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    p1 = jax.tree.map(lambda a: a[1], jparams["blocks"]["mamba"])
    want = jssm.mamba2_apply(jcfg, p1, jnp.asarray(x, jcfg.compute_dtype))
    got = ssm.mamba2_apply(cfg, model.blocks[1].mamba, to_torch(x, "cpu").to(cfg.compute_dtype))
    assert got.dtype == cfg.compute_dtype
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shared_block_matches_jax(dtype):
    jcfg, cfg = _configs("zamba2-2.7b", dtype, flash_min_seq=16)
    jparams = _jax_params(jcfg)
    model = params_from_jax(cfg, jparams, device="cpu")
    x = np.random.default_rng(4).standard_normal((2, 48, cfg.d_model)).astype(np.float32)
    pos = np.arange(48)[None]
    want, _ = jlm._block_apply(jcfg, jparams["shared_block"], jnp.asarray(x, jcfg.compute_dtype),
                               jnp.asarray(pos), moe=False, mesh=None,
                               shuffle=JaxShuffleConfig(mode="dense"))
    got, _ = lm._block_apply(cfg, model.shared_block,
                             to_torch(x, "cpu").to(cfg.compute_dtype), torch.from_numpy(pos))
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "mamba2-130m"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax_with_the_flash_branch(arch, dtype):
    # flash_min_seq 16 < S = 64: the shared block takes the flash branch
    jcfg, cfg = _configs(arch, dtype, flash_min_seq=16)
    jparams = _jax_params(jcfg)
    model = params_from_jax(cfg, jparams, device="cpu")
    tok = _tokens(jcfg, 2, 64)
    want, _ = jax.jit(partial(jlm.forward, jcfg))(jparams, {"tokens": jnp.asarray(tok)})
    got, aux = lm.forward(cfg, model, {"tokens": torch.from_numpy(tok)})
    assert got.shape == want.shape and float(aux) == 0.0
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_jax(dtype):
    jcfg, cfg = _configs("zamba2-2.7b", dtype)
    jparams = _jax_params(jcfg)
    model = params_from_jax(cfg, jparams, device="cpu")
    B, steps = 2, 8
    jcache = jax_init_params(jlm.cache_defs(jcfg, B, steps), jax.random.key(1))
    cache = cache_from_jax(jax.tree.map(np.asarray, jcache), device="cpu")
    tok = _tokens(jcfg, B, steps)
    jstep = jax.jit(partial(jlm.decode_step, jcfg))
    for t in range(steps):
        batch = {"tokens": tok[:, t:t + 1], "pos": t}
        want, jcache = jstep(jparams, jcache, {"tokens": jnp.asarray(batch["tokens"]),
                                               "pos": jnp.int32(t)})
        got, cache = lm.decode_step(cfg, model, cache, {"tokens": torch.from_numpy(
            batch["tokens"]), "pos": t})
        _close(got, want, TOL[dtype])
    for path in (("blocks", "conv"), ("blocks", "state"), ("shared", "k"), ("shared", "v")):
        _close(cache[path[0]][path[1]], jcache[path[0]][path[1]], TOL[dtype])


def test_cache_defs_match_jax():
    for arch in ("zamba2-2.7b", "mamba2-130m"):
        jcfg, cfg = _configs(arch, "bfloat16")
        jdefs = jlm.cache_defs(jcfg, 3, 20)
        defs = lm.cache_defs(cfg, 3, 20)
        flat = jax.tree.leaves_with_path(jdefs, is_leaf=lambda s: hasattr(s, "shape"))
        for path, spec in flat:
            mine = defs
            for k in path:
                mine = mine[k.key]
            assert tuple(mine.shape) == tuple(spec.shape), path
            assert str(mine.dtype).split(".")[-1] == np.dtype(spec.dtype).name, path


@pytest.mark.parametrize("field,value", [
    ("mla", MLAConfig()), ("kind", "encoder"), ("moe", MoEConfig(8, 2, 96)),
    ("multimodal", MultimodalConfig(kind="video")), ("moe", MoEConfig(4, 1, 32))])
def test_what_the_port_does_not_run_raises_naming_it(field, value):
    # MLA and a MoE layer run in the decoder kind only; the last case puts
    # a MoE layer on the ssm kind (mamba2-130m), the others on the hybrid.
    # The stub frontends are audio and vision. The encoder kind builds and
    # runs the forward pass (the hybrid config's Mamba2 fields unread, as
    # in the JAX package) and has no decode step.
    arch = "mamba2-130m" if value == MoEConfig(4, 1, 32) else "zamba2-2.7b"
    cfg = dataclasses.replace(get_config(arch, smoke=True), **{field: value})
    calls = [lambda: lm.cache_defs(cfg, 1, 4), lambda: lm.init_cache(cfg, 1, 4, "cpu")]
    if field == "kind":
        model = init_params(lm.LM(cfg, device="cpu"), torch.Generator().manual_seed(0))
        logits, _ = lm.forward(cfg, model, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})
        assert logits.shape == (1, 4, cfg.vocab_size) and not hasattr(model, "shared_block")
        calls.append(lambda: lm.decode_step(cfg, model, {}, {
            "tokens": torch.zeros((1, 1), dtype=torch.int32), "pos": 0}))
    else:
        calls += [lambda: lm.LM(cfg), lambda: lm.forward(cfg, None, {})]
    for call in calls:
        with pytest.raises(ValueError, match=str(value) if field == "kind" else field):
            call()


def test_intra_bf16_runs_in_lm_cache_defs_and_forward():
    # the three calls that refused ssm.intra_bf16 before the SSD chunk had
    # the mode; tests/test_torch_ssd_intra_bf16.py holds its values to JAX's
    cfg = get_config("mamba2-130m", smoke=True)
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, intra_bf16=True))
    meta = lm.LM(cfg, device="meta")
    assert sum(p.numel() for p in meta.parameters()) == cfg.param_count()
    defs = lm.cache_defs(cfg, 1, 4)
    assert defs == lm.cache_defs(dataclasses.replace(cfg, ssm=get_config(
        "mamba2-130m", smoke=True).ssm), 1, 4)
    model = init_params(lm.LM(cfg, device="cpu"), torch.Generator().manual_seed(0))
    logits, aux = lm.forward(cfg, model, {"tokens": torch.zeros((1, 40), dtype=torch.int32)})
    assert logits.shape == (1, 40, cfg.vocab_size) and bool(torch.isfinite(logits).all())
    assert float(aux) == 0.0


def test_entry_points_default_to_the_card_and_draw_from_a_generator():
    import inspect
    from repro_torch.interop import params_from_jax as pfj
    for fn in (lm.LM, lm.init_cache, zeros_tree, pfj):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    model = lm.LM(get_config("zamba2-2.7b", smoke=True), device="cpu")
    with pytest.raises(TypeError, match="torch.Generator"):
        init_params(model, None)
