"""The port's MLA (``repro_torch.models.mla``) against the JAX package's
``repro.models.mla``, at ``deepseek-v2-lite-smoke`` size (4 heads, a
latent of 32, q/k head dim 16 + 8 = 24, v 16), with the JAX package's
parameters loaded through ``repro_torch.interop.params_from_jax``:
``mla_apply`` on the dense branch and on the flash branch (whose head
dim 24 the port pads to 32 with the scale of 24), ``mla_decode`` from a
zero cache on both paths (``absorb`` False and True), the cache specs,
and the parameter specs. Inputs are made with numpy from a seed; the
zero-initialised ``kv_norm`` is given values so that it counts.

The JAX package's ``absorb=True`` path does not run in bf16 on the CPU
(XLA's CPU runtime has no bf16 x bf16 -> f32 dot for its
``preferred_element_type`` products), so the port's bf16 absorbed decode
is held against the JAX package's bf16 naive decode, the same attention
with the products in another order, and against an oracle of that path
written in jnp (``_absorbed_oracle``): the JAX package's own bf16
projections and cache update, then the products in f32, rounded to bf16
where ``repro.models.mla.mla_decode`` rounds (``q_abs``, ``probs``,
``ctx``, and the output ``out`` before ``wo``), held to one bf16 step of
each output and of the cache. In f32 each path is held against its JAX
twin.

Tolerances (absolute), as for the other model layers
(``tests/test_torch_zamba2.py``): f32 1e-4, the same math in another
order; bf16 1e-1, where the two frameworks round at different places.
"""

import dataclasses
import math
from functools import partial

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro.models import mla as jmla
from repro.models.attention import NEG_INF as JNEG_INF
from repro.models.common import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.interop import cache_from_jax, params_from_jax, to_numpy, to_torch
from repro_torch.models import lm, mla
from repro_torch.models.common import init_params

ARCH = "deepseek-v2-lite-16b"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-4, "bfloat16": 1e-1}
LAYER = 1          # a MoE layer's attention: row 1 of the stacked blocks


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(dtype, seed=0, **kw):
    """(jcfg, cfg, the JAX layer's MLA parameters, the port's MLA)."""
    jd, td = DTYPES[dtype]
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True), compute_dtype=jd, **kw)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), compute_dtype=td, **kw)
    params = jax.tree.map(np.asarray, jax_init_params(jlm.param_defs(jcfg),
                                                      jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    kv_norm = params["blocks"]["attn"]["kv_norm"]
    assert not kv_norm.any()                                 # zeros init
    params["blocks"]["attn"]["kv_norm"] = 0.1 * rng.standard_normal(
        kv_norm.shape).astype(np.float32)
    model = params_from_jax(cfg, params, device="cpu")
    jp = jax.tree.map(lambda a: a[LAYER], params["blocks"]["attn"])
    return jcfg, cfg, jp, model.blocks[LAYER].attn


def _x(cfg, B, S, seed=3):
    return np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(to_numpy(got.float()), np.asarray(want, np.float32),
                               atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("branch", ["dense", "flash"])
def test_mla_apply_matches_jax(branch, dtype):
    # S 64 against flash_min_seq 16 takes the flash branch, q/k dim 24 padded
    jcfg, cfg, jp, p = _setup(dtype, flash_min_seq=16 if branch == "flash" else 2048)
    x = _x(cfg, 2, 64)
    pos = np.arange(64)[None]
    want = jmla.mla_apply(jcfg, jp, jnp.asarray(x, jcfg.compute_dtype),
                          positions=jnp.asarray(pos))
    got = mla.mla_apply(cfg, p, to_torch(x, "cpu").to(cfg.compute_dtype),
                        positions=torch.from_numpy(pos))
    assert got.shape == want.shape and got.dtype == cfg.compute_dtype
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("absorb", [False, True])
def test_mla_decode_matches_jax(absorb, dtype):
    jcfg, cfg, jp, p = _setup(dtype)
    B, steps = 2, 6
    x = _x(cfg, B, steps)
    jcache = jax_init_params(jmla.mla_cache_defs(jcfg, B, steps), jax.random.key(1))
    cache = cache_from_jax(jax.tree.map(np.asarray, jcache), device="cpu")
    c_kv = cache["c_kv"]
    # the JAX bf16 absorbed path cannot run here: its naive path stands in
    jstep = jax.jit(partial(jmla.mla_decode, jcfg,
                            absorb=absorb and dtype == "float32"))
    for t in range(steps):
        want, jcache = jstep(jp, jnp.asarray(x[:, t:t + 1], jcfg.compute_dtype), jcache,
                             jnp.int32(t))
        got, cache = mla.mla_decode(cfg, p, to_torch(x[:, t:t + 1], "cpu").to(cfg.compute_dtype),
                                    cache, t, absorb=absorb)
        assert got.shape == want.shape and got.dtype == cfg.compute_dtype
        _close(got, want, TOL[dtype])
    assert cache["c_kv"] is c_kv                                 # written in place
    for name in ("c_kv", "k_rope"):
        _close(cache[name], jcache[name], TOL[dtype])


def _absorbed_oracle(jcfg, jp, x, cache, pos):
    """``mla_decode(absorb=True)`` of the JAX package in bf16, written in
    jnp: its bf16 projections (``_project``) and cache update, then each
    product in f32 on the bf16 operands, rounded to bf16 at the points
    where the JAX path rounds (``q_abs``, ``probs``, ``ctx``, and ``out``
    before the output projection)."""
    m, cd, f32 = jcfg.mla, jnp.bfloat16, jnp.float32

    def dot(spec, a, b):
        return jnp.einsum(spec, a.astype(cd).astype(f32), b.astype(cd).astype(f32))

    q_nope, q_rope, c_new, k_rope_new = jmla._project(jcfg, jp, x, jnp.asarray([pos]))
    c = cache["c_kv"].at[:, pos].set(c_new[:, 0].astype(cache["c_kv"].dtype))
    kr = cache["k_rope"].at[:, pos].set(k_rope_new[:, 0, 0].astype(cache["k_rope"].dtype))
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_abs = dot("bqhe,rhe->bqhr", q_nope, jp["w_uk"]).astype(cd)
    s = (dot("bqhr,bsr->bhqs", q_abs, c) + dot("bqhe,bse->bhqs", q_rope, kr)) * scale
    s = jnp.where((jnp.arange(c.shape[1]) < pos + 1)[None, None, None], s, JNEG_INF)
    probs = jax.nn.softmax(s, axis=-1).astype(cd)
    ctx = dot("bhqs,bsr->bqhr", probs, c).astype(cd)
    out = dot("bqhr,rhe->bqhe", ctx, jp["w_uv"])
    y = dot("bshe,hed->bsd", out, jp["wo"]).astype(cd)
    return y, {"c_kv": c, "k_rope": kr}


def _bf16_steps(got, want) -> int:
    """The largest distance, in bf16 steps, between two bf16 arrays."""
    g = to_numpy(got).view(np.int16).astype(np.int64)
    w = np.asarray(want).view(np.int16).astype(np.int64)
    return int(np.abs(g - w).max())


def test_bf16_absorbed_mla_decode_matches_a_jnp_oracle():
    jcfg, cfg, jp, p = _setup("bfloat16")
    B, steps = 2, 6
    x = _x(cfg, B, steps)
    jcache = jax_init_params(jmla.mla_cache_defs(jcfg, B, steps), jax.random.key(1))
    cache = cache_from_jax(jax.tree.map(np.asarray, jcache), device="cpu")
    oracle = jax.jit(partial(_absorbed_oracle, jcfg), static_argnums=3)
    for t in range(steps):
        xt = x[:, t:t + 1]
        want, jcache = oracle(jp, jnp.asarray(xt, jnp.bfloat16), jcache, t)
        got, cache = mla.mla_decode(cfg, p, to_torch(xt, "cpu").to(torch.bfloat16), cache, t,
                                    absorb=True)
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert _bf16_steps(got, want) <= 1, t
    for name in ("c_kv", "k_rope"):
        assert _bf16_steps(cache[name], jcache[name]) <= 1, name


def test_mla_decode_paths_agree_in_f32():
    """Absorbing W_uk and W_uv into the query and output reassociates the
    same products: in f32 both paths give the same output."""
    _, cfg, _, p = _setup("float32")
    B, steps = 2, 5
    x = to_torch(_x(cfg, B, steps, seed=7), "cpu")
    caches = [lm.zeros_tree(mla.mla_cache_defs(cfg, B, steps), "cpu") for _ in range(2)]
    for t in range(steps):
        naive, _ = mla.mla_decode(cfg, p, x[:, t:t + 1], caches[0], t, absorb=False)
        absorbed, _ = mla.mla_decode(cfg, p, x[:, t:t + 1], caches[1], t, absorb=True)
        torch.testing.assert_close(absorbed, naive, atol=1e-5, rtol=0)


def test_mla_cache_and_param_defs_match_jax():
    jcfg, cfg, _, _ = _setup("bfloat16")
    for stacked in (0, 3):
        jdefs = jmla.mla_cache_defs(jcfg, 3, 20, stacked=stacked)
        defs = mla.mla_cache_defs(cfg, 3, 20, stacked=stacked)
        assert set(defs) == set(jdefs) == {"c_kv", "k_rope"}
        for name, spec in jdefs.items():
            assert tuple(defs[name].shape) == tuple(spec.shape), name
            assert str(defs[name].dtype).split(".")[-1] == np.dtype(spec.dtype).name, name
            assert defs[name].init == spec.init == "zeros"
    jdefs = jmla.mla_defs(jcfg)
    module = mla.MLA(cfg, device="meta")
    assert set(module.specs) == set(jdefs)
    for name, spec in jdefs.items():
        mine = module.specs[name]
        assert (tuple(mine.shape), mine.axes, mine.init) == (tuple(spec.shape), spec.axes,
                                                             spec.init), name
    # init_params honours kv_norm's zeros (rms_norm scales by 1 + w)
    model = init_params(lm.LM(cfg, device="cpu"), torch.Generator().manual_seed(0))
    assert float(model.blocks[0].attn.kv_norm.abs().max()) == 0.0
    d = cfg.d_model
    assert abs(float(model.blocks[0].attn.w_dkv.std()) - d ** -0.5) < 0.15 * d ** -0.5


@pytest.fixture
def cuda_gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the flash kernel runs only on the card")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [512, 1000])
def test_mla_flash_branch_on_card(cuda_gen, S, monkeypatch):
    """deepseek-v2-lite's published MLA (d 2048, 16 heads, q/k 128 + 64 =
    192, v 128 zero-padded to 192) on the card. The flash branch launches
    the wgmma kernel once, on q, k, v of D 192; on those the kernel holds
    its plain version within the card tolerance of
    ``tests/test_torch_flash_attention.py`` (atol 8e-3, rtol 1e-2,
    relative Frobenius 5e-3); and the layer's output is the dense
    branch's within a relative Frobenius error of 1e-2: the kernel's 5e-3
    through the output projection, plus one bf16 rounding (2**-8) of each
    output. Elementwise, the two outputs differ by a bf16 step of values
    up to ~16 in the rows of few causal keys."""
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import flash_ref

    seen = []

    def capturing(q, k, v, **kwargs):
        seen.append((q, k, v))
        return flash_kernel.flash_attention_cuda(q, k, v, **kwargs)

    monkeypatch.setattr(flash_ops, "flash_attention_cuda", capturing)
    cfg = dataclasses.replace(get_config(ARCH), flash_min_seq=256)
    p = init_params(mla.MLA(cfg, device="cuda"), cuda_gen)
    x = torch.randn((2, S, cfg.d_model), generator=cuda_gen, device="cuda").bfloat16()
    pos = torch.arange(S, device="cuda")[None]
    before = {k.symbol: k.launches for k in flash_kernel.KERNELS}
    got = mla.mla_apply(cfg, p, x, positions=pos)
    ran = {k.symbol: k.launches - before[k.symbol] for k in flash_kernel.KERNELS}
    assert ran == {k.symbol: int(k is flash_kernel.FLASH_WGMMA) for k in flash_kernel.KERNELS}
    (q, k, v), = seen
    assert q.shape == (2, S, 16, 192) and k.shape == v.shape == (2, S, 16, 192)
    assert float(v[..., 128:].abs().max()) == 0.0
    out = flash_kernel.flash_attention_cuda(q, k, v, causal=True)
    want = flash_ref(q, k, v, causal=True)
    torch.testing.assert_close(out.float(), want.float(), atol=8e-3, rtol=1e-2)
    assert float((out.float() - want.float()).norm() / want.float().norm()) <= 5e-3
    dense = mla.mla_apply(dataclasses.replace(cfg, flash_min_seq=1 << 20), p, x, positions=pos)
    assert got.shape == (2, S, cfg.d_model) and bool(torch.isfinite(got).all())
    d = got.float() - dense.float()
    assert float(d.norm() / dense.float().norm()) <= 1e-2
