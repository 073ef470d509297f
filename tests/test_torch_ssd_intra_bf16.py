"""The SSD chunk's bf16-intra mode (``ssm.intra_bf16``) against the JAX
package's ``repro.models.ssm.ssd_chunked(..., intra_bf16=True)``, jitted
on the CPU: the plain per-chunk terms (``ssd_chunk_ref(...,
intra_bf16=True)``), ``ssd_chunked`` and ``ssd_scan_op`` on f32 and bf16
inputs, one and two groups, ragged lengths, N 16 and 128; their
gradients against ``jax.grad``; ``lm.forward`` of ``mamba2-130m`` and
``zamba2-2.7b`` at smoke width on the JAX package's parameters (through
``repro_torch.interop``), and their decode steps and cache specs. Inputs
are made with numpy from a seed. The launchers' route is checked here;
the launchers themselves against the plain version on the card (``cuda``
marker; skips elsewhere; this file imports JAX only inside the CPU tests,
so that the card's case runs where JAX is not installed):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ssd_intra_bf16.py

Tolerances:
- ``TOL``, y (and y_intra) within 1e-4 of its largest value (relative
  max) of JAX's. The port rounds at the JAX package's points, so the two
  differ only where a bf16 rounding flips on f32 values that differ by an
  ulp. XLA sums cum_a in another order than torch (45% of the sums differ
  in their last bit, each decay by up to ~1e-5 of itself at |cum_a| ~
  100), which flips ~0.2% of the bf16 decays; one flip on a score that
  dominates its row moves y by up to 4e-3 of its largest value. So the
  inputs make every cum_a exact in f32 (``_inputs``): the port then
  measured at most 1.4e-7 over 90 runs (these cases, ten seeds each). The f32-intra path (the
  flag ignored) is 2.0e-3 to 7.9e-3 off, rounding once at the end of
  C.B.decay.dt 2.0e-3 to 5.6e-3, leaving out the rounding of dt, of the
  decay or of x 1.5e-3 or more: each fails ``TOL``, which every case
  asserts for the first.
- ``UNQUANTIZED_TOL``, y within 3e-3 of its largest value (relative max)
  of JAX's on inputs off that grid (dt a plain softplus), where XLA's
  cum_a flips bf16 decays: measured at most 2.03e-3 over ten seeds (0-9)
  at one sequence of 4,096 positions in chunks of 256 (4 heads of 16, N
  16), the gap growing with the length (at most 7.96e-4 at 2 x 1,024);
  the f32-intra path is at least 4.28e-3 off there, which the test
  asserts, so the bound still tells the modes apart.
- ``KERNEL_TOL``, the kernels' y_intra within 1e-3 of the plain
  version's largest value on the card, with any inputs: their cum_a is
  the plain version's (both summed in f64), their decays its bits (expf),
  but their f32 sums of C.B^T run in another order, and a flip there
  moves one score by one bf16 step (measured 3.9e-5 at Zamba2's shape).
- states, f32 in both packages: 1e-4 (atol and rtol), as the f32 tests.
- gradients: 1e-2 relative Frobenius error per input. JAX rounds the
  cotangents at its own points (C.B's per head, where the port's plain
  terms keep one score per group; XLA's fusion moves x's), which measured
  up to 5.2e-3 (dt).
- logits of the smoke models in f32: 1e-5 relative max (measured 7.9e-7;
  the f32-intra path is 7.4e-5 off, which the test asserts). In bf16,
  1e-1 absolute, and decode in f32 1e-4 absolute, as
  tests/test_torch_zamba2.py states them.
"""

import dataclasses
from functools import partial
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config
from repro_torch.interop import cache_from_jax, params_from_jax, to_numpy, to_torch
from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan.ops import ssd_chunked, ssd_scan_op
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_ref
from repro_torch.models import lm

TOL = 1e-4            # relative max of y and y_intra against JAX's
UNQUANTIZED_TOL = 3e-3  # relative max of y against JAX's, dt off the 2**-10 grid
KERNEL_TOL = 1e-3     # relative max of the kernels' y_intra against the plain version
STATE_TOL = 1e-4      # atol and rtol of the f32 states
GRAD_TOL = 1e-2       # relative Frobenius error of each gradient
LOGIT_TOL = 1e-5      # relative max of f32 logits
BF16_LOGIT_TOL = 1e-1
DECODE_TOL = 1e-4     # f32 decode logits, absolute, as tests/test_torch_zamba2.py


@pytest.fixture(scope="module")
def jx():
    """The JAX package, for the CPU tests (the card's case needs none)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.models import lm as jlm
    from repro.models import ssm as jssm
    from repro.models.common import init_params as jax_init_params
    return SimpleNamespace(jax=jax, jnp=jnp, get_config=jax_get_config, lm=jlm, ssm=jssm,
                           init_params=jax_init_params)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, S, H, P, G, N, dtype, seed=0):
    """x, dt, A, B, C in f32 numpy; x, B and C hold bf16 values for bf16.
    dt is a softplus on a grid of 2**-10 and A is -1 or -1/2 (the models'
    A_log starts at 0), so that every cum_a is exact in f32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H)) - 1.0))
    dt = (np.round(dt * 1024) / 1024).astype(np.float32)
    A = -(2.0 ** -rng.integers(0, 2, H)).astype(np.float32)
    B = rng.standard_normal((b, S, G, N)).astype(np.float32)
    C = rng.standard_normal((b, S, G, N)).astype(np.float32)
    if dtype == torch.bfloat16:
        x, B, C = (to_numpy(torch.from_numpy(v).bfloat16().float()) for v in (x, B, C))
    return x, dt, A, B, C


def _unquantized_inputs(b, S, H, P, G, N, seed):
    """``_inputs`` in f32 without the 2**-10 grid: dt a plain softplus,
    so that XLA's and torch's cum_a differ in their last bits."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H)) - 1.0)).astype(np.float32)
    A = -(2.0 ** -rng.integers(0, 2, H)).astype(np.float32)
    B = rng.standard_normal((b, S, G, N)).astype(np.float32)
    C = rng.standard_normal((b, S, G, N)).astype(np.float32)
    return x, dt, A, B, C


def _torch_args(args, dtype):
    x, dt, A, B, C = to_torch(args, device="cpu")
    return x.to(dtype), dt, A, B.to(dtype), C.to(dtype)


def rel_max(got, want) -> float:
    got, want = to_numpy(got).astype(np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def rel_fro(got, want) -> float:
    got, want = to_numpy(got).astype(np.float32), np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _jax_chunked(jx, args, chunk, **kw):
    fn = jx.jax.jit(partial(jx.ssm.ssd_chunked, chunk=chunk, **kw))
    return fn(*(jx.jnp.asarray(a) for a in args))


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("b,Q,H,P,G,N,dtype", [
    pytest.param(2, 64, 4, 16, 1, 16, F32, id="f32-g1-n16"),
    pytest.param(1, 128, 4, 16, 2, 128, F32, id="f32-g2-n128"),
    pytest.param(1, 128, 4, 16, 1, 128, BF16, id="bf16-g1-n128"),
    pytest.param(2, 64, 6, 8, 3, 16, BF16, id="bf16-g3-n16"),
])
def test_ssd_chunk_ref_intra_bf16_matches_jax_on_one_chunk(jx, b, Q, H, P, G, N, dtype):
    # one chunk from a zero state: JAX's y is its y_intra
    args = _inputs(b, Q, H, P, G, N, dtype)
    want, _ = _jax_chunked(jx, args, Q, intra_bf16=True)
    x, dt, A, B, C = _torch_args(args, dtype)
    per_chunk = (x[:, None], dt[:, None], A, B[:, None], C[:, None])
    y_intra = ssd_chunk_ref(*per_chunk, intra_bf16=True)[0]
    assert y_intra.dtype == torch.float32 and tuple(y_intra.shape) == (b, 1, Q, H, P)
    assert rel_max(y_intra[:, 0], want) <= TOL
    assert rel_max(ssd_chunk_ref(*per_chunk)[0][:, 0], want) > TOL
    # the other three terms do not depend on the mode
    for got, same in zip(ssd_chunk_ref(*per_chunk, intra_bf16=True)[1:],
                         ssd_chunk_ref(*per_chunk)[1:]):
        assert torch.equal(got, same)


CASES = [
    pytest.param(1, 512, 4, 16, 1, 16, 128, F32, id="f32-g1-n16"),
    pytest.param(2, 300, 4, 8, 2, 16, 64, F32, id="f32-ragged-g2"),
    pytest.param(1, 256, 4, 16, 1, 128, 128, F32, id="f32-n128"),
    pytest.param(2, 200, 4, 16, 2, 16, 64, BF16, id="bf16-ragged-g2"),
    pytest.param(1, 300, 2, 32, 1, 128, 128, BF16, id="bf16-ragged-n128"),
]


@pytest.mark.parametrize("b,S,H,P,G,N,chunk,dtype", CASES)
def test_ssd_chunked_and_op_intra_bf16_match_jax(jx, b, S, H, P, G, N, chunk, dtype):
    args = _inputs(b, S, H, P, G, N, dtype)
    y_want, st_want = _jax_chunked(jx, args, chunk, intra_bf16=True)
    t32 = to_torch(args, device="cpu")        # the values in f32: y in f32
    for fn in (ssd_chunked, ssd_scan_op):
        y, st = fn(*t32, chunk=chunk, intra_bf16=True)
        assert y.dtype == torch.float32 and y.shape == y_want.shape
        assert rel_max(y, y_want) <= TOL, fn.__name__
        np.testing.assert_allclose(to_numpy(st), np.asarray(st_want), atol=STATE_TOL,
                                   rtol=STATE_TOL)
        # a port that ignores the flag fails the tolerance
        assert rel_max(fn(*t32, chunk=chunk)[0], y_want) > TOL, fn.__name__
        if dtype == BF16:
            # bf16 inputs take the same arithmetic, y rounded to bf16 at the end
            yb, stb = fn(*_torch_args(args, dtype), chunk=chunk, intra_bf16=True)
            assert yb.dtype == torch.bfloat16 and torch.equal(yb, y.bfloat16())
            assert torch.allclose(stb, st, atol=1e-6)


@pytest.mark.parametrize("b,S,H,P,G,N,chunk", [
    pytest.param(1, 200, 4, 16, 2, 16, 64, id="ragged-g2"),
    pytest.param(1, 256, 2, 32, 1, 128, 128, id="n128"),
])
def test_intra_bf16_gradients_match_jax_grad(jx, b, S, H, P, G, N, chunk):
    args = _inputs(b, S, H, P, G, N, F32, seed=3)
    rng = np.random.default_rng(4)
    gy = rng.standard_normal((b, S, H, P)).astype(np.float32)
    gs = rng.standard_normal((b, H, P, N)).astype(np.float32)
    jnp = jx.jnp

    def jax_loss(*a):
        y, st = jx.ssm.ssd_chunked(*a, chunk=chunk, intra_bf16=True)
        return jnp.sum(y * gy) + jnp.sum(st * gs)

    want = jx.jax.jit(jx.jax.grad(jax_loss, argnums=(0, 1, 2, 3, 4)))(
        *(jnp.asarray(a) for a in args))
    for fn in (ssd_scan_op, ssd_chunked):
        t = [v.requires_grad_() for v in to_torch(args, device="cpu")]
        y, st = fn(*t, chunk=chunk, intra_bf16=True)
        ((y * torch.from_numpy(gy)).sum() + (st * torch.from_numpy(gs)).sum()).backward()
        for name, v, w in zip("x dt A B C".split(), t, want):
            assert bool(torch.isfinite(v.grad).all()), (fn.__name__, name)
            assert rel_fro(v.grad, w) <= GRAD_TOL, (fn.__name__, name, rel_fro(v.grad, w))


def test_ssd_chunked_intra_bf16_matches_jax_on_unquantized_inputs(jx):
    # ten seeds of one 4,096-position sequence in chunks of 256: the gap
    # comes from bf16 decays that XLA's order of summing cum_a flips
    gaps, f32_intra_gaps = [], []
    for seed in range(10):
        args = _unquantized_inputs(1, 4096, 4, 16, 1, 16, seed)
        y_want, st_want = _jax_chunked(jx, args, 256, intra_bf16=True)
        t32 = to_torch(args, device="cpu")
        y, st = ssd_chunked(*t32, chunk=256, intra_bf16=True)
        gaps.append(rel_max(y, y_want))
        np.testing.assert_allclose(to_numpy(st), np.asarray(st_want), atol=STATE_TOL,
                                   rtol=STATE_TOL)
        f32_intra_gaps.append(rel_max(ssd_chunked(*t32, chunk=256)[0], y_want))
    assert max(gaps) <= UNQUANTIZED_TOL, gaps
    assert min(f32_intra_gaps) > UNQUANTIZED_TOL, f32_intra_gaps


def _configs(jx, arch, dtype, intra_bf16=True):
    jd = {F32: jx.jnp.float32, BF16: jx.jnp.bfloat16}[dtype]
    jcfg = jx.get_config(arch, smoke=True)
    jcfg = dataclasses.replace(jcfg, compute_dtype=jd,
                               ssm=dataclasses.replace(jcfg.ssm, intra_bf16=intra_bf16))
    cfg = get_config(arch, smoke=True)
    cfg = dataclasses.replace(cfg, compute_dtype=dtype,
                              ssm=dataclasses.replace(cfg.ssm, intra_bf16=intra_bf16))
    return jcfg, cfg


def _jax_params(jx, jcfg, seed=0):
    params = jx.init_params(jx.lm.param_defs(jcfg), jx.jax.random.key(seed))
    # norms start at zero (weight 1 + w); give them values so they count
    rng = np.random.default_rng(seed)
    return jx.jax.tree.map(
        lambda a: np.asarray(a) + (0.1 * rng.standard_normal(a.shape).astype(np.float32)
                                   if np.all(np.asarray(a) == 0) else 0), params)


def _tokens(vocab, B, S, seed=5):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["float32", "bfloat16"])
def test_lm_forward_intra_bf16_matches_jax(jx, arch, dtype):
    # 100 tokens: three whole chunks of 32 and a ragged one
    jcfg, cfg = _configs(jx, arch, dtype)
    assert cfg.ssm.intra_bf16 and jcfg.ssm.intra_bf16
    jparams = _jax_params(jx, jcfg)
    model = params_from_jax(cfg, jparams, device="cpu")
    tok = _tokens(jcfg.vocab_size, 2, 100)
    want, _ = jx.jax.jit(partial(jx.lm.forward, jcfg))(jparams, {"tokens": jx.jnp.asarray(tok)})
    want = np.asarray(want.astype(jx.jnp.float32))
    got, _ = lm.forward(cfg, model, {"tokens": torch.from_numpy(tok)})
    assert got.dtype == dtype and tuple(got.shape) == want.shape
    if dtype == BF16:
        np.testing.assert_allclose(to_numpy(got.float()), want, atol=BF16_LOGIT_TOL, rtol=0)
        return
    assert rel_max(got, want) <= LOGIT_TOL
    _, cfg32 = _configs(jx, arch, dtype, intra_bf16=False)
    got32, _ = lm.forward(cfg32, model, {"tokens": torch.from_numpy(tok)})
    assert rel_max(got32, want) > LOGIT_TOL


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
def test_decode_step_and_cache_defs_run_with_intra_bf16(jx, arch):
    # decode has no intra-chunk term: the steps match the JAX package's
    jcfg, cfg = _configs(jx, arch, F32)
    B, steps = 2, 4
    jdefs = jx.lm.cache_defs(jcfg, B, steps)
    defs = lm.cache_defs(cfg, B, steps)
    flat = jx.jax.tree.leaves_with_path(jdefs, is_leaf=lambda s: hasattr(s, "shape"))
    for path, spec in flat:
        mine = defs
        for k in path:
            mine = mine[k.key]
        assert tuple(mine.shape) == tuple(spec.shape), path
    jparams = _jax_params(jx, jcfg)
    model = params_from_jax(cfg, jparams, device="cpu")
    jcache = jx.init_params(jdefs, jx.jax.random.key(1))
    cache = cache_from_jax(jx.jax.tree.map(np.asarray, jcache), device="cpu")
    tok = _tokens(jcfg.vocab_size, B, steps)
    jstep = jx.jax.jit(partial(jx.lm.decode_step, jcfg))
    for t in range(steps):
        want, jcache = jstep(jparams, jcache, {"tokens": jx.jnp.asarray(tok[:, t:t + 1]),
                                               "pos": jx.jnp.int32(t)})
        got, cache = lm.decode_step(cfg, model, cache, {
            "tokens": torch.from_numpy(tok[:, t:t + 1]), "pos": t})
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=DECODE_TOL, rtol=0)


@pytest.mark.parametrize("dtype,Q,P,N,symbol", [
    (BF16, 256, 64, 64, "ssd_chunk_fwd_tc_bf16i"),       # Zamba2-2.7B
    (BF16, 256, 64, 128, "ssd_chunk_fwd_tc_bf16i"),      # mamba2-130m
    (BF16, 256, 64, 40, "ssd_chunk_fwd_bf16i"),          # N off 16
    (BF16, 512, 64, 64, "ssd_chunk_fwd_bf16i"),          # shared memory
    (F32, 256, 64, 64, "ssd_chunk_fwd_bf16i"),
])
def test_route_takes_the_bf16i_launchers(dtype, Q, P, N, symbol):
    assert ssd_kernel.route(dtype, Q, P, N, intra_bf16=True).symbol == symbol
    # the flag changes the launcher only, never the kernel the shape takes
    f32_intra = ssd_kernel.route(dtype, Q, P, N)
    assert symbol == f32_intra.symbol + "_bf16i"


@pytest.mark.parametrize("dtype,Q,N,symbol", [
    (BF16, 64, 32, "ssd_chunk_fwd_tc_bf16i"),
    (BF16, 64, 40, "ssd_chunk_fwd_bf16i"),
    (F32, 64, 32, "ssd_chunk_fwd_bf16i"),
])
def test_ssd_chunk_cuda_passes_the_flag_to_its_launcher(monkeypatch, dtype, Q, N, symbol):
    # the wrapper's arguments, with the launch and the device check faked:
    # the CUDA-core launchers also take x's dtype, the tensor-core ones not
    calls = []
    monkeypatch.setattr(ssd_kernel, "require_cuda", lambda **_: None)
    monkeypatch.setattr(_build.Kernel, "__call__",
                        lambda self, device, *args: calls.append((self.symbol, args)))
    b, nc, H, P, G = 1, 2, 4, 16, 2
    xq = torch.zeros((b, nc, Q, H, P), dtype=dtype)
    dtq = torch.zeros((b, nc, Q, H))
    Bq = torch.zeros((b, nc, Q, G, N), dtype=dtype)
    outs = ssd_kernel.ssd_chunk_cuda(xq, dtq, torch.zeros(H), Bq, Bq.clone(), intra_bf16=True)
    assert [c[0] for c in calls] == [symbol]
    args = calls[0][1]
    assert args[9:16] == (b, nc, Q, H, P, G, N)
    assert args[16:] == ((int(dtype == BF16),) if symbol == "ssd_chunk_fwd_bf16i" else ())
    assert [o.data_ptr() for o in outs] == list(args[5:9])


def test_the_bf16i_wrapper_refuses_cpu_tensors():
    # no fallback: the kernel's wrapper launches or raises
    xq = torch.zeros((1, 1, 16, 2, 16), dtype=BF16)
    Bq = torch.zeros((1, 1, 16, 1, 16), dtype=BF16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_kernel.ssd_chunk_cuda(xq, torch.zeros((1, 1, 16, 2)), torch.zeros(2), Bq, Bq,
                                  intra_bf16=True)


# --- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel runs only on the card")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,nc,Q,H,P,G,N,dtype,symbol", [
    (1, 2, 256, 80, 64, 1, 64, BF16, "ssd_chunk_fwd_tc_bf16i"),    # Zamba2's chunk
    (1, 2, 256, 24, 64, 1, 128, BF16, "ssd_chunk_fwd_tc_bf16i"),   # mamba2-130m's
    (2, 5, 64, 12, 32, 2, 16, BF16, "ssd_chunk_fwd_tc_bf16i"),     # ragged nc, 6 heads a group
    (2, 2, 64, 6, 64, 2, 64, F32, "ssd_chunk_fwd_bf16i"),
    (1, 2, 100, 2, 80, 1, 72, F32, "ssd_chunk_fwd_bf16i"),         # ragged tiles everywhere
    (1, 2, 256, 4, 64, 1, 40, BF16, "ssd_chunk_fwd_bf16i"),        # N off the contract
    # the block's shared score tiles: a last block of 4 heads (8, 8, 4), 40
    # heads a group over two groups, Q 64 with N 128 (one warp group); and
    # Q 256, P 128, N 64, where the tiles do not fit and each head computes
    # its own scores
    (1, 2, 256, 20, 64, 1, 64, BF16, "ssd_chunk_fwd_tc_bf16i"),
    (1, 2, 256, 80, 64, 2, 64, BF16, "ssd_chunk_fwd_tc_bf16i"),
    (2, 3, 64, 8, 64, 1, 128, BF16, "ssd_chunk_fwd_tc_bf16i"),
    (1, 2, 256, 8, 128, 1, 64, BF16, "ssd_chunk_fwd_tc_bf16i"),
])
def test_bf16i_launchers_match_plain_on_card(cuda_gen, b, nc, Q, H, P, G, N, dtype, symbol):
    def randn(*shape):
        return torch.randn(shape, generator=cuda_gen, device="cuda")
    xq = randn(b, nc, Q, H, P).to(dtype)
    dtq = torch.nn.functional.softplus(randn(b, nc, Q, H) - 1.0)
    A = -torch.ones(H, device="cuda")
    Bq = (randn(b, nc, Q, G, N) * N ** -0.25).to(dtype)
    Cq = (randn(b, nc, Q, G, N) * N ** -0.25).to(dtype)
    before = {k.symbol: k.launches for k in ssd_kernel.KERNELS}
    got = ssd_kernel.ssd_chunk_cuda(xq, dtq, A, Bq, Cq, intra_bf16=True)
    torch.cuda.synchronize()
    assert {k.symbol: k.launches - before[k.symbol] for k in ssd_kernel.KERNELS} == {
        k.symbol: int(k.symbol == symbol) for k in ssd_kernel.KERNELS}
    want = ssd_chunk_ref(xq, dtq, A, Bq, Cq, intra_bf16=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert bool(torch.isfinite(g).all())
    assert rel_max(got[0].cpu(), want[0].cpu()) <= KERNEL_TOL
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, atol=STATE_TOL, rtol=STATE_TOL)
