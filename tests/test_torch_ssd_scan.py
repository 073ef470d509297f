"""The port's chunked SSD against the JAX package: the plain per-chunk
terms against ``ssd_chunk_ref`` and ``ssd_chunk_pallas`` in interpret
mode, ``ssd_scan_op`` against the JAX op through its Pallas kernel and
against ``ssd_reference``, and ``ssd_chunked`` with an initial state; a
plain model of the tensor-core kernel's bf16 hi/lo split against the JAX
``ssd_chunk_ref``, and the route between the two kernels. Inputs are made
with numpy from a seed. The kernels themselves are held against the plain
version on the card (``cuda`` marker; skips elsewhere):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ssd_scan.py
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels.ssd_scan import ops as jops
from repro.kernels.ssd_scan.kernel import ssd_chunk_pallas
from repro.kernels.ssd_scan.ref import ssd_chunk_ref as jax_ssd_chunk_ref
from repro.models import ssm as jssm
from repro_torch.interop import to_numpy, to_torch
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan.ops import ssd_chunked, ssd_scan_op
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_ref
from repro_torch.models.ssm import ssd_reference

# the cases of tests/test_kernels.py's SSD test, plus Zamba2's N 64, Q 256
CASES = [
    pytest.param(1, 64, 2, 8, 1, 16, 16, id="base"),
    pytest.param(2, 60, 4, 8, 2, 16, 16, id="ragged-groups"),
    pytest.param(1, 128, 4, 16, 1, 32, 64, id="chunk-64"),
    pytest.param(1, 300, 4, 16, 1, 64, 256, id="n64-q256"),
]
# f32 throughout; the sums run in another order than the JAX package's
ATOL = RTOL = 1e-4


def _inputs(b, S, H, P, G, N, seed=10):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H)) - 1.0)).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    B = rng.standard_normal((b, S, G, N)).astype(np.float32)
    C = rng.standard_normal((b, S, G, N)).astype(np.float32)
    return x, dt, A, B, C


def _chunks(x, dt, B, C, chunk):
    """(b, S, ...) -> (b, nc, chunk, ...), S a multiple of chunk."""
    b, S = x.shape[:2]
    nc = S // chunk
    return (x.reshape(b, nc, chunk, *x.shape[2:]), dt.reshape(b, nc, chunk, -1),
            B.reshape(b, nc, chunk, *B.shape[2:]), C.reshape(b, nc, chunk, *C.shape[2:]))


def _close(got, want):
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("b,S,H,P,G,N,chunk", [
    pytest.param(1, 64, 2, 8, 1, 16, 16, id="base"),
    pytest.param(2, 64, 4, 8, 2, 16, 16, id="groups"),
    pytest.param(1, 256, 4, 16, 1, 64, 256, id="n64-q256"),
])
def test_ssd_chunk_ref_matches_jax_ref_and_pallas(b, S, H, P, G, N, chunk):
    x, dt, A, B, C = _inputs(b, S, H, P, G, N)
    xq, dtq, Bq, Cq = _chunks(x, dt, B, C, chunk)
    rep = H // G
    Bh, Ch = np.repeat(Bq, rep, axis=3), np.repeat(Cq, rep, axis=3)
    jargs = [jnp.asarray(a) for a in (xq, dtq, A, Bh, Ch)]
    want_ref = jax_ssd_chunk_ref(*jargs)
    want_pallas = ssd_chunk_pallas(*jargs, interpret=True)
    # the port reads the G groups directly; the JAX contract repeats them
    got = ssd_chunk_ref(*to_torch((xq, dtq, A, Bq, Cq), device="cpu"))
    got_h = ssd_chunk_ref(*to_torch((xq, dtq, A, Bh, Ch), device="cpu"))
    for g, gh, wr, wp in zip(got, got_h, want_ref, want_pallas):
        assert g.dtype == torch.float32 and tuple(g.shape) == wr.shape
        _close(g, wr)
        _close(g, wp)
        _close(gh, wr)


@pytest.mark.parametrize("b,S,H,P,G,N,chunk", CASES)
def test_ssd_scan_op_matches_jax_op_and_reference(b, S, H, P, G, N, chunk):
    x, dt, A, B, C = _inputs(b, S, H, P, G, N)
    jargs = [jnp.asarray(a) for a in (x, dt, A, B, C)]
    y_ref, st_ref = jssm.ssd_reference(*jargs)
    y_op, st_op = jops.ssd_scan_op(*jargs, chunk=chunk, use_pallas=True)
    y, st = ssd_scan_op(*to_torch((x, dt, A, B, C), device="cpu"), chunk=chunk)
    assert y.dtype == torch.float32 and st.dtype == torch.float32
    for got, want in ((y, y_op), (y, y_ref), (st, st_op), (st, st_ref)):
        _close(got, want)
    # the port's own sequential oracle agrees too
    y_seq, st_seq = ssd_reference(*to_torch((x, dt, A, B, C), device="cpu"))
    _close(y, to_numpy(y_seq))
    _close(st, to_numpy(st_seq))


def test_ssd_scan_op_keeps_bf16_inputs_dtype():
    x, dt, A, B, C = _inputs(2, 60, 4, 8, 2, 16)
    tx, tdt, tA, tB, tC = to_torch((x, dt, A, B, C), device="cpu")
    y, st = ssd_scan_op(tx.bfloat16(), tdt, tA, tB.bfloat16(), tC.bfloat16(), chunk=16)
    y32, st32 = ssd_scan_op(tx.bfloat16().float(), tdt, tA, tB.bfloat16().float(),
                            tC.bfloat16().float(), chunk=16)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    assert torch.equal(y, y32.bfloat16()) and torch.allclose(st, st32, atol=1e-6)


@pytest.mark.parametrize("chunk", [16, 32])
def test_ssd_chunked_with_initial_state_matches_jax(chunk):
    x, dt, A, B, C = _inputs(2, 48, 4, 8, 2, 16)
    s0 = np.random.default_rng(1).standard_normal((2, 4, 8, 16)).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (x, dt, A, B, C)]
    y_w, st_w = jssm.ssd_chunked(*jargs, chunk=chunk, initial_state=jnp.asarray(s0))
    y, st = ssd_chunked(*to_torch((x, dt, A, B, C), device="cpu"), chunk=chunk,
                        initial_state=to_torch(s0, device="cpu"))
    _close(y, y_w)
    _close(st, st_w)


def _split(v):
    """v (f32) as bf16 hi = bf16(v) and lo = bf16(v - hi), both widened."""
    hi = v.bfloat16().float()
    return hi, (v - hi).bfloat16().float()


def _tc_model(xq, dtq, A, Bq, Cq, split=_split):
    """The tensor-core kernel's arithmetic for G = 1 in plain torch: C.B^T
    from the bf16 values with f32 sums (bf16 products are exact in f32),
    the weighted scores and x o w in f32, each split by ``split`` into
    parts whose products with the exact operand add up in f32."""
    x, B, C = xq.float(), Bq[:, :, :, 0].float(), Cq[:, :, :, 0].float()
    Q = x.shape[2]
    cum = torch.cumsum(dtq * A, dim=2)                           # (b,nc,Q,H)
    total = cum[:, :, -1]
    causal = torch.ones(Q, Q).tril().bool()[None, None, :, :, None]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    decay = torch.where(causal, torch.exp(torch.where(causal, diff, 0.0)), 0.0)
    cb = torch.einsum("bcin,bcjn->bcij", C, B)[..., None]
    scores = cb * decay * dtq[:, :, None, :, :]                  # (b,nc,Q,Q,H)
    y = sum(torch.einsum("bcijh,bcjhp->bcihp", part, x) for part in split(scores))
    xw = x * (torch.exp(total[:, :, None, :] - cum) * dtq)[..., None]
    states = sum(torch.einsum("bcjhp,bcjn->bchpn", part, B) for part in split(xw))
    return y, states


@pytest.mark.parametrize("N", [64, 128], ids=["zamba2-n64", "mamba2-n128"])
def test_tc_split_arithmetic_within_ssd_tol_of_jax_ref(N):
    """Q 256, P 64, at chip_smoke.py's input scales (A = -1, dt a softplus,
    B and C at N**-0.25, x, B and C in bf16): the two-term split holds
    y_intra and states within 1e-4 of the JAX reference; bf16 alone does
    not, which is why the kernel splits."""
    b, nc, Q, H, P = 1, 2, 256, 4, 64
    rng = np.random.default_rng(16)
    xq = rng.standard_normal((b, nc, Q, H, P)).astype(np.float32)
    dtq = np.log1p(np.exp(rng.standard_normal((b, nc, Q, H)) - 1.0)).astype(np.float32)
    A = -np.ones(H, np.float32)
    Bq = (rng.standard_normal((b, nc, Q, 1, N)) * N ** -0.25).astype(np.float32)
    Cq = (rng.standard_normal((b, nc, Q, 1, N)) * N ** -0.25).astype(np.float32)
    t = to_torch((xq, dtq, A, Bq, Cq), device="cpu")
    t = (t[0].bfloat16(), t[1], t[2], t[3].bfloat16(), t[4].bfloat16())
    # the JAX reference on the same bf16 values, B and C repeated to H heads
    jargs = [jnp.asarray(to_numpy(v.float())) for v in t]
    jargs[3], jargs[4] = (jnp.repeat(v, H, axis=3) for v in jargs[3:])
    y_want, st_want = (np.asarray(v) for v in jax_ssd_chunk_ref(*jargs)[:2])
    y, st = _tc_model(*t)
    _close(y, y_want)
    _close(st, st_want)
    y1, st1 = _tc_model(*t, split=lambda v: (v.bfloat16().float(),))
    assert not np.allclose(to_numpy(y1), y_want, atol=ATOL, rtol=RTOL)
    assert not np.allclose(to_numpy(st1), st_want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("dtype,Q,P,N,symbol", [
    (torch.bfloat16, 256, 64, 64, "ssd_chunk_fwd_tc"),      # Zamba2-2.7B
    (torch.bfloat16, 256, 64, 128, "ssd_chunk_fwd_tc"),     # mamba2-130m
    (torch.bfloat16, 16, 16, 16, "ssd_chunk_fwd_tc"),
    (torch.bfloat16, 64, 80, 32, "ssd_chunk_fwd_tc"),
    (torch.bfloat16, 256, 64, 40, "ssd_chunk_fwd"),         # N off 16
    (torch.bfloat16, 100, 64, 64, "ssd_chunk_fwd"),         # Q off 16
    (torch.bfloat16, 256, 8, 64, "ssd_chunk_fwd"),          # P off 16
    (torch.bfloat16, 256, 64, 144, "ssd_chunk_fwd"),        # N above 128
    (torch.bfloat16, 512, 64, 64, "ssd_chunk_fwd"),         # shared memory
    (torch.float32, 256, 64, 64, "ssd_chunk_fwd"),
])
def test_route_picks_the_kernel_by_dtype_and_shape(dtype, Q, P, N, symbol):
    assert ssd_kernel.route(dtype, Q, P, N).symbol == symbol


def test_route_refuses_other_dtypes_and_sizes_shared_memory():
    with pytest.raises(ValueError, match="float16"):
        ssd_kernel.route(torch.float16, 256, 64, 64)
    # Zamba2's block takes 8 heads, mamba2-130m's 4, within the block's 227 KB
    assert ssd_kernel.tc_heads(256, 64, 64) == 8
    assert ssd_kernel.tc_smem_bytes(256, 64, 64, 8) == 180224
    assert ssd_kernel.tc_heads(256, 64, 128) == 4
    assert ssd_kernel.tc_smem_bytes(256, 64, 128, 4) == 229376 <= ssd_kernel.SMEM_MAX
    assert ssd_kernel.tc_heads(512, 64, 64) == 0


# --- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel runs only on the card")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,nc,Q,H,P,G,N,dtype,symbol", [
    (2, 3, 256, 4, 64, 1, 64, torch.bfloat16, "ssd_chunk_fwd_tc"),
    (1, 2, 256, 4, 64, 2, 128, torch.bfloat16, "ssd_chunk_fwd_tc"),
    (2, 2, 64, 6, 64, 2, 64, torch.float32, "ssd_chunk_fwd"),
    (1, 2, 100, 2, 80, 1, 72, torch.float32, "ssd_chunk_fwd"),   # ragged tiles everywhere
    (1, 1, 16, 2, 8, 1, 16, torch.float32, "ssd_chunk_fwd"),
    (1, 2, 256, 80, 64, 1, 64, torch.bfloat16, "ssd_chunk_fwd_tc"),   # Zamba2's chunk
    (1, 2, 256, 24, 64, 1, 128, torch.bfloat16, "ssd_chunk_fwd_tc"),  # mamba2-130m's
    (2, 5, 64, 12, 32, 2, 16, torch.bfloat16, "ssd_chunk_fwd_tc"),    # ragged nc, 6 heads a group
    (1, 2, 128, 4, 80, 1, 48, torch.bfloat16, "ssd_chunk_fwd_tc"),    # P past 64
    (1, 2, 256, 4, 64, 1, 40, torch.bfloat16, "ssd_chunk_fwd"),       # N off the contract
])
def test_ssd_chunk_kernel_matches_plain_on_card(cuda_gen, b, nc, Q, H, P, G, N, dtype,
                                                symbol):
    def randn(*shape):
        return torch.randn(shape, generator=cuda_gen, device="cuda")
    xq = randn(b, nc, Q, H, P).to(dtype)
    dtq = torch.nn.functional.softplus(randn(b, nc, Q, H) - 1.0)
    A = -torch.ones(H, device="cuda")     # A_log = 0: cum_a falls ~0.3 a row
    # B and C at N**-0.25 give C.B^T of unit scale; f32 sums in two orders
    # then differ by ~1e-5 of the values
    Bq = (randn(b, nc, Q, G, N) * N ** -0.25).to(dtype)
    Cq = (randn(b, nc, Q, G, N) * N ** -0.25).to(dtype)
    before = {k.symbol: k.launches for k in ssd_kernel.KERNELS}
    got = ssd_kernel.ssd_chunk_cuda(xq, dtq, A, Bq, Cq)
    torch.cuda.synchronize()
    assert {k.symbol: k.launches - before[k.symbol] for k in ssd_kernel.KERNELS} == {
        k.symbol: int(k.symbol == symbol) for k in ssd_kernel.KERNELS}
    want = ssd_chunk_ref(xq, dtq, A, Bq, Cq)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
