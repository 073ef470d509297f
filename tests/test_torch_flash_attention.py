"""The port's flash attention against the JAX package: its plain version
and public op against ``flash_attention_pallas`` in interpret mode and
the JAX ``flash_ref``, the f32-probability plain version against the JAX
flash and the Pallas kernel, dense attention with a query offset and a kv
length, and the dense/flash dispatch of ``attention_op`` (a query offset
and head dims off a multiple of 16 included). Inputs are made
with numpy from a seed. The kernel itself is held against the plain
version on the card (``cuda`` marker; skips elsewhere):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_flash_attention.py
"""

import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import flash_ref as jax_flash_ref
from repro.models import attention as jattn
from repro.models import flash as jflash
from repro.models.common import ModelConfig as JaxModelConfig
from repro_torch.interop import to_numpy, to_torch
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.kernels.flash_attention.ref import flash_ref, flash_ref_f32p
from repro_torch.models import attention
from repro_torch.models.common import ModelConfig

# the cases of tests/test_kernels.py's flash test, plus Zamba2's head dim 80
CASES = [
    pytest.param(2, 256, 4, 4, 64, True, "float32", id="mha"),
    pytest.param(1, 256, 4, 2, 64, True, "float32", id="gqa"),
    pytest.param(1, 128, 2, 1, 32, True, "float32", id="mqa"),
    pytest.param(2, 256, 4, 4, 64, False, "float32", id="non-causal"),
    pytest.param(1, 200, 2, 2, 64, True, "float32", id="ragged-200"),
    pytest.param(1, 256, 2, 2, 64, True, "bfloat16", id="bf16"),
    pytest.param(1, 192, 4, 4, 80, True, "float32", id="d80"),
    pytest.param(2, 136, 4, 2, 80, True, "bfloat16", id="d80-gqa-bf16"),
]

# f32: the same math in another order; bf16: the probabilities are
# rounded to bf16 before the second product, as tests/test_kernels.py
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(B, S, H, KVH, D, dtype, seed=9):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, D), (B, S, KVH, D), (B, S, KVH, D))]
    return [a.astype(jnp.bfloat16) if dtype == "bfloat16" else a for a in arrs]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("B,S,H,KVH,D,causal,dtype", CASES)
def test_plain_flash_matches_pallas_and_jax_ref(B, S, H, KVH, D, causal, dtype):
    q, k, v = _qkv(B, S, H, KVH, D, dtype)
    want_pallas = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_tile=64, kv_tile=64, interpret=True), np.float32)
    want_ref = np.asarray(jax_flash_ref(
        *(jnp.asarray(a, jnp.float32) for a in (q, k, v)), causal=causal))
    tq, tk, tv = to_torch((q, k, v), device="cpu")
    got = flash_ref(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    got_op = flash_attention_op(tq, tk, tv, causal=causal)
    assert torch.equal(got_op, got)
    got = to_numpy(got.float())
    np.testing.assert_allclose(got, want_pallas, atol=TOL[dtype], rtol=0)
    np.testing.assert_allclose(got, want_ref, atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("q_offset,kv_len,causal", [
    (0, None, True), (5, None, True), (0, 9, False), (7, 30, True)])
def test_dense_attention_offset_and_kv_len_match_jax(q_offset, kv_len, causal):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 8, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, 40, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 40, 2, 32)).astype(np.float32)
    want = jattn.dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 causal=causal, q_offset=q_offset, kv_len=kv_len)
    got = attention.dense_attention(*to_torch((q, k, v), device="cpu"),
                                    causal=causal, q_offset=q_offset,
                                    kv_len=kv_len)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=2e-5, rtol=0)


def test_attention_op_takes_flash_above_flash_min_seq(monkeypatch):
    cfg = ModelConfig(name="t", kind="hybrid", num_layers=2, d_model=64,
                      num_heads=4, num_kv_heads=2, d_ff=8, vocab_size=8,
                      flash_min_seq=16)
    calls = []

    def spy(q, k, v, *, causal, q_offset=0):
        calls.append(q.shape[1])
        return flash_ref(q, k, v, causal=causal, q_offset=q_offset)

    monkeypatch.setattr(attention, "flash_attention_op", spy)
    q, k, v = to_torch(_qkv(1, 32, 4, 2, 16, "float32"), device="cpu")
    jcfg = JaxModelConfig(name="t", kind="hybrid", num_layers=2, d_model=64,
                          num_heads=4, num_kv_heads=2, d_ff=8, vocab_size=8,
                          flash_min_seq=16)
    for S in (16, 32):            # dense at flash_min_seq, flash above it
        got = attention.attention_op(cfg, q[:, :S], k[:, :S], v[:, :S], causal=True)
        want = jattn.attention_op(jcfg, *(jnp.asarray(to_numpy(t[:, :S]))
                                         for t in (q, k, v)), causal=True)
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=2e-5)
    assert calls == [32]
    # with a kv length the dense branch runs at any length
    attention.attention_op(cfg, q, k, v, causal=False, kv_len=20)
    assert calls == [32]
    # the flash branch takes a query offset, as JAX's does
    got = attention.attention_op(cfg, q, k, v, causal=True, q_offset=3)
    want = jattn.attention_op(jcfg, *(jnp.asarray(to_numpy(t)) for t in (q, k, v)),
                              causal=True, q_offset=3)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=2e-5)
    assert calls == [32, 32]


@pytest.mark.parametrize("B,S,H,KVH,D,causal", [
    pytest.param(2, 256, 4, 4, 64, True, id="mha"),
    pytest.param(1, 200, 4, 1, 80, True, id="mqa-ragged-d80"),
    pytest.param(1, 192, 4, 2, 32, False, id="gqa-non-causal"),
    pytest.param(1, 130, 2, 2, 24, True, id="d24"),
])
def test_flash_ref_f32p_matches_jax_flash_and_pallas(B, S, H, KVH, D, causal):
    q, k, v = _qkv(B, S, H, KVH, D, "float32")
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want_flash = np.asarray(jflash.flash_attention(jq, jk, jv, causal=causal,
                                                   q_chunk=64, kv_chunk=64))
    want_pallas = np.asarray(flash_attention_pallas(jq, jk, jv, causal=causal, q_tile=64,
                                                    kv_tile=64, interpret=True))
    got = flash_ref_f32p(*to_torch((q, k, v), device="cpu"), causal=causal)
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    # f32 throughout: the same math in another order
    np.testing.assert_allclose(to_numpy(got), want_flash, atol=1e-5, rtol=0)
    np.testing.assert_allclose(to_numpy(got), want_pallas, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [24, 40])
def test_attention_op_flash_branch_takes_head_dims_off_16(monkeypatch, D, dtype):
    """deepseek-v2-lite smoke's MLA has q/k head dim 24: the flash branch
    pads it to 32 and keeps the scale 1/sqrt(24), as the JAX branch
    computes it."""
    kw = dict(name="t", kind="hybrid", num_layers=2, d_model=64, num_heads=4,
              num_kv_heads=2, d_ff=8, vocab_size=8, flash_min_seq=16)
    seen = []

    def spy(q, k, v, *, causal, scale=None, q_offset=0):
        seen.append((q.shape[-1], scale))
        return flash_attention_op(q, k, v, causal=causal, scale=scale, q_offset=q_offset)

    monkeypatch.setattr(attention, "flash_attention_op", spy)
    q, k, v = _qkv(2, 40, 4, 2, D, dtype)
    got = attention.attention_op(ModelConfig(**kw), *to_torch((q, k, v), device="cpu"),
                                 causal=True)
    want = jattn.attention_op(JaxModelConfig(**kw), *(jnp.asarray(a) for a in (q, k, v)),
                              causal=True)
    assert seen == [(-(-D // 16) * 16, 1.0 / np.sqrt(D))]
    assert got.shape == (2, 40, 4, D) and str(got.dtype) == f"torch.{dtype}"
    np.testing.assert_allclose(to_numpy(got.float()), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=0)
    # the op itself still refuses the head dim
    with pytest.raises(ValueError, match="multiple of 16"):
        flash_attention_op(*to_torch((q, k, v), device="cpu"), causal=True)


# --- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel runs only on the card")
    return torch.Generator(device="cuda").manual_seed(0)


# kernel against plain version on the card, as chip_smoke.py holds them:
# |got - want| <= atol + rtol |want| elementwise, and the relative
# Frobenius error within its bound. bf16: the final rounding may differ by
# one bf16 step (rtol), and the probabilities are rounded to bf16 at
# another scale than the plain version's (atol, for the few-key causal
# rows); f32: the same math in another order.
CARD_TOL = {torch.bfloat16: (8e-3, 1e-2, 5e-3), torch.float32: (2e-5, 1e-5, 1e-5)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("B,Sq,Skv,H,KVH,D,causal", [
    (2, 256, 256, 4, 4, 64, True),
    (1, 200, 200, 8, 2, 80, True),      # GQA, ragged
    (1, 256, 256, 8, 1, 128, True),     # MQA
    (2, 192, 192, 4, 4, 80, False),
    (1, 130, 130, 8, 1, 256, True),     # gemma-2b's MQA shape
    (1, 70, 300, 4, 2, 16, False),      # Sq != Skv
    (1, 300, 70, 4, 2, 48, True),
    (1, 1100, 1100, 2, 1, 80, True),    # long rows: 18 kv tiles
])
def test_flash_kernel_matches_plain_on_card(cuda_gen, B, Sq, Skv, H, KVH, D, causal,
                                            dtype):
    q = torch.randn((B, Sq, H, D), generator=cuda_gen, device="cuda").to(dtype)
    k = torch.randn((B, Skv, KVH, D), generator=cuda_gen, device="cuda").to(dtype)
    v = torch.randn((B, Skv, KVH, D), generator=cuda_gen, device="cuda").to(dtype)
    _check_on_card(q, k, v, causal, flash_kernel.route(dtype, D))


def _check_on_card(q, k, v, causal, kernel, direct=False, q_offset=0):
    """One call of the kernel wrapper (or, ``direct``, of ``kernel`` itself
    through ``launch``): it must launch ``kernel`` once and agree with the
    plain version within ``CARD_TOL``."""
    counts = {kern.symbol: kern.launches for kern in flash_kernel.KERNELS}
    if direct:
        got = torch.empty_like(q)
        flash_kernel.launch(got, q, k, v, causal=causal, q_offset=q_offset, kernel=kernel)
    else:
        got = flash_kernel.flash_attention_cuda(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    counts = {kern.symbol: kern.launches - counts[kern.symbol]
              for kern in flash_kernel.KERNELS}
    assert counts == {kern.symbol: int(kern is kernel) for kern in flash_kernel.KERNELS}
    want = flash_ref(q, k, v, causal=causal, q_offset=q_offset)
    assert got.dtype == q.dtype and got.shape == q.shape
    atol, rtol, rel_fro = CARD_TOL[q.dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    d = got.float() - want.float()
    assert float(d.norm() / want.float().norm()) <= rel_fro


# the wgmma kernel's edges: q and kv tiles of 128 rows cut by Sq and Skv
# within a batch row (B >= 2), Sq != Skv both ways, each head dim it is
# built for, MQA and GQA, non-causal, and one long causal row at Zamba2's
# head dim 80
@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Skv,H,KVH,D,causal", [
    (3, 200, 200, 4, 2, 80, True),
    (2, 333, 333, 4, 4, 64, False),
    (2, 100, 300, 4, 1, 16, True),
    (2, 300, 100, 4, 1, 16, True),
    (2, 129, 257, 8, 2, 128, False),
    (2, 257, 129, 8, 2, 128, True),
    (2, 190, 190, 4, 4, 32, True),
    (2, 190, 190, 6, 3, 48, False),
    (2, 256, 256, 8, 8, 96, True),
    (2, 150, 150, 4, 1, 112, True),
    (1, 4200, 4200, 2, 1, 80, True),
])
def test_wgmma_flash_kernel_edges_on_card(cuda_gen, B, Sq, Skv, H, KVH, D, causal):
    _check_on_card(*_bf16_qkv(cuda_gen, B, Sq, Skv, H, KVH, D), causal,
                   flash_kernel.FLASH_WGMMA)


def _bf16_qkv(gen, B, Sq, Skv, H, KVH, D):
    return [torch.randn((B, S, n, D), generator=gen, device="cuda").bfloat16()
            for S, n in ((Sq, H), (Skv, KVH), (Skv, KVH))]


# the wgmma kernel's wide instances (kv tiles of 96 rows up to 192 and 64
# above): a head dim of each tail class of the Q
# and K boxes at each kv tile (144 and 208, 160 and 224, 176 and 240: 16, 32
# and 48 columns past the 64-column boxes; 192 and 256: none), q and kv
# tiles cut by Sq and Skv within a batch row (B >= 2), Sq != Skv both ways,
# MQA and GQA, non-causal, and a causal row of 4,200 keys at 256
@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Skv,H,KVH,D,causal", [
    (2, 200, 200, 4, 2, 144, True),
    (3, 333, 333, 4, 4, 160, False),
    (2, 190, 190, 6, 3, 176, True),
    (2, 100, 300, 4, 1, 192, True),
    (2, 300, 100, 4, 1, 192, True),
    (2, 200, 200, 4, 1, 208, True),
    (2, 150, 250, 4, 2, 224, False),
    (2, 190, 190, 6, 3, 240, True),
    (2, 129, 257, 8, 2, 256, False),
    (2, 257, 129, 8, 2, 256, True),
    (2, 256, 256, 8, 1, 256, True),
    (1, 4200, 4200, 2, 1, 256, True),
])
def test_wgmma_flash_kernel_wide_head_dims_on_card(cuda_gen, B, Sq, Skv, H, KVH, D, causal):
    _check_on_card(*_bf16_qkv(cuda_gen, B, Sq, Skv, H, KVH, D), causal,
                   flash_kernel.FLASH_WGMMA)


# the wgmma kernel's head-major item order, which the launcher takes where
# the K and V that the items read (half of them under the causal mask) do
# not fit in L2 (every shape above runs the balanced order): kv tiles of
# 128, 96 and 64 rows, ragged Sq within a batch row, causal and not
@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KVH,D,causal", [
    (4, 3000, 32, 32, 80, True),
    (3, 3500, 16, 16, 192, True),
    (2, 3000, 16, 16, 256, False),
])
def test_wgmma_flash_kernel_head_major_order_on_card(cuda_gen, B, S, H, KVH, D, causal):
    q, k, v = _bf16_qkv(cuda_gen, B, S, S, H, KVH, D)
    read = 2 * k.numel() * k.element_size() // (2 if causal else 1)
    assert read > torch.cuda.get_device_properties(0).L2_cache_size
    _check_on_card(q, k, v, causal, flash_kernel.FLASH_WGMMA)


# a query offset (row i at position i + q_offset under the causal mask):
# the suffix Sq of Skv, an offset off every kv tile, one past Skv (every key
# visible), non-causal, on the routed kernels and the mma.sync one
@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Skv,H,KVH,D,causal,q_offset,dtype,kernel", [
    (2, 200, 256, 8, 2, 80, True, 56, torch.bfloat16, "FLASH_WGMMA"),
    (2, 256, 256, 8, 8, 64, True, 95, torch.bfloat16, "FLASH_WGMMA"),
    (1, 136, 200, 4, 1, 144, True, 300, torch.bfloat16, "FLASH_WGMMA"),
    (1, 200, 200, 8, 2, 128, False, 17, torch.bfloat16, "FLASH_WGMMA"),
    (1, 200, 256, 8, 2, 80, True, 56, torch.float32, "FLASH_F32"),
    (1, 100, 300, 4, 2, 192, True, 131, torch.bfloat16, "FLASH_MMA"),
])
def test_flash_kernel_takes_q_offset_on_card(cuda_gen, B, Sq, Skv, H, KVH, D, causal,
                                             q_offset, dtype, kernel):
    q = torch.randn((B, Sq, H, D), generator=cuda_gen, device="cuda").to(dtype)
    k = torch.randn((B, Skv, KVH, D), generator=cuda_gen, device="cuda").to(dtype)
    v = torch.randn((B, Skv, KVH, D), generator=cuda_gen, device="cuda").to(dtype)
    _check_on_card(q, k, v, causal, getattr(flash_kernel, kernel),
                   direct=kernel == "FLASH_MMA", q_offset=q_offset)


# the mma.sync kernel, which no route takes any more, launched directly
@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Skv,H,KVH,D,causal", [
    (1, 130, 130, 8, 1, 256, True),     # gemma-2b's MQA shape
    (2, 200, 150, 4, 2, 144, True),
    (2, 150, 200, 4, 2, 144, False),
])
def test_mma_flash_kernel_matches_plain_on_card(cuda_gen, B, Sq, Skv, H, KVH, D, causal):
    _check_on_card(*_bf16_qkv(cuda_gen, B, Sq, Skv, H, KVH, D), causal,
                   flash_kernel.FLASH_MMA, direct=True)


@pytest.mark.parametrize("dtype,D,symbol", [
    (torch.bfloat16, 16, "flash_attention_fwd_wgmma"),
    (torch.bfloat16, 80, "flash_attention_fwd_wgmma"),
    (torch.bfloat16, 128, "flash_attention_fwd_wgmma"),
    (torch.bfloat16, 144, "flash_attention_fwd_wgmma"),
    (torch.bfloat16, 160, "flash_attention_fwd_wgmma"),
    (torch.bfloat16, 176, "flash_attention_fwd_wgmma"),
    (torch.bfloat16, 192, "flash_attention_fwd_wgmma"),
    (torch.bfloat16, 208, "flash_attention_fwd_wgmma"),
    (torch.bfloat16, 224, "flash_attention_fwd_wgmma"),
    (torch.bfloat16, 240, "flash_attention_fwd_wgmma"),
    (torch.bfloat16, 256, "flash_attention_fwd_wgmma"),
    (torch.float32, 80, "flash_attention_fwd_f32"),
    (torch.float32, 256, "flash_attention_fwd_f32"),
])
def test_flash_route_picks_kernel_by_dtype_and_head_dim(dtype, D, symbol):
    assert flash_kernel.route(dtype, D).symbol == symbol


def _launcher_head_dims(symbol):
    """The head dims of the ``FLASH_CASE`` lines in ``symbol``'s switch."""
    source = (Path(flash_kernel.__file__).resolve().parents[1] / "csrc"
              / "flash_attention.cu").read_text()
    body = source.split(f'extern "C" int {symbol}(', 1)[1].split("default:", 1)[0]
    return [int(d) for d in re.findall(r"FLASH_CASE\(\w+, (\d+)\)", body)]


def test_flash_launchers_build_every_head_dim_their_route_sends():
    """The switches of the source and ``route`` cannot drift apart: every
    head dim the op takes (a multiple of 16 up to 256) has an instance in
    the launcher its dtype routes to."""
    head_dims = list(range(16, 257, 16))
    for dtype in (torch.bfloat16, torch.float32):
        for D in head_dims:
            assert D in _launcher_head_dims(flash_kernel.route(dtype, D).symbol)
    assert _launcher_head_dims("flash_attention_fwd_wgmma") == head_dims
    assert _launcher_head_dims("flash_attention_fwd_mma") == list(range(144, 257, 16))


def test_flash_route_refuses_other_dtypes():
    with pytest.raises(ValueError, match="float16"):
        flash_kernel.route(torch.float16, 64)
