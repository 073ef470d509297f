"""The port's host fast paths (``repro_torch.kernels.blob_pack.host``,
``repro_torch.kernels.blob_codec.host``) against the JAX package's, bit
for bit, and against the port's plain versions: payload dtypes, a fresh
output and a dirty reused arena, empty bins, a capacity that drops rows,
and the codec's edge rows (all zero, one large value, values half a
quantization step from a rounding edge). Inputs come from a numpy seed.
The host paths take CPU tensors only: a tensor on another device (a
``meta`` tensor here; a CUDA one under the ``cuda`` marker) and keys out
of range are refused."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels.blob_codec.host import \
    compress_pack_fused_host as jax_compress_pack_fused_host
from repro.kernels.blob_codec.ref import compress_pack_ref as jax_compress_pack_ref
from repro.kernels.blob_pack.host import \
    blob_pack_fused_host as jax_blob_pack_fused_host
from repro.kernels.blob_pack.host import sorted_order_np as jax_sorted_order_np
from repro.shuffle.binning import sorted_order as jax_sorted_order
from repro_torch.interop import assert_same_bits, to_torch
from repro_torch.kernels import blob_codec
from repro_torch.kernels.blob_codec.ref import compress_pack_ref
from repro_torch.kernels.blob_pack import ops
from repro_torch.kernels.blob_pack.ref import blob_pack_ref
from repro_torch.shuffle.binning import sorted_order

BF16 = np.asarray(jnp.zeros(0, jnp.bfloat16)).dtype

# (rows T, width d, bins, capacity, dtype, key range): tests/test_kernels.py's
# host case in its three dtypes; empty bins; a capacity that drops rows;
# rows of 14 and 5 bytes (the uint16 and the byte-wide views)
PACK_CASES = [
    pytest.param(150, 12, 8, 24, "float32", 8, id="f32"),
    pytest.param(150, 12, 8, 24, "int32", 8, id="int32"),
    pytest.param(150, 12, 8, 24, "bfloat16", 8, id="bf16"),
    pytest.param(50, 8, 16, 8, "float32", 8, id="empty-bins"),
    pytest.param(100, 16, 4, 8, "bfloat16", 4, id="drops"),
    pytest.param(64, 7, 6, 16, "bfloat16", 6, id="14-byte-rows"),
    pytest.param(64, 5, 4, 32, "int8", 3, id="5-byte-rows"),
]
ARENAS = ["fresh", "dirty"]


def make_rows(T, d, dtype, seed=5):
    rng = np.random.default_rng(seed)
    if dtype in ("int32", "int8"):
        return rng.integers(-100, 100, (T, d)).astype(dtype)
    x = rng.standard_normal((T, d)).astype(np.float32)
    return x.astype(BF16) if dtype == "bfloat16" else x


def make_keys(T, key_range, seed=6):
    return np.random.default_rng(seed).integers(0, key_range, T).astype(np.int32)


def triple_np(keys, bins):
    return tuple(np.asarray(a) for a in jax_sorted_order(jnp.asarray(keys), bins))


@pytest.mark.parametrize("arena", ARENAS)
@pytest.mark.parametrize("T,d,bins,cap,dtype,key_range", PACK_CASES)
def test_blob_pack_host_matches_jax(T, d, bins, cap, dtype, key_range, arena):
    x, keys = make_rows(T, d, dtype), make_keys(T, key_range)
    want_out, want_triple = jax_blob_pack_fused_host(x, keys, num_bins=bins,
                                                     capacity=cap)
    tx = to_torch(x, device="cpu")
    ref = blob_pack_ref(tx, *to_torch(triple_np(keys, bins), device="cpu"),
                        capacity=cap)
    assert_same_bits(ref, want_out)
    out = None
    if arena == "dirty":
        out = torch.ones((bins, cap, d), dtype=tx.dtype)
    got, triple = ops.blob_pack_fused_host(tx, keys if arena == "fresh"
                                           else torch.from_numpy(keys),
                                           num_bins=bins, capacity=cap, out=out)
    assert out is None or got is out
    assert_same_bits(got, want_out)
    assert_same_bits(triple, tuple(want_triple))
    if key_range < bins:                 # bins past the key range stay zero
        assert not got[key_range:].any()


def test_blob_pack_host_leaves_a_mismatched_arena_alone():
    x, keys = make_rows(150, 12, "float32"), make_keys(150, 8)
    wrong = torch.full((8, 25, 12), 7.0)
    got, _ = ops.blob_pack_fused_host(torch.from_numpy(x), keys, num_bins=8,
                                      capacity=24, out=wrong)
    assert got is not wrong and torch.equal(wrong, torch.full((8, 25, 12), 7.0))
    assert_same_bits(got, jax_blob_pack_fused_host(x, keys, num_bins=8,
                                                   capacity=24)[0])


@pytest.mark.parametrize("T,bins,key_range", [(500, 16, 11), (1, 1, 1), (0, 4, 4),
                                              (3000, 216, 216)])
def test_sorted_order_np_matches_jax_and_the_port(T, bins, key_range):
    keys = make_keys(T, key_range)
    got = ops.sorted_order_np(keys, bins)
    assert all(isinstance(a, np.ndarray) and a.dtype == np.int32 for a in got)
    assert_same_bits(got, jax_sorted_order_np(keys, bins))
    assert_same_bits(got, triple_np(keys, bins))
    assert_same_bits(got, sorted_order(torch.from_numpy(keys), bins))
    assert_same_bits(ops.sorted_order_np(torch.from_numpy(keys), bins), got)


def codec_rows(T, d, dtype, seed=7):
    """Random rows with the edge rows first: all zero; one large value
    among small ones; values half a step from a rounding edge (absmax 127
    and 254, scale ~1 and ~2); a row of equal values; tiny values."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, d)).astype(np.float32)
    x[0] = 0.0
    x[1] = rng.standard_normal(d) * 1e-3
    x[1, d // 2] = 3.0e4
    halves = np.arange(d, dtype=np.float32) % 127 + 0.5
    x[2] = halves * np.where(np.arange(d) % 2, -1, 1)
    x[2, 0] = 127.0
    x[3] = 2 * x[2]
    x[4] = -1.25
    x[5] = rng.standard_normal(d) * 1e-30
    return x.astype(BF16) if dtype == "bfloat16" else x


CODEC_CASES = [
    pytest.param(150, 12, 8, 24, "float32", 8, id="f32"),
    pytest.param(150, 12, 8, 24, "bfloat16", 8, id="bf16"),
    pytest.param(120, 20, 8, 8, "bfloat16", 6, id="bf16-drops-empty-bins"),
    pytest.param(90, 7, 4, 40, "float32", 4, id="f32-7-wide"),
]


@pytest.mark.parametrize("arena", ARENAS)
@pytest.mark.parametrize("T,d,bins,cap,dtype,key_range", CODEC_CASES)
def test_compress_pack_host_matches_jax(T, d, bins, cap, dtype, key_range, arena):
    x, keys = codec_rows(T, d, dtype), make_keys(T, key_range)
    (jq, js), jtriple = jax_compress_pack_fused_host(x, keys, num_bins=bins,
                                                     capacity=cap)
    triple = triple_np(keys, bins)
    # JAX's host path against its own plain version, and the port's
    jref = jax_compress_pack_ref(jnp.asarray(x), *map(jnp.asarray, triple),
                                 capacity=cap)
    assert_same_bits((jq, js), tuple(np.asarray(a) for a in jref))
    tx = to_torch(x, device="cpu")
    assert_same_bits(compress_pack_ref(tx, *to_torch(triple, device="cpu"),
                                       capacity=cap), (jq, js))
    out = None
    if arena == "dirty":
        out = (torch.full((bins, cap, d), 3, dtype=torch.int8),
               torch.full((bins, cap), 9.0))
    (q, s), got_triple = blob_codec.compress_pack_fused_host(
        tx, keys, num_bins=bins, capacity=cap, out=out)
    assert out is None or (q is out[0] and s is out[1])
    assert_same_bits((q, s), (jq, js))
    assert_same_bits(got_triple, tuple(jtriple))


def test_compress_pack_host_quantizes_in_chunks(monkeypatch):
    """Chunks of rows give the bits of one pass: the quantizer is per row."""
    from repro_torch.kernels.blob_codec import host

    x, keys = codec_rows(100, 12, "bfloat16"), make_keys(100, 8)
    want = jax_compress_pack_fused_host(x, keys, num_bins=8, capacity=20)
    monkeypatch.setattr(host, "QUANTIZE_ROWS", 7)
    got = host.compress_pack_fused_host(to_torch(x, device="cpu"), keys,
                                        num_bins=8, capacity=20)
    assert_same_bits(got, want)


HOST_PATHS = {
    "pack": ops.blob_pack_fused_host,
    "codec": blob_codec.compress_pack_fused_host,
}


def _arena(path, device):
    if path == "pack":
        return torch.zeros((4, 8, 6), device=device)
    return (torch.zeros((4, 8, 6), dtype=torch.int8, device=device),
            torch.ones((4, 8), device=device))


@pytest.mark.parametrize("path", sorted(HOST_PATHS))
def test_host_paths_refuse_a_tensor_off_the_host(path):
    fn, x, keys = HOST_PATHS[path], torch.zeros((20, 6)), torch.zeros(20, dtype=torch.int32)
    with pytest.raises(ValueError, match="device meta"):
        fn(x.to("meta"), keys, num_bins=4, capacity=8)
    with pytest.raises(ValueError, match="keys lies on device meta"):
        fn(x, keys.to("meta"), num_bins=4, capacity=8)
    with pytest.raises(ValueError, match="out.* lies on device meta"):
        fn(x, keys, num_bins=4, capacity=8, out=_arena(path, "meta"))
    with pytest.raises(ValueError, match="torch.Tensor"):
        fn(x.numpy(), keys, num_bins=4, capacity=8)


@pytest.mark.parametrize("path", sorted(HOST_PATHS))
@pytest.mark.parametrize("bad", [-1, 4])
def test_host_paths_refuse_keys_out_of_range(path, bad):
    keys = make_keys(20, 4)
    keys[3] = bad
    with pytest.raises(ValueError):       # JAX's numpy refuses them too
        jax_sorted_order_np(keys, 4)
    for k in (keys, torch.from_numpy(keys)):
        with pytest.raises(ValueError, match=r"must lie in \[0, 4\)"):
            ops.sorted_order_np(k, 4)
        with pytest.raises(ValueError, match=r"must lie in \[0, 4\)"):
            HOST_PATHS[path](torch.zeros((20, 6)), k, num_bins=4, capacity=8)
    with pytest.raises(ValueError, match="19 keys for the 20 rows"):
        HOST_PATHS[path](torch.zeros((20, 6)), keys[:19].clip(0, 3), num_bins=4,
                         capacity=8)


@pytest.mark.cuda
@pytest.mark.parametrize("path", sorted(HOST_PATHS))
def test_host_paths_refuse_cuda_tensors(path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fn, x, keys = HOST_PATHS[path], torch.zeros((20, 6)), torch.zeros(20, dtype=torch.int32)
    with pytest.raises(ValueError, match="device cuda"):
        fn(x.cuda(), keys, num_bins=4, capacity=8)
    with pytest.raises(ValueError, match="device cuda"):
        fn(x, keys.cuda(), num_bins=4, capacity=8)
    with pytest.raises(ValueError, match="device cuda"):
        fn(x, keys, num_bins=4, capacity=8, out=_arena(path, "cuda"))
