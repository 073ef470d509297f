"""repro_torch.kernels.blob_codec against repro.kernels.blob_codec, bit for
bit: the plain versions against the JAX oracles, and the ops (on the CPU,
their plain path) against the Pallas kernels in interpret mode."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels.blob_codec import ops as jops
from repro.kernels.blob_codec import ref as jref
from repro.shuffle.binning import bin_pack as jax_bin_pack
from repro.shuffle.binning import sorted_order as jax_sorted_order
from repro_torch.interop import assert_same_bits, to_torch
from repro_torch.kernels.blob_codec import ops, ref

# (rows T, width d, bins, capacity, dtype, key range), after
# tests/test_kernels.py: overflow, empty bins, T not a multiple of 128,
# d == 1, capacity below and above 128
CASES = [
    pytest.param(64, 32, 8, 16, "float32", 8, id="f32"),
    pytest.param(100, 16, 4, 8, "float32", 4, id="overflow"),
    pytest.param(64, 128, 8, 16, "bfloat16", 8, id="bf16"),
    pytest.param(7, 8, 3, 4, "float32", 3, id="tiny"),
    pytest.param(200, 24, 8, 48, "bfloat16", 8, id="ragged-T"),
    pytest.param(100, 1, 8, 32, "float32", 4, id="d-eq-1"),
    pytest.param(50, 8, 16, 8, "float32", 8, id="empty-bins"),
    pytest.param(50, 8, 4, 200, "float32", 4, id="capacity-gt-128"),
]


def make_inputs(T, d, dtype, key_range, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, d)).astype(np.float32)
    x[0] = 0.0                                 # an all-zero record
    x = x.astype(jnp.bfloat16 if dtype == "bfloat16" else np.float32)
    keys = rng.integers(0, key_range, T).astype(np.int32)
    return x, keys


@pytest.mark.parametrize("T,d,bins,cap,dtype,key_range", CASES)
def test_codec_refs_match_jax(T, d, bins, cap, dtype, key_range):
    x, keys = make_inputs(T, d, dtype, key_range)
    triple = tuple(np.asarray(a) for a in jax_sorted_order(jnp.asarray(keys), bins))
    jq, js = jref.compress_pack_ref(jnp.asarray(x), *map(jnp.asarray, triple),
                                    capacity=cap)
    q, s = ref.compress_pack_ref(*to_torch((x,) + triple, device="cpu"),
                                 capacity=cap)
    assert_same_bits((q, s), (np.asarray(jq), np.asarray(js)))
    jpack = jax_bin_pack(jnp.asarray(keys), bins, cap)
    want = jref.unpack_decompress_ref(jq, js, jpack.slot, jpack.valid)
    got = ref.unpack_decompress_ref(
        q, s, *to_torch((np.asarray(jpack.slot), np.asarray(jpack.valid)),
                        device="cpu"))
    assert_same_bits(got, np.asarray(want))


@pytest.mark.parametrize("T,d,bins,cap,dtype,key_range", CASES)
def test_codec_ops_match_pallas(T, d, bins, cap, dtype, key_range):
    x, keys = make_inputs(T, d, dtype, key_range)
    tx, tkeys = to_torch((x, keys), device="cpu")
    (jq, js), jtriple = jops.compress_pack_fused(
        jnp.asarray(x), jnp.asarray(keys), num_bins=bins, capacity=cap,
        use_pallas=True)
    (q, s), triple = ops.compress_pack_fused(tx, tkeys, num_bins=bins,
                                             capacity=cap)
    assert_same_bits(((q, s), triple), ((np.asarray(jq), np.asarray(js)),
                                        tuple(np.asarray(a) for a in jtriple)))
    assert_same_bits(ops.compress_pack(tx, *triple, capacity=cap),
                     (np.asarray(jq), np.asarray(js)))
    want = jops.unpack_decompress_fused(jq, js, jnp.asarray(keys),
                                        num_bins=bins, capacity=cap,
                                        use_pallas=True)
    assert_same_bits(ops.unpack_decompress_fused(q, s, tkeys, num_bins=bins,
                                                 capacity=cap),
                     np.asarray(want))
    jpack = jax_bin_pack(jnp.asarray(keys), bins, cap)
    slot, valid = to_torch((np.asarray(jpack.slot), np.asarray(jpack.valid)),
                           device="cpu")
    assert_same_bits(ops.unpack_decompress(q, s, slot, valid), np.asarray(want))
    if key_range < bins:      # empty bins carry the padding identity
        assert not q[key_range:].any() and bool((s[key_range:] == 1.0).all())
