"""repro_torch.kernels.blob_pack against repro.kernels.blob_pack, bit for
bit: the plain versions against the JAX oracle, and the ops (on the CPU,
their plain path) against the JAX ops running the Pallas kernels in
interpret mode."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels.blob_pack import ops as jops
from repro.kernels.blob_pack.ref import blob_pack_ref as jax_blob_pack_ref
from repro.shuffle.binning import sorted_order as jax_sorted_order
from repro_torch.interop import assert_same_bits, to_torch
from repro_torch.kernels.blob_pack import ops
from repro_torch.kernels.blob_pack.ref import blob_pack_ref

# (rows T, width d, bins, capacity, dtype, key range), after
# tests/test_kernels.py: payload dtypes, overflow, empty bins, T not a
# multiple of 128, d == 1, capacity below and above 128
CASES = [
    pytest.param(64, 32, 8, 16, "float32", 8, id="f32"),
    pytest.param(100, 16, 4, 8, "float32", 4, id="overflow"),
    pytest.param(64, 128, 8, 16, "bfloat16", 8, id="bf16"),
    pytest.param(7, 8, 3, 4, "float32", 3, id="tiny"),
    pytest.param(200, 24, 8, 48, "int32", 8, id="int32-ragged-T"),
    pytest.param(130, 12, 6, 40, "int8", 6, id="int8"),
    pytest.param(100, 1, 8, 32, "float32", 4, id="d-eq-1"),
    pytest.param(50, 8, 16, 8, "float32", 8, id="empty-bins"),
    pytest.param(50, 8, 4, 200, "bfloat16", 4, id="capacity-gt-128"),
]


def make_rows(T, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype in ("int32", "int8"):
        lo, hi = (-128, 128) if dtype == "int8" else (-1000, 1000)
        return rng.integers(lo, hi, (T, d)).astype(dtype)
    x = rng.standard_normal((T, d)).astype(np.float32)
    return x.astype(jnp.bfloat16 if dtype == "bfloat16" else np.float32)


def make_keys(T, key_range, seed=1):
    return np.random.default_rng(seed).integers(0, key_range, T).astype(np.int32)


@pytest.mark.parametrize("T,d,bins,cap,dtype,key_range", CASES)
def test_blob_pack_ref_matches_jax(T, d, bins, cap, dtype, key_range):
    x, keys = make_rows(T, d, dtype), make_keys(T, key_range)
    triple = tuple(np.asarray(a) for a in jax_sorted_order(jnp.asarray(keys), bins))
    want = jax_blob_pack_ref(jnp.asarray(x), *map(jnp.asarray, triple),
                             capacity=cap)
    got = blob_pack_ref(*to_torch((x,) + triple, device="cpu"), capacity=cap)
    assert_same_bits(got, np.asarray(want))


@pytest.mark.parametrize("T,d,bins,cap,dtype,key_range", CASES)
def test_blob_pack_ops_match_pallas(T, d, bins, cap, dtype, key_range):
    x, keys = make_rows(T, d, dtype), make_keys(T, key_range)
    tx, tkeys = to_torch((x, keys), device="cpu")
    jbuf, jtriple = jops.blob_pack_fused(jnp.asarray(x), jnp.asarray(keys),
                                         num_bins=bins, capacity=cap,
                                         use_pallas=True)
    want = (np.asarray(jbuf), tuple(np.asarray(a) for a in jtriple))
    assert_same_bits(ops.blob_pack_fused(tx, tkeys, num_bins=bins,
                                         capacity=cap), want)
    assert_same_bits(ops.pack_from_keys(tx, tkeys, num_bins=bins,
                                        capacity=cap), want)
    jplain = jops.blob_pack(jnp.asarray(x), *jtriple, capacity=cap,
                            use_pallas=True)
    assert_same_bits(ops.blob_pack(tx, *to_torch(want[1], device="cpu"),
                                   capacity=cap), np.asarray(jplain))
    if key_range < bins:                 # bins past the key range stay zero
        assert not np.asarray(jbuf)[key_range:].any()
