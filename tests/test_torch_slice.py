"""The port's data plane as a whole against the JAX package: the two
round trips through the public entry points, and blob layouts carried
across packages through ``repro_torch.interop``."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.shuffle import api as japi
from repro.shuffle.binning import bin_pack as jax_bin_pack
from repro_torch import interop
from repro_torch.interop import assert_same_bits, to_numpy, to_torch
from repro_torch.shuffle import api
from repro_torch.shuffle.binning import Packing, bin_pack

# (records T, width d, partitions, capacity, key range)
CASES = [
    pytest.param(300, 24, 8, 64, 8, id="no-drops"),
    pytest.param(300, 24, 8, 16, 8, id="overflow"),
    pytest.param(130, 1, 12, 20, 6, id="d-eq-1-empty-bins"),
]


def make_records(T, d, key_range, dtype="bfloat16", seed=7):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, d)).astype(np.float32)
    x = x.astype(jnp.bfloat16 if dtype == "bfloat16" else np.float32)
    return x, rng.integers(0, key_range, T).astype(np.int32)


@pytest.mark.parametrize("T,d,P,cap,key_range", CASES)
def test_pack_unpack_round_trip_matches_jax(T, d, P, cap, key_range):
    x, keys = make_records(T, d, key_range)
    tx, tkeys = to_torch((x, keys), device="cpu")
    jbuf, _ = japi.blob_pack_fused(jnp.asarray(x), jnp.asarray(keys),
                                   num_bins=P, capacity=cap, use_pallas=True)
    jback = japi.unpack_from_keys(jbuf, jnp.asarray(keys), num_bins=P,
                                  capacity=cap, use_pallas=True)
    buf, _ = api.blob_pack_fused(tx, tkeys, num_bins=P, capacity=cap)
    back = api.unpack_from_keys(buf, tkeys, num_bins=P, capacity=cap)
    assert_same_bits((buf, back), (np.asarray(jbuf), np.asarray(jback)))
    pack = bin_pack(tkeys, P, cap)
    kept = to_numpy(pack.valid)
    assert_same_bits(x[kept], to_numpy(back)[kept])  # delivered exactly once
    assert not to_numpy(back)[~kept].view(np.uint16).any()


@pytest.mark.parametrize("T,d,P,cap,key_range", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_codec_round_trip_matches_jax(T, d, P, cap, key_range, dtype):
    x, keys = make_records(T, d, key_range, dtype)
    tx, tkeys = to_torch((x, keys), device="cpu")
    (jq, js), _ = japi.compress_pack_fused(jnp.asarray(x), jnp.asarray(keys),
                                           num_bins=P, capacity=cap,
                                           use_pallas=True)
    jout = japi.unpack_decompress_fused(jq, js, jnp.asarray(keys), num_bins=P,
                                        capacity=cap, use_pallas=True)
    (q, s), _ = api.compress_pack_fused(tx, tkeys, num_bins=P, capacity=cap)
    out = api.unpack_decompress_fused(q, s, tkeys, num_bins=P, capacity=cap)
    assert_same_bits((q, s, out), tuple(map(np.asarray, (jq, js, jout))))


@pytest.mark.parametrize("T,d,P,cap,key_range", CASES)
def test_layouts_cross_packages(T, d, P, cap, key_range):
    """A layout packed by JAX unpacks in the port, and the reverse."""
    x, keys = make_records(T, d, key_range)
    jkeys = jnp.asarray(keys)
    tkeys = to_torch(keys, device="cpu")
    # JAX -> port, plain and compressed
    jbuf, _ = japi.blob_pack_fused(jnp.asarray(x), jkeys, num_bins=P,
                                   capacity=cap, use_pallas=True)
    want = japi.unpack_from_keys(jbuf, jkeys, num_bins=P, capacity=cap,
                                 use_pallas=True)
    got = api.unpack_from_keys(to_torch(np.asarray(jbuf), device="cpu"), tkeys,
                               num_bins=P, capacity=cap)
    assert_same_bits(got, np.asarray(want))
    (jq, js), _ = japi.compress_pack_fused(jnp.asarray(x), jkeys, num_bins=P,
                                           capacity=cap, use_pallas=True)
    want = japi.unpack_decompress_fused(jq, js, jkeys, num_bins=P,
                                        capacity=cap, use_pallas=True)
    q, s = to_torch((np.asarray(jq), np.asarray(js)), device="cpu")
    assert_same_bits(api.unpack_decompress_fused(q, s, tkeys, num_bins=P,
                                                 capacity=cap),
                     np.asarray(want))
    # port -> JAX
    buf, _ = api.blob_pack_fused(to_torch(x, device="cpu"), tkeys,
                                 num_bins=P, capacity=cap)
    want = api.unpack_from_keys(buf, tkeys, num_bins=P, capacity=cap)
    got = japi.unpack_from_keys(jnp.asarray(to_numpy(buf)), jkeys, num_bins=P,
                                capacity=cap, use_pallas=True)
    assert_same_bits(np.asarray(got), want)
    (q, s), _ = api.compress_pack_fused(to_torch(x, device="cpu"), tkeys,
                                        num_bins=P, capacity=cap)
    jq, js = to_numpy((q, s))
    got = japi.unpack_decompress_fused(jnp.asarray(jq), jnp.asarray(js), jkeys,
                                       num_bins=P, capacity=cap,
                                       use_pallas=True)
    assert_same_bits(np.asarray(got),
                     api.unpack_decompress_fused(q, s, tkeys, num_bins=P,
                                                 capacity=cap))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32", "int8",
                                   "bool"])
def test_interop_keeps_bits_and_structure(dtype):
    rng = np.random.default_rng(8)
    a = rng.standard_normal((5, 3)).astype(np.float32)
    a = a.astype(jnp.bfloat16) if dtype == "bfloat16" else a.astype(dtype)
    t = to_torch(a, device="cpu")
    assert t.dtype == getattr(torch, dtype)
    assert_same_bits(to_numpy(t), a)
    # the JAX package's Packing crosses as a Packing of tensors and back
    jpack = jax_bin_pack(jnp.asarray(rng.integers(0, 4, 9).astype(np.int32)),
                         4, 2)
    tpack = to_torch(Packing(*(np.asarray(f) for f in jpack)), device="cpu")
    assert isinstance(tpack, Packing)
    assert_same_bits(to_numpy(tpack), tuple(np.asarray(f) for f in jpack))
    with pytest.raises(AssertionError):
        interop.assert_same_bits(a, np.zeros((5, 4), a.dtype))
