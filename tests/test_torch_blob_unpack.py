"""repro_torch.kernels.blob_unpack against repro.kernels.blob_unpack, bit
for bit: the plain version against the JAX oracle, and the ops (on the
CPU, their plain path) against both Pallas kernels in interpret mode."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels.blob_unpack import ops as jops
from repro.kernels.blob_unpack.ref import blob_unpack_ref as jax_blob_unpack_ref
from repro_torch.interop import assert_same_bits, to_torch
from repro_torch.kernels.blob_unpack import ops
from repro_torch.kernels.blob_unpack.ref import blob_unpack_ref

# (units U, bins, capacity, width d, dtype): payload dtypes, U not a
# multiple of 128, d == 1, capacity below and above 128
CASES = [
    pytest.param(64, 8, 16, 32, "float32", id="f32"),
    pytest.param(33, 4, 8, 16, "bfloat16", id="bf16"),
    pytest.param(8, 2, 4, 8, "float32", id="tiny"),
    pytest.param(130, 6, 40, 12, "int32", id="int32-ragged-U"),
    pytest.param(130, 6, 40, 7, "int8", id="int8"),
    pytest.param(100, 8, 32, 1, "float32", id="d-eq-1"),
    pytest.param(50, 2, 200, 8, "bfloat16", id="capacity-gt-128"),
]


def make_layout(U, bins, cap, d, dtype, seed=4):
    rng = np.random.default_rng(seed)
    shape = (bins, cap, d)
    if dtype in ("int32", "int8"):
        buf = rng.integers(-100, 100, shape).astype(dtype)
    else:
        buf = rng.standard_normal(shape).astype(np.float32)
        buf = buf.astype(jnp.bfloat16 if dtype == "bfloat16" else np.float32)
    # a few slots fall outside the layout on either side: both sides clip
    slot = rng.integers(-3, bins * cap + 3, U).astype(np.int32)
    valid = rng.random(U) < 0.8
    return buf, slot, valid


@pytest.mark.parametrize("U,bins,cap,d,dtype", CASES)
def test_blob_unpack_ref_matches_jax(U, bins, cap, d, dtype):
    buf, slot, valid = make_layout(U, bins, cap, d, dtype)
    want = jax_blob_unpack_ref(jnp.asarray(buf), jnp.asarray(slot),
                               jnp.asarray(valid))
    got = blob_unpack_ref(*to_torch((buf, slot, valid), device="cpu"))
    assert_same_bits(got, np.asarray(want))


@pytest.mark.parametrize("U,bins,cap,d,dtype", CASES)
def test_blob_unpack_ops_match_pallas(U, bins, cap, d, dtype):
    buf, slot, valid = make_layout(U, bins, cap, d, dtype)
    jargs = tuple(map(jnp.asarray, (buf, slot, valid)))
    targs = to_torch((buf, slot, valid), device="cpu")
    want = np.asarray(jops.blob_unpack_fused(*jargs, use_pallas=True))
    assert_same_bits(np.asarray(jops.blob_unpack(*jargs, use_pallas=True)), want)
    assert_same_bits(ops.blob_unpack_fused(*targs), want)
    assert_same_bits(ops.blob_unpack(*targs), want)


@pytest.mark.parametrize("U,bins,cap,key_range", [
    pytest.param(100, 4, 8, 4, id="overflow"),
    pytest.param(50, 16, 8, 8, id="empty-bins"),
    pytest.param(200, 8, 48, 8, id="ragged-U"),
])
def test_unpack_from_keys_matches_pallas(U, bins, cap, key_range):
    rng = np.random.default_rng(5)
    buf = rng.standard_normal((bins, cap, 12)).astype(np.float32)
    keys = rng.integers(0, key_range, U).astype(np.int32)
    want = jops.unpack_from_keys(jnp.asarray(buf), jnp.asarray(keys),
                                 num_bins=bins, capacity=cap, use_pallas=True)
    got = ops.unpack_from_keys(*to_torch((buf, keys), device="cpu"),
                               num_bins=bins, capacity=cap)
    assert_same_bits(got, np.asarray(want))
