"""repro_torch.shuffle.binning against repro.shuffle.binning, bit for bit."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.shuffle import binning as jb
from repro_torch.interop import assert_same_bits, to_torch
from repro_torch.shuffle import binning as tb

# (units U, bins, capacity, key range): overflow, empty bins, U not a
# multiple of 128, capacity below 128 and above it
CASES = [
    pytest.param(64, 8, 16, 8, id="plain"),
    pytest.param(100, 4, 8, 4, id="overflow"),
    pytest.param(50, 16, 8, 8, id="empty-bins"),
    pytest.param(200, 8, 48, 8, id="ragged-U"),
    pytest.param(7, 3, 4, 3, id="tiny"),
    pytest.param(300, 4, 200, 4, id="capacity-gt-128"),
]


def _keys(U, key_range, seed=0):
    return np.random.default_rng(seed).integers(0, key_range, U).astype(np.int32)


@pytest.mark.parametrize("U,bins,cap,key_range", CASES)
def test_sorted_order_and_bin_pack_match_jax(U, bins, cap, key_range):
    keys = _keys(U, key_range)
    tkeys = to_torch(keys, device="cpu")
    assert_same_bits(tb.sorted_order(tkeys, bins),
                     tuple(np.asarray(a) for a in jb.sorted_order(
                         jnp.asarray(keys), bins)))
    got = tb.bin_pack(tkeys, bins, cap)
    want = jb.bin_pack(jnp.asarray(keys), bins, cap)
    assert isinstance(got, tb.Packing)
    assert_same_bits(tuple(got), tuple(np.asarray(a) for a in want))
    assert_same_bits(tb.dropped_units(got, cap),
                     np.asarray(jb.dropped_units(want, cap)))


@pytest.mark.parametrize("U,bins,cap,key_range", CASES)
@pytest.mark.parametrize("payload", [(), (3, 4)], ids=["rows", "multidim"])
def test_scatter_gather_match_jax(U, bins, cap, key_range, payload):
    keys = _keys(U, key_range, seed=1)
    rng = np.random.default_rng(2)
    values = rng.standard_normal((U,) + payload).astype(np.float32)
    jpack = jb.bin_pack(jnp.asarray(keys), bins, cap)
    tpack = tb.bin_pack(to_torch(keys, device="cpu"), bins, cap)
    jbuf = jb.scatter_to_bins(jnp.asarray(values), jpack, bins, cap)
    tbuf = tb.scatter_to_bins(to_torch(values, device="cpu"), tpack, bins, cap)
    assert_same_bits(tbuf, np.asarray(jbuf))
    assert_same_bits(tb.gather_from_bins(tbuf, tpack),
                     np.asarray(jb.gather_from_bins(jbuf, jpack)))


def test_sorted_order_is_stable_on_many_keys():
    keys = _keys(100_000, 16, seed=3)
    order, _, _ = tb.sorted_order(to_torch(keys, device="cpu"), 16)
    assert_same_bits(order, np.argsort(keys, kind="stable").astype(np.int32))
