"""repro_torch.shuffle.compression against repro.shuffle.compression, bit
for bit, and the two int8 quantizers each against its own JAX twin."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels.blob_codec.ref import quantize_rows as jax_quantize_rows
from repro.shuffle import compression as jc
from repro_torch.interop import assert_same_bits, to_torch
from repro_torch.kernels.blob_codec.ref import quantize_rows
from repro_torch.shuffle import compression as tc

SHAPES = [(64, 32), (7, 1), (3, 5, 17)]
DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rows(shape, np_dtype, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x.reshape(-1, shape[-1])[0] = 0.0          # an all-zero row: scale 1.0
    return x.astype(np_dtype)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_int8_codec_matches_jax(shape, dtype):
    np_dtype, t_dtype = DTYPES[dtype]
    x = _rows(shape, np_dtype)
    tx = to_torch(x, device="cpu")
    q, s = tc.int8_quantize(tx)
    jq, js = jc.int8_quantize(jnp.asarray(x))
    assert_same_bits((q, s), (np.asarray(jq), np.asarray(js)))
    assert_same_bits(tc.int8_dequantize(q, s, t_dtype),
                     np.asarray(jc.int8_dequantize(jq, js, jnp.dtype(np_dtype))))
    assert_same_bits(tc.compress_decompress(tx),
                     np.asarray(jc.compress_decompress(jnp.asarray(x))))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_with_error_feedback_matches_jax(dtype):
    np_dtype, _ = DTYPES[dtype]
    grad = _rows((16, 24), np_dtype, seed=1)
    residual = (_rows((16, 24), np.float32, seed=2) * 0.01).astype(np.float32)
    got = tc.with_error_feedback(to_torch(grad, device="cpu"),
                                 to_torch(residual, device="cpu"))
    want = jc.with_error_feedback(jnp.asarray(grad), jnp.asarray(residual))
    assert_same_bits(got, tuple(np.asarray(a) for a in want))


def test_two_quantizers_differ_and_each_matches_its_twin():
    """The divide form (absmax / 127) and the codec's multiply form
    (absmax * f32(1/127)) give different scales on some rows; the port
    keeps both and each equals its own JAX counterpart."""
    x = _rows((20000, 64), np.float32, seed=3)
    tx = to_torch(x, device="cpu")
    div_q, div_s = tc.int8_quantize(tx)
    mul_q, mul_s = quantize_rows(tx)
    jdiv = jc.int8_quantize(jnp.asarray(x))
    jmul = jax_quantize_rows(jnp.asarray(x))
    assert_same_bits((div_q, div_s), tuple(np.asarray(a) for a in jdiv))
    assert_same_bits((mul_q, mul_s), tuple(np.asarray(a) for a in jmul))
    assert int((div_s != mul_s).sum()) > 100
