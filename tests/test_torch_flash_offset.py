"""The flash branch with a query offset against the JAX package.

    PYTHONPATH=src python -m pytest -q tests/test_torch_flash_offset.py

Under the causal mask query row i sits at position ``i + q_offset`` and
sees key j where ``j <= i + q_offset``; without the mask the offset
changes nothing. Inputs are made with numpy from a seed.

(a) ``attention_op(..., q_offset=n)`` above ``flash_min_seq`` against
    JAX's ``attention_op``: both take their flash branch, JAX's with small
    ``flash_q_chunk``/``flash_kv_chunk`` so that its blocks cross the
    sequence (the port's config has no such fields). Within ``TOL``: f32
    the same math in another order (2e-5), bf16 the probabilities rounded
    to bf16 before the second product (2e-2), as
    ``tests/test_torch_flash_attention.py`` holds them.
(b) ``flash_attention_op(q_offset=n)``'s (dq, dk, dv), through
    ``models.flash.flash_bwd`` at chunks smaller than the sequence,
    against ``jax.vjp`` of JAX's ``flash_attention(q_offset=n)`` on the
    same ``dout``, within ``GRAD_TOL`` relative Frobenius error: f32 1e-5
    (the same math in another order), bf16 1e-2 (the forward's bf16
    rounding of the probabilities reaches the backward through ``out``,
    and each gradient is rounded to bf16). The blockwise log-sum-exp is
    held against the one JAX's forward saves.
(c) A negative offset is refused by name on both branches, and the op and
    the kernel wrapper refuse an offset that is not a non-negative int or
    that overflows the kernels' int32 positions.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.models import attention as jattn
from repro.models import flash as jflash
from repro.models.common import ModelConfig as JaxModelConfig
from repro_torch.interop import to_numpy, to_torch
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.models import attention
from repro_torch.models import flash as tflash
from repro_torch.models.common import ModelConfig

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
FLASH_MIN_SEQ = 16
Q_CHUNK, KV_CHUNK = 8, 16     # JAX's flash blocks and the port's backward's

# (B, Sq, Skv, H, KVH, D, causal, q_offset)
FORWARD_CASES = [
    pytest.param(2, 24, 64, 4, 4, 32, True, 40, id="suffix"),
    pytest.param(1, 48, 48, 4, 4, 32, True, 7, id="pure-shift"),
    pytest.param(1, 16, 32, 4, 4, 32, True, 40, id="beyond"),
    pytest.param(2, 40, 56, 4, 2, 32, True, 16, id="gqa"),
    pytest.param(1, 40, 40, 4, 2, 24, True, 9, id="head-dim-24"),
    pytest.param(1, 32, 48, 4, 2, 32, False, 11, id="non-causal"),
]


def _kw():
    return dict(name="t", kind="hybrid", num_layers=2, d_model=64, num_heads=4,
                num_kv_heads=2, d_ff=8, vocab_size=8, flash_min_seq=FLASH_MIN_SEQ)


def _qkv(B, Sq, Skv, H, KVH, D, dtype, seed=11):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Skv, KVH, D), (B, Skv, KVH, D))]
    return [a.astype(jnp.bfloat16) if dtype == "bfloat16" else a for a in arrs]


def _rel_fro(got: np.ndarray, want: np.ndarray) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,H,KVH,D,causal,q_offset", FORWARD_CASES)
def test_attention_op_flash_branch_offset_matches_jax(monkeypatch, B, Sq, Skv, H, KVH, D,
                                                      causal, q_offset, dtype):
    calls = []

    def counting(q, k, v, **kwargs):
        calls.append(kwargs["q_offset"])
        return flash_attention_op(q, k, v, **kwargs)

    monkeypatch.setattr(attention, "flash_attention_op", counting)
    q, k, v = _qkv(B, Sq, Skv, H, KVH, D, dtype)
    got = attention.attention_op(ModelConfig(**_kw()), *to_torch((q, k, v), device="cpu"),
                                 causal=causal, q_offset=q_offset)
    jcfg = JaxModelConfig(**_kw(), flash_q_chunk=Q_CHUNK, flash_kv_chunk=KV_CHUNK)
    want = jattn.attention_op(jcfg, *(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                              q_offset=q_offset)
    assert calls == [q_offset]                  # the port's flash branch ran
    assert got.shape == (B, Sq, H, D) and str(got.dtype) == f"torch.{dtype}"
    np.testing.assert_allclose(to_numpy(got.float()), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=0)


# (B, Sq, Skv, H, KVH, D, causal, q_offset), head dims the op takes
GRAD_CASES = [
    pytest.param(1, 24, 64, 4, 4, 32, True, 40, id="suffix"),
    pytest.param(1, 40, 40, 4, 2, 16, True, 7, id="pure-shift-gqa"),
    pytest.param(1, 16, 32, 2, 2, 16, True, 40, id="beyond"),
    pytest.param(2, 20, 48, 4, 1, 32, True, 21, id="mqa-ragged"),
    pytest.param(1, 24, 40, 4, 2, 16, False, 5, id="non-causal"),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,H,KVH,D,causal,q_offset", GRAD_CASES)
def test_flash_op_offset_gradients_match_jax_grad(monkeypatch, B, Sq, Skv, H, KVH, D, causal,
                                                  q_offset, dtype):
    bwd_calls, flash_bwd = [], tflash.flash_bwd

    def small_chunks(*args, **kwargs):
        bwd_calls.append(kwargs["q_offset"])
        return flash_bwd(*args, q_chunk=Q_CHUNK, kv_chunk=KV_CHUNK, **kwargs)

    monkeypatch.setattr(tflash, "flash_bwd", small_chunks)
    q, k, v = _qkv(B, Sq, Skv, H, KVH, D, dtype, seed=5)
    dout = np.random.default_rng(6).standard_normal((B, Sq, H, D)).astype(np.float32)
    dout = dout.astype(jnp.bfloat16) if dtype == "bfloat16" else dout

    leaves = [t.requires_grad_() for t in to_torch((q, k, v), device="cpu")]
    out = flash_attention_op(*leaves, causal=causal, q_offset=q_offset)
    got = torch.autograd.grad(out, leaves, to_torch(dout, device="cpu"))
    assert bwd_calls == [q_offset]

    fn = functools.partial(jflash.flash_attention, causal=causal, q_chunk=Q_CHUNK,
                           kv_chunk=KV_CHUNK, q_offset=q_offset)
    _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(dout))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert str(g.dtype) == f"torch.{dtype}" and tuple(g.shape) == w.shape
        err = _rel_fro(to_numpy(g.float()), np.asarray(w, np.float32))
        assert err <= GRAD_TOL[dtype], f"{name}: {err}"


@pytest.mark.parametrize("B,Sq,Skv,H,KVH,D,causal,q_offset", FORWARD_CASES[:4])
def test_flash_lse_offset_matches_jax_forward(B, Sq, Skv, H, KVH, D, causal, q_offset):
    q, k, _ = _qkv(B, Sq, Skv, H, KVH, D, "float32")
    got = tflash.flash_lse(*to_torch((q, k), device="cpu"), causal=causal, q_chunk=Q_CHUNK,
                           kv_chunk=KV_CHUNK, q_offset=q_offset)      # (B, KVH, G, Sq)
    jq, jk = jnp.asarray(q), jnp.asarray(k)
    _, lse = jflash._flash_fwd_impl(jq, jk, jk, causal, Q_CHUNK, KV_CHUNK, q_offset,
                                    jflash.NO_HINTS)                  # (B, nq, H, qc)
    want = np.moveaxis(np.asarray(lse), 2, 1).reshape(B, H, -1)[..., :Sq]
    np.testing.assert_allclose(to_numpy(got).reshape(B, H, Sq), want, atol=2e-5, rtol=0)


def _cpu(**kw):
    return to_torch(_qkv(**kw, dtype="float32"), device="cpu")


REFUSALS = {
    "attention-op-dense-branch": lambda: attention.attention_op(
        ModelConfig(**_kw()), *_cpu(B=1, Sq=8, Skv=8, H=4, KVH=2, D=16), causal=True,
        q_offset=-1),
    "attention-op-flash-branch": lambda: attention.attention_op(
        ModelConfig(**_kw()), *_cpu(B=1, Sq=24, Skv=32, H=4, KVH=2, D=16), causal=True,
        q_offset=-8),
    "flash-op-negative": lambda: flash_attention_op(
        *_cpu(B=1, Sq=8, Skv=8, H=4, KVH=2, D=16), q_offset=-1),
    "flash-op-float": lambda: flash_attention_op(
        *_cpu(B=1, Sq=8, Skv=8, H=4, KVH=2, D=16), q_offset=1.5),
    "flash-op-bool": lambda: flash_attention_op(
        *_cpu(B=1, Sq=8, Skv=8, H=4, KVH=2, D=16), q_offset=True),
    "flash-op-int32-overflow": lambda: flash_attention_op(
        *_cpu(B=1, Sq=8, Skv=8, H=4, KVH=2, D=16), q_offset=2 ** 31 - 8),
    "flash-kernel-negative": lambda: flash_kernel.flash_attention_cuda(
        *(t.bfloat16() for t in _cpu(B=1, Sq=8, Skv=8, H=4, KVH=2, D=16)), q_offset=-1),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_bad_q_offset_is_refused_by_name(name):
    with pytest.raises(ValueError, match="q_offset"):
        REFUSALS[name]()
