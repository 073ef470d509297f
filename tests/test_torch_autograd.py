"""Gradients of the port's kernel ops and of the expert-parallel dispatch.

    PYTHONPATH=src python -m pytest -q tests/test_torch_autograd.py

(a) Each autograd Function on the CPU against torch autograd of its
    plain version on the same inputs: flash attention (the plain backward
    of ``models.flash``, with its blockwise log-sum-exp) in f32 within
    1e-5 relative to the largest entry; the SSD chunk bit for bit (its
    backward is autograd of the same plain terms); pack and unpack bit
    for bit where every row is read once, and the pack within f32
    rounding where rows repeat (the MoE scatter), its repeated rows
    summed in f32 in a fixed order.
(b) ``ep_moe_ffn``'s gradients in ``direct`` and ``blob`` on a stacked
    mesh against the JAX package's on 8 host devices (one subprocess),
    at a capacity that drops no unit and at one that drops in every
    mode, within 2e-4 atol and rtol, the bound of
    ``tests/test_multidevice.py``'s dispatch gradients.
(c) ``cuda``: on the card, each Function's gradients against the CPU's
    and the launches of its backward (pack's backward launches the unpack
    kernel, and the reverse); skipped without a CUDA device.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro_torch.kernels.blob_pack.ops import blob_pack, sum_rows
from repro_torch.kernels.blob_pack.ref import blob_pack_ref
from repro_torch.kernels.blob_unpack.ops import blob_unpack
from repro_torch.kernels.blob_unpack.ref import blob_unpack_ref
from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.kernels.flash_attention.ref import _probs, flash_ref
from repro_torch.kernels.ssd_scan.ops import SSDChunk
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_ref
from repro_torch.launch import mesh as M
from repro_torch.models.flash import flash_bwd, flash_lse
from repro_torch.shuffle import api
from repro_torch.shuffle.binning import bin_pack, sorted_order

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLASH_TOL = 1e-5
GRAD_TOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _worst(got, want):
    return float((got - want).abs().max() / want.abs().max())


# ---------------------------------------------------------------------------
# (a) the Functions against autograd of their plain versions
# ---------------------------------------------------------------------------

# (B, S, H, KVH, D, causal, q_chunk, kv_chunk): MHA, GQA, MQA, non-causal,
# ragged lengths, several q and kv blocks (and the default blocks)
FLASH_CASES = [
    (2, 48, 4, 4, 16, True, 16, 32),
    (1, 100, 4, 2, 32, True, 32, 16),
    (1, 77, 8, 1, 16, False, 16, 32),
    (2, 130, 4, 2, 48, True, 512, 1024),
    (1, 600, 2, 1, 16, True, 512, 1024),
]


def _flash_inputs(B, S, H, KVH, D, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, S, h, D, generator=g) for h in (H, KVH, KVH))
    return q, k, v, torch.randn(B, S, H, D, generator=g)


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_backward_matches_autograd_of_the_plain_version(case):
    B, S, H, KVH, D, causal, qc, kc = case
    q, k, v, dout = _flash_inputs(B, S, H, KVH, D)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_ref(*leaves, causal=causal), leaves, dout)
    out = flash_ref(q, k, v, causal=causal)
    got = flash_bwd(q, k, v, out, dout, causal=causal, q_chunk=qc, kv_chunk=kc)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and _worst(g, w) < FLASH_TOL
    # through the op's Function, with the default blocks
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(flash_attention_op(*leaves, causal=causal), leaves, dout)
    for g, w in zip(got, want):
        assert _worst(g, w) < FLASH_TOL


def test_flash_lse_matches_the_dense_softmax():
    B, S, H, KVH, D = 1, 70, 4, 2, 16
    q, k, _, _ = _flash_inputs(B, S, H, KVH, D, seed=1)
    for causal in (True, False):
        lse = flash_lse(q, k, causal=causal, q_chunk=16, kv_chunk=32)
        scores = torch.einsum("bqhgd,bkhd->bhgqk", q.reshape(B, S, KVH, 2, D), k) / D ** 0.5
        if causal:
            scores = scores.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), -1e30)
        np.testing.assert_allclose(lse.numpy(), torch.logsumexp(scores, -1).numpy(),
                                   atol=1e-5, rtol=0)
        probs = _probs(q, k, causal=causal)
        np.testing.assert_allclose(torch.exp(scores - lse[..., None]).numpy(), probs.numpy(),
                                   atol=1e-6, rtol=0)


def test_flash_backward_keeps_the_dtypes_and_the_scale():
    q, k, v, dout = _flash_inputs(1, 40, 4, 2, 16, seed=2)
    q16, k16, v16 = (t.to(torch.bfloat16).requires_grad_() for t in (q, k, v))
    out = flash_attention_op(q16, k16, v16, causal=True, scale=0.3)
    grads = torch.autograd.grad(out, (q16, k16, v16), dout.to(torch.bfloat16))
    assert all(g.dtype == torch.bfloat16 for g in grads)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_ref(*leaves, causal=True, scale=0.3), leaves, dout)
    got = flash_bwd(q, k, v, flash_ref(q, k, v, causal=True, scale=0.3), dout,
                    causal=True, scale=0.3)
    for g, w in zip(got, want):
        assert _worst(g, w) < FLASH_TOL


def _ssd_inputs(b, nc, Q, H, P, G, N, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, nc, Q, H, P, generator=g),
            torch.rand(b, nc, Q, H, generator=g) * 0.5,
            -torch.rand(H, generator=g) - 0.1,
            torch.randn(b, nc, Q, G, N, generator=g),
            torch.randn(b, nc, Q, G, N, generator=g))


@pytest.mark.parametrize("shape", [(2, 3, 8, 4, 6, 4, 5), (1, 2, 16, 4, 8, 2, 8),
                                   (1, 1, 12, 2, 4, 1, 3)], ids=str)
def test_ssd_chunk_backward_is_autograd_of_the_plain_terms(shape):
    inputs = _ssd_inputs(*shape)
    g = torch.Generator().manual_seed(9)
    outs = ssd_chunk_ref(*inputs)
    douts = [torch.randn(o.shape, generator=g) for o in outs]
    a = [t.clone().requires_grad_() for t in inputs]
    want = torch.autograd.grad(ssd_chunk_ref(*a), a, douts)
    b = [t.clone().requires_grad_() for t in inputs]
    got = torch.autograd.grad(SSDChunk.apply(*b), b, douts)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    # an output no one reads (y_decay) sends no gradient
    c = [t.clone().requires_grad_() for t in inputs]
    y_intra, states, a_total, _ = SSDChunk.apply(*c)
    got = torch.autograd.grad((y_intra * douts[0]).sum() + (states * douts[1]).sum()
                              + (a_total * douts[2]).sum(), c)
    d = [t.clone().requires_grad_() for t in inputs]
    y_intra, states, a_total, _ = ssd_chunk_ref(*d)
    want = torch.autograd.grad((y_intra * douts[0]).sum() + (states * douts[1]).sum()
                               + (a_total * douts[2]).sum(), d)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def _ssd_terms_f64(xq, dtq, A, Bq, Cq):
    """The chunk terms in f64 with the JAX package's ``where`` after the
    exponential, which cannot overflow in f64 at these sizes."""
    b, nc, Q, H, P = xq.shape
    a = torch.cumsum(dtq * A, dim=2)
    diff = a[:, :, :, None, :] - a[:, :, None, :, :]
    causal = torch.ones(Q, Q, dtype=torch.bool).tril()[None, None, :, :, None]
    decay = torch.where(causal, torch.exp(diff), 0.0)
    scores = torch.einsum("bcign,bcjgn->bcijg", Cq, Bq) * decay * dtq[:, :, None]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores, xq)
    w = torch.exp(a[:, :, -1:, :] - a) * dtq
    states = torch.einsum("bcjhp,bcjhn->bchpn", xq * w[..., None], Bq)
    return y_intra, states, a[:, :, -1], torch.exp(a)


def test_ssd_chunk_gradient_is_finite_where_the_masked_decay_overflows():
    """A chunk of 128 steps of decay 1 a step: exp(diff) passes f32's
    range in the masked half. Autograd of ``where(causal, exp(diff), 0)``
    gives nan there (0 * inf), as JAX's autodiff of the same expression
    does; the port's plain terms mask before the exponential."""
    b, nc, Q, H, P, N = 1, 1, 128, 2, 4, 3
    g = torch.Generator().manual_seed(5)
    inputs = (torch.randn(b, nc, Q, H, P, generator=g), torch.ones(b, nc, Q, H),
              -torch.ones(H), torch.randn(b, nc, Q, H, N, generator=g),
              torch.randn(b, nc, Q, H, N, generator=g))
    douts = [torch.randn(o.shape, generator=g) for o in ssd_chunk_ref(*inputs)]
    leaves = [t.clone().requires_grad_() for t in inputs]
    got = torch.autograd.grad(SSDChunk.apply(*leaves), leaves, douts)
    f64 = [t.double().requires_grad_() for t in inputs]
    want = torch.autograd.grad(_ssd_terms_f64(*f64), f64, [d.double() for d in douts])
    for x, y in zip(got, want):
        assert bool(torch.isfinite(x).all())
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(y.abs().max()))


def _moe_keys(T, k, E, seed=0):
    rng = np.random.default_rng(seed)
    p = np.linspace(3, 1, E) / np.linspace(3, 1, E).sum()        # skewed: drops
    return torch.from_numpy(rng.choice(E, size=T * k, p=p).astype(np.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cap", [4, 16, 64])
def test_pack_and_unpack_backward_where_each_row_is_read_once(dtype, cap):
    T, k, E, d = 30, 2, 6, 7
    keys = _moe_keys(T, k, E)
    order, starts, counts = sorted_order(keys, E)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(T * k, d, generator=g).to(dtype)
    dout = torch.randn(E, cap, d, generator=g).to(dtype)
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    want, = torch.autograd.grad(blob_pack_ref(a, order, starts, counts, capacity=cap), a, dout)
    got, = torch.autograd.grad(blob_pack(b, order, starts, counts, capacity=cap), b, dout)
    assert torch.equal(got, want)
    pk = bin_pack(keys, E, cap)
    buf = torch.randn(E, cap, d, generator=g).to(dtype)
    dy = torch.randn(T * k, d, generator=g).to(dtype)
    a, b = buf.clone().requires_grad_(), buf.clone().requires_grad_()
    want, = torch.autograd.grad(blob_unpack_ref(a, pk.slot, pk.valid), a, dy)
    got, = torch.autograd.grad(blob_unpack(b, pk.slot, pk.valid), b, dy)
    assert torch.equal(got, want)


@pytest.mark.parametrize("cap", [4, 16, 64])
def test_pack_backward_sums_repeated_rows_in_f32(cap):
    """The MoE scatter: blob_pack(x, unit_tok[order], ...) reads each
    token's row top_k times."""
    T, k, E, d = 30, 3, 6, 7
    keys = _moe_keys(T, k, E, seed=2)
    order, starts, counts = sorted_order(keys, E)
    tok = torch.arange(T, dtype=torch.int32).repeat_interleave(k)[order]
    g = torch.Generator().manual_seed(3)
    x = torch.randn(T, d, generator=g)
    dout = torch.randn(E, cap, d, generator=g)
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    want, = torch.autograd.grad(blob_pack_ref(a, tok, starts, counts, capacity=cap), a, dout)
    got, = torch.autograd.grad(blob_pack(b, tok, starts, counts, capacity=cap), b, dout)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=1e-6)
    # bf16: the f32 sum of the same bf16 units in the order of the
    # positions, rounded once
    x16, d16 = x.to(torch.bfloat16).requires_grad_(), dout.to(torch.bfloat16)
    got, = torch.autograd.grad(blob_pack(x16, tok, starts, counts, capacity=cap), x16, d16)
    units = torch.zeros(tok.shape[0], d)
    r = torch.arange(cap)
    live = r[None] < torch.clamp(counts, max=cap)[:, None]
    units[(starts[:, None] + r)[live].long()] = d16.float()[live]
    want = torch.zeros(T, d)
    for u in range(tok.shape[0]):
        want[tok[u]] += units[u]
    assert got.dtype == torch.bfloat16 and torch.equal(got, want.to(torch.bfloat16))


def test_sum_rows_is_a_scatter_where_rows_are_named_once():
    g = torch.randn(5, 3)
    out = sum_rows(g, torch.tensor([4, 0, 2, 6, 1], dtype=torch.int32), 8)
    assert torch.equal(out[[4, 0, 2, 6, 1]], g) and not out[[3, 5, 7]].any()


def test_adjoints_refuse_what_is_not_a_sorted_order():
    x = torch.randn(6, 2, requires_grad=True)
    order = torch.arange(6, dtype=torch.int32)
    starts, counts = torch.tensor([0, 2], dtype=torch.int32), torch.tensor(
        [4, 3], dtype=torch.int32)                        # bins share positions 2, 3
    out = blob_pack(x, order, starts, counts, capacity=4)
    with pytest.raises(ValueError, match="share positions"):
        out.sum().backward()
    buf = torch.randn(2, 3, 2, requires_grad=True)
    slot = torch.tensor([0, 4, 4], dtype=torch.int32)    # slot 4 read twice
    y = blob_unpack(buf, slot, torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError, match="read one slot"):
        y.sum().backward()


def test_metadata_packs_carry_no_gradient():
    keys = _moe_keys(10, 2, 4)
    order, starts, counts = sorted_order(keys, 4)
    meta = blob_pack((keys + 1)[:, None].contiguous(), order, starts, counts, capacity=8)
    assert meta.dtype == torch.int32 and not meta.requires_grad


# ---------------------------------------------------------------------------
# (b) ep_moe_ffn's gradients against the JAX package's
# ---------------------------------------------------------------------------

E, K, D_, DE, T = 8, 2, 12, 16, 128
EP_GRAD_CASES = {"direct-no-drop": ("direct", 16.0), "blob-no-drop": ("blob", 16.0),
                 "direct-drops": ("direct", 1.0), "blob-drops": ("blob", 1.0)}

JAX_EP_GRADS = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.launch.mesh import make_test_mesh
from repro.shuffle.api import ShuffleConfig, ep_moe_ffn
cases, folder = json.loads(sys.argv[1]), sys.argv[2]
mesh = make_test_mesh(devices=8)
a = np.load(f"{folder}/in.npz")
args = [jnp.asarray(a[n]) for n in ("x", "wr", "wg", "wu", "wd")]
for name, (mode, cf) in cases.items():
    cfg = ShuffleConfig(mode=mode, capacity_factor=cf)
    def loss(x, wr, wg, wu, wd):
        y, aux, dg = ep_moe_ffn(x, wr, wg, wu, wd, top_k=2, cfg=cfg, mesh=mesh,
                                compute_dtype=jnp.float32)
        return jnp.sum(jnp.tanh(y)) + aux, dg.dropped
    (l, dropped), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4),
                                                 has_aux=True))(*args)
    np.savez(f"{folder}/{name}.npz", loss=np.asarray(l), dropped=np.asarray(dropped),
             **{f"g{i}": np.asarray(t) for i, t in enumerate(g)})
"""


def _ep_grad_inputs():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((T, D_)).astype(np.float32)
    wr = (0.5 * rng.standard_normal((D_, E))).astype(np.float32)
    wr[:, 0] += 1.0                                     # skewed: drops at 1.0
    w = [(rng.standard_normal(s) / np.sqrt(s[1])).astype(np.float32)
         for s in ((E, D_, DE), (E, D_, DE), (E, DE, D_))]
    return [x, wr, *w]


@pytest.fixture(scope="module")
def jax_ep_grads(tmp_path_factory):
    folder = tmp_path_factory.mktemp("ep_grads")
    x, wr, wg, wu, wd = _ep_grad_inputs()
    np.savez(folder / "in.npz", x=x, wr=wr, wg=wg, wu=wu, wd=wd)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_EP_GRADS),
                        json.dumps(EP_GRAD_CASES), str(folder)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return {name: dict(np.load(folder / f"{name}.npz")) for name in EP_GRAD_CASES}


@pytest.mark.parametrize("name", sorted(EP_GRAD_CASES))
def test_ep_moe_ffn_gradients_match_jax(jax_ep_grads, name):
    mode, cf = EP_GRAD_CASES[name]
    want = jax_ep_grads[name]
    leaves = [torch.from_numpy(a).requires_grad_() for a in _ep_grad_inputs()]
    y, aux, dg = api.ep_moe_ffn(*leaves, top_k=K, cfg=api.ShuffleConfig(
        mode=mode, capacity_factor=cf), mesh=M.make_test_mesh(devices=8),
        compute_dtype=torch.float32)
    loss = torch.tanh(y).sum() + aux
    np.testing.assert_allclose(float(loss.detach()), float(want["loss"]), rtol=1e-5)
    assert int(dg.dropped) == int(want["dropped"])
    assert (int(dg.dropped) > 0) == (cf == 1.0)
    for i, g in enumerate(torch.autograd.grad(loss, leaves)):
        np.testing.assert_allclose(g.numpy(), want[f"g{i}"], atol=GRAD_TOL, rtol=GRAD_TOL)


def test_dense_dispatch_gradients_match_the_flat_dispatch_without_drops():
    """The dense layer's pack and unpack Functions against the stacked
    exchange's transposes, where no unit drops."""
    grads = {}
    for mode in ("dense", "direct"):
        leaves = [torch.from_numpy(a).requires_grad_() for a in _ep_grad_inputs()]
        y, aux, _ = api.ep_moe_ffn(*leaves, top_k=K, cfg=api.ShuffleConfig(
            mode=mode, capacity_factor=16.0), mesh=M.make_test_mesh(devices=8),
            compute_dtype=torch.float32)
        grads[mode] = torch.autograd.grad(torch.tanh(y).sum() + aux, leaves)
    for a, b in zip(grads["dense"], grads["direct"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=GRAD_TOL, rtol=GRAD_TOL)


# ---------------------------------------------------------------------------
# (c) on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_pack_and_unpack_backwards_launch_each_other_on_the_card(cuda):
    from repro_torch.kernels.blob_pack.kernel import PACK
    from repro_torch.kernels.blob_unpack.kernel import UNPACK

    T, k, Ex, cap, d = 500, 4, 16, 96, 64
    keys = _moe_keys(T, k, Ex).to(cuda)
    order, starts, counts = sorted_order(keys, Ex)
    tok = torch.arange(T, dtype=torch.int32, device=cuda).repeat_interleave(k)[order]
    x = torch.randn(T, d, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    out = blob_pack(x, tok, starts, counts, capacity=cap)
    before = (PACK.launches, UNPACK.launches)
    got, = torch.autograd.grad(out, x, torch.ones_like(out))
    assert (PACK.launches - before[0], UNPACK.launches - before[1]) == (0, 1)
    xc = x.detach().cpu().requires_grad_()
    want, = torch.autograd.grad(blob_pack(xc, tok.cpu(), starts.cpu(), counts.cpu(),
                                          capacity=cap), xc, torch.ones(out.shape,
                                                                        dtype=torch.bfloat16))
    assert torch.equal(got.cpu(), want)
    pk = bin_pack(keys, Ex, cap)
    buf = torch.randn(Ex, cap, d, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    y = blob_unpack(buf, pk.slot, pk.valid)
    before = (PACK.launches, UNPACK.launches)
    got, = torch.autograd.grad(y, buf, torch.ones_like(y))
    assert (PACK.launches - before[0], UNPACK.launches - before[1]) == (1, 0)
    bc = buf.detach().cpu().requires_grad_()
    want, = torch.autograd.grad(blob_unpack(bc, pk.slot.cpu(), pk.valid.cpu()), bc,
                                torch.ones(y.shape, dtype=torch.bfloat16))
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("H,KVH,D", [(8, 8, 128), (4, 1, 256), (4, 4, 80)])
def test_flash_gradients_on_the_card_match_the_cpu(cuda, H, KVH, D):
    q, k, v, dout = _flash_inputs(1, 1100, H, KVH, D, seed=4)
    cpu = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_ref(*cpu, causal=True), cpu, dout)
    dev = [t.to(cuda).requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(flash_attention_op(*dev, causal=True), dev, dout.to(cuda))
    for g, w in zip(got, want):
        assert _worst(g.cpu(), w) < 1e-4
