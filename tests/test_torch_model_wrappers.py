"""Every argument check of the flash-attention and SSD ops and kernel
wrappers raises ``ValueError`` naming the offending shape, on the CPU,
before anything reaches a kernel; the kernel wrappers refuse CPU
tensors."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan.ops import ssd_chunked, ssd_scan_op
from repro_torch.models import attention
from repro_torch.models.common import ModelConfig


def _qkv(B=1, S=8, H=4, KVH=2, D=16, dtype=torch.float32, Skv=None):
    g = torch.Generator().manual_seed(0)
    q = torch.randn((B, S, H, D), generator=g).to(dtype)
    k = torch.randn((B, Skv or S, KVH, D), generator=g).to(dtype)
    v = torch.randn((B, Skv or S, KVH, D), generator=g).to(dtype)
    return q, k, v


def _ssd(b=1, S=8, H=4, P=4, G=2, N=4):
    g = torch.Generator().manual_seed(0)
    return (torch.randn((b, S, H, P), generator=g), torch.rand((b, S, H), generator=g),
            -torch.ones(H), torch.randn((b, S, G, N), generator=g),
            torch.randn((b, S, G, N), generator=g))


def _chunk_args(b=1, nc=2, Q=4, H=4, P=4, G=2, N=4, dtype=torch.float32):
    x, dt, A, B, C = _ssd(b, nc * Q, H, P, G, N)
    return (x.reshape(b, nc, Q, H, P).to(dtype), dt.reshape(b, nc, Q, H), A,
            B.reshape(b, nc, Q, G, N).to(dtype), C.reshape(b, nc, Q, G, N).to(dtype))


def _flash_cfg():
    return ModelConfig(name="t", kind="hybrid", num_layers=2, d_model=64, num_heads=4,
                       num_kv_heads=2, d_ff=8, vocab_size=8, flash_min_seq=4)


def _with(args, i, t):
    args = list(args)
    args[i] = t
    return args


BAD_CALLS = {
    # flash attention: the op checks the kernel's contract on both devices
    "heads-not-multiple-of-kv-heads": (
        lambda: flash_attention_op(*_qkv(H=4, KVH=3)), "multiple of k's 3"),
    "head-dim-not-multiple-of-16": (
        lambda: flash_attention_op(*_qkv(D=24)), "multiple of 16"),
    "head-dim-above-256": (
        lambda: flash_attention_op(*_qkv(D=272)), "multiple of 16"),
    "qkv-dtypes-differ": (
        lambda: flash_attention_op(*_with(_qkv(), 1, _qkv()[1].bfloat16())),
        "share one dtype"),
    "qkv-float64": (
        lambda: flash_attention_op(*_qkv(dtype=torch.float64)), "dtype in"),
    "k-v-shapes-differ": (
        lambda: flash_attention_op(*_with(_qkv(), 2, _qkv(Skv=9)[2])), "Skv"),
    "q-3d": (
        lambda: flash_attention_op(*_with(_qkv(), 0, _qkv()[0][0])), "4-D"),
    "q-not-contiguous": (
        lambda: flash_attention_op(*_with(_qkv(), 0, _qkv()[0].transpose(1, 2))),
        "contiguous"),
    "flash-branch-negative-q-offset": (
        lambda: attention.attention_op(_flash_cfg(), *_qkv(S=8), causal=True, q_offset=-2),
        "q_offset"),
    # f32 passes the dtype check (the kernel has an f32 instance) and is
    # refused only for lying on the CPU
    "flash-kernel-f32": (
        lambda: flash_kernel.flash_attention_cuda(*_qkv()), "CUDA tensors"),
    "flash-kernel-float16": (
        lambda: flash_kernel.flash_attention_cuda(*_qkv(dtype=torch.float16)), "dtype in"),
    "flash-kernel-on-cpu": (
        lambda: flash_kernel.flash_attention_cuda(*_qkv(dtype=torch.bfloat16)),
        "CUDA tensors"),
    # the SSD op and the chunk kernel
    "ssd-dt-shape": (
        lambda: ssd_scan_op(*_with(_ssd(), 1, _ssd()[1][:, :-1]), chunk=4), "dt"),
    "ssd-A-shape": (
        lambda: ssd_scan_op(*_with(_ssd(), 2, -torch.ones(3)), chunk=4), "A"),
    "ssd-B-C-shapes-differ": (
        lambda: ssd_scan_op(*_with(_ssd(), 4, _ssd(N=5)[4]), chunk=4), "C"),
    "ssd-heads-not-multiple-of-groups": (
        lambda: ssd_chunked(*_ssd(H=4, G=3), chunk=4), "groups"),
    "ssd-chunk-zero": (
        lambda: ssd_scan_op(*_ssd(), chunk=0), "chunk"),
    "ssd-x-float64": (
        lambda: ssd_scan_op(*_with(_ssd(), 0, _ssd()[0].double()), chunk=4), "dtype in"),
    "chunk-B-dtype-differs-from-x": (
        lambda: ssd_kernel.ssd_chunk_cuda(*_with(_chunk_args(), 3, _chunk_args()[3].double())),
        "Bq"),
    "chunk-dt-not-f32": (
        lambda: ssd_kernel.ssd_chunk_cuda(*_with(_chunk_args(), 1,
                                                 _chunk_args()[1].bfloat16())), "dtq"),
    "chunk-dt-chunks-mismatch": (
        lambda: ssd_kernel.ssd_chunk_cuda(*_with(_chunk_args(), 1,
                                                 _chunk_args(nc=3)[1])), "dtq"),
    "chunk-B-rows-mismatch": (
        lambda: ssd_kernel.ssd_chunk_cuda(*_with(_chunk_args(), 3, _chunk_args(Q=5)[3])),
        "Bq"),
    "chunk-groups-not-dividing-heads": (
        lambda: ssd_kernel.ssd_chunk_cuda(*_chunk_args(H=4, G=3)), "groups"),
    "chunk-kernel-on-cpu": (
        lambda: ssd_kernel.ssd_chunk_cuda(*_chunk_args()), "CUDA tensors"),
}


@pytest.mark.parametrize("name", sorted(BAD_CALLS))
def test_bad_call_raises_value_error(name):
    call, match = BAD_CALLS[name]
    with pytest.raises(ValueError, match=match):
        call()


def test_good_calls_pass_the_checks():
    q, k, v = _qkv()
    assert flash_attention_op(q, k, v).shape == q.shape
    y, st = ssd_scan_op(*_ssd(S=7), chunk=4)
    assert y.shape == (1, 7, 4, 4) and st.shape == (1, 4, 4, 4)
