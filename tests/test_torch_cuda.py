"""The Hopper kernels against their plain versions on the card, bit for
bit. These need a CUDA device and nvcc; elsewhere they skip.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.interop import assert_same_bits
from repro_torch.kernels.blob_codec import kernel as codec_kernel
from repro_torch.kernels.blob_codec import ref as codec_ref
from repro_torch.kernels.blob_pack import kernel as pack_kernel
from repro_torch.kernels.blob_pack.ref import blob_pack_ref
from repro_torch.kernels.blob_unpack import kernel as unpack_kernel
from repro_torch.kernels.blob_unpack.ref import blob_unpack_ref
from repro_torch.shuffle import api
from repro_torch.shuffle.binning import bin_pack, sorted_order

pytestmark = pytest.mark.cuda

# (rows T, width d, bins, capacity, dtype): 16-byte and narrow row
# accesses, overflow, a capacity no rows-per-block value divides
CASES = [
    (2000, 64, 8, 512, torch.float32),
    (2000, 64, 8, 512, torch.bfloat16),
    (2000, 7, 8, 512, torch.int8),
    (2000, 33, 8, 512, torch.int32),
    (2000, 64, 8, 100, torch.bfloat16),
    (999, 20, 16, 37, torch.float32),
]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels run only on the card")
    return torch.Generator(device="cuda").manual_seed(0)


def _inputs(gen, T, d, bins, cap, dtype):
    if dtype in (torch.int8, torch.int32):
        x = torch.randint(-100, 100, (T, d), generator=gen, device="cuda",
                          dtype=dtype)
    else:
        x = torch.randn((T, d), generator=gen, device="cuda").to(dtype)
    keys = torch.randint(0, bins // 2 + 1, (T,), generator=gen, device="cuda",
                         dtype=torch.int32)
    return x, keys


@pytest.mark.parametrize("T,d,bins,cap,dtype", CASES)
@pytest.mark.parametrize("rows_per_block", [16, 5])
def test_pack_unpack_kernels_match_plain(gen, T, d, bins, cap, dtype,
                                         rows_per_block):
    x, keys = _inputs(gen, T, d, bins, cap, dtype)
    order, starts, counts = sorted_order(keys, bins)
    buf = pack_kernel.blob_pack_fused_cuda(x, order, starts, counts,
                                           capacity=cap,
                                           rows_per_block=rows_per_block)
    assert_same_bits(buf, blob_pack_ref(x, order, starts, counts, capacity=cap))
    p = bin_pack(keys, bins, cap)
    out = unpack_kernel.blob_unpack_fused_cuda(buf, p.slot, p.valid,
                                               rows_per_block=rows_per_block)
    assert_same_bits(out, blob_unpack_ref(buf, p.slot, p.valid))


@pytest.mark.parametrize("T,d,bins,cap,dtype", [
    c for c in CASES if c[4] in (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("rows_per_block", [16, 5])
def test_codec_kernels_match_plain(gen, T, d, bins, cap, dtype,
                                   rows_per_block):
    x, keys = _inputs(gen, T, d, bins, cap, dtype)
    order, starts, counts = sorted_order(keys, bins)
    q, s = codec_kernel.compress_pack_fused_cuda(
        x, order, starts, counts, capacity=cap, rows_per_block=rows_per_block)
    assert_same_bits((q, s), codec_ref.compress_pack_ref(
        x, order, starts, counts, capacity=cap))
    p = bin_pack(keys, bins, cap)
    out = codec_kernel.unpack_decompress_fused_cuda(
        q, s, p.slot, p.valid, rows_per_block=rows_per_block)
    assert_same_bits(out, codec_ref.unpack_decompress_ref(q, s, p.slot, p.valid))


def test_entry_points_on_cuda_match_cpu(gen):
    x, keys = _inputs(gen, 3000, 48, 12, 512, torch.bfloat16)
    kw = dict(num_bins=12, capacity=512)
    for t in (x, keys):
        assert t.is_cuda
    buf, _ = api.blob_pack_fused(x, keys, **kw)
    assert_same_bits(buf, api.blob_pack_fused(x.cpu(), keys.cpu(), **kw)[0])
    assert_same_bits(api.unpack_from_keys(buf, keys, **kw), x)
    (q, s), _ = api.compress_pack_fused(x, keys, **kw)
    assert_same_bits((q, s),
                     api.compress_pack_fused(x.cpu(), keys.cpu(), **kw)[0])
    assert_same_bits(api.unpack_decompress_fused(q, s, keys, **kw),
                     api.unpack_decompress_fused(q.cpu(), s.cpu(), keys.cpu(),
                                                 **kw))
