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
from repro_torch.launch.mesh import stacked_mesh
from repro_torch.shuffle import api, dispatch
from repro_torch.shuffle.binning import bin_pack, sorted_order
from repro_torch.shuffle.exchange import for_mesh

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


def test_stacked_binning_on_cuda_matches_cpu(gen):
    """One pack and one unpack launch over every rank, the (U, 1) int32
    metadata rows and the drop bin included, bit for bit the plain
    versions on the same tensors on the CPU."""
    R, U, T, nb, cap, d = 8, 3072, 512, 17, 240, 64
    keys = torch.randint(0, nb, (R, U), generator=gen, device="cuda",
                         dtype=torch.int32)
    rows = torch.randn((R, T, d), generator=gen, device="cuda").to(torch.bfloat16)
    unit_row = torch.arange(T, dtype=torch.int32, device="cuda").repeat_interleave(U // T)
    buf = torch.randn((R, nb, cap, d), generator=gen, device="cuda").to(torch.bfloat16)
    got, want = (dispatch.StackedBinning(keys, nb, cap),
                 dispatch.StackedBinning(keys.cpu(), nb, cap))
    for bins in (None, nb - 1):
        assert_same_bits(got.scatter(rows, unit_row, bins=bins),
                         want.scatter(rows.cpu(), unit_row.cpu(), bins=bins))
        assert_same_bits(got.scatter(keys + 1, bins=bins),
                         want.scatter(keys.cpu() + 1, bins=bins))
    assert_same_bits(got.gather(buf), want.gather(buf.cpu()))


@pytest.mark.parametrize("mode", ["flat", "blob", "blob_int8"])
def test_stacked_dispatch_on_cuda_matches_cpu(gen, mode, monkeypatch):
    """The dispatch on a stacked P 2 x M 4 mesh: every bin it scatters is
    bit for bit the CPU's; the output within f32 1e-5 (cuBLAS and the CPU
    sum the expert products in other orders); the diagnostics equal."""
    scattered = {"cuda": [], "cpu": []}

    class Recording(dispatch.StackedBinning):
        def scatter(self, *args, **kwargs):
            out = super().scatter(*args, **kwargs)
            scattered[out.device.type].append(out)
            return out

    monkeypatch.setattr(dispatch, "StackedBinning", Recording)
    mesh = stacked_mesh(pod=2, model=4)
    R, T_loc, k, E, d, de = 8, 64, 2, 16, 32, 64
    x = torch.randn((R, T_loc, d), generator=gen, device="cuda")
    sel_idx = torch.stack([torch.randperm(E, generator=gen, device="cuda")[:k]
                           for _ in range(R * T_loc)]).view(R, T_loc, k).to(torch.int32)
    sel_w = torch.rand((R, T_loc, k), generator=gen, device="cuda")
    w = [torch.randn(s, generator=gen, device="cuda") / s[1] ** 0.5
         for s in ((E, d, de), (E, d, de), (E, de, d))]
    outs = {}
    for dev in ("cuda", "cpu"):
        ffn = api._expert_ffn(*(t.to(dev) for t in w), torch.float32)

        def expert_fn(t):
            return ffn(t.reshape(-1, *t.shape[2:])).view(*t.shape[:3], -1)

        args = (x.to(dev), sel_idx.to(dev), sel_w.to(dev), expert_fn)
        common = dict(exchange=for_mesh(mesh), num_experts=E, capacity_factor=1.0, d_out=d)
        if mode == "flat":
            outs[dev] = dispatch.flat_dispatch_combine(*args, ep_axes=("pod", "model"),
                                                       **common)
        else:
            outs[dev] = dispatch.blob_dispatch_combine(
                *args, pod_axis="pod", inner_axes=("model",),
                compress_dcn=mode == "blob_int8", **common)
    assert len(scattered["cuda"]) == len(scattered["cpu"]) > 0
    for a, b in zip(scattered["cuda"], scattered["cpu"]):
        assert_same_bits(a, b)
    (y, dg), (y_w, dg_w) = outs["cuda"], outs["cpu"]
    torch.testing.assert_close(y.cpu(), y_w, atol=1e-5, rtol=0)
    for a, b in zip(dg, dg_w):
        assert torch.equal(a.cpu(), b)
