"""Every argument check of the port's blob ops and kernel wrappers raises
``ValueError`` naming the offending shape, on the CPU, before anything
reaches a kernel; the kernel wrappers refuse CPU tensors."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build
from repro_torch.kernels.blob_codec import kernel as codec_kernel
from repro_torch.kernels.blob_codec import ops as codec
from repro_torch.kernels.blob_pack import kernel as pack_kernel
from repro_torch.kernels.blob_pack import ops as pack
from repro_torch.kernels.blob_unpack import kernel as unpack_kernel
from repro_torch.kernels.blob_unpack import ops as unpack
from repro_torch.shuffle import binning

T, D, BINS, CAP = 40, 6, 4, 16


def _good():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((T, D), generator=g)
    keys = torch.randint(0, BINS, (T,), generator=g, dtype=torch.int32)
    order, starts, counts = binning.sorted_order(keys, BINS)
    p = binning.bin_pack(keys, BINS, CAP)
    buf = pack.blob_pack(x, order, starts, counts, capacity=CAP)
    q, s = codec.compress_pack(x, order, starts, counts, capacity=CAP)
    return dict(x=x, keys=keys, order=order, starts=starts, counts=counts,
                slot=p.slot, valid=p.valid, buf=buf, q=q, s=s)


def _pack(a, **kw):
    args = dict(x=a["x"], order=a["order"], starts=a["starts"],
                counts=a["counts"])
    args.update(kw)
    return pack.blob_pack(args["x"], args["order"], args["starts"],
                          args["counts"], capacity=args.get("capacity", CAP))


BAD_CALLS = {
    "keys-above-range": lambda a: pack.blob_pack_fused(
        a["x"], a["keys"] + BINS, num_bins=BINS, capacity=CAP),
    "keys-negative": lambda a: unpack.unpack_from_keys(
        a["buf"], a["keys"] - 1, num_bins=BINS, capacity=CAP),
    "keys-float": lambda a: codec.compress_pack_fused(
        a["x"], a["keys"].float(), num_bins=BINS, capacity=CAP),
    "keys-2d": lambda a: codec.unpack_decompress_fused(
        a["q"], a["s"], a["keys"][None], num_bins=BINS, capacity=CAP),
    "x-float64": lambda a: _pack(a, x=a["x"].double()),
    "x-1d": lambda a: _pack(a, x=a["x"][:, 0].contiguous()),
    "x-not-contiguous": lambda a: _pack(a, x=a["x"].t().contiguous().t()),
    "x-no-width": lambda a: _pack(a, x=a["x"][:, :0].contiguous()),
    "order-int64": lambda a: _pack(a, order=a["order"].long()),
    "order-out-of-range": lambda a: _pack(a, order=a["order"] + 1),
    "starts-counts-shapes": lambda a: _pack(a, starts=a["starts"][:-1]),
    "capacity-zero": lambda a: _pack(a, capacity=0),
    "devices-differ": lambda a: _pack(a, order=a["order"].to("meta")),
    "codec-x-int32": lambda a: codec.compress_pack(
        a["x"].int(), a["order"], a["starts"], a["counts"], capacity=CAP),
    "buf-2d": lambda a: unpack.blob_unpack(
        a["buf"].reshape(-1, D), a["slot"], a["valid"]),
    "buf-float64": lambda a: unpack.blob_unpack(
        a["buf"].double(), a["slot"], a["valid"]),
    "slot-int64": lambda a: unpack.blob_unpack(
        a["buf"], a["slot"].long(), a["valid"]),
    "valid-not-bool": lambda a: unpack.blob_unpack(
        a["buf"], a["slot"], a["valid"].to(torch.uint8)),
    "slot-valid-lengths": lambda a: unpack.blob_unpack(
        a["buf"], a["slot"], a["valid"][:-1]),
    "layout-geometry": lambda a: unpack.unpack_from_keys(
        a["buf"], a["keys"], num_bins=BINS, capacity=CAP + 1),
    "q-not-int8": lambda a: codec.unpack_decompress(
        a["q"].int(), a["s"], a["slot"], a["valid"]),
    "scales-shape": lambda a: codec.unpack_decompress(
        a["q"], a["s"][:, :-1].contiguous(), a["slot"], a["valid"]),
    "q-layout-geometry": lambda a: codec.unpack_decompress_fused(
        a["q"], a["s"], a["keys"], num_bins=BINS + 1, capacity=CAP),
    # the kernel wrappers take CUDA tensors only
    "pack-kernel-on-cpu": lambda a: pack_kernel.blob_pack_fused_cuda(
        a["x"], a["order"], a["starts"], a["counts"], capacity=CAP),
    "unpack-kernel-on-cpu": lambda a: unpack_kernel.blob_unpack_fused_cuda(
        a["buf"], a["slot"], a["valid"]),
    "compress-kernel-on-cpu": lambda a: codec_kernel.compress_pack_fused_cuda(
        a["x"], a["order"], a["starts"], a["counts"], capacity=CAP),
    "decompress-kernel-on-cpu": lambda a:
        codec_kernel.unpack_decompress_fused_cuda(
            a["q"], a["s"], a["slot"], a["valid"]),
}


@pytest.mark.parametrize("case", list(BAD_CALLS))
def test_bad_call_raises_value_error_with_shape(case):
    launches = [k.launches for k in (pack_kernel.PACK, unpack_kernel.UNPACK,
                                     codec_kernel.COMPRESS_PACK,
                                     codec_kernel.UNPACK_DECOMPRESS)]
    with pytest.raises(ValueError,
                       match="capacity" if case == "capacity-zero" else "shape"):
        BAD_CALLS[case](_good())
    assert launches == [k.launches for k in (
        pack_kernel.PACK, unpack_kernel.UNPACK, codec_kernel.COMPRESS_PACK,
        codec_kernel.UNPACK_DECOMPRESS)]


def test_good_calls_pass_the_checks():
    a = _good()
    assert _pack(a).shape == (BINS, CAP, D)
    assert unpack.blob_unpack(a["buf"], a["slot"], a["valid"]).shape == (T, D)


def test_nvcc_build_is_sm90a_with_ieee_math():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    path = _build.library_path("blob_kernels")
    assert path.parent == _build.BUILD_DIR and path.name.startswith("blob_kernels-")
    assert (_build.CSRC / "blob_kernels.cu").exists()
