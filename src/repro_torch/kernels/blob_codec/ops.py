"""Public ops of the fused blob codec, the port of
``repro.kernels.blob_codec.ops``.

CUDA tensors go through the kernels in ``kernel.py``, CPU tensors through
the plain versions in ``ref.py``. The ``*_fused`` ops add the sort/rank
front half of ``repro_torch.shuffle.binning``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._checks import (CODEC_DTYPES, check_layout,
                                         check_pack, check_unpack_codes)
from repro_torch.kernels.blob_codec.kernel import (
    compress_pack_fused_cuda, unpack_decompress_fused_cuda)
from repro_torch.kernels.blob_codec.ref import (compress_pack_ref,
                                                unpack_decompress_ref)
from repro_torch.shuffle.binning import bin_pack, sorted_order

__all__ = ["compress_pack", "compress_pack_fused", "unpack_decompress",
           "unpack_decompress_fused"]


def compress_pack(x: torch.Tensor, order: torch.Tensor, starts: torch.Tensor,
                  counts: torch.Tensor, *, capacity: int):
    """(T, d) rows + sorted-order description -> compressed blob layout
    (q int8 (bins, capacity, d), scales f32 (bins, capacity))."""
    if x.is_cuda:
        return compress_pack_fused_cuda(x, order, starts, counts,
                                        capacity=capacity)
    check_pack(x, order, starts, counts, capacity, CODEC_DTYPES)
    return compress_pack_ref(x, order, starts, counts, capacity=capacity)


def compress_pack_fused(x: torch.Tensor, keys: torch.Tensor, *,
                        num_bins: int, capacity: int):
    """Batcher path: (rows, destination keys) -> ((q, scales),
    (order, starts, counts))."""
    order, starts, counts = sorted_order(keys, num_bins)
    out = compress_pack(x, order, starts, counts, capacity=capacity)
    return out, (order, starts, counts)


def unpack_decompress(q: torch.Tensor, scales: torch.Tensor,
                      slot: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Compressed blob layout + (slot, valid) -> (U, d) f32 unit rows."""
    if q.is_cuda:
        return unpack_decompress_fused_cuda(q, scales, slot, valid)
    check_unpack_codes(q, scales, slot, valid)
    return unpack_decompress_ref(q, scales, slot, valid)


def unpack_decompress_fused(q: torch.Tensor, scales: torch.Tensor,
                            keys: torch.Tensor, *, num_bins: int,
                            capacity: int) -> torch.Tensor:
    """Debatcher path: compressed (bins, capacity, d) + destination keys ->
    (U, d) f32."""
    check_layout("q", q, num_bins, capacity)
    pack = bin_pack(keys, num_bins, capacity)
    return unpack_decompress(q, scales, pack.slot, pack.valid)
