"""CUDA kernels for the fused blob codec, the port of
``repro.kernels.blob_codec.kernel``.

``compress_pack`` in ``csrc/blob_kernels.cu`` replaces
``compress_pack_fused_pallas``: a warp gathers a destination row, reduces
its absmax across the warp, and writes the int8 codes and the f32 scale,
so the uncompressed layout never reaches device memory.
``unpack_decompress`` replaces ``unpack_decompress_fused_pallas``: a warp
gathers a unit's codes and scale and writes ``f32(q) * scale``, or zero
for a dropped unit. Both are bit-exact with ``ref.py``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import (CODEC_DTYPES, check_pack,
                                         check_unpack_codes, require_cuda)

#: rows per block (8 warps); the chip smoke test sweeps it
ROWS_PER_BLOCK = 16

COMPRESS_PACK = _build.Kernel(
    "blob_kernels", "blob_compress_pack",
    [_build.P, _build.I32] + [_build.P] * 5 + [_build.I64] * 4 + [_build.I32])
UNPACK_DECOMPRESS = _build.Kernel(
    "blob_kernels", "blob_unpack_decompress",
    [_build.P] * 5 + [_build.I64] * 3 + [_build.I32])


def launch_compress_pack(q: torch.Tensor, scales: torch.Tensor,
                         x: torch.Tensor, order: torch.Tensor,
                         starts: torch.Tensor, counts: torch.Tensor, *,
                         rows_per_block: int = ROWS_PER_BLOCK) -> None:
    """Launch into (q, scales) without checks: only for tensors that
    ``compress_pack_fused_cuda`` has accepted."""
    bins, capacity, d = q.shape
    COMPRESS_PACK(x.device, x.data_ptr(), int(x.dtype == torch.bfloat16),
                  order.data_ptr(), starts.data_ptr(), counts.data_ptr(),
                  q.data_ptr(), scales.data_ptr(), order.shape[0], bins,
                  capacity, d, rows_per_block)


def launch_unpack_decompress(out: torch.Tensor, q: torch.Tensor,
                             scales: torch.Tensor, slot: torch.Tensor,
                             valid: torch.Tensor, *,
                             rows_per_block: int = ROWS_PER_BLOCK) -> None:
    """Launch into ``out`` without checks: only for tensors that
    ``unpack_decompress_fused_cuda`` has accepted."""
    bins, cap, d = q.shape
    if slot.shape[0]:
        UNPACK_DECOMPRESS(q.device, q.data_ptr(), scales.data_ptr(),
                          slot.data_ptr(), valid.data_ptr(), out.data_ptr(),
                          slot.shape[0], bins * cap, d, rows_per_block)


def compress_pack_fused_cuda(x: torch.Tensor, order: torch.Tensor,
                             starts: torch.Tensor, counts: torch.Tensor, *,
                             capacity: int,
                             rows_per_block: int = ROWS_PER_BLOCK
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, d) bf16/f32 rows + sorted-order description -> (q int8
    (bins, capacity, d), scales f32 (bins, capacity))."""
    check_pack(x, order, starts, counts, capacity, CODEC_DTYPES)
    require_cuda(x=x)
    bins, d = starts.shape[0], x.shape[1]
    q = torch.empty((bins, capacity, d), dtype=torch.int8, device=x.device)
    scales = torch.empty((bins, capacity), dtype=torch.float32,
                         device=x.device)
    launch_compress_pack(q, scales, x, order, starts, counts,
                         rows_per_block=rows_per_block)
    return q, scales


def unpack_decompress_fused_cuda(q: torch.Tensor, scales: torch.Tensor,
                                 slot: torch.Tensor, valid: torch.Tensor, *,
                                 rows_per_block: int = ROWS_PER_BLOCK
                                 ) -> torch.Tensor:
    """Compressed blob layout + (slot, valid) -> (U, d) f32 unit rows."""
    check_unpack_codes(q, scales, slot, valid)
    require_cuda(q=q)
    out = torch.empty((slot.shape[0], q.shape[2]), dtype=torch.float32,
                      device=q.device)
    launch_unpack_decompress(out, q, scales, slot, valid,
                             rows_per_block=rows_per_block)
    return out
