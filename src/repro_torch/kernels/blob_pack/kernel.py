"""CUDA kernel for blob_pack, the port of ``repro.kernels.blob_pack.kernel``.

``pack_rows`` in ``csrc/blob_kernels.cu`` replaces both Pallas entry
points, ``blob_pack_fused_pallas`` and ``blob_pack_pallas``, which share
one body through ``_pack_call``: a warp per destination row copies the
row's bytes with 16-byte accesses where the row width and pointers allow,
and writes padding rows as zero without reading. It is a byte copy, so
the layout is bit-exact for every payload dtype.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import check_pack, require_cuda

#: destination rows per block (8 warps); the chip smoke test sweeps it
ROWS_PER_BLOCK = 16

PACK = _build.Kernel("blob_kernels", "blob_pack_rows",
                     [_build.P] * 5 + [_build.I64] * 4 + [_build.I32])


def launch(out: torch.Tensor, x: torch.Tensor, order: torch.Tensor,
           starts: torch.Tensor, counts: torch.Tensor, *,
           rows_per_block: int = ROWS_PER_BLOCK) -> None:
    """Launch into ``out`` without checks: only for tensors that
    ``blob_pack_fused_cuda`` has accepted."""
    bins, capacity, _ = out.shape
    PACK(x.device, x.data_ptr(), order.data_ptr(), starts.data_ptr(),
         counts.data_ptr(), out.data_ptr(), order.shape[0], bins, capacity,
         x.shape[1] * x.element_size(), rows_per_block)


def blob_pack_fused_cuda(x: torch.Tensor, order: torch.Tensor,
                         starts: torch.Tensor, counts: torch.Tensor, *,
                         capacity: int,
                         rows_per_block: int = ROWS_PER_BLOCK) -> torch.Tensor:
    """(T, d) rows + sorted-order description -> (bins, capacity, d)."""
    check_pack(x, order, starts, counts, capacity)
    require_cuda(x=x)
    out = torch.empty((starts.shape[0], capacity, x.shape[1]),
                      dtype=x.dtype, device=x.device)
    launch(out, x, order, starts, counts, rows_per_block=rows_per_block)
    return out


#: the plain Pallas entry point shares the fused body; so does the port
blob_pack_cuda = blob_pack_fused_cuda
