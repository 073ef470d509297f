"""CUDA kernel for blob_unpack, the port of
``repro.kernels.blob_unpack.kernel``.

``unpack_rows`` in ``csrc/blob_kernels.cu`` replaces both Pallas entry
points, ``blob_unpack_fused_pallas`` and the per-row ``blob_unpack_pallas``,
which give the same output: a warp per unit row copies the row's bytes
from its clipped slot, and writes dropped units as zero without reading.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import check_unpack, require_cuda

#: unit rows per block (8 warps); the chip smoke test sweeps it
ROWS_PER_BLOCK = 16

UNPACK = _build.Kernel("blob_kernels", "blob_unpack_rows",
                       [_build.P] * 4 + [_build.I64] * 3 + [_build.I32])


def launch(out: torch.Tensor, buf: torch.Tensor, slot: torch.Tensor,
           valid: torch.Tensor, *, rows_per_block: int = ROWS_PER_BLOCK
           ) -> None:
    """Launch into ``out`` without checks: only for tensors that
    ``blob_unpack_fused_cuda`` has accepted."""
    bins, cap, d = buf.shape
    if slot.shape[0]:
        UNPACK(buf.device, buf.data_ptr(), slot.data_ptr(), valid.data_ptr(),
               out.data_ptr(), slot.shape[0], bins * cap,
               d * buf.element_size(), rows_per_block)


def blob_unpack_fused_cuda(buf: torch.Tensor, slot: torch.Tensor,
                           valid: torch.Tensor, *,
                           rows_per_block: int = ROWS_PER_BLOCK
                           ) -> torch.Tensor:
    """(bins, cap, d) blob layout + (slot, valid) -> (U, d) unit rows."""
    check_unpack(buf, slot, valid)
    require_cuda(buf=buf)
    out = torch.empty((slot.shape[0], buf.shape[2]), dtype=buf.dtype,
                      device=buf.device)
    launch(out, buf, slot, valid, rows_per_block=rows_per_block)
    return out


#: both Pallas versions give the same output; so does the one kernel
blob_unpack_cuda = blob_unpack_fused_cuda
