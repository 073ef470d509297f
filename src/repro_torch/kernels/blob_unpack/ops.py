"""Public ops of blob_unpack, the port of ``repro.kernels.blob_unpack.ops``.

CUDA tensors go through the kernel (``kernel.blob_unpack_fused_cuda``),
CPU tensors through the plain version (``ref.blob_unpack_ref``).
``unpack_from_keys`` derives (slot, valid) from destination keys with
``binning.bin_pack`` first.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._checks import check_layout, check_unpack
from repro_torch.kernels.blob_unpack.kernel import blob_unpack_fused_cuda
from repro_torch.kernels.blob_unpack.ref import blob_unpack_ref
from repro_torch.shuffle.binning import bin_pack

__all__ = ["blob_unpack", "blob_unpack_fused", "unpack_from_keys"]


def blob_unpack(buf: torch.Tensor, slot: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """(bins, cap, d) blob layout + (slot, valid) -> (U, d) unit rows."""
    if buf.is_cuda:
        return blob_unpack_fused_cuda(buf, slot, valid)
    check_unpack(buf, slot, valid)
    return blob_unpack_ref(buf, slot, valid)


#: same contract and output as ``blob_unpack``, as in the JAX package
blob_unpack_fused = blob_unpack


def unpack_from_keys(buf: torch.Tensor, keys: torch.Tensor, *, num_bins: int,
                     capacity: int) -> torch.Tensor:
    """Debatcher extract: (bins, capacity, d) + destination keys -> (U, d)."""
    check_layout("buf", buf, num_bins, capacity)
    pack = bin_pack(keys, num_bins, capacity)
    return blob_unpack(buf, pack.slot, pack.valid)
