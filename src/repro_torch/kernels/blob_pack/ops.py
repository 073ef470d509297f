"""Public ops of blob_pack, the port of ``repro.kernels.blob_pack.ops``.

Each op runs where its tensors lie: CUDA tensors go through the kernel
(``kernel.blob_pack_fused_cuda``), CPU tensors through the plain version
(``ref.blob_pack_ref``). ``pack_from_keys`` and ``blob_pack_fused`` add
the sort front half (``repro_torch.shuffle.binning.sorted_order``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels._checks import check_pack
from repro_torch.kernels.blob_pack.kernel import blob_pack_fused_cuda
from repro_torch.kernels.blob_pack.ref import blob_pack_ref
from repro_torch.shuffle.binning import sorted_order

__all__ = ["blob_pack", "pack_from_keys", "blob_pack_fused"]


def blob_pack(x: torch.Tensor, order: torch.Tensor, starts: torch.Tensor,
              counts: torch.Tensor, *, capacity: int) -> torch.Tensor:
    """(T, d) rows + sorted-order description -> (bins, capacity, d)."""
    if x.is_cuda:
        return blob_pack_fused_cuda(x, order, starts, counts,
                                    capacity=capacity)
    check_pack(x, order, starts, counts, capacity)
    return blob_pack_ref(x, order, starts, counts, capacity=capacity)


def blob_pack_fused(x: torch.Tensor, keys: torch.Tensor, *, num_bins: int,
                    capacity: int):
    """(rows, destination keys) -> ((bins, capacity, d) blob layout,
    (order, starts, counts))."""
    order, starts, counts = sorted_order(keys, num_bins)
    out = blob_pack(x, order, starts, counts, capacity=capacity)
    return out, (order, starts, counts)


#: same contract and output as ``blob_pack_fused``, as in the JAX package
pack_from_keys = blob_pack_fused
