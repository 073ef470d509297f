"""Public ops of blob_unpack, the port of ``repro.kernels.blob_unpack.ops``.

CUDA tensors go through the kernel (``kernel.blob_unpack_fused_cuda``),
CPU tensors through the plain version (``ref.blob_unpack_ref``).
``unpack_from_keys`` derives (slot, valid) from destination keys with
``binning.bin_pack`` first.

``blob_unpack`` is differentiable in ``buf``. No two valid units read
one slot (``bin_pack`` gives each unit its own), so its adjoint is a pure
scatter, and that is a pack (the pack kernel on CUDA tensors): slot s of
the gradient takes the incoming row of the unit that reads s, and a zero
row where none does. The backward raises on a slot read twice.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._checks import check_layout, check_unpack
from repro_torch.kernels.blob_unpack.kernel import blob_unpack_fused_cuda
from repro_torch.kernels.blob_unpack.ref import blob_unpack_ref
from repro_torch.shuffle.binning import bin_pack

__all__ = ["blob_unpack", "blob_unpack_fused", "unpack_from_keys"]


def unpack_rows(buf: torch.Tensor, slot: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """The unpack where its tensors lie, outside autograd."""
    if buf.is_cuda:
        return blob_unpack_fused_cuda(buf, slot, valid)
    check_unpack(buf, slot, valid)
    return blob_unpack_ref(buf, slot, valid)


def unpack_adjoint(dy: torch.Tensor, slot: torch.Tensor, valid: torch.Tensor,
                   bins: int, capacity: int) -> torch.Tensor:
    """The gradient of ``blob_unpack`` in buf: dy (U, d) -> (bins,
    capacity, d), through one pack."""
    from repro_torch.kernels.blob_pack.ops import pack_rows

    U, d = dy.shape
    readers = slot[valid].long()
    if readers.numel() and int(torch.bincount(readers).max()) > 1:
        raise ValueError("two valid units read one slot, so the unpack has "
                         "no pack for its adjoint")
    src = torch.full((bins * capacity,), U, dtype=torch.int32, device=dy.device)
    src[readers] = torch.arange(U, dtype=torch.int32, device=dy.device)[valid]
    rows = torch.cat([dy, dy.new_zeros((1, d))])
    starts = torch.arange(bins, dtype=torch.int32, device=dy.device) * capacity
    counts = torch.full((bins,), capacity, dtype=torch.int32, device=dy.device)
    return pack_rows(rows, src, starts, counts, capacity)


class BlobUnpack(torch.autograd.Function):
    """``unpack_rows`` with ``unpack_adjoint`` as its backward."""

    @staticmethod
    def forward(ctx, buf, slot, valid):
        out = unpack_rows(buf, slot, valid)
        ctx.save_for_backward(slot, valid)
        ctx.layout = tuple(buf.shape[:2])
        return out

    @staticmethod
    def backward(ctx, dy):
        slot, valid = ctx.saved_tensors
        return unpack_adjoint(dy.contiguous(), slot, valid, *ctx.layout), None, None


def blob_unpack(buf: torch.Tensor, slot: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """(bins, cap, d) blob layout + (slot, valid) -> (U, d) unit rows."""
    return BlobUnpack.apply(buf, slot, valid)


#: same contract and output as ``blob_unpack``, as in the JAX package
blob_unpack_fused = blob_unpack


def unpack_from_keys(buf: torch.Tensor, keys: torch.Tensor, *, num_bins: int,
                     capacity: int) -> torch.Tensor:
    """Debatcher extract: (bins, capacity, d) + destination keys -> (U, d)."""
    check_layout("buf", buf, num_bins, capacity)
    pack = bin_pack(keys, num_bins, capacity)
    return blob_unpack(buf, pack.slot, pack.valid)
