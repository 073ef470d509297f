"""Public ops of blob_pack, the port of ``repro.kernels.blob_pack.ops``.

Each op runs where its tensors lie: CUDA tensors go through the kernel
(``kernel.blob_pack_fused_cuda``), CPU tensors through the plain version
(``ref.blob_pack_ref``). ``pack_from_keys`` and ``blob_pack_fused`` add
the sort front half (``repro_torch.shuffle.binning.sorted_order``).
``blob_pack_fused_host`` (``host.py``) is the explicit entry point for
rows on the host; it takes CPU tensors only, and no op falls back to it.

``blob_pack`` is differentiable in ``x``. Its adjoint is an unpack: the
incoming (bins, capacity, d) gradient is read back into the sorted
positions of ``order`` (the unpack kernel on CUDA tensors), and each
position's row is added onto the row of ``x`` that ``order`` names. Where
``order`` names a row more than once (the MoE scatter reads each token
once per selected expert), the rows are summed in f32 in a fixed order:
by position within ``order``. The triple must describe a sorted order,
each bin owning its own positions of ``order`` (``sorted_order`` makes
such triples); the backward raises on bins that share a position.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._checks import check_pack
from repro_torch.kernels.blob_pack.host import (blob_pack_fused_host,
                                                sorted_order_np)
from repro_torch.kernels.blob_pack.kernel import blob_pack_fused_cuda
from repro_torch.kernels.blob_pack.ref import blob_pack_ref
from repro_torch.shuffle.binning import sorted_order

__all__ = ["blob_pack", "pack_from_keys", "blob_pack_fused",
           "blob_pack_fused_host", "sorted_order_np"]


def pack_rows(x: torch.Tensor, order: torch.Tensor, starts: torch.Tensor,
              counts: torch.Tensor, capacity: int) -> torch.Tensor:
    """The pack where its tensors lie, outside autograd."""
    if x.is_cuda:
        return blob_pack_fused_cuda(x, order, starts, counts,
                                    capacity=capacity)
    check_pack(x, order, starts, counts, capacity)
    return blob_pack_ref(x, order, starts, counts, capacity=capacity)


def sum_rows(g: torch.Tensor, order: torch.Tensor, rows: int) -> torch.Tensor:
    """(rows, d): row t the sum of the rows g[u] with order[u] == t, in
    f32 in the order of u, zero where order names t nowhere."""
    U, d = g.shape
    idx = order.long()
    n = torch.bincount(idx, minlength=rows)
    most = int(n.max()) if U else 0
    if most <= 1:                       # a row named once: a pure scatter
        out = g.new_zeros((rows, d))
        out[idx] = g
        return out
    # positions of each row, in order, padded with a zero row's index U
    perm = torch.argsort(idx, stable=True)
    tok = idx[perm]
    rank = torch.arange(U, device=g.device) - (torch.cumsum(n, 0) - n)[tok]
    at = torch.full((rows, most), U, dtype=torch.long, device=g.device)
    at[tok, rank] = perm
    g_ext = torch.cat([g, g.new_zeros((1, d))])
    acc = g_ext[at[:, 0]].float()
    for j in range(1, most):
        acc.add_(g_ext[at[:, j]])
    return acc.to(g.dtype)


def pack_adjoint(dout: torch.Tensor, order: torch.Tensor, starts: torch.Tensor,
                 counts: torch.Tensor, rows: int) -> torch.Tensor:
    """The gradient of ``blob_pack`` in x: dout (bins, capacity, d) ->
    (rows, d), through one unpack into the sorted positions."""
    from repro_torch.kernels.blob_unpack.ops import unpack_rows

    bins, capacity, _ = dout.shape
    U = order.shape[0]
    r = torch.arange(capacity, dtype=torch.int32, device=dout.device)
    live = r[None, :] < torch.clamp(counts, max=capacity)[:, None]
    pos = (starts[:, None] + r[None, :])[live].long()
    slot = torch.zeros(U, dtype=torch.int32, device=dout.device)
    valid = torch.zeros(U, dtype=torch.bool, device=dout.device)
    slot[pos] = torch.arange(bins * capacity, dtype=torch.int32,
                             device=dout.device).view(bins, capacity)[live]
    valid[pos] = True
    if int(valid.sum()) != pos.numel():
        raise ValueError("the bins of (starts, counts) share positions of "
                         "order, so the pack has no unpack for its adjoint")
    return sum_rows(unpack_rows(dout.contiguous(), slot, valid), order, rows)


class BlobPack(torch.autograd.Function):
    """``pack_rows`` with ``pack_adjoint`` as its backward."""

    @staticmethod
    def forward(ctx, x, order, starts, counts, capacity):
        out = pack_rows(x, order, starts, counts, capacity)
        ctx.save_for_backward(order, starts, counts)
        ctx.rows = x.shape[0]
        return out

    @staticmethod
    def backward(ctx, dout):
        order, starts, counts = ctx.saved_tensors
        dx = pack_adjoint(dout, order, starts, counts, ctx.rows)
        return dx, None, None, None, None


def blob_pack(x: torch.Tensor, order: torch.Tensor, starts: torch.Tensor,
              counts: torch.Tensor, *, capacity: int) -> torch.Tensor:
    """(T, d) rows + sorted-order description -> (bins, capacity, d)."""
    return BlobPack.apply(x, order, starts, counts, capacity)


def blob_pack_fused(x: torch.Tensor, keys: torch.Tensor, *, num_bins: int,
                    capacity: int):
    """(rows, destination keys) -> ((bins, capacity, d) blob layout,
    (order, starts, counts))."""
    order, starts, counts = sorted_order(keys, num_bins)
    out = blob_pack(x, order, starts, counts, capacity=capacity)
    return out, (order, starts, counts)


#: same contract and output as ``blob_pack_fused``, as in the JAX package
pack_from_keys = blob_pack_fused
