"""Host fast path for the fused blob pack, the port of
``repro.kernels.blob_pack.host``: BlobShuffle's Batcher on a CPU
instance, with no kernel.

The pack reaches the host's copy bandwidth in three moves:

  1. one stable argsort + bincount/cumsum (``sorted_order_np``, the numpy
     twin of ``repro_torch.shuffle.binning.sorted_order``);
  2. one row gather into destination order on the widest integer view of
     the row bytes (fewer, wider items move the same bytes);
  3. per-bin **contiguous block copies** into the padded (bins,
     capacity, d) layout: sequential memcpys, not per-row gathers.

The JAX package gathers and copies with numpy; the port uses
``torch.index_select`` and ``copy_`` on the same views, which spread the
work over torch's threads (2.7-3.1x faster gathers, 2.3x faster copies
on the card machine's host: ``tools/host_paths_probe.py``). The bytes
moved are the same.

Rows and outputs are CPU tensors of any dtype, bf16 included: the path
moves their bytes through an integer view. A tensor on another device is
refused, never copied to the host: the CUDA kernels
(``ops.blob_pack_fused``) serve the card, and nothing falls back to this
path. Outputs are bit-exact with ``blob_pack_ref``.

Callers on a steady-state hot path pass ``out=`` and reuse the returned
tensor: a fresh allocation of the whole layout pays a page-fault storm
that costs more than the copies. Padding rows are re-zeroed on every
call, so reuse is invisible in the result.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels._checks import check_keys


def on_host(name: str, t) -> None:
    """Host paths take CPU tensors only, and copy nothing to the host."""
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.device.type != "cpu":
        raise ValueError(f"a host path takes CPU tensors; {name} lies on "
                         f"device {t.device} (the CUDA kernels serve the card)")


def host_rows(x) -> torch.Tensor:
    """(T, d) CPU rows, C-contiguous."""
    on_host("x", x)
    if x.dim() != 2:
        raise ValueError(f"x must be (T, d) rows, got shape {tuple(x.shape)}")
    return x.detach().contiguous()


def zeros(shape, dtype: torch.dtype) -> torch.Tensor:
    """``torch.zeros`` in numpy's memory: ``np.zeros`` maps zero pages
    lazily where ``torch.zeros`` writes every page, so a fresh layout
    costs only the pages the copies touch, as in the JAX package."""
    item = torch.empty((), dtype=dtype).element_size()
    raw = np.zeros(tuple(shape[:-1]) + (shape[-1] * item,), np.uint8)
    return torch.from_numpy(raw).view(dtype)


def widest_view(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's rows (last axis) as the widest integers whose
    size divides the row's bytes, sharing its memory."""
    raw = t.view(torch.uint8)
    for width, dt in ((8, torch.int64), (4, torch.int32), (2, torch.int16)):
        if raw.shape[-1] % width == 0:
            return raw.view(dt)
    return raw


def block_copies(dst: torch.Tensor, src: torch.Tensor, starts: np.ndarray,
                 take: np.ndarray, pad=None) -> None:
    """dst[b, :take[b]] = src[starts[b]:][:take[b]] for each bin b; the
    rest of the bin set to ``pad`` (left alone where ``pad`` is None)."""
    for b, (s, c) in enumerate(zip(starts.tolist(), take.tolist())):
        dst[b, :c].copy_(src[s:s + c])
        if pad is not None and c < dst.shape[1]:
            dst[b, c:].fill_(pad)


def keys_np(keys, num_bins: int) -> np.ndarray:
    """Destination keys (a CPU tensor or an integer numpy array) as a
    numpy array, every key in ``[0, num_bins)`` (``check_keys``)."""
    if isinstance(keys, torch.Tensor):
        on_host("keys", keys)
        keys = keys.numpy()
    keys = np.ascontiguousarray(keys)
    check_keys(torch.from_numpy(keys), num_bins)
    return keys


def check_rows(x: torch.Tensor, order: np.ndarray) -> None:
    if order.shape[0] != x.shape[0]:
        raise ValueError(f"{order.shape[0]} keys for the {x.shape[0]} rows "
                         f"of x (shape {tuple(x.shape)})")


def sorted_order_np(keys, num_bins: int
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Numpy twin of ``sorted_order``: identical int32 (order, starts,
    counts) (a stable argsort resolves ties the same way), so host- and
    device-packed blobs line up slot for slot."""
    keys = keys_np(keys, num_bins)
    order = np.argsort(keys, kind="stable").astype(np.int32)
    counts = np.bincount(keys, minlength=num_bins).astype(np.int32)
    starts = np.zeros(num_bins, np.int32)
    np.cumsum(counts[:-1], out=starts[1:])
    return order, starts, counts


def blob_pack_fused_host(x: torch.Tensor, keys, *, num_bins: int,
                         capacity: int, out: Optional[torch.Tensor] = None):
    """(T, d) CPU rows + destination keys -> ((bins, capacity, d) blob
    layout, (order, starts, counts)), all CPU tensors, bit-exact with
    ``blob_pack_ref``.

    ``out``: a (bins, capacity, d) CPU tensor of ``x``'s dtype to write
    into and return (arena reuse; see the module docstring); one of
    another shape, dtype or layout is left alone, as in the JAX package."""
    x = host_rows(x)
    if out is not None:
        on_host("out", out)
    d = x.shape[-1]
    order, starts, counts = sorted_order_np(keys, num_bins)
    check_rows(x, order)
    reuse = (out is not None and tuple(out.shape) == (num_bins, capacity, d)
             and out.dtype == x.dtype and out.is_contiguous())
    if not reuse:
        out = zeros((num_bins, capacity, d), x.dtype)
    order_t = torch.from_numpy(order)
    xs = torch.index_select(widest_view(x), 0, order_t)
    block_copies(widest_view(out), xs, starts, np.minimum(counts, capacity),
                 pad=0 if reuse else None)
    return out, (order_t, torch.from_numpy(starts), torch.from_numpy(counts))
