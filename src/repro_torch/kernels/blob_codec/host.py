"""Host fast path for the fused compress+pack codec, the port of
``repro.kernels.blob_codec.host``.

The per-row int8 quantizer does not depend on destination order, so it
runs **before** the pack, once over the T live rows instead of over the
bins x capacity padded ones, and the gather then moves int8 codes (half
or a quarter of the raw rows' bytes):

  1. quantize the T rows with ``quantize_rows``, the *same function* the
     plain version (``compress_pack_ref``) uses, so outputs cannot drift;
     in chunks of ``QUANTIZE_ROWS`` rows, which bound the f32 temporaries
     and give the same bits, the quantizer being per row; the temporaries
     are allocated once for all chunks;
  2. ``sorted_order_np``, shared with ``blob_pack.host``;
  3. one gather of the codes (on their widest integer view) and of the
     scales, then per-bin contiguous block copies into the padded
     layout, as ``blob_pack.host`` does them; padding rows are (q=0,
     scale=1.0), what the plain version's quantize of zeros gives.

Bit-exact with ``compress_pack_ref``. ``out=`` takes a ``(q, scales)``
arena pair for steady-state reuse, as ``blob_pack_fused_host`` does. The
tensors are CPU tensors; one on another device is refused, never copied.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.blob_codec.ref import quantize_rows
from repro_torch.kernels.blob_pack.host import (block_copies, check_rows,
                                                host_rows, on_host,
                                                sorted_order_np, widest_view,
                                                zeros)

#: rows quantized at a time (two 16 MiB f32 temporaries for 512-wide rows,
#: allocated once). Fresh temporaries a chunk made the time hang on the
#: allocator: each chunk's page faults came back whenever glibc's dynamic
#: mmap threshold stood below the chunk's size, and which sizes those were
#: shifted from host to host (tools/host_paths_probe.py counts the faults
#: and times the chunks).
QUANTIZE_ROWS = 1 << 13


def quantize_host(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``quantize_rows`` of (T, d) CPU rows, a chunk of rows at a time
    into the same two temporaries."""
    T, d = x.shape
    q = torch.empty((T, d), dtype=torch.int8)
    s = torch.empty((T,), dtype=torch.float32)
    scratch = torch.empty((2, min(QUANTIZE_ROWS, T), d), dtype=torch.float32)
    for i in range(0, T, QUANTIZE_ROWS):
        j = min(i + QUANTIZE_ROWS, T)
        quantize_rows(x[i:j], out=(q[i:j], s[i:j]), scratch=scratch[:, :j - i])
    return q, s


def compress_pack_fused_host(x: torch.Tensor, keys, *, num_bins: int,
                             capacity: int,
                             out: Optional[Tuple[torch.Tensor,
                                                 torch.Tensor]] = None):
    """(T, d) CPU rows + destination keys -> ((q int8 (bins, capacity,
    d), scales f32 (bins, capacity)), (order, starts, counts)), all CPU
    tensors, bit-exact with ``compress_pack_ref``."""
    x = host_rows(x)
    if out is not None:
        on_host("out[0]", out[0])
        on_host("out[1]", out[1])
    order, starts, counts = sorted_order_np(keys, num_bins)
    check_rows(x, order)
    d = x.shape[-1]
    reuse = (out is not None
             and tuple(out[0].shape) == (num_bins, capacity, d)
             and out[0].dtype == torch.int8
             and tuple(out[1].shape) == (num_bins, capacity)
             and out[1].dtype == torch.float32
             and out[0].is_contiguous())
    if reuse:
        q_out, s_out = out
    else:
        q_out = zeros((num_bins, capacity, d), torch.int8)
        s_out = torch.ones((num_bins, capacity), dtype=torch.float32)
    q_all, s_all = quantize_host(x)
    order_t = torch.from_numpy(order)
    take = np.minimum(counts, capacity)
    block_copies(widest_view(q_out), torch.index_select(widest_view(q_all), 0, order_t),
                 starts, take, pad=0 if reuse else None)
    block_copies(s_out, s_all[order_t], starts, take, pad=1.0 if reuse else None)
    return (q_out, s_out), (order_t, torch.from_numpy(starts), torch.from_numpy(counts))
