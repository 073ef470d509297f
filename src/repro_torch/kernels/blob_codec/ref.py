"""Plain PyTorch version of the fused blob compress+pack codec, the port
of ``repro.kernels.blob_codec.ref``:

  compress_pack_ref     = quantize_rows ∘ blob_pack_ref     (per blob row)
  unpack_decompress_ref = blob_unpack_ref ∘ int8_dequantize

``quantize_rows`` is the **multiply** form of the per-row scale,
``absmax * f32(1/127)``, which the JAX codec spells out so that its
kernel and oracle agree bit for bit. ``shuffle.compression.int8_quantize``
keeps the divide form; the two differ on some rows. Padding rows are
all-zero and quantize to (q=0, scale=1.0).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.blob_pack.ref import blob_pack_ref
from repro_torch.kernels.blob_unpack.ref import blob_unpack_ref
from repro_torch.shuffle.compression import int8_dequantize

_INV_127 = 1.0 / 127.0


def quantize_rows(x: torch.Tensor, *, out=None,
                  scratch=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization over the last axis (any leading
    shape): (q int8, scale float32).

    ``out=(q, scale)`` takes the results, ``scratch`` (f32, ``(2,
    *x.shape)``) the two temporaries; a caller that quantizes chunk after
    chunk passes the same buffers each time, so that no chunk allocates
    (and page-faults) its own."""
    if scratch is None:
        scratch = x.new_empty((2, *x.shape), dtype=torch.float32)
    x32, tmp = scratch[0], scratch[1]
    x32.copy_(x)
    absmax = torch.amax(torch.abs(x32, out=tmp), dim=-1)
    scale = torch.where(absmax > 0, absmax * absmax.new_tensor(_INV_127),
                        torch.ones_like(absmax))
    torch.div(x32, scale[..., None], out=tmp)
    torch.clamp(torch.round(tmp, out=tmp), -127, 127, out=tmp)
    if out is None:
        return tmp.to(torch.int8), scale
    out[0].copy_(tmp)
    out[1].copy_(scale)
    return out


def compress_pack_ref(x: torch.Tensor, order: torch.Tensor,
                      starts: torch.Tensor, counts: torch.Tensor, *,
                      capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, d) rows + sorted-order description -> compressed blob layout
    (q int8 (bins, capacity, d), scales float32 (bins, capacity))."""
    packed = blob_pack_ref(x, order, starts, counts, capacity=capacity)
    return quantize_rows(packed)


def unpack_decompress_ref(q: torch.Tensor, scales: torch.Tensor,
                          slot: torch.Tensor, valid: torch.Tensor,
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Compressed blob layout + (slot, valid) -> (U, d) rows in ``dtype``,
    dequantized; capacity-dropped units are zero."""
    return blob_unpack_ref(int8_dequantize(q, scales, dtype), slot, valid)
