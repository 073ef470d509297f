"""Quantized transfer for the expensive leg, the port of
``repro.shuffle.compression``.

This is the **divide** form of the per-row int8 scale (``absmax / 127``).
The blob codec keeps its own multiply form
(``repro_torch.kernels.blob_codec.ref.quantize_rows``); the two give
different scales on some rows and each is held against its own JAX
counterpart.
"""

from __future__ import annotations

from typing import Tuple

import torch


def int8_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization over the last axis.

    Returns (q int8 same shape, scale float32 shape[:-1])."""
    x32 = x.to(torch.float32)
    absmax = torch.amax(torch.abs(x32), dim=-1)
    # A tensor divisor keeps this an IEEE divide: PyTorch's CUDA kernel
    # turns division by a Python scalar into a reciprocal multiply.
    scale = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0),
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


def compress_decompress(x: torch.Tensor) -> torch.Tensor:
    """Round trip through the lossy channel."""
    q, s = int8_quantize(x)
    return int8_dequantize(q, s, x.dtype)


def with_error_feedback(grad: torch.Tensor, residual: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize (grad + residual); return (dequantized payload, new
    residual), where new_residual = (grad + residual) - payload is carried
    to the next step."""
    target = grad.to(torch.float32) + residual.to(torch.float32)
    payload = compress_decompress(target)
    new_residual = target - payload.to(torch.float32)
    return payload.to(grad.dtype), new_residual.to(residual.dtype)
