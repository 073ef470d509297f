"""CUDA kernel for flash attention, the port of
``repro.kernels.flash_attention.kernel.flash_attention_pallas``.

``flash_attention_fwd`` in ``csrc/flash_attention.cu``: one block of four
warps per (q tile of 64 rows, head, batch), K and V tiles staged through
shared memory, and an online softmax in f32. GQA reads kv-head
``h // (H // KVH)``; no repeat is made. bf16 q, k, v run both products on
the tensor cores (``mma.sync`` m16n8k16, bf16 in, f32 accumulation); f32
q, k, v run them in f32 on the CUDA cores, as the Pallas kernel computes
f32 inputs. The head dim is a multiple of 16 up to 256.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import (GRID_YZ_MAX, check_attention,
                                         require_cuda)

#: the kernel's dtypes, those of ``flash_attention_pallas``
KERNEL_DTYPES = (torch.bfloat16, torch.float32)

FLASH = _build.Kernel("flash_attention", "flash_attention_fwd",
                      [_build.P] * 4 + [_build.I32] * 8 + [_build.F32])


def launch(out: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor, *, causal: bool) -> None:
    """Launch into ``out`` without checks: only for tensors that
    ``flash_attention_cuda`` has accepted."""
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    FLASH(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
          B, Sq, Skv, H, KVH, D, int(causal), int(q.dtype == torch.float32),
          1.0 / math.sqrt(D))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """q (B, Sq, H, D); k, v (B, Skv, KVH, D), all bf16 or all f32, on
    the card -> (B, Sq, H, D) in their dtype."""
    check_attention(q, k, v, KERNEL_DTYPES)
    require_cuda(q=q, k=k, v=v)
    if q.shape[0] > GRID_YZ_MAX or q.shape[2] > GRID_YZ_MAX:
        raise ValueError(f"batch and heads of q {tuple(q.shape)} must be at "
                         f"most {GRID_YZ_MAX}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start on 16-byte boundaries "
                         "(the kernel copies rows in 16-byte pieces)")
    out = torch.empty_like(q)
    launch(out, q, k, v, causal=causal)
    return out
