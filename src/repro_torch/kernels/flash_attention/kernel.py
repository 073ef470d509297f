"""CUDA kernels for flash attention, the port of
``repro.kernels.flash_attention.kernel.flash_attention_pallas``.

``csrc/flash_attention.cu`` holds three kernels, one launcher each; the
dtype picks one of the first two (``route``):

- bf16, every head dim: ``flash_attention_fwd_wgmma``. One block per
  SM walks tiles of 128 q rows; a producer warpgroup streams Q and the K
  and V tiles with TMA into an mbarrier ring of 2-4 stages; two consumer
  warpgroups of 64 q rows run both products as ``wgmma`` (P from
  registers) and the online softmax, in turn on the tensor cores. The kv
  tiles are 128 rows up to head dim 128, 96 up to 192 and 64 above.
  Where all of K and V fit in L2 together, the blocks take the work
  items in a balanced order (longest first over all heads); otherwise
  head-major, so that the blocks at work at one time share a few heads.
- f32: ``flash_attention_fwd_f32``, f32 products on the CUDA cores, as
  the Pallas kernel computes f32 inputs.
- ``flash_attention_fwd_mma``, bf16 head dims 144-256 by ``mma.sync``
  m16n8k16 with K and V tiles staged by ``cp.async``: no route takes it.
  It is kept as the wgmma kernel's timed comparison at those head dims
  (``launch(..., kernel=FLASH_MMA)``).

Every kernel reads kv-head ``h // (H // KVH)`` (no repeat) and keeps the
softmax statistics in f32. Under the causal mask query row i sits at
position ``i + q_offset`` and sees key j where ``j <= i + q_offset``, as in
the JAX package's jnp ``flash_attention(q_offset=)``; the offset moves the
mask and the kv tiles a q tile reaches, never the rows loaded or stored.
The head dim is a multiple of 16 up to 256. The scores are scaled by
``scale``, 1/sqrt(D) unless the caller gives another
(``models.attention.attention_op`` pads the head dim to a multiple of 16
and passes the scale of the true one).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import (GRID_YZ_MAX, check_attention,
                                         require_cuda)

#: the kernels' dtypes, those of ``flash_attention_pallas``
KERNEL_DTYPES = (torch.bfloat16, torch.float32)

_ARGS = [_build.P] * 4 + [_build.I32] * 8 + [_build.F32]
FLASH_WGMMA = _build.Kernel("flash_attention", "flash_attention_fwd_wgmma", _ARGS)
FLASH_MMA = _build.Kernel("flash_attention", "flash_attention_fwd_mma", _ARGS)
FLASH_F32 = _build.Kernel("flash_attention", "flash_attention_fwd_f32", _ARGS)
KERNELS = (FLASH_WGMMA, FLASH_MMA, FLASH_F32)


def route(dtype: torch.dtype, head_dim: int) -> _build.Kernel:
    """The kernel that serves q, k, v of this dtype and head dim (each
    kernel is built for every head dim the op takes: a multiple of 16 up
    to 256)."""
    if dtype == torch.float32:
        return FLASH_F32
    if dtype != torch.bfloat16:
        raise ValueError(f"no flash kernel takes {dtype}")
    return FLASH_WGMMA


def check_q_offset(q_offset, Sq: int) -> None:
    """``q_offset`` must be a non-negative Python int with ``Sq + q_offset``
    below 2**31 (the kernels add it to int32 row indices)."""
    if isinstance(q_offset, bool) or not isinstance(q_offset, int) or q_offset < 0:
        raise ValueError(f"q_offset must be an int >= 0, got {q_offset!r}")
    if Sq + q_offset >= 2 ** 31:
        raise ValueError(f"Sq + q_offset must be below 2**31, got Sq {Sq} + "
                         f"q_offset {q_offset}")


def launch(out: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor, *, causal: bool, scale: Optional[float] = None,
           q_offset: int = 0, kernel: Optional[_build.Kernel] = None) -> None:
    """Launch ``kernel`` (default: the routed one) into ``out`` without
    checks: only for tensors and an offset that ``flash_attention_cuda``
    has accepted, and of the dtype and head dim the kernel is built for."""
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    kernel = route(q.dtype, D) if kernel is None else kernel
    kernel(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           B, Sq, Skv, H, KVH, D, int(causal), q_offset,
           1.0 / math.sqrt(D) if scale is None else scale)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, scale: Optional[float] = None,
                         q_offset: int = 0) -> torch.Tensor:
    """q (B, Sq, H, D); k, v (B, Skv, KVH, D), all bf16 or all f32, on
    the card -> (B, Sq, H, D) in their dtype. ``q_offset``: the position
    of q's row 0 under the causal mask."""
    check_attention(q, k, v, KERNEL_DTYPES)
    check_q_offset(q_offset, q.shape[1])
    require_cuda(q=q, k=k, v=v)
    if q.shape[0] > GRID_YZ_MAX or q.shape[2] > GRID_YZ_MAX:
        raise ValueError(f"batch and heads of q {tuple(q.shape)} must be at "
                         f"most {GRID_YZ_MAX}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start on 16-byte boundaries "
                         "(the kernels copy rows in 16-byte pieces)")
    out = torch.empty_like(q)
    launch(out, q, k, v, causal=causal, scale=scale, q_offset=q_offset)
    return out
