"""Public op of flash attention, the port of
``repro.kernels.flash_attention.ops``: CUDA tensors go through the kernel
(``kernel.flash_attention_cuda``), CPU tensors through the plain version
(``ref.flash_ref``). Both devices check the kernel's contract."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._checks import check_attention
from repro_torch.kernels.flash_attention.kernel import (KERNEL_DTYPES,
                                                       flash_attention_cuda)
from repro_torch.kernels.flash_attention.ref import flash_ref


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       *, causal: bool = True, scale: Optional[float] = None
                       ) -> torch.Tensor:
    """q (B, Sq, H, D); k, v (B, Skv, KVH, D) -> (B, Sq, H, D) in q's
    dtype. The scores are scaled by ``scale``, 1/sqrt(D) unless given."""
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal, scale=scale)
    check_attention(q, k, v, KERNEL_DTYPES)
    return flash_ref(q, k, v, causal=causal, scale=scale)
