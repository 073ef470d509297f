"""Public op of flash attention, the port of
``repro.kernels.flash_attention.ops``: CUDA tensors go through the kernel
(``kernel.flash_attention_cuda``), CPU tensors through the plain version
(``ref.flash_ref``). Both devices check the kernel's contract.

``flash_attention_op`` is differentiable in q, k and v. The JAX package
has no Pallas backward: its flash attention's VJP is plain jnp
(``repro.models.flash``). So here too the backward is plain torch on
every device, ``repro_torch.models.flash.flash_bwd``: the block scores
are recomputed from q and k in f32, after the log-sum-exp, which the
kernel does not write."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._checks import check_attention
from repro_torch.kernels.flash_attention.kernel import (KERNEL_DTYPES,
                                                       check_q_offset,
                                                       flash_attention_cuda)
from repro_torch.kernels.flash_attention.ref import flash_ref


def attention_rows(q, k, v, causal: bool, scale: Optional[float],
                   q_offset: int = 0) -> torch.Tensor:
    """The attention where its tensors lie, outside autograd."""
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal, scale=scale,
                                    q_offset=q_offset)
    check_attention(q, k, v, KERNEL_DTYPES)
    check_q_offset(q_offset, q.shape[1])
    return flash_ref(q, k, v, causal=causal, scale=scale, q_offset=q_offset)


class FlashAttention(torch.autograd.Function):
    """``attention_rows`` with ``models.flash.flash_bwd`` as its backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_offset):
        out = attention_rows(q, k, v, causal, scale, q_offset)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.scale, ctx.q_offset = causal, scale, q_offset
        return out

    @staticmethod
    def backward(ctx, dout):
        from repro_torch.models.flash import flash_bwd

        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, dout, causal=ctx.causal, scale=ctx.scale,
                               q_offset=ctx.q_offset)
        return dq, dk, dv, None, None, None


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       *, causal: bool = True, scale: Optional[float] = None,
                       q_offset: int = 0) -> torch.Tensor:
    """q (B, Sq, H, D); k, v (B, Skv, KVH, D) -> (B, Sq, H, D) in q's
    dtype. The scores are scaled by ``scale``, 1/sqrt(D) unless given.
    Under ``causal`` query row i sits at position ``i + q_offset``
    (``q_offset`` >= 0), as in the JAX package's ``flash_attention``."""
    return FlashAttention.apply(q, k, v, causal, scale, q_offset)
