"""Plain PyTorch version of the SSD chunk kernel, the port of
``repro.kernels.ssd_scan.ref.ssd_chunk_ref``.

Per (batch, chunk, head) it computes, all in f32:
  y_intra  the within-chunk quadratic contribution,
  states   the end-of-chunk state contribution (before the recurrence),
  a_total  the head's total decay over the chunk,
  y_decay  exp(cum_a), so that the caller adds the inter-chunk term
           y_inter[i] = y_decay[i] * C[i] . S_prev.

B and C may carry G groups for the H heads (head h reads group
``h // (H // G)``); G == H is the JAX package's contract.

``intra_bf16`` rounds the intra-chunk tensors to bf16 where
``repro.models.ssm.ssd_chunked(..., intra_bf16=True)`` does: C and B are
rounded and C . B^T summed in f32 and rounded; the decay is rounded, the
product with it rounded, dt rounded and the product with it rounded; the
scores times x (rounded) are summed in f32. ``states``, ``a_total`` and
``y_decay`` are f32 either way.

It is also the backward of the kernel (``ops.SSDChunk``): autograd of
these terms. Its values are the JAX package's bit for bit (in f32); its
gradient is finite where JAX's autodiff of
``jnp.where(causal, jnp.exp(diff), 0)`` is not (a chunk whose decay
leaves f32's range in the masked half).
"""

from __future__ import annotations

import torch


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16)


def ssd_chunk_ref(xq, dtq, A, Bq, Cq, intra_bf16: bool = False):
    """xq (b,nc,Q,H,P); dtq (b,nc,Q,H); A (H,); Bq/Cq (b,nc,Q,G,N).

    Returns (y_intra (b,nc,Q,H,P), states (b,nc,H,P,N), a_total (b,nc,H),
    y_decay (b,nc,Q,H)).
    """
    b, nc, Q, H, P = xq.shape
    G, N = Bq.shape[3], Bq.shape[4]
    rep = H // G
    xq = xq.float()
    dtq = dtq.float()
    Bq = Bq.float()
    Cq = Cq.float()
    a = dtq * A.float()
    # summed in f64 and rounded once: the correctly rounded sums on every
    # device (the CPU's cumsum of f32 already sums in f64), which the
    # bf16-intra kernels reproduce, so that their decays round as these do
    cum_a = torch.cumsum(a.double(), dim=2).float()
    a_total = cum_a[:, :, -1]
    diff = cum_a[:, :, :, None, :] - cum_a[:, :, None, :, :]   # (b,nc,Q,Q,H)
    ii = torch.arange(Q, device=xq.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    # the masked half is set to -inf before the exponential (0 after it,
    # as the JAX package's where after the exponential gives): there diff
    # can pass f32's range, and an inf there would make the gradient
    # 0 * inf = nan
    decay = torch.exp(torch.where(causal, diff, -torch.inf))
    if intra_bf16:
        # bf16 products are exact in f32, so the f32 sums of the widened
        # values are the JAX package's f32 accumulation; each product of
        # the scores below rounds to bf16
        cb = _bf16(torch.einsum("bcign,bcjgn->bcijg", _bf16(Cq).float(), _bf16(Bq).float()))
        decay, dt_j, x_j = _bf16(decay), _bf16(dtq), _bf16(xq).float()
    else:
        cb = torch.einsum("bcign,bcjgn->bcijg", Cq, Bq)
        dt_j, x_j = dtq, xq
    scores = (cb[..., None] * decay.reshape(b, nc, Q, Q, G, rep)).reshape(b, nc, Q, Q, H) \
        * dt_j[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores.float(), x_j)
    w = torch.exp(a_total[:, :, None, :] - cum_a) * dtq          # (b,nc,Q,H)
    xw = (xq * w[..., None]).reshape(b, nc, Q, G, rep, P)
    states = torch.einsum("bcjgrp,bcjgn->bcgrpn", xw, Bq).reshape(b, nc, H, P, N)
    return y_intra, states, a_total, torch.exp(cum_a)
