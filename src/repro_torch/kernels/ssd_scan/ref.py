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

It is also the backward of the kernel (``ops.SSDChunk``): autograd of
these terms. Its values are the JAX package's bit for bit; its gradient
is finite where JAX's autodiff of ``jnp.where(causal, jnp.exp(diff), 0)``
is not (a chunk whose decay leaves f32's range in the masked half).
"""

from __future__ import annotations

import torch


def ssd_chunk_ref(xq, dtq, A, Bq, Cq):
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
    cum_a = torch.cumsum(a, dim=2)
    a_total = cum_a[:, :, -1]
    diff = cum_a[:, :, :, None, :] - cum_a[:, :, None, :, :]   # (b,nc,Q,Q,H)
    ii = torch.arange(Q, device=xq.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    # the masked half is set to -inf before the exponential (0 after it,
    # as the JAX package's where after the exponential gives): there diff
    # can pass f32's range, and an inf there would make the gradient
    # 0 * inf = nan
    decay = torch.exp(torch.where(causal, diff, -torch.inf))
    cb = torch.einsum("bcign,bcjgn->bcijg", Cq, Bq)[..., None]  # (b,nc,Q,Q,G,1)
    scores = (cb * decay.reshape(b, nc, Q, Q, G, rep)).reshape(b, nc, Q, Q, H) \
        * dtq[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores, xq)
    w = torch.exp(a_total[:, :, None, :] - cum_a) * dtq          # (b,nc,Q,H)
    xw = (xq * w[..., None]).reshape(b, nc, Q, G, rep, P)
    states = torch.einsum("bcjgrp,bcjgn->bcgrpn", xw, Bq).reshape(b, nc, H, P, N)
    return y_intra, states, a_total, torch.exp(cum_a)
