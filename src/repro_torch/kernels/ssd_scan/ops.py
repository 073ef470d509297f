"""Public op of the chunked SSD, the port of
``repro.kernels.ssd_scan.ops``: pad to whole chunks, compute the
per-chunk terms (the kernel ``kernel.ssd_chunk_cuda`` on CUDA tensors,
the plain ``ref.ssd_chunk_ref`` on CPU tensors), then run the short
inter-chunk recurrence and the ``y_inter`` contraction in torch.

``ssd_chunked`` is the same algorithm with the plain per-chunk terms on
every device: the reference the op is held against on the card.

The per-chunk terms are differentiable (``SSDChunk``): the JAX package's
gradient of the SSD is autodiff of its jnp chunked scan, so the backward
here is autograd of the plain per-chunk terms, recomputed from the saved
inputs. The recurrence and ``y_inter`` are plain torch already.

``intra_bf16`` holds the intra-chunk tensors in bf16 as
``repro.models.ssm.ssd_chunked(..., intra_bf16=True)`` does: the kernel's
bf16-intra launchers on CUDA tensors, ``ssd_chunk_ref(...,
intra_bf16=True)`` in the plain path and in the backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels._checks import _desc, check_ssd_chunk
from repro_torch.kernels.ssd_scan.kernel import ssd_chunk_cuda
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_ref

#: dtypes of x, B and C the plain version takes
PLAIN_DTYPES = (torch.float32, torch.bfloat16)


def chunk_terms(xq, dtq, A, Bq, Cq, intra_bf16: bool = False):
    """The per-chunk terms where their tensors lie, outside autograd."""
    if xq.is_cuda:
        return ssd_chunk_cuda(xq, dtq, A, Bq, Cq, intra_bf16=intra_bf16)
    check_ssd_chunk(xq, dtq, A, Bq, Cq, PLAIN_DTYPES)
    return ssd_chunk_ref(xq, dtq, A, Bq, Cq, intra_bf16)


class SSDChunk(torch.autograd.Function):
    """``chunk_terms`` with autograd of ``ssd_chunk_ref`` as its backward."""

    @staticmethod
    def forward(ctx, xq, dtq, A, Bq, Cq, intra_bf16=False):
        out = chunk_terms(xq, dtq, A, Bq, Cq, intra_bf16)
        ctx.save_for_backward(xq, dtq, A, Bq, Cq)
        ctx.intra_bf16 = intra_bf16
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, *grads):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            outs = ssd_chunk_ref(*inputs, ctx.intra_bf16)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
        flag = (None,) * (len(ctx.needs_input_grad) - len(inputs))   # intra_bf16, if given
        if not wanted or not pairs:
            return (None,) * len(inputs) + flag
        got = iter(torch.autograd.grad([o for o, _ in pairs], wanted,
                                       [g for _, g in pairs], allow_unused=True))
        return tuple(next(got) if t.requires_grad else None for t in inputs) + flag


def _per_chunk(xq, dtq, A, Bq, Cq, intra_bf16):
    return SSDChunk.apply(xq, dtq, A, Bq, Cq, intra_bf16)


def _check_inputs(x, dt, A, B, C, chunk) -> None:
    if not all(isinstance(t, torch.Tensor) for t in (x, dt, A, B, C)):
        raise ValueError("x, dt, A, B and C must be tensors")
    if x.dim() != 4 or B.dim() != 4 or B.shape != C.shape:
        raise ValueError(f"x ({_desc(x)}) must be (b, S, H, P) and B "
                         f"({_desc(B)}), C ({_desc(C)}) (b, S, G, N)")
    b, S, H, _ = x.shape
    if (tuple(dt.shape) != (b, S, H) or tuple(A.shape) != (H,)
            or tuple(B.shape[:2]) != (b, S)):
        raise ValueError(f"dt ({_desc(dt)}) must be (b, S, H), A "
                         f"({_desc(A)}) (H,) and B ({_desc(B)}) (b, S, G, N) "
                         f"for x {_desc(x)}")
    if B.shape[2] < 1 or H % B.shape[2]:
        raise ValueError(f"x's {H} heads are not a multiple of the "
                         f"{B.shape[2]} groups of B ({_desc(B)})")
    if not isinstance(chunk, int) or chunk < 1:
        raise ValueError(f"chunk must be an int >= 1, got {chunk!r}")


def _chunked(x, dt, A, B, C, chunk, per_chunk, initial_state=None,
             intra_bf16=False):
    _check_inputs(x, dt, A, B, C, chunk)
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    pad = (-S) % chunk
    x = F.pad(x, (0, 0, 0, 0, 0, pad)).contiguous()
    dt = F.pad(dt.float(), (0, 0, 0, pad)).contiguous()
    B = F.pad(B, (0, 0, 0, 0, 0, pad)).contiguous()
    C = F.pad(C, (0, 0, 0, 0, 0, pad)).contiguous()
    Sp = S + pad
    nc = Sp // chunk
    xq = x.reshape(b, nc, chunk, H, P)
    dtq = dt.reshape(b, nc, chunk, H)
    Bq = B.reshape(b, nc, chunk, G, N)
    Cq = C.reshape(b, nc, chunk, G, N)
    y_intra, states, a_total, y_decay = per_chunk(
        xq, dtq, A.float().contiguous(), Bq, Cq, intra_bf16)

    # inter-chunk recurrence, in the order of the JAX package's scan
    state = (torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    decays = torch.exp(a_total)                          # (b, nc, H)
    prev = torch.empty_like(states)
    for c in range(nc):
        prev[:, c] = state
        state = state * decays[:, c, :, None, None] + states[:, c]
    # y_inter[i] = y_decay[i] * C[i] . prev, group by group
    t = torch.einsum("bcign,bcgrpn->bcigrp", Cq.float(),
                     prev.reshape(b, nc, G, rep, P, N))
    y_inter = t.reshape(b, nc, chunk, H, P) * y_decay[..., None]
    y = (y_intra + y_inter).reshape(b, Sp, H, P)[:, :S]
    return y.to(x.dtype), state


def ssd_scan_op(x, dt, A, B, C, *, chunk: int = 256, intra_bf16: bool = False):
    """Chunked SSD: x (b,S,H,P); dt (b,S,H); A (H,); B, C (b,S,G,N).

    Returns (y (b,S,H,P) in x's dtype, final_state (b,H,P,N) f32), the
    contract of ``repro.models.ssm.ssd_chunked``, ``intra_bf16`` included
    (the JAX package's Pallas op has no such mode; its model then takes
    the jnp ``ssd_chunked``, whose twin this is).
    """
    return _chunked(x, dt, A, B, C, chunk, _per_chunk, intra_bf16=intra_bf16)


def ssd_chunked(x, dt, A, B, C, *, chunk: int = 256, initial_state=None,
                intra_bf16: bool = False):
    """``ssd_scan_op`` with the plain per-chunk terms on every device,
    and an optional initial state (b, H, P, N)."""
    return _chunked(x, dt, A, B, C, chunk, ssd_chunk_ref, initial_state, intra_bf16)
