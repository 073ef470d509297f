"""Flash attention's backward in plain PyTorch, the port of the custom VJP
of ``repro.models.flash`` (``_flash_bwd``, flash-2 style): the block
scores are recomputed from q and k instead of saving the probabilities,
so no S x S tensor is ever held.

q runs in blocks of ``Q_CHUNK`` rows and k, v in blocks of ``KV_CHUNK``,
all in f32. Grouped-query heads read kv-head ``h // G`` (q is viewed as
(B, S, KVH, G, D)), so dk and dv sum the G heads of each kv head, as the
JAX backward folds them back. Blocks that the causal mask hides wholly
are skipped: every probability in them is exactly 0. Under the mask query
row i sits at position ``i + q_offset``, as in JAX's ``_flash_bwd``.

The JAX backward reads the log-sum-exp that its forward saved. The port's
forward is the CUDA kernel (or its plain version on the CPU), which does
not write it, so ``flash_lse`` recomputes it first, blockwise from q and
k, with the JAX forward's online softmax (running max from -1e30, lse
``m + log(max(l, 1e-30))``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30
Q_CHUNK, KV_CHUNK = 512, 1024


def _scores(qb, kb, scale, q0, k0, causal):
    """f32 scores (B, KVH, G, qc, kc) of a q block against a k block, the
    causal mask applied (q0, k0: the blocks' first positions, q0 with the
    query offset)."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb) * scale
    if causal and k0 + kb.shape[1] - 1 > q0:
        qpos = torch.arange(q0, q0 + qb.shape[1], device=qb.device)
        kpos = torch.arange(k0, k0 + kb.shape[1], device=qb.device)
        s = torch.where(qpos[:, None] >= kpos[None, :], s, s.new_full((), NEG_INF))
    return s


def _kv_blocks(q0: int, qn: int, Skv: int, causal: bool, kv_chunk: int):
    """The first positions of the kv blocks a q block at positions
    [q0, q0 + qn) sees."""
    end = min(Skv, q0 + qn) if causal else Skv
    return range(0, end, kv_chunk)


def _grouped(q: torch.Tensor, kvh: int) -> torch.Tensor:
    B, S, H, D = q.shape
    return q.reshape(B, S, kvh, H // kvh, D).float()


def flash_lse(q: torch.Tensor, k: torch.Tensor, *, causal: bool,
              scale: Optional[float] = None, q_chunk: int = Q_CHUNK,
              kv_chunk: int = KV_CHUNK, q_offset: int = 0) -> torch.Tensor:
    """The softmax's log-sum-exp of every q row, (B, KVH, G, Sq) in f32."""
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    qg, kf = _grouped(q, KVH), k.float()
    lse = qg.new_empty((B, KVH, H // KVH, Sq))
    for q0 in range(0, Sq, q_chunk):
        qb = qg[:, q0:q0 + q_chunk]
        m = qb.new_full((B, KVH, H // KVH, qb.shape[1]), NEG_INF)
        l = torch.zeros_like(m)
        for k0 in _kv_blocks(q0 + q_offset, qb.shape[1], Skv, causal, kv_chunk):
            s = _scores(qb, kf[:, k0:k0 + kv_chunk], scale, q0 + q_offset, k0, causal)
            m_new = torch.maximum(m, s.amax(dim=-1))
            l = l * torch.exp(m - m_new) + torch.exp(s - m_new[..., None]).sum(dim=-1)
            m = m_new
        lse[..., q0:q0 + q_chunk] = m + torch.log(torch.clamp(l, min=1e-30))
    return lse


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              out: torch.Tensor, dout: torch.Tensor, *, causal: bool,
              scale: Optional[float] = None, lse: Optional[torch.Tensor] = None,
              q_chunk: int = Q_CHUNK, kv_chunk: int = KV_CHUNK, q_offset: int = 0):
    """(dq, dk, dv) of attention(q, k, v) -> out against ``dout``, each in
    its input's dtype. q, out, dout (B, Sq, H, D); k, v (B, Skv, KVH, D);
    q's row i at position ``i + q_offset`` under the causal mask."""
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    if lse is None:
        lse = flash_lse(q, k, causal=causal, scale=scale, q_chunk=q_chunk,
                        kv_chunk=kv_chunk, q_offset=q_offset)
    qg, dog = _grouped(q, KVH), _grouped(dout, KVH)
    kf, vf = k.float(), v.float()
    # D_i = rowsum(dout * out), (B, KVH, G, Sq)
    delta = (dog * _grouped(out, KVH)).sum(dim=-1).permute(0, 2, 3, 1)
    dq = torch.zeros_like(qg)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for q0 in range(0, Sq, q_chunk):
        qb, dob = qg[:, q0:q0 + q_chunk], dog[:, q0:q0 + q_chunk]
        lse_b = lse[..., q0:q0 + q_chunk, None]
        delta_b = delta[..., q0:q0 + q_chunk, None]
        for k0 in _kv_blocks(q0 + q_offset, qb.shape[1], Skv, causal, kv_chunk):
            kb, vb = kf[:, k0:k0 + kv_chunk], vf[:, k0:k0 + kv_chunk]
            p = torch.exp(_scores(qb, kb, scale, q0 + q_offset, k0, causal) - lse_b)
            dv[:, k0:k0 + kv_chunk] += torch.einsum("bhgqk,bqhgd->bkhd", p, dob)
            dp = torch.einsum("bqhgd,bkhd->bhgqk", dob, vb)
            ds = p * (dp - delta_b) * scale
            dq[:, q0:q0 + q_chunk] += torch.einsum("bhgqk,bkhd->bqhgd", ds, kb)
            dk[:, k0:k0 + kv_chunk] += torch.einsum("bhgqk,bqhgd->bkhd", ds, qb)
    return (dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
