"""Plain PyTorch versions of the flash-attention kernel: dense attention,
the port of ``repro.models.attention.dense_attention`` (whose
``q_offset`` 0 form is the JAX package's ``flash_ref``), and
``flash_ref_f32p``, the same attention with the probabilities and V kept
in f32 for the second product, as ``repro.models.flash`` and the Pallas
kernel compute it.

``repro_torch.models.attention`` re-exports ``dense_attention`` from here,
so that this module depends on nothing of the model.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset=0,
                    kv_len: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Reference attention.

    q: (B, Sq, H, D); k, v: (B, Skv, KVH, D) with H % KVH == 0.
    ``q_offset``: position of q[0] relative to k[0] (decode: the current
    position). ``kv_len``: valid kv length (masks positions >= kv_len).
    ``scale``: multiplies the scores, 1/sqrt(D) unless given.
    Grouped-query heads read kv-head ``h // G`` without a repeat. Scores
    and the softmax are f32; the probabilities are rounded to v's dtype
    and the second product accumulates in f32, as the JAX einsums with
    ``preferred_element_type=f32`` do. The output has q's dtype.
    """
    probs = _probs(q, k, causal=causal, q_offset=q_offset, kv_len=kv_len,
                   scale=scale).to(v.dtype)
    return _weighted_sum(probs, v, q)


def _probs(q, k, *, causal, q_offset=0, kv_len=None, scale=None):
    """The f32 softmax probabilities (B, KVH, G, Sq, Skv) of q against k."""
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sq, KVH, H // KVH, D).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    kpos = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        qpos = torch.arange(Sq, device=q.device) + q_offset
        mask = mask & (qpos[:, None] >= kpos[None, :])
    if kv_len is not None:
        mask = mask & (kpos[None, :] < kv_len)
    scores = torch.where(mask, scores, torch.tensor(NEG_INF, device=q.device))
    return torch.softmax(scores, dim=-1)


def _weighted_sum(probs, v, q):
    """probs (B, KVH, G, Sq, Skv) times v (B, Skv, KVH, D) in f32 -> q's
    shape and dtype."""
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.float(), v.float())
    return out.reshape(q.shape).to(q.dtype)


def flash_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, scale: Optional[float] = None,
              q_offset: int = 0) -> torch.Tensor:
    """q (B,Sq,H,D); k,v (B,Skv,KVH,D) -> (B,Sq,H,D)."""
    return dense_attention(q, k, v, causal=causal, q_offset=q_offset, scale=scale)


def flash_ref_f32p(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, scale: Optional[float] = None,
                   q_offset: int = 0) -> torch.Tensor:
    """``flash_ref`` without rounding the probabilities to v's dtype: P and
    V enter the second product in f32, as in ``repro.models.flash`` (K and
    V cast to f32, ``p`` f32) and ``flash_attention_pallas``. The output
    has q's dtype."""
    return _weighted_sum(_probs(q, k, causal=causal, q_offset=q_offset, scale=scale),
                         v, q)
