"""Plain PyTorch version of the flash-attention kernel: dense attention,
the port of ``repro.models.attention.dense_attention`` (whose
``q_offset`` 0 form is the JAX package's ``flash_ref``).

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
                    kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reference attention.

    q: (B, Sq, H, D); k, v: (B, Skv, KVH, D) with H % KVH == 0.
    ``q_offset``: position of q[0] relative to k[0] (decode: the current
    position). ``kv_len``: valid kv length (masks positions >= kv_len).
    Grouped-query heads read kv-head ``h // G`` without a repeat. Scores
    and the softmax are f32; the probabilities are rounded to v's dtype
    and the second product accumulates in f32, as the JAX einsums with
    ``preferred_element_type=f32`` do. The output has q's dtype.
    """
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sq, KVH, G, D).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    kpos = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        qpos = torch.arange(Sq, device=q.device) + q_offset
        mask = mask & (qpos[:, None] >= kpos[None, :])
    if kv_len is not None:
        mask = mask & (kpos[None, :] < kv_len)
    scores = torch.where(mask, scores, torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.float(), v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


def flash_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True) -> torch.Tensor:
    """q (B,Sq,H,D); k,v (B,Skv,KVH,D) -> (B,Sq,H,D)."""
    return dense_attention(q, k, v, causal=causal)
