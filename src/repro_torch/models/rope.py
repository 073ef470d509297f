"""Rotary position embeddings (rotate-half convention), the port of
``repro.models.rope``; computed in f32."""

from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim//2,), float32."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables for integer positions (...,) -> (..., head_dim//2)."""
    inv = rope_freqs(head_dim, theta, positions.device)
    angles = positions.float()[..., None] * inv
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions broadcastable to
    (..., seq). Pairs are (x[: d/2], x[d/2 :])."""
    head_dim = x.shape[-1]
    cos, sin = rope_cos_sin(positions, head_dim, theta)
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
