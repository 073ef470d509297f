"""Attention, the port of ``repro.models.attention``: dense reference
attention, the dense/flash dispatch, and the GQA/MQA/MHA layer for full
sequences and for one-token decode with a KV cache.

The flash branch calls ``repro_torch.kernels.flash_attention.ops
.flash_attention_op``: the Hopper kernel on CUDA tensors, its plain
version on CPU tensors.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.kernels.flash_attention.ref import NEG_INF, dense_attention
from repro_torch.models.common import ArraySpec, ModelConfig, ParamModule
from repro_torch.models.rope import apply_rope

__all__ = ["NEG_INF", "dense_attention", "attention_op", "Attention",
           "attention_qkv", "attention_apply", "attention_decode",
           "attention_cache_defs"]


def attention_op(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, *, causal: bool, q_offset: int = 0,
                 kv_len=None) -> torch.Tensor:
    """Dense attention when ``kv_len`` is given or
    ``max(Sq, Skv) <= cfg.flash_min_seq``, else the flash op. Under
    ``causal`` query row i sits at position ``i + q_offset``; a negative
    offset is refused on both branches. The flash op takes head dims that
    are multiples of 16, so another head dim D is zero-padded to the next
    one (zeros add nothing to q . k, and V's zero columns are sliced off)
    and the scale stays 1/sqrt(D), as the JAX flash branch computes it for
    any D."""
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset!r}")
    Sq, Skv = q.shape[1], k.shape[1]
    if kv_len is not None or max(Sq, Skv) <= cfg.flash_min_seq:
        return dense_attention(q, k, v, causal=causal, q_offset=q_offset,
                               kv_len=kv_len)
    D = q.shape[-1]
    pad = (-D) % 16
    if pad == 0:
        return flash_attention_op(q, k, v, causal=causal, q_offset=q_offset)
    q, k, v = (F.pad(t, (0, pad)) for t in (q, k, v))
    out = flash_attention_op(q, k, v, causal=causal, scale=1.0 / math.sqrt(D),
                             q_offset=q_offset)
    return out[..., :D]


class Attention(ParamModule):
    """q/k/v/o projections: wq (d, H, hd), wk/wv (d, KVH, hd),
    wo (H, hd, d); with ``cfg.qkv_bias`` the biases bq (H, hd) and bk/bv
    (KVH, hd), initialised to zero."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, H, KVH, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                         cfg.resolved_head_dim)
        pd = cfg.param_dtype
        self.declare("wq", ArraySpec((d, H, hd), pd, ("embed", "heads", None)), device)
        self.declare("wk", ArraySpec((d, KVH, hd), pd, ("kv_embed", "kv_heads", None)),
                     device)
        self.declare("wv", ArraySpec((d, KVH, hd), pd, ("kv_embed", "kv_heads", None)),
                     device)
        self.declare("wo", ArraySpec((H, hd, d), pd, ("heads", None, "embed")), device)
        if cfg.qkv_bias:
            self.declare("bq", ArraySpec((H, hd), pd, ("heads", None), init="zeros"),
                         device)
            self.declare("bk", ArraySpec((KVH, hd), pd, ("kv_heads", None),
                                         init="zeros"), device)
            self.declare("bv", ArraySpec((KVH, hd), pd, ("kv_heads", None),
                                         init="zeros"), device)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, d) @ (d, h, e) -> (B, S, h, e)."""
    d, h, e = w.shape
    return (x @ w.reshape(d, h * e)).reshape(*x.shape[:-1], h, e)


def attention_qkv(cfg: ModelConfig, p: Attention, x: torch.Tensor,
                  positions: torch.Tensor):
    """Project to q, k, v and apply RoPE. x: (B, S, d)."""
    cd = cfg.compute_dtype
    x = x.to(cd)
    q = _project(x, p.wq.to(cd))
    k = _project(x, p.wk.to(cd))
    v = _project(x, p.wv.to(cd))
    if cfg.qkv_bias:
        q = q + p.bq.to(cd)
        k = k + p.bk.to(cd)
        v = v + p.bv.to(cd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(cfg: ModelConfig, p: Attention, out: torch.Tensor) -> torch.Tensor:
    cd = cfg.compute_dtype
    H, hd, d = p.wo.shape
    return out.to(cd).reshape(*out.shape[:2], H * hd) @ p.wo.to(cd).reshape(H * hd, d)


def attention_apply(cfg: ModelConfig, p: Attention, x: torch.Tensor, *,
                    positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence attention (prefill), causal as ``cfg.causal``.
    x: (B, S, d)."""
    q, k, v = attention_qkv(cfg, p, x, positions)
    return _out_proj(cfg, p, attention_op(cfg, q, k, v, causal=cfg.causal))


def attention_decode(cfg: ModelConfig, p: Attention, x: torch.Tensor,
                     cache: dict, pos: int):
    """One-token decode. x: (B, 1, d); cache {"k", "v"}: (B, S, KVH, hd).

    ``pos`` is the number of tokens already in the cache. The new k and v
    are written into the cache in place (the JAX package returns an
    updated copy); returns (out (B, 1, d), cache).
    """
    positions = torch.tensor([pos], device=x.device)
    q, k_new, v_new = attention_qkv(cfg, p, x, positions)
    cache["k"][:, pos] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, pos] = v_new[:, 0].to(cache["v"].dtype)
    out = dense_attention(q, cache["k"], cache["v"], causal=False,
                          kv_len=pos + 1)
    return _out_proj(cfg, p, out), cache


def attention_cache_defs(cfg: ModelConfig, batch: int, max_seq: int, *,
                         stacked: int = 0) -> dict:
    KVH, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    L = (stacked,) if stacked else ()
    la = ("layers",) if stacked else ()
    spec = ArraySpec(L + (batch, max_seq, KVH, hd), cfg.compute_dtype,
                     la + ("batch", "kv_seq", "kv_heads", None), init="zeros")
    return {"k": spec, "v": spec}
