"""Multi-head Latent Attention (DeepSeek-V2) with a compressed KV cache,
the port of ``repro.models.mla``.

Prefill expands keys and values from the latent ``c_kv`` and runs
``attention.attention_op`` (the flash kernel on CUDA tensors at long
sequences); V is zero-padded to the q/k head dim for it and sliced
after. The RoPE half of K is one head, broadcast to every head. Two
decode paths, as in the JAX package:
  * ``absorb=False`` (naive, the one ``lm`` calls): expand k_nope and v
    from the whole cached latent every step, then dense attention.
  * ``absorb=True``: fold W_uk into the query and W_uv into the output,
    so attention runs in the latent space; every product with the cache
    accumulates in f32 on the cache as it is stored, never rounded.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.attention import (NEG_INF, _out_proj, _project as _heads,
                                          attention_op, dense_attention)
from repro_torch.models.common import ArraySpec, ModelConfig, ParamModule
from repro_torch.models.layers import rms_norm
from repro_torch.models.rope import apply_rope


class MLA(ParamModule):
    """``wq`` (d, H, qk), ``w_dkv`` (d, kv_lora + rope), ``kv_norm``
    (kv_lora,) in f32 initialised to zero, ``w_uk`` (kv_lora, H, nope),
    ``w_uv`` (kv_lora, H, v), ``wo`` (H, v, d); qk = nope + rope."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        m = cfg.mla
        d, H, pd = cfg.d_model, cfg.num_heads, cfg.param_dtype
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        r = m.kv_lora_rank
        self.declare("wq", ArraySpec((d, H, qk), pd, ("embed", "heads", None)), device)
        self.declare("w_dkv", ArraySpec((d, r + m.qk_rope_head_dim), pd,
                                        ("embed", None)), device)
        self.declare("kv_norm", ArraySpec((r,), torch.float32, (None,), init="zeros"),
                     device)
        self.declare("w_uk", ArraySpec((r, H, m.qk_nope_head_dim), pd,
                                       (None, "heads", None)), device)
        self.declare("w_uv", ArraySpec((r, H, m.v_head_dim), pd,
                                       (None, "heads", None)), device)
        self.declare("wo", ArraySpec((H, m.v_head_dim, d), pd,
                                     ("heads", None, "embed")), device)


def _project(cfg: ModelConfig, p: MLA, x: torch.Tensor, positions: torch.Tensor):
    """The common projections: (q_nope, q_rope, c_kv, k_rope), k_rope
    (B, S, 1, rope) shared by every head."""
    m = cfg.mla
    cd = cfg.compute_dtype
    x = x.to(cd)
    q = _heads(x, p.wq.to(cd))
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions, cfg.rope_theta)
    dkv = x @ p.w_dkv.to(cd)
    c_kv = rms_norm(dkv[..., :m.kv_lora_rank], p.kv_norm, cfg.norm_eps)
    k_rope = apply_rope(dkv[..., None, m.kv_lora_rank:], positions, cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def _qk(cfg: ModelConfig, p: MLA, q_nope, q_rope, c_kv, k_rope):
    """q = [q_nope, q_rope] and k = [c_kv W_uk, k_rope broadcast to the
    heads], with v = c_kv W_uv; every product in the compute dtype."""
    cd = cfg.compute_dtype
    k_nope = _heads(c_kv.to(cd), p.w_uk.to(cd))
    v = _heads(c_kv.to(cd), p.w_uv.to(cd))
    k_rope = k_rope.to(cd).expand(*k_rope.shape[:2], cfg.num_heads, k_rope.shape[-1])
    return (torch.cat([q_nope, q_rope], dim=-1), torch.cat([k_nope, k_rope], dim=-1), v)


def _pad_v(v: torch.Tensor, d: int) -> torch.Tensor:
    """Pad the value head dim up to the q/k head dim (sliced off after)."""
    if v.shape[-1] == d:
        return v
    return torch.nn.functional.pad(v, (0, d - v.shape[-1]))


def mla_apply(cfg: ModelConfig, p: MLA, x: torch.Tensor, *,
              positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence MLA (prefill) through expanded keys and values."""
    q, k, v = _qk(cfg, p, *_project(cfg, p, x, positions))
    out = attention_op(cfg, q, k, _pad_v(v, q.shape[-1]), causal=cfg.causal)
    return _out_proj(cfg, p, out[..., :cfg.mla.v_head_dim])


def mla_cache_defs(cfg: ModelConfig, batch: int, max_seq: int, *,
                   stacked: int = 0) -> dict:
    m = cfg.mla
    L = (stacked,) if stacked else ()
    la = ("layers",) if stacked else ()
    return {
        "c_kv": ArraySpec(L + (batch, max_seq, m.kv_lora_rank), cfg.compute_dtype,
                          la + ("batch", "kv_seq", None), init="zeros"),
        "k_rope": ArraySpec(L + (batch, max_seq, m.qk_rope_head_dim), cfg.compute_dtype,
                            la + ("batch", "kv_seq", None), init="zeros"),
    }


def mla_decode(cfg: ModelConfig, p: MLA, x: torch.Tensor, cache: dict, pos: int, *,
               absorb: bool = False):
    """One-token MLA decode against the latent cache. x: (B, 1, d); cache
    {"c_kv": (B, S, kv_lora), "k_rope": (B, S, rope)}. ``pos`` is the
    number of tokens already in the cache. The new latent and RoPE key
    are written into the cache in place; returns (out (B, 1, d), cache)."""
    m = cfg.mla
    cd = cfg.compute_dtype
    positions = torch.tensor([pos], device=x.device)
    q_nope, q_rope, c_new, k_rope_new = _project(cfg, p, x, positions)
    c_cache, kr_cache = cache["c_kv"], cache["k_rope"]
    c_cache[:, pos] = c_new[:, 0].to(c_cache.dtype)
    kr_cache[:, pos] = k_rope_new[:, 0, 0].to(kr_cache.dtype)
    S = c_cache.shape[1]

    if absorb:
        scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
        q_abs = torch.einsum("bqhe,rhe->bqhr", q_nope.to(cd), p.w_uk.to(cd))
        c32 = c_cache.float()
        s = (torch.einsum("bqhr,bsr->bhqs", q_abs.float(), c32)
             + torch.einsum("bqhe,bse->bhqs", q_rope.to(cd).float(), kr_cache.float()))
        s = s * scale
        valid = torch.arange(S, device=x.device) < pos + 1
        s = torch.where(valid, s, torch.tensor(NEG_INF, device=x.device))
        probs = torch.softmax(s, dim=-1).to(cd)
        ctx = torch.einsum("bhqs,bsr->bqhr", probs.float(), c32)
        out = torch.einsum("bqhr,rhe->bqhe", ctx.to(cd).float(), p.w_uv.to(cd).float())
    else:
        q, k, v = _qk(cfg, p, q_nope, q_rope, c_cache, kr_cache[:, :, None, :])
        out = dense_attention(q, k, _pad_v(v, q.shape[-1]), causal=False,
                              kv_len=pos + 1)[..., :m.v_head_dim]
    return _out_proj(cfg, p, out), cache
