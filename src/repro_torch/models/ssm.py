"""Mamba2 (state-space duality / SSD) blocks, the port of
``repro.models.ssm``.

The block's prefill runs ``ssd_scan_op`` (the SSD chunk kernel on CUDA
tensors). ``ssd_chunked`` (plain per-chunk terms) and ``ssd_reference``
(the step-by-step recurrence) are the oracles the tests and the card's
checks hold it against. Decode runs ``ssd_decode_step``, one token at a
time, in plain torch as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.ops import ssd_chunked, ssd_scan_op
from repro_torch.models.common import ArraySpec, ModelConfig, ParamModule
from repro_torch.models.layers import rms_norm

__all__ = ["ssd_reference", "ssd_chunked", "ssd_decode_step", "Mamba2",
           "mamba2_apply", "mamba2_decode", "mamba2_cache_defs"]


def ssd_reference(x, dt, A, B, C, *, initial_state=None):
    """Naive sequential recurrence (oracle).

    x: (b, S, H, P); dt: (b, S, H); A: (H,); B, C: (b, S, G, N).
    Returns (y (b, S, H, P), final_state (b, H, P, N)).
    """
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    Bh = B.repeat_interleave(rep, dim=2).float()
    Ch = C.repeat_interleave(rep, dim=2).float()
    x32, dt32 = x.float(), dt.float()
    dA = torch.exp(dt32 * A.float()[None, None, :])
    state = (torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    ys = []
    for t in range(S):
        state = state * dA[:, t, :, None, None] + \
            (dt32[:, t, :, None, None] * x32[:, t, :, :, None]) * Bh[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), state


def ssd_decode_step(state, x, dt, A, B, C):
    """Single-token SSD update.

    state: (b, H, P, N); x: (b, H, P); dt: (b, H); B, C: (b, G, N).
    Returns (y (b, H, P), new_state).
    """
    H, G = x.shape[1], B.shape[1]
    rep = H // G
    Bh = B.repeat_interleave(rep, dim=1).float()
    Ch = C.repeat_interleave(rep, dim=1).float()
    dt32 = dt.float()
    dA = torch.exp(dt32 * A[None, :])
    state = state * dA[..., None, None] + \
        (dt32[..., None, None] * x.float()[..., None]) * Bh[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    return y.to(x.dtype), state


# ---------------------------------------------------------------------------
# Mamba2 block (in_proj -> conv -> SSD -> gated norm -> out_proj)
# ---------------------------------------------------------------------------

def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.d_inner(cfg.d_model)
    H = s.nheads(cfg.d_model)
    conv_ch = d_inner + 2 * s.ngroups * s.d_state
    d_in_proj = 2 * d_inner + 2 * s.ngroups * s.d_state + H
    return s, d_inner, H, conv_ch, d_in_proj


class Mamba2(ParamModule):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        s, d_inner, H, conv_ch, d_in_proj = _dims(cfg)
        pd, f32 = cfg.param_dtype, torch.float32
        self.declare("in_proj", ArraySpec((cfg.d_model, d_in_proj), pd,
                                          ("embed", "mlp")), device)
        self.declare("conv_w", ArraySpec((s.d_conv, conv_ch), pd, (None, "mlp"),
                                         init="small"), device)
        self.declare("conv_b", ArraySpec((conv_ch,), pd, ("mlp",), init="zeros"),
                     device)
        self.declare("A_log", ArraySpec((H,), f32, ("heads",), init="zeros"), device)
        self.declare("dt_bias", ArraySpec((H,), f32, ("heads",), init="zeros"), device)
        self.declare("D", ArraySpec((H,), f32, ("heads",), init="ones"), device)
        self.declare("norm", ArraySpec((d_inner,), f32, ("mlp",), init="zeros"), device)
        self.declare("out_proj", ArraySpec((d_inner, cfg.d_model), pd,
                                           ("mlp", "embed")), device)


def _split_in_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    s, d_inner, H, conv_ch, _ = _dims(cfg)
    gn = s.ngroups * s.d_state
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:d_inner + conv_ch]
    dt = zxbcdt[..., d_inner + conv_ch:]
    return z, xBC, dt, (s, d_inner, H, gn)


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. xBC: (B, S, C); w: (K, C); b: (C,)."""
    K, S = w.shape[0], xBC.shape[1]
    x = F.pad(xBC, (0, 0, K - 1, 0))
    out = torch.zeros(xBC.shape, dtype=torch.float32, device=xBC.device)
    for k in range(K):
        out = out + x[:, k:k + S].float() * w[k].float()
    return (out + b.float()).to(xBC.dtype)


def mamba2_apply(cfg: ModelConfig, p: Mamba2, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence Mamba2 block. x: (B, S, d_model)."""
    cd = cfg.compute_dtype
    zxbcdt = x.to(cd) @ p.in_proj.to(cd)
    z, xBC, dt, (s, d_inner, H, gn) = _split_in_proj(cfg, zxbcdt)
    xBC = F.silu(_causal_conv(xBC, p.conv_w, p.conv_b))
    b, S = x.shape[0], x.shape[1]
    xs = xBC[..., :d_inner].reshape(b, S, H, s.headdim)
    Bm = xBC[..., d_inner:d_inner + gn].reshape(b, S, s.ngroups, s.d_state)
    Cm = xBC[..., d_inner + gn:].reshape(b, S, s.ngroups, s.d_state)
    dt = F.softplus(dt.float() + p.dt_bias)
    A = -torch.exp(p.A_log)
    y, _ = ssd_scan_op(xs, dt, A, Bm, Cm, chunk=s.chunk, intra_bf16=s.intra_bf16)
    y = y + p.D[None, None, :, None] * xs.float()
    y = y.reshape(b, S, d_inner).to(cd)
    y = rms_norm(y * F.silu(z), p.norm, cfg.norm_eps)
    return y @ p.out_proj.to(cd)


def mamba2_cache_defs(cfg: ModelConfig, batch: int, *, stacked: int = 0) -> dict:
    s, d_inner, H, conv_ch, _ = _dims(cfg)
    L = (stacked,) if stacked else ()
    la = ("layers",) if stacked else ()
    return {
        "conv": ArraySpec(L + (batch, s.d_conv - 1, conv_ch), cfg.compute_dtype,
                          la + ("batch", None, "mlp"), init="zeros"),
        "state": ArraySpec(L + (batch, H, s.headdim, s.d_state), torch.float32,
                           la + ("batch", "heads", None, None), init="zeros"),
    }


def mamba2_decode(cfg: ModelConfig, p: Mamba2, x: torch.Tensor, cache: dict,
                  pos: int):
    """Single-token Mamba2 step. x: (B, 1, d_model); cache {"conv":
    (B, K-1, C), "state": (B, H, P, N)}. Returns (out (B, 1, d_model),
    new cache)."""
    cd = cfg.compute_dtype
    zxbcdt = x[:, 0].to(cd) @ p.in_proj.to(cd)
    z, xBC, dt, (s, d_inner, H, gn) = _split_in_proj(cfg, zxbcdt)
    window = torch.cat([cache["conv"], xBC[:, None]], dim=1)      # (B, K, C)
    conv_out = torch.einsum("bkc,kc->bc", window.float(), p.conv_w.float()) + \
        p.conv_b.float()
    xBC = F.silu(conv_out).to(cd)
    xs = xBC[..., :d_inner].reshape(-1, H, s.headdim)
    Bm = xBC[..., d_inner:d_inner + gn].reshape(-1, s.ngroups, s.d_state)
    Cm = xBC[..., d_inner + gn:].reshape(-1, s.ngroups, s.d_state)
    dt = F.softplus(dt.float() + p.dt_bias)
    A = -torch.exp(p.A_log)
    y, new_state = ssd_decode_step(cache["state"], xs, dt, A, Bm, Cm)
    y = y + p.D[None, :, None] * xs.float()
    y = y.reshape(-1, d_inner).to(cd)
    y = rms_norm(y * F.silu(z), p.norm, cfg.norm_eps)
    out = (y @ p.out_proj.to(cd))[:, None]
    return out, {"conv": window[:, 1:], "state": new_state}
