"""Basic layers, the port of ``repro.models.layers``: RMSNorm, the
SwiGLU, GeGLU and plain GELU MLPs, embedding (with gemma's sqrt(d)
scale) and unembedding, each a module that holds its parameters and a
function that applies it. GELU is the tanh approximation, as
``jax.nn.gelu``'s default."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ArraySpec, ModelConfig, ParamModule


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with f32 statistics and the product in the input dtype,
    weight ``1 + w``."""
    dtype = x.dtype
    var = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(dtype)
    w = (1.0 + weight.float()).to(dtype)
    return x * inv * w


def norm_spec(d: int) -> ArraySpec:
    return ArraySpec((d,), torch.float32, ("embed",), init="zeros")


class MLP(ParamModule):
    """The MLP of ``cfg.mlp``: SwiGLU and GeGLU hold ``w_gate``, ``w_up``,
    ``w_down``; plain GELU ``w_up``, ``b_up``, ``w_down``, ``b_down``
    (the biases initialised to zero). ``hidden_axis`` is the logical axis
    of the hidden dim (``None``: replicated, as the MoE shared experts)."""

    def __init__(self, cfg: ModelConfig, d_ff: int, device, *,
                 hidden_axis: str | None = "mlp"):
        super().__init__()
        d, pd = cfg.d_model, cfg.param_dtype
        w_up = ArraySpec((d, d_ff), pd, ("embed", hidden_axis))
        w_down = ArraySpec((d_ff, d), pd, (hidden_axis, "embed"))
        if cfg.mlp in ("swiglu", "geglu"):
            self.declare("w_gate", w_up, device)
            self.declare("w_up", w_up, device)
            self.declare("w_down", w_down, device)
        else:
            self.declare("w_up", w_up, device)
            self.declare("b_up", ArraySpec((d_ff,), pd, (hidden_axis,), init="zeros"),
                         device)
            self.declare("w_down", w_down, device)
            self.declare("b_down", ArraySpec((d,), pd, ("embed",), init="zeros"), device)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def mlp_apply(cfg: ModelConfig, p: MLP, x: torch.Tensor) -> torch.Tensor:
    cd = cfg.compute_dtype
    x = x.to(cd)
    if cfg.mlp in ("swiglu", "geglu"):
        act = F.silu if cfg.mlp == "swiglu" else _gelu
        g = act(x @ p.w_gate.to(cd))
        u = x @ p.w_up.to(cd)
        return (g * u) @ p.w_down.to(cd)
    h = _gelu(x @ p.w_up.to(cd) + p.b_up.to(cd))
    return h @ p.w_down.to(cd) + p.b_down.to(cd)


class Embedding(ParamModule):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.declare("tok", ArraySpec((cfg.vocab_size, cfg.d_model),
                                      cfg.param_dtype, ("vocab", "embed"),
                                      init="small"), device)
        if not cfg.tie_embeddings:
            self.declare("unembed", ArraySpec((cfg.d_model, cfg.vocab_size),
                                              cfg.param_dtype,
                                              ("embed", "vocab")), device)


def embed_apply(cfg: ModelConfig, p: Embedding,
                tokens: torch.Tensor) -> torch.Tensor:
    """The token rows in the compute dtype; with ``cfg.embed_scale``
    times sqrt(d) rounded to that dtype first, as the JAX package
    multiplies by ``jnp.asarray(sqrt(d), cd)`` (a Python float would
    stay at f32 opmath precision and round the product differently)."""
    x = p.tok[tokens.long()].to(cfg.compute_dtype)
    if cfg.embed_scale:
        x = x * torch.full((), cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    return x


def unembed_apply(cfg: ModelConfig, p: Embedding,
                  x: torch.Tensor) -> torch.Tensor:
    cd = cfg.compute_dtype
    if cfg.tie_embeddings:
        return x.to(cd) @ p.tok.to(cd).T
    return x.to(cd) @ p.unembed.to(cd)
