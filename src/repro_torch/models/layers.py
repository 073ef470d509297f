"""Basic layers, the port of ``repro.models.layers``: RMSNorm, the
SwiGLU MLP, embedding and unembedding, each a module that holds its
parameters and a function that applies it. The GeGLU/GELU MLPs and the
embedding scale of the decoder configs come with the decoder slice;
``lm`` refuses configs that ask for them."""

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
    """The SwiGLU MLP: ``w_gate``, ``w_up``, ``w_down``."""

    def __init__(self, cfg: ModelConfig, d_ff: int, device):
        super().__init__()
        d, pd = cfg.d_model, cfg.param_dtype
        self.declare("w_gate", ArraySpec((d, d_ff), pd, ("embed", "mlp")), device)
        self.declare("w_up", ArraySpec((d, d_ff), pd, ("embed", "mlp")), device)
        self.declare("w_down", ArraySpec((d_ff, d), pd, ("mlp", "embed")), device)


def mlp_apply(cfg: ModelConfig, p: MLP, x: torch.Tensor) -> torch.Tensor:
    cd = cfg.compute_dtype
    x = x.to(cd)
    g = F.silu(x @ p.w_gate.to(cd))
    u = x @ p.w_up.to(cd)
    return (g * u) @ p.w_down.to(cd)


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
    return p.tok[tokens.long()].to(cfg.compute_dtype)


def unembed_apply(cfg: ModelConfig, p: Embedding,
                  x: torch.Tensor) -> torch.Tensor:
    cd = cfg.compute_dtype
    if cfg.tie_embeddings:
        return x.to(cd) @ p.tok.to(cd).T
    return x.to(cd) @ p.unembed.to(cd)
