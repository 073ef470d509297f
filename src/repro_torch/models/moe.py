"""MoE FFN layer, the port of ``repro.models.moe``: shared experts
(always on, local, never shuffled) plus routed experts dispatched through
``repro_torch.shuffle.api``."""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.common import ArraySpec, ModelConfig, ParamModule
from repro_torch.shuffle.api import ShuffleConfig, dense_moe_ffn, ep_moe_ffn


class MoE(ParamModule):
    """``router`` (d, E) in f32; ``we_gate``/``we_up`` (E, d, d_e) and
    ``we_down`` (E, d_e, d); ``shared``, the shared experts fused into one
    SwiGLU of ``num_shared * d_e``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        m = cfg.moe
        d, de, E, pd = cfg.d_model, m.d_expert, m.num_experts, cfg.param_dtype
        self.declare("router", ArraySpec((d, E), torch.float32, ("embed", None),
                                         init="small"), device)
        self.declare("we_gate", ArraySpec((E, d, de), pd,
                                          ("experts", "embed", "expert_mlp")), device)
        self.declare("we_up", ArraySpec((E, d, de), pd,
                                        ("experts", "embed", "expert_mlp")), device)
        self.declare("we_down", ArraySpec((E, de, d), pd,
                                          ("experts", "expert_mlp", "embed")), device)
        if m.num_shared:
            # the JAX package's shared w_gate/w_up/w_down, with the SwiGLU
            # MLP's fan-in (d, then num_shared * d_e); the hidden dim is
            # replicated (logical axis None), as in the JAX package:
            # model-sharding it would fight the sequence-sharded residual
            self.shared = L.MLP(_swiglu(cfg), m.num_shared * de, device,
                                hidden_axis=None)


def _swiglu(cfg: ModelConfig) -> ModelConfig:
    """The shared experts are a SwiGLU whatever ``cfg.mlp`` (a GELU
    encoder's too), as in the JAX package."""
    return cfg if cfg.mlp == "swiglu" else dataclasses.replace(cfg, mlp="swiglu")


def shared_apply(cfg: ModelConfig, p: MoE, x: torch.Tensor) -> torch.Tensor:
    """The shared experts' SwiGLU on x (B, S, d), in the compute dtype."""
    return L.mlp_apply(_swiglu(cfg), p.shared, x)


def moe_apply(cfg: ModelConfig, p: MoE, x: torch.Tensor, *,
              shuffle: ShuffleConfig, mesh=None):
    """x: (B, S, d). Returns (y, aux_loss, diagnostics dict). With a mesh
    and a mode other than ``dense`` the routed experts run over the
    mesh's ranks: the B * S tokens are padded to a multiple of the
    token axes' product and the pad tokens masked out."""
    m = cfg.moe
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    if shuffle.mode == "dense" or mesh is None:
        y, aux, load = dense_moe_ffn(
            xt, p.router, p.we_gate, p.we_up, p.we_down, top_k=m.top_k,
            capacity_factor=m.capacity_factor, norm_topk=shuffle.norm_topk,
            compute_dtype=cfg.compute_dtype)
        # the JAX package reports no drops on this path, whatever the
        # capacity dropped; the loads and the capacity say how many
        diag = {"expert_load": load,
                "dropped": torch.zeros((), dtype=torch.int32, device=x.device),
                "dcn_bytes": torch.zeros((), dtype=torch.float32, device=x.device)}
    else:
        shuf = shuffle.resolve(mesh)
        devs = math.prod(mesh.shape[a] for a in shuf.token_axes)
        T = B * S
        pad = (-T) % devs
        if pad:
            xt = F.pad(xt, (0, 0, 0, pad))
        mask = (torch.arange(T + pad, device=x.device) < T).float()
        y, aux, dg = ep_moe_ffn(
            xt, p.router, p.we_gate, p.we_up, p.we_down, top_k=m.top_k,
            cfg=shuf, mesh=mesh, compute_dtype=cfg.compute_dtype,
            token_mask=mask)
        y = y[:T]
        diag = {"expert_load": dg.expert_load, "dropped": dg.dropped,
                "dcn_bytes": dg.dcn_bytes}
    y = y.reshape(B, S, d)
    if m.num_shared:
        y = y + shared_apply(cfg, p, x)
    return y.to(x.dtype), aux * m.aux_loss_coef, diag
