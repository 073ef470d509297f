"""AdamW with global-norm clipping and a warmup-cosine schedule, the port
of ``repro.training.optimizer``.

Parameters are an ``nn.Module`` (the port's ``models.lm.LM``); gradients
and the moments are dicts keyed by the parameters' names
(``named_parameters``). The update runs per parameter in f32, in the
JAX package's order of operations, and writes the new values into the
module in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class OptConfig:
    learning_rate: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_frac``, in f32."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.learning_rate * warm * frac


def adamw_init(params: nn.Module) -> dict:
    """Zero f32 moments for every parameter and a step count of 0."""
    def zeros():
        return {n: torch.zeros_like(p, dtype=torch.float32)
                for n, p in params.named_parameters()}
    device = next(params.parameters()).device
    return {"m": zeros(), "v": zeros(),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree.values()))


@torch.no_grad()
def adamw_update(cfg: OptConfig, grads: Dict[str, torch.Tensor], opt_state: dict,
                 params: nn.Module) -> Tuple[nn.Module, dict, dict]:
    """One AdamW step: ``params`` updated in place and returned, with the
    new optimizer state and the metrics {grad_norm, lr}."""
    count = opt_state["count"] + 1
    gnorm = global_norm(grads)
    if cfg.grad_clip > 0:
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    else:
        scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
    lr = schedule(cfg, count)
    b1, b2 = cfg.beta1, cfg.beta2
    c1 = 1.0 - b1 ** count.to(torch.float32)
    c2 = 1.0 - b2 ** count.to(torch.float32)
    new_m, new_v = {}, {}
    for name, p in params.named_parameters():
        g = grads[name].to(torch.float32) * scale
        m = b1 * opt_state["m"][name] + (1 - b1) * g
        v = b2 * opt_state["v"][name] + (1 - b2) * torch.square(g)
        step = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        if cfg.weight_decay:
            step = step + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * step).to(p.dtype))
        new_m[name], new_v[name] = m, v
    return params, {"m": new_m, "v": new_v, "count": count}, {"grad_norm": gnorm, "lr": lr}
