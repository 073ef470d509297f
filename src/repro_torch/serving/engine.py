"""Serving steps, the port of ``repro.serving.engine``: prefill (the
full-sequence forward, logits only) and one-token decode with the
KV/state cache. Both run under ``torch.inference_mode``.

``ServeConfig`` keeps the JAX package's ``shuffle`` field, which selects
the MoE dispatch. The ssm and hybrid kinds have no MoE layer, so neither
package's steps read it for them, and it has no effect until the MoE
slice of the port. The JAX package's ``temperature`` is read by nothing
there and is left out; sampling is greedy."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import lm
from repro_torch.models.common import ModelConfig
from repro_torch.shuffle.api import ShuffleConfig


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    shuffle: ShuffleConfig = ShuffleConfig(mode="dense")


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)


def make_prefill_step(cfg: ModelConfig, scfg: ServeConfig):
    """prefill(params, batch{tokens}) -> logits (B, S, V)."""
    def prefill(params, batch):
        with torch.inference_mode():
            logits, _ = lm.forward(cfg, params, batch)
        return logits
    return prefill


def make_decode_step(cfg: ModelConfig, scfg: ServeConfig):
    """serve_step(params, cache, batch{tokens, pos}) -> (cache, next,
    logits). The cache is updated in place and returned."""
    def serve_step(params, cache, batch):
        with torch.inference_mode():
            logits, cache = lm.decode_step(cfg, params, cache, batch)
            nxt = greedy_sample(logits)
        return cache, nxt, logits
    return serve_step
