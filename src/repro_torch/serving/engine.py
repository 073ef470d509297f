"""Serving steps, the port of ``repro.serving.engine``: prefill (the
full-sequence forward, logits only) and one-token decode with the
KV/state cache. Both run under ``torch.inference_mode``.

``ServeConfig.shuffle`` selects the MoE dispatch and ``mesh`` the ranks
it runs over, as in the JAX package: both steps pass them to the model's
MoE layers. Without a mesh every mode takes the dense dispatch; the ssm
and hybrid kinds have no MoE layer. The prefill takes the batch of the
config's inputs: ``tokens``, ``frames`` (audio) or ``patches`` and
``tokens`` (vision); the decode step takes tokens, and an encoder has
none. The JAX package's ``temperature`` is read by nothing there and is
left out; sampling is greedy."""

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


def make_prefill_step(cfg: ModelConfig, scfg: ServeConfig, mesh=None):
    """prefill(params, batch{tokens | frames | patches, tokens}) ->
    logits (B, S, V)."""
    def prefill(params, batch):
        with torch.inference_mode():
            logits, _ = lm.forward(cfg, params, batch, mesh=mesh,
                                   shuffle=scfg.shuffle)
        return logits
    return prefill


def make_decode_step(cfg: ModelConfig, scfg: ServeConfig, mesh=None):
    """serve_step(params, cache, batch{tokens, pos}) -> (cache, next,
    logits). The cache is updated in place and returned. An encoder has
    no decode step: the step raises ``ValueError`` naming it."""
    def serve_step(params, cache, batch):
        with torch.inference_mode():
            logits, cache = lm.decode_step(cfg, params, cache, batch,
                                           mesh=mesh, shuffle=scfg.shuffle)
            nxt = greedy_sample(logits)
        return cache, nxt, logits
    return serve_step
