"""Architecture registry of the port: ``get_config("<arch-id>")``.

The port supports the Mamba2 (``ssm``) and Zamba2 (``hybrid``) kinds and
the ``decoder`` kind with the single-device MoE layer (qwen2-moe), MLA
with leading dense layers (deepseek-v2-lite), and GeGLU with scaled tied
embeddings (gemma-2b) so far; the other architectures of
``repro.configs`` (the encoder kind, the multimodal frontends, and the
decoders not registered here) come with later slices.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.common import ModelConfig

ARCH_MODULES: Dict[str, str] = {
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "gemma-2b": "repro_torch.configs.gemma_2b",
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2_7b",
}

ARCH_IDS: List[str] = list(ARCH_MODULES)


def get_config(arch: str, *, smoke: bool = False) -> ModelConfig:
    if arch not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port knows {ARCH_IDS}")
    mod = importlib.import_module(ARCH_MODULES[arch])
    return mod.SMOKE if smoke else mod.CONFIG
