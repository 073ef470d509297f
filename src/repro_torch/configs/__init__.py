"""Architecture registry of the port: ``get_config("<arch-id>")``.

The ten architectures of ``repro.configs``, in its order, each with its
published config and a reduced SMOKE variant of the same family, field
for field as the JAX package's; and the shape cells that apply to each
(``get_shape``, ``all_cells``, ``all_skips``).
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.common import (ALL_SHAPES, ModelConfig, ShapeConfig,
                                       applicable_shapes, skipped_shapes)

ARCH_MODULES: Dict[str, str] = {
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    "gemma-2b": "repro_torch.configs.gemma_2b",
    "qwen2-72b": "repro_torch.configs.qwen2_72b",
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "llava-next-34b": "repro_torch.configs.llava_next_34b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2_7b",
}

ARCH_IDS: List[str] = list(ARCH_MODULES)


def get_config(arch: str, *, smoke: bool = False) -> ModelConfig:
    if arch not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port knows {ARCH_IDS}")
    mod = importlib.import_module(ARCH_MODULES[arch])
    return mod.SMOKE if smoke else mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}")


def all_cells():
    """Every applicable (arch, shape name) cell."""
    for arch in ARCH_IDS:
        for shape in applicable_shapes(get_config(arch)):
            yield arch, shape.name


def all_skips():
    """(arch, shape name, reason) of every cell that does not apply."""
    for arch in ARCH_IDS:
        for name, why in skipped_shapes(get_config(arch)):
            yield arch, name, why
