"""Specs of every model input (no device allocation), the port of
``repro.launch.specs``.

``input_specs(cfg, shape)`` returns an ``ArraySpec`` per step input, with
the JAX package's shapes and logical axes and torch dtypes; the sharding
rules of ``repro_torch.distributed.sharding`` read the axes.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.common import ArraySpec, ModelConfig, ShapeConfig


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, ArraySpec]:
    B, S = shape.global_batch, shape.seq_len

    if shape.step == "decode":
        return {"tokens": ArraySpec((B, 1), torch.int32, ("batch", None)),
                "pos": ArraySpec((), torch.int32, ())}

    specs: Dict[str, ArraySpec] = {}
    mm = cfg.multimodal
    if mm is not None and mm.kind == "audio":
        specs["frames"] = ArraySpec((B, S, cfg.d_model), torch.bfloat16,
                                    ("batch", "seq", None))
    elif mm is not None and mm.kind == "vision":
        P = mm.num_patches
        specs["tokens"] = ArraySpec((B, S - P), torch.int32, ("batch", "seq"))
        specs["patches"] = ArraySpec((B, P, cfg.d_model), torch.bfloat16,
                                     ("batch", "seq", None))
    else:
        specs["tokens"] = ArraySpec((B, S), torch.int32, ("batch", "seq"))

    if shape.step == "train":
        specs["labels"] = ArraySpec((B, S), torch.int32, ("batch", "seq"))
    return specs
