"""Expert dispatch diagnostics and capacity arithmetic, the part of
``repro.shuffle.dispatch`` that the single-device MoE layer needs.

``_cap`` and ``pooled_capacity_factor`` decide which units are dropped,
so they stay plain Python on Python floats, as in the JAX package: a
float difference in ``ceil(expected * factor)`` would move a unit
across the capacity. The flat and blob dispatch over
``torch.distributed`` (``flat_dispatch_combine``,
``blob_dispatch_combine``) come with the dispatch slice.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class DispatchDiagnostics(NamedTuple):
    dropped: torch.Tensor       # units dropped to capacity overflow (global)
    expert_load: torch.Tensor   # (E,) tokens routed per expert (global)
    dcn_bytes: torch.Tensor     # payload bytes that crossed the pod axis


def _cap(expected: float, factor: float, align: int = 8) -> int:
    c = int(math.ceil(expected * factor))
    return max(align, -(-c // align) * align)


def pooled_capacity_factor(base: float, pool: int) -> float:
    """Slack needed shrinks ~1/sqrt(pool) when pooling independent demand,
    the statistical-multiplexing win of blob aggregation (paper §4)."""
    return 1.0 + (base - 1.0) / math.sqrt(max(pool, 1))
