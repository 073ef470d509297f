"""Model configuration and parameter definitions, the port of
``repro.models.common``.

The config dataclasses keep the JAX package's fields and defaults; dtypes
are torch dtypes. Two fields are left out: ``flash_q_chunk`` and
``flash_kv_chunk``, the Pallas kernel's tile sizes, which the CUDA kernel
does not take (its tiles are fixed at 64 rows). ``SSMConfig.intra_bf16``
holds the SSD chunk's intra-chunk tensors in bf16, as in the JAX package
(``repro_torch.kernels.ssd_scan``). ``ArraySpec`` declares one parameter
or cache array (shape, dtype, logical axes, init scheme) as in the JAX
package.
``fill_`` draws the distributions of the JAX ``ArraySpec.materialize``
from an explicit ``torch.Generator``: a fan-in scaled normal whose
fan-in excludes the ``layers``/``experts``/``stack`` axes, ``small``
(0.02), ``embed`` (1.0), zeros and ones. The numbers differ from ``jax.random``'s,
so parity tests load the JAX package's parameters through
``repro_torch.interop.params_from_jax`` instead.

Modules hold their parameters as ``nn.Parameter``s and record each one's
spec in ``ParamModule.specs``; ``init_params`` walks a module tree and
draws every parameter in place. Parameters are declared without
``requires_grad``, for serving; the train step makes them leaves that
require grad (``training.train_step``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class ArraySpec:
    """Shape + dtype + logical axes + init scheme of one array."""

    shape: tuple
    dtype: Any = torch.float32
    axes: tuple = ()
    init: str = "normal"     # normal | zeros | ones | embed | small
    init_scale: float = 1.0  # multiplier on top of the fan-in scaling

    def __post_init__(self):
        if self.axes and len(self.axes) != len(self.shape):
            raise ValueError(
                f"axes {self.axes} rank != shape {self.shape} rank")

    def scale(self) -> float:
        """Standard deviation of the normal draw (``normal``/``embed``/
        ``small``), as ``repro.models.common.ArraySpec.materialize``."""
        fan_dims = [
            d for d, a in zip(self.shape, self.axes or (None,) * len(self.shape))
            if a not in ("layers", "experts", "stack")
        ]
        fan_in = fan_dims[0] if fan_dims else 1
        if self.init == "embed":
            scale = 1.0
        elif self.init == "small":
            scale = 0.02
        else:
            scale = 1.0 / math.sqrt(max(fan_in, 1))
        return scale * self.init_scale

    def empty(self, device) -> torch.Tensor:
        return torch.empty(self.shape, dtype=self.dtype, device=device)


def fill_(t: torch.Tensor, spec: ArraySpec, generator: torch.Generator) -> None:
    """Draw ``t`` in place by ``spec``'s scheme (f32 draw, then cast)."""
    with torch.no_grad():
        if spec.init == "zeros":
            t.zero_()
        elif spec.init == "ones":
            t.fill_(1.0)
        else:
            x = torch.randn(t.shape, generator=generator, device=t.device,
                            dtype=torch.float32)
            t.copy_(x.mul_(spec.scale()))


class ParamModule(nn.Module):
    """An ``nn.Module`` whose own parameters are declared by specs."""

    def __init__(self):
        super().__init__()
        self.specs: dict = {}

    def declare(self, name: str, spec: ArraySpec, device) -> None:
        self.specs[name] = spec
        self.register_parameter(name, nn.Parameter(spec.empty(device),
                                                   requires_grad=False))


def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every declared parameter of ``module`` and its children from
    ``generator`` (on the parameters' device), in the order of
    ``named_modules``; returns ``module``."""
    if not isinstance(generator, torch.Generator):
        raise TypeError(f"init_params draws from a torch.Generator, got "
                        f"{type(generator).__name__}")
    for _, m in module.named_modules():
        if isinstance(m, ParamModule):
            for name, spec in m.specs.items():
                fill_(getattr(m, name), spec, generator)
    return module


def zeros_tree(defs, device="cuda"):
    """A nested dict of specs -> the same dict of zero tensors."""
    if isinstance(defs, dict):
        return {k: zeros_tree(v, device) for k, v in defs.items()}
    return torch.zeros(defs.shape, dtype=defs.dtype, device=device)


# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int            # routed experts
    top_k: int
    d_expert: int               # per-expert FFN hidden size
    num_shared: int = 0         # always-on shared experts (same d_expert)
    first_dense_layers: int = 0  # leading layers that use a dense FFN instead
    dense_d_ff: int = 0          # hidden size of those dense layers
    router_noise: float = 0.0
    aux_loss_coef: float = 0.001
    # token capacity factor of the dense (capacity-based) dispatch
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64
    ngroups: int = 1
    chunk: int = 256
    intra_bf16: bool = False  # quadratic intra-chunk tensors in bf16

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def nheads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.headdim


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0          # 0 = no query compression (v2-lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style: Mamba2 backbone with a shared attention block."""
    shared_block_every: int = 6   # one shared-block call per this many layers
    # the shared block consumes concat(h, h_embed) -> proj to d_model
    concat_embed: bool = True


@dataclasses.dataclass(frozen=True)
class MultimodalConfig:
    """Stub modality frontend: the batch brings precomputed embeddings."""
    kind: str = "vision"          # vision | audio
    num_patches: int = 2880       # patches (vision) per example
    frontend_dim: int = 0         # 0 => already projected to d_model


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    kind: str                      # decoder | encoder | ssm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 => d_model // num_heads
    mlp: str = "swiglu"            # swiglu | geglu | gelu
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    embed_scale: bool = False      # gemma: scale embeddings by sqrt(d)
    causal: bool = True
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    mla: Optional[MLAConfig] = None
    hybrid: Optional[HybridConfig] = None
    multimodal: Optional[MultimodalConfig] = None
    # numerics
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    # attention implementation threshold
    flash_min_seq: int = 2048      # below this use dense reference attention
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def sub_quadratic(self) -> bool:
        """Supports the long_500k decode shape (SSM / hybrid)."""
        return self.kind in ("ssm", "hybrid")

    @property
    def has_decode(self) -> bool:
        return self.kind != "encoder"

    def param_count(self) -> int:
        """Exact parameter count from the port's module tree, built on the
        meta device (no memory)."""
        from repro_torch.models import lm  # local import to avoid a cycle
        model = lm.LM(self, device="meta")
        return sum(p.numel() for p in model.parameters())

    def active_param_count(self) -> int:
        """Active params per token (MoE: shared + top_k routed only), the
        JAX package's formula over ``param_count``."""
        total = self.param_count()
        if self.moe is None:
            return total
        m = self.moe
        moe_layers = self.num_layers - m.first_dense_layers
        per_expert = 3 * self.d_model * m.d_expert
        inactive = moe_layers * (m.num_experts - m.top_k) * per_expert
        return total - inactive


# ---------------------------------------------------------------------------
# Shape presets (the four input-shape cells of the JAX package)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    step: str                      # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.step == "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def applicable_shapes(cfg: ModelConfig) -> list:
    """The shape cells that apply to this architecture: no decode shape
    for an encoder, long_500k for the sub-quadratic kinds only."""
    out = []
    for s in ALL_SHAPES:
        if s.is_decode and not cfg.has_decode:
            continue
        if s.name == "long_500k" and not cfg.sub_quadratic:
            continue
        out.append(s)
    return out


def skipped_shapes(cfg: ModelConfig) -> list:
    """(name, reason) of each shape cell that does not apply."""
    names = {s.name for s in applicable_shapes(cfg)}
    out = []
    for s in ALL_SHAPES:
        if s.name in names:
            continue
        if s.is_decode and not cfg.has_decode:
            out.append((s.name, "encoder-only arch has no decode step"))
        else:
            out.append((s.name, "pure full-attention arch; long_500k needs "
                                "sub-quadratic attention"))
    return out
