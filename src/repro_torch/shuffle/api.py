"""Public entry points of the device blob data plane, the kernel surface
of ``repro.shuffle.api``.

  blob_pack_fused          Batcher: (rows, keys) -> blob layout
  unpack_from_keys         Debatcher: blob layout + keys -> rows
  compress_pack_fused      Batcher with the int8 codec
  unpack_decompress_fused  Debatcher with the int8 codec

Each runs where its tensors lie: on CUDA through the Hopper kernels, on
the CPU through their plain versions. ``ShuffleConfig`` holds the MoE
dispatch settings of the JAX package, field for field.
"""

import dataclasses

from repro_torch.kernels.blob_codec.ops import (compress_pack_fused,
                                                unpack_decompress_fused)
from repro_torch.kernels.blob_pack.ops import blob_pack_fused
from repro_torch.kernels.blob_unpack.ops import unpack_from_keys

__all__ = ["ShuffleConfig", "blob_pack_fused", "unpack_from_keys",
           "compress_pack_fused", "unpack_decompress_fused"]


@dataclasses.dataclass(frozen=True)
class ShuffleConfig:
    """Fields and defaults of ``repro.shuffle.api.ShuffleConfig``. Nothing
    in the port reads them yet: the ssm and hybrid kinds have no MoE
    layer, and the dispatch modes come with the MoE slice."""
    mode: str = "dense"                  # dense | direct | blob
    token_axes: tuple = ("pod", "data", "model")
    expert_axes: tuple = ("pod", "model")  # EP domain, major -> minor
    pod_axis: str = "pod"
    capacity_factor: float = 1.25
    compress_dcn: bool = False
    norm_topk: bool = True
    use_context_mesh: bool = False
