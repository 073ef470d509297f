"""Public entry points of the device blob data plane, the kernel surface
of ``repro.shuffle.api``.

  blob_pack_fused          Batcher: (rows, keys) -> blob layout
  unpack_from_keys         Debatcher: blob layout + keys -> rows
  compress_pack_fused      Batcher with the int8 codec
  unpack_decompress_fused  Debatcher with the int8 codec

Each runs where its tensors lie: on CUDA through the Hopper kernels, on
the CPU through their plain versions.
"""

from repro_torch.kernels.blob_codec.ops import (compress_pack_fused,
                                                unpack_decompress_fused)
from repro_torch.kernels.blob_pack.ops import blob_pack_fused
from repro_torch.kernels.blob_unpack.ops import unpack_from_keys

__all__ = ["blob_pack_fused", "unpack_from_keys", "compress_pack_fused",
           "unpack_decompress_fused"]
