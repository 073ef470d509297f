from repro_torch.kernels.blob_codec.host import compress_pack_fused_host
from repro_torch.kernels.blob_codec.ops import (compress_pack,
                                                compress_pack_fused,
                                                unpack_decompress,
                                                unpack_decompress_fused)

__all__ = ["compress_pack", "compress_pack_fused",
           "compress_pack_fused_host", "unpack_decompress",
           "unpack_decompress_fused"]
