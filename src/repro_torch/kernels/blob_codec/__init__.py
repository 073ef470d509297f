from repro_torch.kernels.blob_codec.ops import (compress_pack,
                                                compress_pack_fused,
                                                unpack_decompress,
                                                unpack_decompress_fused)

__all__ = ["compress_pack", "compress_pack_fused", "unpack_decompress",
           "unpack_decompress_fused"]
