from repro_torch.checkpoint.blobstore_ckpt import (BlobCheckpointer, FileStore,
                                             latest_step)
from repro_torch.checkpoint.tiered import TieredCheckpointStore

__all__ = ["BlobCheckpointer", "FileStore", "TieredCheckpointStore",
           "latest_step"]
