"""Raw v1: the legacy blob block layout, re-homed behind ``BlobFormat``.

A block is exactly the concatenation of record wire frames — no magic,
no header, nothing between the records. Every blob written before the
format registry existed is a raw-v1 blob, and this class decodes it
byte-identically (it IS the old ``extract`` / ``extract_batch`` path).
"""

from __future__ import annotations

from typing import Sequence

from repro_torch.core.recordbatch import RecordBatch


class RawV1:
    format_id = 1
    name = "raw-v1"

    def encode_block(self, chunks: Sequence) -> Sequence:
        """Identity: the chunks are already the wire layout (zero-copy —
        the caller joins them once into the blob payload)."""
        return chunks

    def decode_block(self, block) -> bytes:
        return block

    def decode_block_batch(self, block) -> RecordBatch:
        return RecordBatch.from_buffer(block)

    def __repr__(self) -> str:
        return f"RawV1({self.name!r})"
