"""Blob format: concatenated per-partition buffers + byte-range index.

A finalized batch ("blob") is a single byte buffer composed of the
per-partition byte buffers, such that records for a given partition appear
sequentially within the blob (paper §3.1). The index maps partition id to
its byte range; notifications carry ``(blob_id, partition, range)``.
"""

from __future__ import annotations

import dataclasses
import uuid
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.formats import BlobFormat, detect_format
from repro_torch.core.recordbatch import RecordBatch
from repro_torch.core.records import Record, deserialize_all, serialize


@dataclasses.dataclass(frozen=True)
class ByteRange:
    offset: int
    length: int

    @property
    def end(self) -> int:
        return self.offset + self.length


@dataclasses.dataclass(frozen=True)
class BlobIndex:
    """partition id -> byte range within the blob payload."""
    ranges: Dict[int, ByteRange]

    def partitions(self) -> List[int]:
        return sorted(self.ranges)


@dataclasses.dataclass(frozen=True)
class Blob:
    blob_id: str
    payload: bytes          # any bytes-like (the batch path passes bytearray)
    index: BlobIndex
    target_az: int

    @property
    def size(self) -> int:
        return len(self.payload)


@dataclasses.dataclass(frozen=True)
class Notification:
    """Compact reference flowing through the messaging layer (paper Fig 2)."""
    blob_id: str
    partition: int
    byte_range: ByteRange
    target_az: int

    @property
    def size(self) -> int:
        return 48  # uuid + partition + range + az (wire estimate)


def new_blob_id() -> str:
    return uuid.uuid4().hex


def build_blob_from_buffers(per_partition: Dict[int, Sequence],
                            target_az: int,
                            blob_id: Optional[str] = None,
                            fmt: Optional[BlobFormat] = None
                            ) -> Tuple[Blob, List[Notification]]:
    """Assemble a blob from per-partition lists of already-serialized
    chunks (any bytes-like: ``bytes``, ``bytearray``, ``memoryview``).

    This is the zero-copy batch path: the payload is one preallocated
    buffer sized from the range math that is computed anyway, and every
    chunk is written into its final position exactly once — no
    intermediate chunk list, no join. ``fmt`` routes each partition's
    chunks through a wire format's ``encode_block`` (``None`` keeps the
    raw v1 identity path); byte ranges index the *encoded* blocks, so
    ranged GETs fetch exactly one decodable block and mixed-format blobs
    stay well-formed.
    """
    bid = blob_id or new_blob_id()
    encoded: List[Sequence] = []
    ranges: Dict[int, ByteRange] = {}
    off = 0
    for part in sorted(per_partition):
        enc = per_partition[part]
        if fmt is not None:
            enc = fmt.encode_block(enc)
        ln = sum(len(c) for c in enc)
        if ln == 0:
            continue
        encoded.append(enc)
        ranges[part] = ByteRange(off, ln)
        off += ln
    payload = bytearray(off)
    pos = 0
    for enc in encoded:
        for c in enc:
            ln = len(c)
            payload[pos:pos + ln] = c
            pos += ln
    blob = Blob(bid, payload, BlobIndex(ranges), target_az)
    notes = [Notification(bid, p, r, target_az)
             for p, r in sorted(ranges.items())]
    return blob, notes


def build_blob(per_partition: Dict[int, List[Record]], target_az: int,
               blob_id: Optional[str] = None) -> Tuple[Blob, List[Notification]]:
    """Concatenate per-partition record buffers into one blob + notifications
    (legacy per-``Record`` convenience; payload bytes are identical to the
    chunked path)."""
    return build_blob_from_buffers(
        {p: [serialize(r) for r in recs]
         for p, recs in per_partition.items()},
        target_az, blob_id)


def extract(payload, rng: ByteRange) -> List[Record]:
    """Debatch one partition's records from a blob payload (or sub-blob).
    The byte range is sliced as a ``memoryview`` — no payload copy. The
    block's format is sniffed per block, so blobs mixing raw and framed
    partitions decode transparently."""
    block = memoryview(payload)[rng.offset:rng.end]
    fmt = detect_format(block)
    if fmt.format_id == 1:
        return deserialize_all(block)       # raw v1: decode in place
    return fmt.decode_block_batch(block).to_records()


def extract_batch(payload, rng: ByteRange) -> RecordBatch:
    """Columnar debatch: one partition's byte range -> ``RecordBatch``
    (memoryview slice in, vectorized arena gather out — the payload bytes
    are never copied into intermediate per-record objects). Framed blocks
    are sniffed and decoded straight into the columnar form."""
    block = memoryview(payload)[rng.offset:rng.end]
    return detect_format(block).decode_block_batch(block)
