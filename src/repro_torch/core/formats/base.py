"""Versioned blob wire formats: protocol, registry, and sniffing.

A blob stays what PR 3 made it — concatenated per-partition blocks plus a
byte-range index — but each *block* is now owned by a ``BlobFormat``:

  * ``RawV1`` is today's layout verbatim: the block IS the concatenated
    record wire bytes, with no header at all, so every legacy blob decodes
    byte-identically through it.
  * Framed formats (v2+) prefix each block with ``MAGIC`` + a version
    byte; the registry routes a block to its decoder by that header.

Because v1 has no header, detection is "no known magic → raw v1". A raw
stream can only collide with ``MAGIC`` if its first record claims a
``0x46575342``-byte (~1.1 GiB) key — unreachable for blobs batched at
MiB granularity (see README "Blob wire format & codecs").

Formats register by *name* (what ``BlobShuffleConfig.wire_format``
selects; one name per encoder configuration, e.g. ``columnar-v2`` vs the
lossy ``columnar-v2-int8``) and by *version byte* (what the decoder
sniffs; one canonical decoder per version, able to decode every flag
combination its encoders emit).
"""

from __future__ import annotations

from typing import Dict, List, Protocol, Sequence, runtime_checkable

from repro_torch.core.recordbatch import RecordBatch

#: Frame magic for versioned (v2+) blocks. Raw v1 blocks have no header.
WIRE_MAGIC = b"BSWF"


class BlobFormatError(Exception):
    """Base class for wire-format errors."""


class UnknownFormatError(BlobFormatError):
    """Block carries the frame magic but an unregistered version byte."""


class CorruptBlobError(BlobFormatError):
    """Block is truncated or internally inconsistent (bad section frame,
    failed decompression, length mismatch)."""


@runtime_checkable
class BlobFormat(Protocol):
    """One wire format for a per-partition blob block.

    ``encode_block`` takes the partition's already-serialized record
    chunks (any bytes-like) and returns the chunk list to splice into the
    blob payload — identity for raw v1 (zero-copy), a single encoded
    frame for framed formats. Encoders may *negotiate down*: returning
    the input chunks unchanged is the raw fallback, taken whenever the
    encoded form would not be smaller (or the rows use features the
    format does not cover, e.g. record headers).

    ``decode_block`` returns the raw record wire bytes (bit-exact with
    what ``encode_block`` consumed); ``decode_block_batch`` decodes
    straight into a columnar ``RecordBatch`` without materializing the
    intermediate wire form.
    """

    format_id: int     # version byte in the frame header (1 = headerless raw)
    name: str          # registry key used by BlobShuffleConfig.wire_format

    def encode_block(self, chunks: Sequence) -> Sequence: ...

    def decode_block(self, block) -> bytes: ...

    def decode_block_batch(self, block) -> RecordBatch: ...


_BY_NAME: Dict[str, BlobFormat] = {}
_BY_ID: Dict[int, BlobFormat] = {}


def register_format(fmt: BlobFormat, *, canonical: bool = True) -> BlobFormat:
    """Add a format to the registry. ``canonical=True`` also installs it
    as the decoder for its version byte — pass ``False`` for alternate
    encoder configurations of an already-registered version (they share
    the canonical decoder)."""
    if fmt.name in _BY_NAME:
        raise ValueError(f"wire format {fmt.name!r} already registered")
    if canonical and fmt.format_id in _BY_ID:
        raise ValueError(
            f"wire format version {fmt.format_id} already registered "
            f"(as {_BY_ID[fmt.format_id].name!r})")
    _BY_NAME[fmt.name] = fmt
    if canonical:
        _BY_ID[fmt.format_id] = fmt
    return fmt


def get_format(name: str) -> BlobFormat:
    try:
        return _BY_NAME[name]
    except KeyError:
        raise UnknownFormatError(
            f"unknown wire format {name!r}; registered: "
            f"{sorted(_BY_NAME)}") from None


def registered_formats() -> List[str]:
    return sorted(_BY_NAME)


def detect_format(block) -> BlobFormat:
    """Sniff one block's format from its leading bytes.

    Framed blocks open with ``MAGIC + version``; anything else is the
    headerless raw v1 layout (including the empty block). Raises
    ``UnknownFormatError`` for a framed block whose version byte has no
    registered decoder — a *typed* failure, so readers can distinguish
    "newer writer" from corruption.
    """
    mv = memoryview(block)
    if len(mv) >= len(WIRE_MAGIC) + 1 and bytes(mv[:4]) == WIRE_MAGIC:
        version = mv[4]
        fmt = _BY_ID.get(version)
        if fmt is None:
            raise UnknownFormatError(
                f"block carries wire-format version {version} but only "
                f"{sorted(_BY_ID)} are registered")
        return fmt
    return _BY_ID[1]     # headerless → raw v1
