"""Pluggable, versioned blob wire formats (see README "Blob wire format
& codecs").

Built-in registrations:

  * ``raw-v1``            — the legacy headerless layout (default; blobs
                            are byte-identical to pre-registry blobs)
  * ``columnar-v2``       — per-column encodings (dict keys, delta
                            timestamps, zlib-framed arenas), lossless
  * ``columnar-v2-int8``  — v2 with the int8 per-row value quantizer
                            (lossy; opt-in for float32 numeric payloads)

Custom formats register via ``register_format`` and become selectable by
name through ``BlobShuffleConfig.wire_format``.
"""

from repro_torch.core.formats.base import (WIRE_MAGIC, BlobFormat,
                                     BlobFormatError, CorruptBlobError,
                                     UnknownFormatError, detect_format,
                                     get_format, register_format,
                                     registered_formats)
from repro_torch.core.formats.columnar_v2 import ColumnarV2
from repro_torch.core.formats.raw_v1 import RawV1

RAW_V1 = register_format(RawV1())
COLUMNAR_V2 = register_format(ColumnarV2())
COLUMNAR_V2_INT8 = register_format(
    ColumnarV2(value_codec="int8", name="columnar-v2-int8"),
    canonical=False)

__all__ = [
    "WIRE_MAGIC", "BlobFormat", "BlobFormatError", "CorruptBlobError",
    "UnknownFormatError", "detect_format", "get_format", "register_format",
    "registered_formats", "RawV1", "ColumnarV2", "RAW_V1", "COLUMNAR_V2",
    "COLUMNAR_V2_INT8",
]
