"""Section codecs for framed blob formats.

Two layers:

  * **frame codecs** — every column section of a v2 block is framed as
    ``u8 codec | u32 enc_len | u32 raw_len | payload`` and the encoder
    negotiates per section: constant-pattern when the section is one
    repeating period (proved by a vectorized compare instead of a
    deflate pass), zlib when it wins, stored otherwise. The framing is
    self-describing, so new codecs slot in behind a new id without a
    version bump.
  * **int8 value codec** — the numpy twin of the device-side quantizer
    in ``repro_torch.shuffle.compression`` (same symmetric per-row absmax/127
    semantics), applied to a uniform-width float32 value arena. Lossy:
    only the explicitly-selected ``columnar-v2-int8`` format uses it.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple, Union

import numpy as np

from repro_torch.core.formats.base import CorruptBlobError

CODEC_STORED = 0
CODEC_ZLIB = 1
#: payload is one period of a repeating byte pattern; the section decodes
#: to ``payload * (raw_len // enc_len)``. Constant columns (uniform
#: lengths, all-zero arenas) are common in shuffle payloads, and zlib —
#: even at level 1 — pays a full deflate pass to discover what a single
#: vectorized compare can prove, so CONST is negotiated *before* zlib.
CODEC_CONST = 2

_SECTION_HDR = struct.Struct("<BII")      # codec, enc_len, raw_len

#: zlib level for section compression. Level 1 runs at frame-codec speed
#: (the arenas are the hot path) and captures nearly all of the win on
#: the highly redundant shuffle payloads the codec exists for.
ZLIB_LEVEL = 1

#: periods the constant-pattern probe tries, longest first (8 covers u64
#: columns; 4/2/1 cover u32/u16/byte-constant sections). A longer period
#: that also has a shorter one still round-trips identically, so probe
#: order only affects the (negligible) pattern-bytes overhead.
_CONST_PERIODS = (8, 4, 2, 1)


_PERIOD_DTYPE = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def _const_period(arr: np.ndarray) -> Optional[int]:
    """Longest probed period ``p`` such that ``arr`` is ``arr[:p]``
    tiled, or None. The first-two-periods screen rejects non-constant
    sections after comparing at most 16 bytes; only candidates that pass
    pay the full compare, done on a view with one integer per period
    (8x fewer compares and an 8x smaller bool temp than a byte-wise
    broadcast compare for the u64 case)."""
    n = arr.size
    for p in _CONST_PERIODS:
        if n % p or n < 2 * p:
            continue
        if not (arr[:p] == arr[p:2 * p]).all():
            continue
        v = arr.view(_PERIOD_DTYPE[p])
        if not (v != v[0]).any():
            return p
    return None


def encode_section(raw: Union[bytes, bytearray, memoryview, np.ndarray],
                   *, level: int = ZLIB_LEVEL,
                   try_compress: bool = True) -> bytes:
    """Frame one section, negotiating constant-pattern vs zlib vs stored
    by encoded size.

    ``raw`` may be bytes-like **or a numpy array** (any dtype; its
    C-contiguous little-endian byte image is framed) — array callers skip
    the ``tobytes`` copy the old bytes-only signature forced."""
    if isinstance(raw, np.ndarray):
        arr = np.ascontiguousarray(raw).reshape(-1).view(np.uint8)
    else:
        arr = np.frombuffer(raw, np.uint8)
    n = arr.size
    if try_compress and n > _SECTION_HDR.size:
        p = _const_period(arr)
        if p is not None:
            return _SECTION_HDR.pack(CODEC_CONST, p, n) + arr[:p].tobytes()
        enc = zlib.compress(arr, level)
        if len(enc) < n:
            return _SECTION_HDR.pack(CODEC_ZLIB, len(enc), n) + enc
    return _SECTION_HDR.pack(CODEC_STORED, n, n) + arr.tobytes()


def decode_section(block: memoryview, offset: int) -> Tuple[bytes, int]:
    """Decode one framed section at ``offset``; returns (raw bytes, next
    offset). Raises ``CorruptBlobError`` on truncation, an unknown codec
    id, or a decompressed-length mismatch."""
    end = offset + _SECTION_HDR.size
    if end > len(block):
        raise CorruptBlobError("truncated section header")
    codec, enc_len, raw_len = _SECTION_HDR.unpack_from(block, offset)
    if end + enc_len > len(block):
        raise CorruptBlobError(
            f"truncated section payload ({end + enc_len} > {len(block)})")
    payload = bytes(block[end:end + enc_len])
    if codec == CODEC_STORED:
        if enc_len != raw_len:
            raise CorruptBlobError("stored section length mismatch")
        raw = payload
    elif codec == CODEC_ZLIB:
        try:
            raw = zlib.decompress(payload)
        except zlib.error as e:
            raise CorruptBlobError(f"zlib section failed: {e}") from None
        if len(raw) != raw_len:
            raise CorruptBlobError(
                f"section inflated to {len(raw)} bytes, expected {raw_len}")
    elif codec == CODEC_CONST:
        if enc_len == 0 or raw_len % enc_len:
            raise CorruptBlobError(
                f"constant section: raw_len {raw_len} is not a multiple "
                f"of pattern length {enc_len}")
        raw = payload * (raw_len // enc_len)
    else:
        raise CorruptBlobError(f"unknown section codec id {codec}")
    return raw, end + enc_len


# -- int8 value codec --------------------------------------------------------

def quantize_value_arena(arena: np.ndarray, width: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int8 quantization of a packed float32 value
    arena (rows of ``width`` bytes, width % 4 == 0). Returns
    (q int8 (n, width/4), scales float32 (n,)) — bit-compatible with
    ``repro_torch.shuffle.compression.int8_quantize`` run per row."""
    x = np.frombuffer(np.ascontiguousarray(arena), "<f4")
    x = x.reshape(-1, width // 4)
    absmax = np.max(np.abs(x), axis=-1)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(x / scale[:, None]), -127, 127).astype(np.int8)
    return q, scale


def dequantize_value_arena(q: np.ndarray, scales: np.ndarray,
                           width: int) -> np.ndarray:
    """Inverse of ``quantize_value_arena``: back to a packed uint8 arena
    of float32 rows."""
    x = (q.astype(np.float32) * scales[:, None]).astype("<f4")
    return np.ascontiguousarray(x).reshape(-1).view(np.uint8)
