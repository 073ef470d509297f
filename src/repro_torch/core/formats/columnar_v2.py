"""Columnar v2: per-column encodings over the SoA arenas, framed per block.

The encoder parses a partition block's record wire bytes into a
``RecordBatch`` (the vectorized PR-3 parser) and re-emits it column by
column:

  * **keys** — dictionary-encoded when the keys are fixed-width and the
    distinct set is small (the Zipf-workload shape: a few hot keys
    dominate), else raw lengths + arena;
  * **timestamps** — delta-encoded from the first value (arrival order
    makes deltas tiny and highly repetitive);
  * **values** — the packed arena, frame-compressed; optionally int8
    per-row quantized first (``value_codec="int8"``, lossy, for float32
    numeric payloads — the blob-layer twin of the DCN quantizer in
    ``repro_torch.shuffle.compression``).

Every section is framed through ``codecs.encode_section`` (zlib vs
stored, negotiated by size). The whole block then negotiates against the
raw form: if the encoded block is not strictly smaller than the wire
bytes — or the rows carry record headers, which v2 does not cover — the
encoder falls back to raw v1 for that block. Decoders sniff per block,
so mixed blobs are fine.

Block layout (little-endian):

    0   4  MAGIC ``b"BSWF"``
    4   1  version = 2
    5   1  flags: bit0 keys-dict, bit1 ts-delta, bit2 values-int8
    6   4  n_records (u32)
    10  4  value_width (u32; nonzero only with values-int8)
    14  …  framed sections, in order:
           keys-dict:  codes | dict_lengths (u32) | dict_arena
           keys-raw:   key_lengths (u32) | key_arena
           timestamps: ts0 (u64) + deltas (i64[n-1])  — or u64[n] raw
           value_lengths (u32)
           values-int8: q (i8) | scales (f32)  — or value_arena raw
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.formats.base import WIRE_MAGIC, CorruptBlobError
from repro_torch.core.formats.codecs import (decode_section, encode_section,
                                       dequantize_value_arena,
                                       quantize_value_arena)
from repro_torch.core.recordbatch import RecordBatch, _offsets_from_lengths, \
    _ragged_gather

_BLOCK_HDR = struct.Struct("<4sBBII")    # magic, version, flags, n, vwidth

FLAG_KEYS_DICT = 1
FLAG_TS_DELTA = 2
FLAG_VALUES_INT8 = 4
_KNOWN_FLAGS = FLAG_KEYS_DICT | FLAG_TS_DELTA | FLAG_VALUES_INT8

#: dictionary encoding must at least halve the key column to be chosen
_DICT_MAX_FRACTION = 0.5


def _uniform_width(offsets: np.ndarray) -> Optional[int]:
    lengths = np.diff(offsets)
    if len(lengths) and (lengths == lengths[0]).all():
        return int(lengths[0])
    return None


def _code_dtype(n_dict: int):
    if n_dict <= 0xFF:
        return np.uint8
    if n_dict <= 0xFFFF:
        return np.dtype("<u2")
    return np.dtype("<u4")


class ColumnarV2:
    format_id = 2

    def __init__(self, *, value_codec: str = "zlib",
                 name: str = "columnar-v2"):
        if value_codec not in ("zlib", "int8"):
            raise ValueError(f"unknown value codec {value_codec!r}")
        self.value_codec = value_codec
        self.name = name

    # -- encode -----------------------------------------------------------
    def encode_block(self, chunks: Sequence) -> Sequence:
        wire = chunks[0] if len(chunks) == 1 else b"".join(chunks)
        batch = RecordBatch.from_buffer(wire)
        if len(batch) == 0 or batch.headers is not None:
            return chunks                       # raw fallback
        block = self._encode_batch(batch)
        if len(block) >= len(wire):
            return chunks                       # compression does not pay
        return [block]

    def _encode_batch(self, batch: RecordBatch) -> bytes:
        n = len(batch)
        flags = 0
        sections: List[bytes] = []
        # keys: dictionary when fixed-width and the distinct set is small
        kw = _uniform_width(batch.key_offsets)
        dict_enc = self._dict_encode(batch, kw) if kw else None
        if dict_enc is not None:
            flags |= FLAG_KEYS_DICT
            codes, dict_lengths, dict_arena = dict_enc
            sections.append(encode_section(codes))
            sections.append(encode_section(dict_lengths))
            sections.append(encode_section(dict_arena))
        else:
            klen = np.diff(batch.key_offsets).astype("<u4")
            sections.append(encode_section(klen))
            sections.append(encode_section(
                np.ascontiguousarray(batch.key_arena)))
        # timestamps: delta from ts0 (falls back to raw near the u64 top).
        # ts0-then-diffs is built as one <i8 array — ts0 < 2^63, so its
        # two's-complement bytes equal the <u8 image the format specifies.
        ts = batch.timestamps
        if n >= 1 and bool((ts < np.uint64(1 << 63)).all()):
            flags |= FLAG_TS_DELTA
            signed = ts.astype(np.int64)
            deltas = np.empty(n, "<i8")
            deltas[0] = signed[0]
            np.subtract(signed[1:], signed[:-1], out=deltas[1:])
            sections.append(encode_section(deltas))
        else:
            sections.append(encode_section(ts.astype("<u8")))
        # value lengths + arena (optionally int8-quantized)
        vlen = np.diff(batch.value_offsets).astype("<u4")
        sections.append(encode_section(vlen))
        arena = np.ascontiguousarray(batch.value_arena)
        vw = _uniform_width(batch.value_offsets)
        vwidth = 0
        if (self.value_codec == "int8" and vw and vw % 4 == 0
                and arena.size == n * vw):
            flags |= FLAG_VALUES_INT8
            vwidth = vw
            q, scales = quantize_value_arena(arena, vw)
            sections.append(encode_section(q))
            sections.append(encode_section(scales.astype("<f4", copy=False)))
        else:
            sections.append(encode_section(arena))
        hdr = _BLOCK_HDR.pack(WIRE_MAGIC, self.format_id, flags, n, vwidth)
        return hdr + b"".join(sections)

    @staticmethod
    def _dict_encode(batch: RecordBatch, kw: int
                     ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """(codes, dict_lengths, dict_arena) when a fixed-width dictionary
        pays, else None. Uniques sort ascending, so the encoding is a
        pure function of the key multiset (deterministic across runs)."""
        n = len(batch)
        arena = np.ascontiguousarray(batch.key_arena)
        if kw in (1, 2, 4, 8):
            flat = arena.view(f"<u{kw}")
            uniq, codes = np.unique(flat, return_inverse=True)
            uniq_bytes = uniq.view(np.uint8)
        else:
            rows = arena.reshape(n, kw).view(np.dtype((np.void, kw)))[:, 0]
            uniq, codes = np.unique(rows, return_inverse=True)
            uniq_bytes = uniq.view(np.uint8).reshape(-1)
        if len(uniq) > n * _DICT_MAX_FRACTION:
            return None
        return (codes.astype(_code_dtype(len(uniq))),
                np.full(len(uniq), kw, "<u4"), uniq_bytes)

    # -- decode -----------------------------------------------------------
    def decode_block(self, block) -> bytes:
        return bytes(self.decode_block_batch(block).serialize_rows())

    def decode_block_batch(self, block) -> RecordBatch:
        mv = memoryview(block)
        if len(mv) < _BLOCK_HDR.size:
            raise CorruptBlobError("truncated v2 block header")
        magic, version, flags, n, vwidth = _BLOCK_HDR.unpack_from(mv, 0)
        if magic != WIRE_MAGIC or version != self.format_id:
            raise CorruptBlobError(
                f"not a v2 block (magic={magic!r}, version={version})")
        if flags & ~_KNOWN_FLAGS:
            raise CorruptBlobError(f"unsupported v2 flags 0x{flags:02x}")
        off = _BLOCK_HDR.size
        # keys
        if flags & FLAG_KEYS_DICT:
            codes_raw, off = decode_section(mv, off)
            dlen_raw, off = decode_section(mv, off)
            darena_raw, off = decode_section(mv, off)
            if n == 0 or len(codes_raw) % n:
                raise CorruptBlobError("dict code section length mismatch")
            itemsize = len(codes_raw) // n
            if itemsize not in (1, 2, 4):
                raise CorruptBlobError(
                    f"dict codes have itemsize {itemsize}")
            codes = np.frombuffer(codes_raw, f"<u{itemsize}").astype(np.int64)
            dlen = np.frombuffer(dlen_raw, "<u4").astype(np.int64)
            darena = np.frombuffer(darena_raw, np.uint8)
            if len(dlen) == 0 or codes.max(initial=-1) >= len(dlen) \
                    or int(dlen.sum()) != darena.size:
                raise CorruptBlobError("dict section inconsistent")
            doff = _offsets_from_lengths(dlen)
            klen = dlen[codes]
            ka = _ragged_gather(darena, doff[:-1][codes], klen)
        else:
            klen_raw, off = decode_section(mv, off)
            ka_raw, off = decode_section(mv, off)
            klen = np.frombuffer(klen_raw, "<u4").astype(np.int64)
            ka = np.frombuffer(ka_raw, np.uint8)
        # timestamps
        ts_raw, off = decode_section(mv, off)
        if flags & FLAG_TS_DELTA:
            if len(ts_raw) != 8 * n:
                raise CorruptBlobError("delta timestamp section mismatch")
            if n == 0:
                ts = np.zeros(0, np.uint64)
            else:
                ts0 = np.frombuffer(ts_raw[:8], "<u8").astype(np.int64)
                deltas = np.frombuffer(ts_raw[8:], "<i8")
                ts = np.concatenate([ts0, ts0 + np.cumsum(deltas)]) \
                    .astype(np.uint64)
        else:
            ts = np.frombuffer(ts_raw, "<u8").astype(np.uint64)
        # values
        vlen_raw, off = decode_section(mv, off)
        vlen = np.frombuffer(vlen_raw, "<u4").astype(np.int64)
        if flags & FLAG_VALUES_INT8:
            q_raw, off = decode_section(mv, off)
            scales_raw, off = decode_section(mv, off)
            if vwidth <= 0 or vwidth % 4 or len(q_raw) != n * (vwidth // 4):
                raise CorruptBlobError("int8 value section mismatch")
            q = np.frombuffer(q_raw, np.int8).reshape(n, vwidth // 4)
            scales = np.frombuffer(scales_raw, "<f4")
            if len(scales) != n:
                raise CorruptBlobError("int8 scale section mismatch")
            va = dequantize_value_arena(q, scales, vwidth)
        else:
            va_raw, off = decode_section(mv, off)
            va = np.frombuffer(va_raw, np.uint8)
        if off != len(mv):
            raise CorruptBlobError(
                f"{len(mv) - off} trailing bytes after the last section")
        if len(klen) != n or len(vlen) != n or len(ts) != n \
                or int(klen.sum()) != ka.size or int(vlen.sum()) != va.size:
            raise CorruptBlobError("column lengths inconsistent with header")
        return RecordBatch(_offsets_from_lengths(klen), ka,
                           _offsets_from_lengths(vlen), va, ts)

    def __repr__(self) -> str:
        return f"ColumnarV2({self.name!r}, value_codec={self.value_codec!r})"
