"""Record model + serialization (key, value, timestamp, headers).

Matches the paper's Batcher contract: records are buffered in serialized
form; a blob is the concatenation of per-partition byte buffers.
"""

from __future__ import annotations

import dataclasses
import functools
import struct
from typing import List, Tuple

_HDR = struct.Struct("<IIQH")  # key_len, value_len, timestamp_us, n_headers


@dataclasses.dataclass(frozen=True)
class Record:
    key: bytes
    value: bytes
    timestamp_us: int = 0
    headers: Tuple[Tuple[bytes, bytes], ...] = ()

    @functools.cached_property
    def size(self) -> int:
        # cached: records are frozen, and the hot path reads size per
        # buffered record (cached_property writes around the frozen guard)
        return serialized_size(self)


def serialized_size(rec: Record) -> int:
    n = _HDR.size + len(rec.key) + len(rec.value)
    for k, v in rec.headers:
        n += 8 + len(k) + len(v)
    return n


def serialize(rec: Record) -> bytes:
    out = [_HDR.pack(len(rec.key), len(rec.value), rec.timestamp_us,
                     len(rec.headers)), rec.key, rec.value]
    for k, v in rec.headers:
        out.append(struct.pack("<II", len(k), len(v)))
        out.append(k)
        out.append(v)
    return b"".join(out)


def deserialize(buf, offset: int = 0) -> Tuple[Record, int]:
    """Parse one record from any bytes-like object. Slicing goes through a
    ``memoryview`` so each field is copied exactly once — callers can pass
    a view over a blob payload without materializing the range first."""
    mv = buf if isinstance(buf, memoryview) else memoryview(buf)
    klen, vlen, ts, nh = _HDR.unpack_from(mv, offset)
    p = offset + _HDR.size
    key = bytes(mv[p:p + klen]); p += klen
    value = bytes(mv[p:p + vlen]); p += vlen
    headers = []
    for _ in range(nh):
        hk, hv = struct.unpack_from("<II", mv, p); p += 8
        headers.append((bytes(mv[p:p + hk]), bytes(mv[p + hk:p + hk + hv])))
        p += hk + hv
    return Record(key, value, ts, tuple(headers)), p


def deserialize_all(buf) -> List[Record]:
    mv = buf if isinstance(buf, memoryview) else memoryview(buf)
    out, p = [], 0
    end = len(mv)
    while p < end:
        rec, p = deserialize(mv, p)
        out.append(rec)
    return out


def default_partitioner(key: bytes, num_partitions: int) -> int:
    """Deterministic key -> partition (murmur-ish via FNV-1a, like Kafka's
    default semantics: stable across instances)."""
    h = 0xCBF29CE484222325
    for b in key:
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h % num_partitions
