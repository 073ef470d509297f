"""Columnar record batches: the structure-of-arrays unit of flow.

A ``RecordBatch`` holds N records as contiguous byte arenas plus offset /
timestamp arrays (numpy-backed), so the hot path — partitioning, binning,
serialization — runs as vectorized array ops instead of per-``Record``
Python loops. ``Record`` remains the thin per-row view for compatibility.

Wire format is unchanged and bit-exact with ``repro_torch.core.records``: the
vectorized serializer emits exactly ``b"".join(serialize(r) for r in
rows)`` (property-tested), so legacy and columnar paths produce
bit-identical blob payloads.

Headers are rare on the hot path; they are kept as an optional per-record
Python tuple side-table. Rows without headers take the fully vectorized
path; rows with headers get their (variable, self-describing) header
block appended by a small fix-up loop at the correct wire position.
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.records import Record, _HDR

_HDR_NP = np.dtype([("klen", "<u4"), ("vlen", "<u4"),
                    ("ts", "<u8"), ("nh", "<u2")])
assert _HDR_NP.itemsize == _HDR.size

_FNV_OFFSET = np.uint64(0xCBF29CE484222325)
_FNV_PRIME = np.uint64(0x100000001B3)

_EMPTY_U8 = np.zeros(0, np.uint8)
_ZERO_OFF = np.zeros(1, np.int64)


def _offsets_from_lengths(lengths: np.ndarray) -> np.ndarray:
    out = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=out[1:])
    return out


def _ragged_gather(src: np.ndarray, starts: np.ndarray,
                   lengths: np.ndarray) -> np.ndarray:
    """Gather variable-length segments ``src[starts[i]:starts[i]+len[i]]``
    into one contiguous array, in order, with a single fancy index."""
    total = int(lengths.sum())
    if total == 0:
        return _EMPTY_U8
    seg_off = _offsets_from_lengths(lengths)
    idx = np.repeat(starts - seg_off[:-1], lengths) + np.arange(total)
    return src[idx]


class RecordBatch:
    """N records in structure-of-arrays layout.

    Arrays (all numpy):
      key_offsets    (N+1,) int64 — key i = key_arena[ko[i]:ko[i+1]]
      value_offsets  (N+1,) int64
      key_arena      (Kbytes,) uint8 — contiguous key bytes
      value_arena    (Vbytes,) uint8
      timestamps     (N,) uint64 — microseconds
      partitions     (N,) int32 or None — filled by the partitioner
      headers        tuple of per-record header tuples, or None (= none)
    """

    __slots__ = ("key_offsets", "value_offsets", "key_arena", "value_arena",
                 "timestamps", "partitions", "headers", "groups")

    def __init__(self, key_offsets: np.ndarray, key_arena: np.ndarray,
                 value_offsets: np.ndarray, value_arena: np.ndarray,
                 timestamps: np.ndarray,
                 headers: Optional[Tuple[Tuple[Tuple[bytes, bytes], ...],
                                         ...]] = None,
                 partitions: Optional[np.ndarray] = None):
        self.key_offsets = np.asarray(key_offsets, np.int64)
        self.value_offsets = np.asarray(value_offsets, np.int64)
        self.key_arena = np.asarray(key_arena, np.uint8)
        self.value_arena = np.asarray(value_arena, np.uint8)
        self.timestamps = np.asarray(timestamps, np.uint64)
        self.headers = headers
        self.partitions = partitions
        # opaque destination-grouping cache (owned by Batcher._group, so
        # the engine's arrival bookkeeping and the Batcher's binning share
        # one argsort); invalidated implicitly: row-subset views get None
        self.groups = None

    # -- construction -----------------------------------------------------
    @classmethod
    def empty(cls) -> "RecordBatch":
        return cls(_ZERO_OFF, _EMPTY_U8, _ZERO_OFF, _EMPTY_U8,
                   np.zeros(0, np.uint64))

    @classmethod
    def from_records(cls, records: Sequence[Record]) -> "RecordBatch":
        if not records:
            return cls.empty()
        keys = [r.key for r in records]
        values = [r.value for r in records]
        ko = _offsets_from_lengths(
            np.fromiter((len(k) for k in keys), np.int64, len(keys)))
        vo = _offsets_from_lengths(
            np.fromiter((len(v) for v in values), np.int64, len(values)))
        ka = np.frombuffer(b"".join(keys), np.uint8)
        va = np.frombuffer(b"".join(values), np.uint8)
        ts = np.fromiter((r.timestamp_us for r in records), np.uint64,
                         len(records))
        headers = (tuple(r.headers for r in records)
                   if any(r.headers for r in records) else None)
        return cls(ko, ka, vo, va, ts, headers)

    @classmethod
    def from_fixed(cls, keys_u64: np.ndarray, value_bytes: int,
                   timestamps_us: np.ndarray) -> "RecordBatch":
        """Vectorized builder for the common workload shape: 8-byte
        little-endian integer keys + constant-size zero values."""
        n = len(keys_u64)
        ka = np.ascontiguousarray(
            np.asarray(keys_u64).astype("<u8")).view(np.uint8)
        ko = np.arange(n + 1, dtype=np.int64) * 8
        vo = np.arange(n + 1, dtype=np.int64) * value_bytes
        va = np.zeros(n * value_bytes, np.uint8)
        return cls(ko, ka, vo, va, np.asarray(timestamps_us, np.uint64))

    @classmethod
    def from_buffer(cls, buf) -> "RecordBatch":
        """Parse a wire-format byte stream (the content of one blob byte
        range) into a columnar batch. The variable-length framing forces a
        sequential header scan, but key/value bytes are then gathered into
        the arenas with two vectorized passes — no per-record ``Record``
        objects or intermediate ``bytes`` copies are created."""
        mv = memoryview(buf)
        nbytes = len(mv)
        data = np.frombuffer(mv, np.uint8) if nbytes else _EMPTY_U8
        fast = cls._from_buffer_uniform(data)
        if fast is not None:
            return fast
        kst: List[int] = []
        kln: List[int] = []
        vln: List[int] = []
        ts: List[int] = []
        hdrs: List[Tuple[Tuple[bytes, bytes], ...]] = []
        any_hdrs = False
        unpack = _HDR.unpack_from
        hsz = _HDR.size
        p = 0
        while p < nbytes:
            klen, vlen, t, nh = unpack(mv, p)
            q = p + hsz
            kst.append(q)
            kln.append(klen)
            vln.append(vlen)
            ts.append(t)
            q += klen + vlen
            if nh:
                any_hdrs = True
                hs = []
                for _ in range(nh):
                    hk, hv = struct.unpack_from("<II", mv, q)
                    q += 8
                    hs.append((bytes(mv[q:q + hk]),
                               bytes(mv[q + hk:q + hk + hv])))
                    q += hk + hv
                hdrs.append(tuple(hs))
            else:
                hdrs.append(())
            p = q
        n = len(ts)
        if n == 0:
            return cls.empty()
        kst_a = np.asarray(kst, np.int64)
        kln_a = np.asarray(kln, np.int64)
        vln_a = np.asarray(vln, np.int64)
        ka = _ragged_gather(data, kst_a, kln_a)
        va = _ragged_gather(data, kst_a + kln_a, vln_a)
        return cls(_offsets_from_lengths(kln_a), ka,
                   _offsets_from_lengths(vln_a), va,
                   np.asarray(ts, np.uint64),
                   tuple(hdrs) if any_hdrs else None)

    @classmethod
    def _from_buffer_uniform(cls, data: np.ndarray) -> Optional["RecordBatch"]:
        """Opportunistic vectorized parse: hypothesize from the first
        header that every record has the same (klen, vlen, no headers)
        frame, then *verify* the hypothesis over all headers with one
        vectorized pass before trusting it. Returns None (→ generic scan)
        whenever the stream isn't uniform."""
        nbytes = data.size
        if nbytes < _HDR.size:
            return None
        kw, vw, _, nh = _HDR.unpack_from(data, 0)
        if nh != 0:
            return None
        row = _HDR.size + kw + vw
        if row == 0 or nbytes % row != 0:
            return None
        n = nbytes // row
        rows = data.reshape(n, row)
        hdr = np.ascontiguousarray(rows[:, :_HDR.size]).view(_HDR_NP)[:, 0]
        if not ((hdr["klen"] == kw).all() and (hdr["vlen"] == vw).all()
                and (hdr["nh"] == 0).all()):
            return None
        ka = (np.ascontiguousarray(rows[:, _HDR.size:_HDR.size + kw]).ravel()
              if kw else _EMPTY_U8)
        va = (np.ascontiguousarray(rows[:, _HDR.size + kw:]).ravel()
              if vw else _EMPTY_U8)
        return cls(np.arange(n + 1, dtype=np.int64) * kw, ka,
                   np.arange(n + 1, dtype=np.int64) * vw, va,
                   hdr["ts"].astype(np.uint64))

    # -- row access (compat views) ----------------------------------------
    def __len__(self) -> int:
        return len(self.timestamps)

    def key(self, i: int) -> bytes:
        return self.key_arena[
            self.key_offsets[i]:self.key_offsets[i + 1]].tobytes()

    def value(self, i: int) -> bytes:
        return self.value_arena[
            self.value_offsets[i]:self.value_offsets[i + 1]].tobytes()

    def record(self, i: int) -> Record:
        """Thin per-row ``Record`` view (copies the row's bytes)."""
        hs = self.headers[i] if self.headers is not None else ()
        return Record(self.key(i), self.value(i),
                      int(self.timestamps[i]), hs)

    def iter_records(self) -> Iterator[Record]:
        for i in range(len(self)):
            yield self.record(i)

    def to_records(self) -> List[Record]:
        return list(self.iter_records())

    # -- row selection -----------------------------------------------------
    def slice_rows(self, start: int, stop: int) -> "RecordBatch":
        """Zero-copy row slice: arenas and offsets are numpy views (the
        offset arrays are rebased, the byte arenas are shared)."""
        ko = self.key_offsets[start:stop + 1] - self.key_offsets[start]
        vo = self.value_offsets[start:stop + 1] - self.value_offsets[start]
        ka = self.key_arena[self.key_offsets[start]:self.key_offsets[stop]]
        va = self.value_arena[
            self.value_offsets[start]:self.value_offsets[stop]]
        hs = (self.headers[start:stop]
              if self.headers is not None else None)
        parts = (self.partitions[start:stop]
                 if self.partitions is not None else None)
        return RecordBatch(ko, ka, vo, va, self.timestamps[start:stop],
                           hs, parts)

    def select(self, idx: np.ndarray) -> "RecordBatch":
        """Gather arbitrary rows (vectorized ragged gather)."""
        idx = np.asarray(idx, np.int64)
        klen = self.key_offsets[idx + 1] - self.key_offsets[idx]
        vlen = self.value_offsets[idx + 1] - self.value_offsets[idx]
        ka = _ragged_gather(self.key_arena, self.key_offsets[idx], klen)
        va = _ragged_gather(self.value_arena, self.value_offsets[idx], vlen)
        hs = (tuple(self.headers[int(i)] for i in idx)
              if self.headers is not None else None)
        parts = (self.partitions[idx]
                 if self.partitions is not None else None)
        return RecordBatch(_offsets_from_lengths(klen), ka,
                           _offsets_from_lengths(vlen), va,
                           self.timestamps[idx], hs, parts)

    # -- serialization -----------------------------------------------------
    def _header_sizes(self, idx: np.ndarray) -> np.ndarray:
        hsz = np.zeros(len(idx), np.int64)
        if self.headers is not None:
            for j, i in enumerate(idx):
                hs = self.headers[int(i)]
                if hs:
                    hsz[j] = sum(8 + len(k) + len(v) for k, v in hs)
        return hsz

    def serialized_sizes(self) -> np.ndarray:
        """(N,) int64 — wire size of each row (vectorized Record.size)."""
        idx = np.arange(len(self), dtype=np.int64)
        return (_HDR.size
                + np.diff(self.key_offsets)
                + np.diff(self.value_offsets)
                + self._header_sizes(idx))

    @property
    def nbytes(self) -> int:
        return int(self.serialized_sizes().sum())

    def _uniform_widths(self) -> Optional[Tuple[int, int]]:
        """(key_width, value_width) when every row has the same key and
        value length and no headers — the fixed-size hot-path shape —
        else None."""
        if self.headers is not None or len(self) == 0:
            return None
        if (self.key_offsets[0] != 0 or self.value_offsets[0] != 0
                or self.key_arena.size != self.key_offsets[-1]
                or self.value_arena.size != self.value_offsets[-1]):
            return None    # arenas not densely packed from 0: generic path
        klen = np.diff(self.key_offsets)
        vlen = np.diff(self.value_offsets)
        if (klen == klen[0]).all() and (vlen == vlen[0]).all():
            return int(klen[0]), int(vlen[0])
        return None

    def serialize_rows(self, idx: Optional[np.ndarray] = None) -> bytearray:
        """Wire-serialize rows ``idx`` (default: all, in order) into one
        buffer — bit-exact with ``b"".join(serialize(row))``."""
        if idx is None:
            idx = np.arange(len(self), dtype=np.int64)
        else:
            idx = np.asarray(idx, np.int64)
        m = len(idx)
        if m == 0:
            return bytearray()
        uniform = self._uniform_widths()
        if uniform is not None:
            return self._serialize_rows_uniform(idx, *uniform)
        klen = self.key_offsets[idx + 1] - self.key_offsets[idx]
        vlen = self.value_offsets[idx + 1] - self.value_offsets[idx]
        hsz = self._header_sizes(idx)
        row_off = _offsets_from_lengths(_HDR.size + klen + vlen + hsz)
        out = bytearray(int(row_off[-1]))
        o = np.frombuffer(out, np.uint8)
        # fixed 18-byte headers: one packed struct-array scatter
        hdr = np.zeros(m, _HDR_NP)
        hdr["klen"] = klen
        hdr["vlen"] = vlen
        hdr["ts"] = self.timestamps[idx]
        if self.headers is not None:
            hdr["nh"] = [len(self.headers[int(i)]) for i in idx]
        dst = (row_off[:-1, None] + np.arange(_HDR.size)).ravel()
        o[dst] = hdr.view(np.uint8)
        # key bytes: ragged gather + ragged scatter
        self._scatter_segments(o, self.key_arena, self.key_offsets[idx],
                               klen, row_off[:-1] + _HDR.size)
        self._scatter_segments(o, self.value_arena, self.value_offsets[idx],
                               vlen, row_off[:-1] + _HDR.size + klen)
        # variable header blocks: rare fix-up loop at the exact wire offset
        if self.headers is not None:
            for j, i in enumerate(idx):
                hs = self.headers[int(i)]
                if not hs:
                    continue
                pos = int(row_off[j] + _HDR.size + klen[j] + vlen[j])
                for k, v in hs:
                    struct.pack_into("<II", out, pos, len(k), len(v))
                    pos += 8
                    out[pos:pos + len(k)] = k
                    pos += len(k)
                    out[pos:pos + len(v)] = v
                    pos += len(v)
        return out

    def _serialize_rows_uniform(self, idx: np.ndarray, kw: int,
                                vw: int) -> bytearray:
        """Fixed-width fast path: the wire buffer is one (m, row) matrix
        filled by column slices and row-level gathers — no per-byte index
        arrays, so serialization runs at near-memcpy speed."""
        m = len(idx)
        row = _HDR.size + kw + vw
        out = bytearray(m * row)
        o = np.frombuffer(out, np.uint8).reshape(m, row)
        hdr = np.zeros(m, _HDR_NP)
        hdr["klen"] = kw
        hdr["vlen"] = vw
        hdr["ts"] = self.timestamps[idx]
        o[:, :_HDR.size] = hdr.view(np.uint8).reshape(m, _HDR.size)
        if kw:
            o[:, _HDR.size:_HDR.size + kw] = \
                self.key_arena.reshape(-1, kw)[idx]
        if vw:
            o[:, _HDR.size + kw:] = self.value_arena.reshape(-1, vw)[idx]
        return out

    @staticmethod
    def _scatter_segments(out: np.ndarray, arena: np.ndarray,
                          src_starts: np.ndarray, lengths: np.ndarray,
                          dst_starts: np.ndarray) -> None:
        total = int(lengths.sum())
        if total == 0:
            return
        seg_off = _offsets_from_lengths(lengths)
        pos = np.arange(total)
        src = np.repeat(src_starts - seg_off[:-1], lengths) + pos
        dst = np.repeat(dst_starts - seg_off[:-1], lengths) + pos
        out[dst] = arena[src]


# -- vectorized partitioner -------------------------------------------------

def fnv1a_batch(key_arena: np.ndarray,
                key_offsets: np.ndarray) -> np.ndarray:
    """(N,) uint64 FNV-1a over the key arena — bit-exact with the scalar
    ``records.default_partitioner`` hash. Vectorized across records:
    iterate byte *positions* (max key length passes), each pass folding
    byte j of every still-active key with wrapping uint64 arithmetic."""
    n = len(key_offsets) - 1
    h = np.full(n, _FNV_OFFSET, np.uint64)
    if n == 0:
        return h
    starts = np.asarray(key_offsets[:-1], np.int64)
    lens = np.asarray(key_offsets[1:], np.int64) - starts
    arena = np.asarray(key_arena, np.uint8)
    with np.errstate(over="ignore"):
        if (starts[0] == 0 and arena.size == key_offsets[-1]
                and (lens == lens[0]).all()):
            # fixed-width keys over a packed arena: column-strided passes,
            # no boolean masks or index arrays
            w = int(lens[0])
            if w:
                mat = arena.reshape(n, w)
                for j in range(w):
                    h = (h ^ mat[:, j].astype(np.uint64)) * _FNV_PRIME
            return h
        for j in range(int(lens.max()) if n else 0):
            sel = lens > j
            b = arena[starts[sel] + j].astype(np.uint64)
            h[sel] = (h[sel] ^ b) * _FNV_PRIME
    return h


def default_partitioner_batch(batch: "RecordBatch",
                              num_partitions: int) -> np.ndarray:
    """(N,) int32 partition ids — vectorized ``default_partitioner``."""
    h = fnv1a_batch(batch.key_arena, batch.key_offsets)
    return (h % np.uint64(num_partitions)).astype(np.int32)
