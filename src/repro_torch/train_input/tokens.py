"""Token-stream ⇄ Record codec for the shuffle-fed training input.

One training step's global batch is ``batch`` records, one per batch
row. Each record carries ``seq_len + 1`` int32 tokens (the LM input is
``value[:-1]``, the labels ``value[1:]``); its 8-byte key encodes
``(step, row)`` little-endian, which both routes it through the
engine's key partitioner and lets the consumer reassemble batches out
of any delivery order.

Generation is **step-keyed and deterministic** (a fresh
``np.random.Generator`` seeded from ``(seed, step)``): a restarted run
re-submits the identical records, which is what makes resume-after-crash
loss trajectories bit-identical to uninterrupted runs.

>>> cfg = TokenStreamConfig(vocab_size=64, batch=2, seq_len=4, seed=0)
>>> rb = step_records(cfg, step=3)
>>> len(rb)
2
>>> step, row, toks = decode_record(rb.record(1))
>>> (step, row, toks.shape, toks.dtype == np.int32)
(3, 1, (5,), True)
>>> rb2 = step_records(cfg, step=3)          # deterministic re-generation
>>> rb2.record(1).value == rb.record(1).value
True
>>> rows = {r: decode_record(rb.record(r))[2] for r in range(2)}
>>> b = assemble_batch(cfg, rows)
>>> sorted(b), b["tokens"].shape, b["labels"].shape
(['labels', 'tokens'], (2, 4), (2, 4))
>>> bool((b["tokens"][1, 1:] == b["labels"][1, :-1]).all())
True
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, Tuple

import numpy as np

from repro_torch.core.recordbatch import RecordBatch
from repro_torch.core.records import Record

_KEY = struct.Struct("<II")      # (step, row) little-endian


@dataclasses.dataclass(frozen=True)
class TokenStreamConfig:
    """Shape + determinism of the synthetic LM token stream."""
    vocab_size: int
    batch: int                   # global batch rows per training step
    seq_len: int                 # model sequence length S
    seed: int = 0

    @property
    def record_value_bytes(self) -> int:
        return (self.seq_len + 1) * 4


def step_tokens(cfg: TokenStreamConfig, step: int) -> np.ndarray:
    """The (batch, seq_len+1) int32 token matrix for ``step`` — the
    ground truth both the producer (``step_records``) and any verifier
    derive from."""
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, int(step)]))
    return rng.integers(0, cfg.vocab_size,
                        (cfg.batch, cfg.seq_len + 1), dtype=np.int32)


def step_records(cfg: TokenStreamConfig, step: int) -> RecordBatch:
    """Encode step ``step`` as a columnar ``RecordBatch`` of ``batch``
    records, ready for ``AsyncShuffleEngine.submit_batch``."""
    toks = step_tokens(cfg, step)
    recs = [Record(key=_KEY.pack(step, row),
                   value=toks[row].tobytes(),
                   timestamp_us=step)
            for row in range(cfg.batch)]
    return RecordBatch.from_records(recs)


def decode_record(rec: Record) -> Tuple[int, int, np.ndarray]:
    """A delivered ``Record`` back to ``(step, row, tokens[S+1])``."""
    step, row = _KEY.unpack(rec.key)
    toks = np.frombuffer(rec.value, dtype=np.int32)
    return step, row, toks


def assemble_batch(cfg: TokenStreamConfig,
                   rows: Dict[int, np.ndarray]) -> Dict[str, np.ndarray]:
    """Rows (``row -> tokens[S+1]``) to the model's train-step batch
    (``tokens``/``labels``, both (batch, seq_len) int32), shifted by one
    position like ``repro_torch.data.lm_batch_stream``."""
    if len(rows) != cfg.batch:
        missing = sorted(set(range(cfg.batch)) - set(rows))
        raise ValueError(f"incomplete batch: missing rows {missing}")
    mat = np.stack([rows[r] for r in range(cfg.batch)])
    return {"tokens": np.ascontiguousarray(mat[:, :-1]),
            "labels": np.ascontiguousarray(mat[:, 1:])}


def reference_batch(cfg: TokenStreamConfig, step: int
                    ) -> Dict[str, np.ndarray]:
    """What the shuffle-fed pipeline MUST produce for ``step`` — derived
    without the engine, used by tests and the resume correctness gate."""
    toks = step_tokens(cfg, step)
    return {"tokens": np.ascontiguousarray(toks[:, :-1]),
            "labels": np.ascontiguousarray(toks[:, 1:])}
