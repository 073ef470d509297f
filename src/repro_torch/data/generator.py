"""Data pipeline, the port of ``repro.data.generator``: the ShuffleBench
load generator and synthetic LM batches for training.

* ``shufflebench_records`` — the paper's benchmark workload: records with
  random byte values; the key is the value's first 8 bytes (paper §5.1.1
  step ii), the timestamp the record's index past ``t0_us``.
* ``LoadGenerator`` — rate-capped generator (offered load above the
  system's capacity).
* ``lm_batch_stream`` — step-keyed synthetic token batches.

The first two are the JAX package's code with ``Record`` taken from
``repro_torch.core.records``: the same seed gives the same records.

In ``lm_batch_stream`` each step's batch is drawn from its own ``numpy.random.Generator``,
seeded by (seed, step), so a restart replays the same batches. The JAX
package draws from ``jax.random.key(step)``, whose stream cannot be
reproduced here: the two packages give different values for a step, and
parity tests feed both the same numpy batch. The shapes, dtypes and
layout are the JAX package's: text batches of tokens and their shifted
labels; for the stub frontends bf16 embeddings of ``d_model`` (audio
``frames``; vision ``patches`` before the tokens, whose labels are
``IGNORE`` over the patch positions).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import numpy as np
import torch

from repro_torch.core.records import Record
from repro_torch.training.train_step import IGNORE


def shufflebench_records(n: int, value_bytes: int = 1024, seed: int = 0,
                         t0_us: int = 0) -> List[Record]:
    rng = np.random.default_rng(seed)
    out = []
    vals = rng.bytes(n * value_bytes)
    for i in range(n):
        v = vals[i * value_bytes:(i + 1) * value_bytes]
        out.append(Record(key=v[:8], value=v, timestamp_us=t0_us + i))
    return out


@dataclasses.dataclass
class LoadGenerator:
    """Per-instance generator emitting up to ``rate`` records/s."""
    rate: float = 180_000.0
    value_bytes: int = 1024
    seed: int = 0

    def window(self, t_start: float, t_end: float) -> List[Record]:
        n = int((t_end - t_start) * self.rate)
        return shufflebench_records(n, self.value_bytes, seed=self.seed,
                                    t0_us=int(t_start * 1e6))


def lm_batch_stream(vocab_size: int, batch: int, seq: int, *, multimodal=None,
                    d_model: int = 0, seed: int = 0,
                    device="cuda") -> Callable[[int], Dict[str, torch.Tensor]]:
    """Returns batch_fn(step) -> the step's batch on ``device``:

    * text: {"tokens", "labels"}, (batch, seq) int32 each, the labels the
      tokens shifted by one (a draw of seq + 1 tokens a row);
    * audio: {"frames": (batch, seq, d_model) bf16, "labels": (batch, seq)};
    * vision (P = ``multimodal.num_patches``): {"tokens": (batch, seq - P),
      "patches": (batch, P, d_model) bf16, "labels": (batch, seq)} with
      the labels ``IGNORE`` over the first P positions (no loss on
      patches).

    The embeddings are standard normal, the tokens and labels uniform
    over the vocabulary."""
    kind = None if multimodal is None else multimodal.kind
    if kind not in (None, "audio", "vision"):
        raise ValueError(f"the port has no {kind!r} frontend; lm_batch_stream "
                         f"draws text, audio and vision batches")

    def ints(rng, shape):
        return torch.from_numpy(rng.integers(0, vocab_size, shape, dtype=np.int32)).to(device)

    def embeddings(rng, shape):
        x = rng.standard_normal(shape, dtype=np.float32)
        return torch.from_numpy(x).to(device).to(torch.bfloat16)

    def batch_fn(step: int) -> Dict[str, torch.Tensor]:
        rng = np.random.default_rng((seed, step))
        if kind == "audio":
            return {"frames": embeddings(rng, (batch, seq, d_model)),
                    "labels": ints(rng, (batch, seq))}
        if kind == "vision":
            P = multimodal.num_patches
            tokens = ints(rng, (batch, seq - P))
            patches = embeddings(rng, (batch, P, d_model))
            labels = ints(rng, (batch, seq))
            labels[:, :P] = IGNORE
            return {"tokens": tokens, "patches": patches, "labels": labels}
        toks = ints(rng, (batch, seq + 1))
        return {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}
    return batch_fn
