"""Synthetic LM token batches for training, the port of the text branch
of ``repro.data.generator.lm_batch_stream``.

Each step's batch is drawn from its own ``numpy.random.Generator``,
seeded by (seed, step), so a restart replays the same batches. The JAX
package draws from ``jax.random.key(step)``, whose stream cannot be
reproduced here: the two packages give different tokens for a step, and
parity tests feed both the same numpy batch. The audio and vision
branches come with the multimodal frontends, which the port does not run
yet.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch


def lm_batch_stream(vocab_size: int, batch: int, seq: int, *, multimodal=None,
                    d_model: int = 0, seed: int = 0,
                    device="cuda") -> Callable[[int], Dict[str, torch.Tensor]]:
    """Returns batch_fn(step) -> {"tokens", "labels"}: (batch, seq) int32
    each, the labels the tokens shifted by one (a draw of seq + 1 tokens
    a row), on ``device``."""
    if multimodal is not None:
        raise ValueError(f"the port has no {multimodal.kind!r} frontend yet; "
                         f"lm_batch_stream draws text batches only")

    def batch_fn(step: int) -> Dict[str, torch.Tensor]:
        rng = np.random.default_rng((seed, step))
        toks = torch.from_numpy(rng.integers(0, vocab_size, (batch, seq + 1),
                                             dtype=np.int32)).to(device)
        return {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}
    return batch_fn
