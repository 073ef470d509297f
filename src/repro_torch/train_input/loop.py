"""Shuffle-fed training loop, the port of ``repro.train_input.loop``
without its checkpoints.

``train_shuffle_fed`` makes the two halves of the repo one system: an
``AsyncShuffleEngine`` (built fresh and deterministically by
``engine_factory``) feeds batches through ``ShuffleFedInput`` into the
port's ``make_train_step``, which updates the ``lm.LM`` in place.
Parameters are drawn by ``init_model`` (a test swaps in the JAX
package's through ``interop.params_from_jax``); a numpy batch (no mesh)
goes to the parameters' device before the step.

``crash_at_step=s`` raises ``SimulatedCrash`` after step ``s``'s batch
was fetched but before the step runs, as in the JAX package. The blob
checkpointer is ported (``repro_torch.checkpoint``), but this loop's
resume path is not yet (``ROADMAP.md`` queue 1 item 3b): a ``ckpt`` is
refused, and so is ``resume=True``, which needs one. With it will come
``fast_forward``'s resume path and the step-0 manifest.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch

from repro_torch.models import lm
from repro_torch.models.common import init_params
from repro_torch.train_input.pipeline import ShuffleFedInput
from repro_torch.train_input.tokens import TokenStreamConfig
from repro_torch.training import adamw_init, make_train_step


class SimulatedCrash(RuntimeError):
    """Injected process death mid-step (benchmarks/tests)."""


@dataclasses.dataclass
class ShuffleTrainResult:
    start_step: int              # first step this run trained
    steps: List[int]             # steps actually trained, in order
    losses: List[float]          # float32-exact loss per trained step
    crashed: bool
    offsets_checked: bool        # resume verified offsets vs manifest
    input_stats: Dict[str, float]
    pipeline: ShuffleFedInput
    engine: object


def init_model(model_cfg, init_seed: int, device) -> lm.LM:
    """The model the loop trains, drawn from ``init_seed`` on ``device``."""
    return init_params(lm.LM(model_cfg, device=device),
                       torch.Generator(device=device).manual_seed(init_seed))


def train_shuffle_fed(model_cfg, tcfg, mesh, stream: TokenStreamConfig, *,
                      steps: int, engine_factory, ckpt=None,
                      ckpt_every: int = 4, resume: bool = False,
                      crash_at_step: Optional[int] = None,
                      step_fn=None, init_seed: int = 0,
                      pipeline_kwargs: Optional[dict] = None,
                      device="cuda") -> ShuffleTrainResult:
    """Run a shuffle-fed training session on ``device``. See module doc."""
    if resume and ckpt is None:
        raise ValueError("resume=True requires a checkpointer")
    if ckpt is not None:
        raise NotImplementedError(
            "the shuffle-fed loop's checkpoints and resume path are not ported "
            "yet (ROADMAP.md queue 1 item 3b): train_shuffle_fed runs with ckpt=None")
    engine = engine_factory()
    pipeline = ShuffleFedInput(engine, stream, steps=steps, mesh=mesh,
                               model_cfg=model_cfg, device=device,
                               **(pipeline_kwargs or {}))
    pipeline.submit()

    params = init_model(model_cfg, init_seed, device)
    at = next(params.parameters()).device
    opt = adamw_init(params)
    if step_fn is None:
        step_fn = make_train_step(model_cfg, tcfg, mesh=mesh)

    losses: List[float] = []
    trained: List[int] = []
    step_time_s = 0.0
    crashed = False
    try:
        for s in range(steps):
            got, batch, _hit = pipeline.next_batch()
            assert got == s, f"pipeline served {got}, trainer at {s}"
            if crash_at_step is not None and s == crash_at_step:
                raise SimulatedCrash(f"injected crash mid-step {s}")
            if mesh is None:
                batch = {k: torch.from_numpy(v).to(at) for k, v in batch.items()}
            t0 = time.perf_counter()
            params, opt, metrics = step_fn(params, opt, batch)
            loss = float(metrics["loss"])       # blocks on the step
            step_time_s += time.perf_counter() - t0
            losses.append(loss)
            trained.append(s)
    except SimulatedCrash:
        crashed = True     # process "dies": no drain

    if not crashed:
        pipeline.finish()

    m = engine.metrics
    stats = {
        "records_delivered": m.records_delivered,
        "bytes_delivered": m.bytes_delivered,
        "records_replayed": m.records_replayed,
        "engine_duplicates": m.duplicates_delivered,
        "duplicate_rows_filtered": pipeline.duplicate_rows,
        "skipped_rows": pipeline.skipped_rows,
        "requests": pipeline.requests,
        "prefetch_hits": pipeline.prefetch_hits,
        "overlap_fraction": (pipeline.prefetch_hits / pipeline.requests
                             if pipeline.requests else 0.0),
        "host_wait_s": pipeline.host_wait_s,
        "host_prefetch_s": pipeline.host_prefetch_s,
        "step_time_s": step_time_s,
    }
    return ShuffleTrainResult(0, trained, losses, crashed, False, stats,
                              pipeline, engine)
