"""Shuffle-fed training loop with blob checkpointing and crash/resume,
the port of ``repro.train_input.loop``.

``train_shuffle_fed`` makes the two halves of the repo one system: an
``AsyncShuffleEngine`` (built fresh and deterministically by
``engine_factory``) feeds batches through ``ShuffleFedInput`` into the
port's ``make_train_step``, which updates the ``lm.LM`` in place; every
``ckpt_every`` steps the model and optimizer state is checkpointed
through ``BlobCheckpointer`` with the pipeline's committed per-partition
offsets riding in the manifest's ``extra`` — model state and input
progress commit atomically. Parameters are drawn
by ``init_model`` (a test swaps in the JAX package's through
``interop.params_from_jax``); a numpy batch (no mesh) goes to the
parameters' device before the step.

Over a ``ProcessGroupMesh`` (one rank a process) every process runs
this loop on its own device: its own engine from the same factory, its
own ``ShuffleFedInput``, which puts the global batch there and checks at
each step that every process's batch is the same bits, and the step
over the processes (``make_train_step(..., mesh=mesh)``), whose losses,
parameters and moments come out the same on every process. So each
process's caller hands it a checkpointer over that process's own store:
each saves its whole replicated state, and a resume restores it on each
(``BlobCheckpointer.restore`` without ``shardings``).

The state saved and restored is ``interop.train_state_tree(model,
opt)``, the JAX package's train state tree over the model's and the
optimizer's own tensors, built anew at each save (the step returns a
new optimizer state); ``save`` copies it to the host before it
returns, and a restore writes it into the fresh model in place. So the
store holds the JAX package's layout, and either package resumes the
other's checkpoints.

Crash/resume contract (the resume-after-AZ-outage scenario of the JAX
package's ``benchmarks/train_input.py``):

* ``crash_at_step=s`` raises ``SimulatedCrash`` after step ``s``'s batch
  was fetched but before the step runs — a crash mid-step, with
  uncommitted work in flight;
* a ``resume=True`` run restores the latest manifest, rebuilds the
  engine from the same factory (the virtual-clock replay is
  bit-deterministic), fast-forwards the pipeline past the committed
  prefix, and cross-checks the replayed per-partition offsets against
  the manifest — so the resumed run re-trains exactly the uncommitted
  steps and nothing else;
* records are step-keyed (``train_input.tokens``) and parameters are
  stored as raw bytes, so the resumed loss trajectory is bit-identical
  to an uninterrupted run's.

For a deterministic crash window use a synchronous checkpointer
(``async_upload=False``): with async uploads, a manifest scheduled just
before the crash may or may not become visible — exactly the real-world
ambiguity, but not a reproducible gate. As in the JAX package, a run
whose ``steps`` is a multiple of ``ckpt_every`` saves its last step
twice, at its period and at the end.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch

from repro_torch.checkpoint import latest_step
from repro_torch.interop import train_state_tree
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
    """Run (or resume) shuffle-fed training on ``device``. See module doc."""
    if resume and ckpt is None:
        raise ValueError("resume=True requires a checkpointer")
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

    start, offsets_checked = 0, False
    if resume:
        last = latest_step(ckpt.store)
        if last is None:
            raise RuntimeError("resume requested but no committed manifest")
        m = ckpt.manifest(last)
        ckpt.restore(last, train_state_tree(params, opt))    # in place
        start = int(m["extra"]["next_step"])
        pipeline.fast_forward(start, m["extra"]["offsets"])
        offsets_checked = True
    elif ckpt is not None:
        # step-0 manifest: a crash before the first periodic checkpoint
        # still restores to a well-defined state
        ckpt.save(0, train_state_tree(params, opt),
                  extra={"next_step": 0, "offsets": {}})
        ckpt.wait()

    losses: List[float] = []
    trained: List[int] = []
    step_time_s = 0.0
    crashed = False
    try:
        for s in range(start, steps):
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
            if ckpt is not None and (s + 1) % ckpt_every == 0:
                pipeline.commit(s + 1)
                ckpt.save(s + 1, train_state_tree(params, opt),
                          extra={"next_step": s + 1,
                                 "offsets": pipeline.offsets()})
    except SimulatedCrash:
        crashed = True     # process "dies": no final commit, no drain

    if not crashed:
        if ckpt is not None:
            pipeline.commit(steps)
            ckpt.save(steps, train_state_tree(params, opt),
                      extra={"next_step": steps,
                             "offsets": pipeline.offsets()})
            ckpt.wait()
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
    return ShuffleTrainResult(start, trained, losses, crashed,
                              offsets_checked, stats, pipeline, engine)
