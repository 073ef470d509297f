"""``ShuffleFedInput`` — the AsyncShuffleEngine as a training data source.

The adapter closes the loop between the repo's two halves: training
records are submitted to the shuffle engine as columnar
``RecordBatch``es (one per step, spaced on the virtual clock), and the
engine's delivered output (``engine.out[partition]``) is drained through
monotonic per-partition cursors, decoded, and reassembled into the
model's ``tokens``/``labels`` batches — sharded onto the mesh via
``launch.specs.input_specs`` + ``distributed.sharding`` when a mesh is
given.

Three properties the training loop leans on:

* **double-buffering on the virtual clock** — after serving step ``s``
  the pipeline immediately advances the engine until step
  ``s + prefetch_steps`` is fully staged (or the event heap drains), so
  by the time the trainer asks for ``s + 1`` the rows are already
  resident; ``prefetch_hits / requests`` is the step-time overlap
  fraction reported by the benchmark;
* **exactly-once consumption** — every delivered record is identified by
  its ``(step, row)`` key; replays/duplicates the engine's exactly-once
  commit path lets through during failure scenarios are filtered here
  and counted (``duplicate_rows``), so a batch can never contain a row
  twice and a step can never be assembled twice;
* **committed offsets** — ``commit(upto)`` folds the per-partition
  delivery counts of consumed steps into an offsets table that the
  trainer persists inside the checkpoint manifest (atomically with the
  model state). On restart, ``fast_forward`` replays the engine from
  zero, drops exactly the committed prefix, and cross-checks the
  recomputed offsets against the manifest — a restart can neither skip
  nor re-train a batch without tripping this gate.
"""

from __future__ import annotations

import time
from collections import Counter, defaultdict
from typing import Dict, Optional, Set, Tuple

import numpy as np

from repro_torch.train_input.tokens import (TokenStreamConfig, assemble_batch,
                                      decode_record, step_records)


class ShuffleFedInput:
    """Drives an ``AsyncShuffleEngine`` as a step-indexed batch source."""

    def __init__(self, engine, stream: TokenStreamConfig, *,
                 steps: int, prefetch_steps: int = 2,
                 step_interval_s: float = 0.05,
                 time_slice_s: float = 0.05,
                 start_t: float = 0.0,
                 mesh=None, model_cfg=None, rules=None, device="cuda"):
        self.engine = engine
        self.stream = stream
        self.steps = steps
        self.prefetch_steps = max(1, prefetch_steps)
        self.step_interval_s = step_interval_s
        self.time_slice_s = time_slice_s
        self.start_t = start_t
        # -- consumption state --------------------------------------------
        self._next = 0              # next step to serve to the trainer
        self._consumed_upto = 0     # steps < this are committed
        self._cursor: Dict[int, int] = defaultdict(int)
        self._staged: Dict[int, Dict[int, np.ndarray]] = {}
        self._seen: Set[Tuple[int, int]] = set()
        self._step_parts: Dict[int, Counter] = {}
        self._offsets: Dict[int, int] = {}
        self._horizon = start_t     # monotonic loop-advance watermark
        # -- counters -------------------------------------------------------
        self.requests = 0
        self.prefetch_hits = 0      # batches already staged when requested
        self.duplicate_rows = 0     # engine replays filtered by (step,row)
        self.late_rows = 0          # rows for already-committed steps
        self.skipped_rows = 0       # committed prefix dropped on resume
        self.host_wait_s = 0.0      # blocking collect time the step sees
        self.host_prefetch_s = 0.0  # overlapped advance time
        self._put = (self._make_device_put(mesh, model_cfg, rules, device)
                     if mesh is not None else None)

    # -- producer side ------------------------------------------------------
    def submit(self) -> None:
        """Schedule every step's RecordBatch on the virtual clock (an open
        stream arriving one micro-batch per ``step_interval_s``) and arm
        the engine's periodic commit cadence."""
        for s in range(self.steps):
            self.engine.submit_batch(self.start_t + s * self.step_interval_s,
                                     step_records(self.stream, s))
        self.engine.start()

    # -- consumer side ------------------------------------------------------
    def _drain(self) -> None:
        """Fold newly delivered records (past each partition cursor) into
        the staging tables; filter duplicates by ``(step, row)``."""
        for p, lst in self.engine.out.items():
            c = self._cursor[p]
            if c >= len(lst):
                continue
            for rec in lst[c:]:
                step, row, toks = decode_record(rec)
                key = (step, row)
                if key in self._seen:
                    self.duplicate_rows += 1
                    continue
                self._seen.add(key)
                self._step_parts.setdefault(step, Counter())[p] += 1
                if step < self._consumed_upto:
                    self.late_rows += 1
                else:
                    self._staged.setdefault(step, {})[row] = toks
            self._cursor[p] = len(lst)

    def _complete(self, step: int) -> bool:
        return len(self._staged.get(step, ())) == self.stream.batch

    def _advance(self, step: int, strict: bool) -> None:
        """Run the event loop in ``time_slice_s`` increments until
        ``step`` is fully staged. ``strict`` raises if the heap drains
        first (a lost batch); prefetch passes ``strict=False`` and just
        stops at the heap's end."""
        loop = self.engine.loop
        while not self._complete(step):
            if loop.pending() == 0:
                if strict:
                    have = len(self._staged.get(step, ()))
                    raise RuntimeError(
                        f"engine drained before step {step} was delivered "
                        f"({have}/{self.stream.batch} rows staged)")
                return
            self._horizon = max(self._horizon, loop.now) + self.time_slice_s
            loop.run(until=self._horizon)
            self._drain()

    def prefetch(self) -> None:
        """Advance the clock until ``prefetch_steps`` future steps are
        staged — the input runs ahead of training on the virtual clock."""
        t0 = time.perf_counter()
        target = min(self._next + self.prefetch_steps - 1, self.steps - 1)
        for s in range(self._next, target + 1):
            self._advance(s, strict=False)
        self.host_prefetch_s += time.perf_counter() - t0

    def next_batch(self):
        """The next step's batch: ``(step, batch, prefetched)``.

        ``batch`` is ``tokens``/``labels`` numpy (or sharded device
        arrays when the pipeline was built with a mesh); ``prefetched``
        is True when the rows were already staged — the double-buffer
        absorbed the input latency."""
        s = self._next
        if s >= self.steps:
            raise StopIteration(f"stream exhausted at step {self.steps}")
        self.requests += 1
        hit = self._complete(s)
        if hit:
            self.prefetch_hits += 1
        else:
            t0 = time.perf_counter()
            self._advance(s, strict=True)
            self.host_wait_s += time.perf_counter() - t0
        rows = self._staged.pop(s)
        batch = assemble_batch(self.stream, rows)
        self._next = s + 1
        self.prefetch()
        if self._put is not None:
            batch = self._put(batch)
        return s, batch, hit

    # -- commit / resume ----------------------------------------------------
    def commit(self, upto_step: int) -> None:
        """Mark steps ``< upto_step`` consumed: their per-partition
        delivery counts fold into the committed offsets table. Only
        already-served steps can commit."""
        if upto_step > self._next:
            raise ValueError(f"cannot commit step {upto_step}: "
                             f"only {self._next} steps served")
        for s in range(self._consumed_upto, upto_step):
            for p, n in self._step_parts.pop(s, {}).items():
                self._offsets[p] = self._offsets.get(p, 0) + n
        self._consumed_upto = max(self._consumed_upto, upto_step)

    def offsets(self) -> Dict[int, int]:
        """Committed per-partition consumed-record counts (checkpoint
        manifest payload)."""
        return {int(p): int(n) for p, n in sorted(self._offsets.items())}

    def fast_forward(self, resume_step: int,
                     expected_offsets: Optional[Dict] = None) -> None:
        """Resume path: replay the (deterministic) engine from zero,
        consume-and-drop the committed prefix ``[0, resume_step)``, and
        verify the recomputed per-partition offsets against the
        checkpoint manifest's. After this, ``next_batch`` serves
        ``resume_step`` — nothing skipped, nothing re-trained."""
        if self._next != 0:
            raise RuntimeError("fast_forward must run before consumption")
        for s in range(resume_step):
            self._advance(s, strict=True)
            self.skipped_rows += len(self._staged.pop(s))
        self._next = resume_step
        self.commit(resume_step)
        if expected_offsets is not None:
            exp = {int(p): int(n) for p, n in expected_offsets.items()}
            got = self.offsets()
            if got != exp:
                raise RuntimeError(
                    "resume offsets diverged from the committed manifest: "
                    f"manifest={exp} replayed={got}")
        self.prefetch()

    def finish(self):
        """Drain the engine (remaining uploads/commits/retention) and
        return its ``ShuffleMetrics`` — call once training is done."""
        return self.engine.run()

    # -- device batches -----------------------------------------------------
    def _make_device_put(self, mesh, model_cfg, rules, device):
        """The port's put: each array to an int32 tensor on ``device``,
        and ``self.shardings`` each input's ``PartitionSpec`` on the
        mesh, as JAX's ``NamedSharding`` names it.

        On a ``StackedMesh`` every rank lives in this process, so the
        tensor is the global batch (the train step splits it over the
        pods). On a ``ProcessGroupMesh`` (one rank a process) each
        process puts the global batch on its own ``device`` too, where
        JAX's devices each hold their block: the port's step takes the
        whole batch on every process (``auto`` routes every token over
        the processes, the blob modes cut their own pod's block), and
        ``specs_check.validate_device_batch`` reads each process's block
        through ``exchange.shard``. Every process runs its own copy of
        the deterministic engine, so nothing is broadcast; at each step
        the processes compare a 64-bit digest of the batch's bytes
        (``exchange.digest64``) in one all-gather over the mesh, and
        every process raises, naming the step, if any differs."""
        import torch

        from repro_torch.distributed.sharding import DEFAULT_RULES, batch_specs
        from repro_torch.launch.specs import input_specs
        from repro_torch.models.common import ShapeConfig
        from repro_torch.shuffle import exchange

        if model_cfg is None:
            raise ValueError("mesh given without model_cfg")
        self.shape = ShapeConfig("shuffle_fed", self.stream.seq_len,
                                 self.stream.batch, "train")
        self.input_specs = input_specs(model_cfg, self.shape)
        self.shardings = batch_specs(self.input_specs,
                                     rules or DEFAULT_RULES, mesh)
        ex = exchange.for_mesh(mesh)        # refuses a mesh that no exchange runs

        def put(batch):
            if isinstance(ex, exchange.ProcessGroups):
                # next_batch has moved past the step it serves
                exchange.check_same(ex, exchange.digest64(
                    [batch[k] for k in sorted(batch)]), device,
                    f"step {self._next - 1}'s batches")
            return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        return put
