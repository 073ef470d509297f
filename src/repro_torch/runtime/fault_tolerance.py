"""Fault-tolerant training: periodic blob checkpoints + restart,
the port of ``repro.runtime.fault_tolerance``.

Failures (injected or real exceptions) roll back to the latest *committed*
manifest; the restarted run continues bit-identically (tested), because
the checkpoint captures (params, opt_state, step) and the data pipeline
is step-keyed (deterministic record generation per step).

The port's train step updates the ``lm.LM`` in place, so the state the
trainer saves and restores is ``interop.train_state_tree``'s view of it:
the JAX package's tree, whose leaves are the model's and the optimizer's
own tensors. ``save`` copies them to the host before it returns, and a
restore writes them in place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

from repro_torch.checkpoint import BlobCheckpointer, FileStore, latest_step
from repro_torch.interop import train_state_tree


class InjectedFailure(RuntimeError):
    pass


def _tree(state: dict):
    """What the checkpointer saves and restores in place for ``state``."""
    return train_state_tree(state["params"], state["opt"])


@dataclasses.dataclass
class FaultTolerantTrainer:
    """Drives train_step with checkpoint/restart.

    train_step: (params, opt, batch) -> (params, opt, metrics), params
                the ``lm.LM`` (updated in place) and opt its AdamW state
    batch_fn:   step -> batch  (deterministic — the data pipeline is
                step-keyed so replays after restart are identical)
    """
    store: FileStore
    train_step: Callable
    batch_fn: Callable
    ckpt_every: int = 10
    async_upload: bool = True

    def __post_init__(self):
        self.ckpt = BlobCheckpointer(self.store,
                                     async_upload=self.async_upload)

    def run(self, params, opt_state, *, steps: int,
            fail_at: Optional[Dict[int, int]] = None,
            max_restarts: int = 10):
        """Run ``steps`` steps; ``fail_at`` maps step->how many times to
        fail there. Returns (params, opt, history of losses)."""
        fail_at = dict(fail_at or {})
        state = {"params": params, "opt": opt_state}
        # the state holds them now: the first optimizer state, left named
        # here, would keep a second set of moments alive on the device
        del params, opt_state
        self.ckpt.save(0, _tree(state))
        self.ckpt.wait()
        history = {}
        step = 0
        restarts = 0
        while step < steps:
            try:
                if fail_at.get(step, 0) > 0:
                    fail_at[step] -= 1
                    raise InjectedFailure(f"node failure at step {step}")
                batch = self.batch_fn(step)
                p, o, metrics = self.train_step(state["params"],
                                                state["opt"], batch)
                state = {"params": p, "opt": o}
                history[step] = float(metrics["loss"])
                step += 1
                if step % self.ckpt_every == 0:
                    self.ckpt.save(step, _tree(state))
            except InjectedFailure:
                restarts += 1
                if restarts > max_restarts:
                    raise
                self.ckpt.wait()
                last = latest_step(self.store)
                self.ckpt.restore(last, _tree(state))   # in place
                # drop uncommitted history (recomputed after restart)
                history = {s: l for s, l in history.items() if s < last}
                step = last
        self.ckpt.save(steps, _tree(state))
        self.ckpt.wait()
        losses = [history[s] for s in sorted(history)]
        return state["params"], state["opt"], losses
