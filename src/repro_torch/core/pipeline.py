"""BlobShuffle pipeline facade — the add-on API of Listing 1, runnable as
a single-process, multi-instance topology (used by examples and tests).

    shuffle = BlobShufflePipeline(config)
    out = shuffle.run(records)   # records routed to per-partition outputs

Since the async-engine refactor this is a thin driver over
``repro_torch.core.engine.AsyncShuffleEngine``: records are scheduled on the
virtual clock, commits (and injected failures) become events, and the
event loop runs to quiescence — so the same execution model that powers
the latency/cost sweeps also backs the functional API. Exactly-once
semantics are unchanged: replayed records re-enter the topology and the
Debatchers' (blob, partition) dedup plus commit-batched notification
visibility keep the output duplicate-free.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.core.batcher import BlobShuffleConfig
from repro_torch.core.engine import AsyncShuffleEngine, EngineConfig
from repro_torch.core.records import Record
from repro_torch.core.stores import BlobStore


class BlobShufflePipeline:
    def __init__(self, cfg: BlobShuffleConfig, *, n_instances: int = 3,
                 store: Optional[BlobStore] = None, seed: int = 0,
                 exactly_once: bool = True,
                 engine_cfg: Optional[EngineConfig] = None):
        self.cfg = cfg
        self.n_instances = n_instances
        self.engine = AsyncShuffleEngine(cfg, engine_cfg,
                                         n_instances=n_instances,
                                         store=store, seed=seed,
                                         exactly_once=exactly_once)
        # component views kept for introspection/back-compat
        self.store = self.engine.store
        self.caches = self.engine.caches
        self.batchers = self.engine.batchers
        self.debatchers = self.engine.debatchers
        self.coordinators = self.engine.coordinators
        self.notifications = self.engine.published

    def partition_to_az(self, partition: int) -> int:
        return self.engine.partition_to_az(partition)

    def run(self, records: List[Record], *, now: float = 0.0,
            commit_every: Optional[int] = None,
            fail_instance_before_commit: Optional[int] = None
            ) -> Dict[int, List[Record]]:
        """Push records round-robin through instances; commit; debatch.

        ``fail_instance_before_commit``: inject a crash on that instance
        right before the first commit (its uncommitted records replay —
        at-least-once upstream, exactly-once downstream via dedup).
        """
        eng = self.engine
        dt = 1e-6
        t = now
        for i, rec in enumerate(records):
            eng.submit(t, rec, inst=i % self.n_instances)
            if commit_every and (i + 1) % commit_every == 0:
                if fail_instance_before_commit is not None:
                    eng.fail_at(t + dt / 4, fail_instance_before_commit)
                    fail_instance_before_commit = None
                eng.commit_at(t + dt / 2)
            t += dt
        eng.run()
        return {p: list(rs) for p, rs in eng.out.items()}
