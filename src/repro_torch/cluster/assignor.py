"""Sticky, AZ-aware partition assignment.

Kafka's sticky assignor plus rack awareness, adapted to the BlobShuffle
topology where every partition has a *home AZ* (``partition % num_az`` —
the AZ its blobs are batched toward and whose cache cluster holds the
write-through copies). Priorities, strictly in order:

  1. **balance** — no worker exceeds ``ceil(P / W)`` partitions;
  2. **stickiness** — a partition stays with its current owner when that
     owner is alive, AZ-compatible, and under the balance cap (minimal
     movement: a join moves at most the new worker's fair share, a crash
     moves only the dead worker's partitions);
  3. **AZ alignment** — otherwise the least-loaded alive worker in the
     partition's home AZ (same-AZ cache hits, no cross-AZ GET penalty);
  4. **cross-AZ fallback** — no alive worker in the home AZ (AZ outage):
     the least-loaded worker anywhere. Consuming cross-AZ costs latency
     and routing charges, but beats not consuming at all.

The output is deterministic for a given (partitions, workers, previous)
input — ties break on worker id — so virtual-clock runs reproduce.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, Iterable, List, Optional

from repro_torch.cluster.membership import UP, WorkerInfo


@dataclasses.dataclass(frozen=True)
class PartitionMeta:
    partition: int
    home_az: int


@dataclasses.dataclass
class AssignorStats:
    assignments: int = 0
    moved: int = 0           # partitions whose owner changed
    cross_az: int = 0        # partitions assigned outside their home AZ


class StickyAzAssignor:
    def __init__(self):
        self.stats = AssignorStats()

    def assign(self, parts: Iterable[PartitionMeta],
               workers: Iterable[WorkerInfo],
               previous: Optional[Dict[int, str]] = None) -> Dict[int, str]:
        """partition -> worker_id over the alive workers."""
        previous = previous or {}
        alive = sorted((w for w in workers if w.state == UP),
                       key=lambda w: w.worker_id)
        ordered = sorted(parts, key=lambda p: p.partition)
        if not alive:
            return {}
        by_id = {w.worker_id: w for w in alive}
        by_az: Dict[int, List[WorkerInfo]] = defaultdict(list)
        for w in alive:
            by_az[w.az].append(w)
        cap = -(-len(ordered) // len(alive))       # ceil(P / W)
        load = {w.worker_id: 0 for w in alive}
        out: Dict[int, str] = {}
        # pass 1 — sticky: keep the previous owner wherever allowed
        for p in ordered:
            prev = previous.get(p.partition)
            w = by_id.get(prev)
            if w is None or load[prev] >= cap:
                continue
            if w.az == p.home_az or not by_az.get(p.home_az):
                out[p.partition] = prev
                load[prev] += 1
        # pass 2 — place the rest: home AZ first, then anywhere
        for p in ordered:
            if p.partition in out:
                continue
            cands = by_az.get(p.home_az) or alive
            under = [w for w in cands if load[w.worker_id] < cap]
            pool = (under
                    or [w for w in alive if load[w.worker_id] < cap]
                    or alive)
            w = min(pool, key=lambda w: (load[w.worker_id], w.worker_id))
            out[p.partition] = w.worker_id
            load[w.worker_id] += 1
        self.stats.assignments += 1
        self.stats.moved += sum(1 for p, w in out.items()
                                if previous.get(p) not in (None, w))
        self.stats.cross_az += sum(
            1 for p in ordered if by_id[out[p.partition]].az != p.home_az)
        return out

    @staticmethod
    def moved(previous: Dict[int, str], new: Dict[int, str]) -> List[int]:
        """Partitions whose owner changes going from ``previous`` to
        ``new`` (newly-assigned partitions count as moved)."""
        return sorted(p for p, w in new.items() if previous.get(p) != w)
