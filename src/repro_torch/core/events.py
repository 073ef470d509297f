"""Virtual-clock discrete-event scheduler for the async shuffle engine.

A minimal deterministic event loop: callbacks are ordered by (time,
insertion sequence), so ties resolve in scheduling order and a run with a
fixed RNG seed is exactly reproducible. All simulated concurrency in
``repro_torch.core.engine`` (in-flight PUTs/GETs, notification fan-out, cache
fills racing reads, commit barriers) reduces to events on this loop.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Any, Callable, List, Optional, Tuple


class EventLoop:
    """Single-threaded virtual-time event loop.

    Time only moves forward: scheduling at a time earlier than ``now``
    clamps to ``now`` (the event still runs, just "immediately").
    """

    def __init__(self, start: float = 0.0):
        self.now = float(start)
        self._heap: List[Tuple[float, int, Callable, Tuple[Any, ...]]] = []
        self._seq = itertools.count()
        self.events_run = 0

    def at(self, t: float, fn: Callable, *args: Any) -> None:
        """Schedule ``fn(*args)`` at absolute virtual time ``t``."""
        heapq.heappush(self._heap, (max(float(t), self.now),
                                    next(self._seq), fn, args))

    def after(self, delay: float, fn: Callable, *args: Any) -> None:
        """Schedule ``fn(*args)`` ``delay`` seconds from now (>= 0)."""
        self.at(self.now + max(0.0, float(delay)), fn, *args)

    def pending(self) -> int:
        return len(self._heap)

    def run(self, until: Optional[float] = None) -> float:
        """Run events in order until the heap drains (or past ``until``).

        Returns the loop's final virtual time (the makespan when the heap
        drained).
        """
        while self._heap:
            t = self._heap[0][0]
            if until is not None and t > until:
                break
            t, _, fn, args = heapq.heappop(self._heap)
            self.now = t
            self.events_run += 1
            fn(*args)
        return self.now
