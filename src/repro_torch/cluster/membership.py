"""Virtual-clock worker lifecycle: join / leave / crash / timeout.

Layered on the deterministic ``EventLoop``: a crash is *silent* — the
worker stops heartbeating at the crash instant, but the group only
learns of it ``heartbeat_timeout_s`` later (the detection event is
scheduled on the loop, so failover latency is part of the simulation,
exactly like a missed ``session.timeout.ms`` in a Kafka consumer group).
Graceful ``leave`` is announced and takes effect immediately. Periodic
heartbeat *events* are elided — on a virtual clock they would be no-ops
between state changes — but the ``heartbeat``/``last_heartbeat`` API is
kept so liveness can be probed and a flapping worker can cancel its own
pending detection by beating in time.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from repro_torch.core.events import EventLoop

UP = "up"
LEFT = "left"
CRASHED = "crashed"


@dataclasses.dataclass
class WorkerInfo:
    worker_id: str
    az: int
    inst: int                 # engine instance index backing this worker
    joined_at: float
    state: str = UP
    last_heartbeat: float = 0.0
    # crash instant, while the group has not yet detected it (ground
    # truth the simulator knows; the group's view is ``state``)
    silent_since: Optional[float] = None


class Membership:
    """Consumer-group membership view with timeout-based crash detection."""

    def __init__(self, loop: EventLoop, heartbeat_timeout_s: float = 2.0,
                 on_change: Optional[Callable[[str, WorkerInfo], None]]
                 = None):
        self.loop = loop
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.on_change = on_change
        self.workers: Dict[str, WorkerInfo] = {}
        self.generation = 0        # bumps on every membership change

    # -- lifecycle ---------------------------------------------------------
    def join(self, worker_id: str, az: int, inst: int) -> WorkerInfo:
        now = self.loop.now
        w = WorkerInfo(worker_id, az, inst, joined_at=now,
                       last_heartbeat=now)
        self.workers[worker_id] = w
        self._changed("join", w)
        return w

    def leave(self, worker_id: str) -> None:
        """Graceful departure: announced, takes effect immediately."""
        w = self.workers[worker_id]
        if w.state != UP:
            return
        w.state = LEFT
        self._changed("leave", w)

    def crash(self, worker_id: str) -> None:
        """Fail-stop NOW; the group detects it one heartbeat timeout
        later (the scheduled ``_detect`` event bumps the generation)."""
        w = self.workers[worker_id]
        if w.state != UP or w.silent_since is not None:
            return
        w.silent_since = self.loop.now
        self.loop.after(self.heartbeat_timeout_s, self._detect, worker_id)

    def _detect(self, worker_id: str) -> None:
        w = self.workers.get(worker_id)
        if w is None or w.state != UP or w.silent_since is None:
            return      # left meanwhile, or a heartbeat got through
        w.state = CRASHED
        self._changed("crash", w)

    def heartbeat(self, worker_id: str) -> None:
        w = self.workers[worker_id]
        if w.state == UP:
            w.last_heartbeat = self.loop.now
            w.silent_since = None    # cancels any pending detection

    # -- views -------------------------------------------------------------
    def alive(self) -> List[WorkerInfo]:
        """The GROUP's view: members it believes are up — including
        crashed-but-undetected workers (messages routed to them are lost
        until the timeout fires, which is the point)."""
        return sorted((w for w in self.workers.values() if w.state == UP),
                      key=lambda w: w.worker_id)

    def is_alive_now(self, worker_id: str) -> bool:
        """Ground truth: up AND actually running (not silently dead)."""
        w = self.workers.get(worker_id)
        return (w is not None and w.state == UP
                and w.silent_since is None)

    def pending_detections(self) -> bool:
        return any(w.state == UP and w.silent_since is not None
                   for w in self.workers.values())

    def _changed(self, kind: str, w: WorkerInfo) -> None:
        self.generation += 1
        if self.on_change is not None:
            self.on_change(kind, w)
