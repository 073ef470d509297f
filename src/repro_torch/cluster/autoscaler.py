"""Lag- and throughput-driven autoscaling against the capacity model.

The policy (Shukla & Simmhan-style: elasticity decisions co-designed
with the migration mechanism they trigger) watches two signals each
tick:

  * **notification-log lag** — end offset minus committed offset, summed
    over partitions, normalized per alive worker. Sustained high lag
    (``breach_ticks`` consecutive ticks) means the consumers cannot keep
    up: scale OUT. Sustained near-zero lag with more workers than the
    capacity model says the observed throughput needs: scale IN.
  * **delivered throughput vs. the calibrated capacity curve** —
    ``CapacityModel.max_throughput`` gives the cluster's processing
    ceiling per worker count, so the target size is the smallest count
    whose ceiling clears the observed rate with ``headroom``; lag alone
    can overshoot (a transient spike) or undershoot (a slow leak).

Every decision is recorded with its $ consequence (workers ×
``worker_cost_per_hour``), so scenarios can report the cost delta
against a statically peak-provisioned cluster. Scale-out adds workers
through the cluster (join → cooperative rebalance); scale-in retires the
newest least-loaded worker gracefully (leave → handoff), draining surge
capacity in LIFO order.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.core.capacity import CapacityModel
from repro_torch.core.costs import AwsPrices

MiB = 1024.0 ** 2


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    interval_s: float = 0.5
    high_lag_per_worker: float = 24.0    # log entries per alive worker
    low_lag_per_worker: float = 2.0
    # producer-side backpressure: blobs queued behind the upload lanes
    # (a load spike shows up here commits before it reaches the log)
    high_queue_per_worker: float = 3.0
    low_queue_per_worker: float = 0.5
    breach_ticks: int = 2                # sustained ticks before acting
    cooldown_s: float = 1.5              # min gap between scale actions
    min_workers: int = 2
    max_workers: int = 16
    headroom: float = 1.2                # capacity margin over observed rate
    idle_stop_ticks: int = 3             # quiesce ticks before stopping
    worker_cost_per_hour: float = AwsPrices().ec2_r6in_xlarge_hour


@dataclasses.dataclass
class ScaleDecision:
    t: float
    action: str                          # "scale_out" | "scale_in"
    reason: str
    lag: int
    workers_before: int
    workers_after: int
    cost_per_hour_delta: float


class Autoscaler:
    def __init__(self, cluster, policy: Optional[AutoscalePolicy] = None,
                 capacity: Optional[CapacityModel] = None):
        self.cluster = cluster
        self.policy = policy or AutoscalePolicy()
        self.capacity = capacity or CapacityModel()
        self.decisions: List[ScaleDecision] = []
        self._hi = 0
        self._lo = 0
        self._idle = 0
        self._last_action_t = float("-inf")
        self._last_bytes = 0
        self._last_lag = -1

    def start(self) -> None:
        self.cluster.loop.after(self.policy.interval_s, self._tick)

    def workers_for_throughput(self, bytes_s: float) -> int:
        """Smallest worker count whose capacity ceiling clears
        ``bytes_s × headroom`` (the cost-curve side of the decision)."""
        cfg = self.cluster.engine.cfg
        batch_mib = cfg.batch_bytes / MiB
        need = bytes_s * self.policy.headroom
        for n in range(self.policy.min_workers,
                       self.policy.max_workers + 1):
            if self.capacity.max_throughput(batch_mib, cfg.num_partitions,
                                            n, cfg.num_az) >= need:
                return n
        return self.policy.max_workers

    def _tick(self) -> None:
        cluster, pol = self.cluster, self.policy
        eng = cluster.engine
        now = cluster.loop.now
        alive = cluster.membership.alive()
        lag = cluster.undelivered_lag()
        delivered = eng.metrics.bytes_delivered
        rate = (delivered - self._last_bytes) / pol.interval_s
        self._last_bytes = delivered
        need = self.workers_for_throughput(rate)
        lag_pw = lag / max(len(alive), 1)
        queue_pw = sum(len(q) for q in eng._upload_q) / max(len(alive), 1)
        if (lag_pw >= pol.high_lag_per_worker
                or queue_pw >= pol.high_queue_per_worker):
            self._hi, self._lo = self._hi + 1, 0
        elif (lag_pw <= pol.low_lag_per_worker
              and queue_pw <= pol.low_queue_per_worker):
            self._hi, self._lo = 0, self._lo + 1
        else:
            self._hi = self._lo = 0
        cooled = now - self._last_action_t >= pol.cooldown_s
        if (self._hi >= pol.breach_ticks and cooled
                and len(alive) < pol.max_workers):
            target = min(pol.max_workers, max(len(alive) + 1, need))
            for _ in range(target - len(alive)):
                cluster.add_worker()
            self.decisions.append(ScaleDecision(
                now, "scale_out",
                f"lag/worker={lag_pw:.0f} queue/worker={queue_pw:.1f}",
                lag, len(alive), target,
                (target - len(alive)) * pol.worker_cost_per_hour))
            self._last_action_t = now
            self._hi = 0
        elif (self._lo >= pol.breach_ticks and cooled
              and len(alive) > max(pol.min_workers, need)):
            victim = min(
                alive,
                key=lambda w: (cluster.partitions_of(w.worker_id),
                               -w.joined_at, w.worker_id))
            cluster.remove_worker(victim.worker_id)
            self.decisions.append(ScaleDecision(
                now, "scale_in",
                f"lag/worker={lag_pw:.0f} queue/worker={queue_pw:.1f}",
                lag, len(alive), len(alive) - 1,
                -pol.worker_cost_per_hour))
            self._last_action_t = now
            self._lo = 0
        # keep ticking while the system is busy; stop after a few idle
        # ticks so the virtual-clock run can drain (undelivered lag, not
        # committed lag: committed offsets only advance on commits, which
        # stop with the producers). A lag that is positive but STUCK with
        # no engine work in flight is a permanent loss (e.g. an aborted
        # fetch of an expired blob), not business — ticking on it forever
        # would keep the loop alive and run() would never return.
        progressing = lag > 0 and lag != self._last_lag
        self._last_lag = lag
        busy = (eng._work_pending() or progressing
                or cluster.membership.pending_detections())
        self._idle = 0 if busy else self._idle + 1
        if busy or self._idle < pol.idle_stop_ticks:
            cluster.loop.after(pol.interval_s, self._tick)
