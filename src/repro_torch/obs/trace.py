"""Per-blob lifecycle traces in Chrome trace-event format.

A sampled blob becomes one "thread" in the trace (pid = partition of the
first note, tid = a small per-blob lane id, named after the blob id via a
thread_name metadata event), carrying complete spans (``ph: "X"``):

    pack    first buffered record -> blob finalized
    upload  finalized -> durable in the object store
    notify  note published -> fetch enqueued at the consumer
    fetch   fetch enqueued -> records delivered (includes cache race,
            store GET or cache hit, and the extract, which is
            instantaneous on the virtual clock)

plus instant events (``ph: "i"``) for deliveries and engine-level marks
(crashes, rebalance trigger/complete). Timestamps are virtual-clock
seconds scaled to microseconds, so a 2 s simulation reads as 2 s in the
viewer. Load the artifact in ``chrome://tracing`` or
https://ui.perfetto.dev.

Sampling is deterministic (crc32 of the blob id, 1-in-``sample_every``),
never consuming engine RNG; the event list is capped at ``max_events``.
"""

from __future__ import annotations

import json
import zlib
from typing import Dict, List, Optional


class BlobTracer:
    def __init__(self, sample_every: int = 8, max_events: int = 20000):
        self.sample_every = max(1, sample_every)
        self.max_events = max_events
        self.events: List[dict] = []
        self.dropped = 0
        self._lanes: Dict[str, int] = {}   # blob_id -> tid
        self._sampled: Dict[str, bool] = {}

    def sampled(self, blob_id: str) -> bool:
        s = self._sampled.get(blob_id)
        if s is None:
            s = self._sampled[blob_id] = (
                zlib.crc32(blob_id.encode()) % self.sample_every == 0)
        return s

    def _lane(self, blob_id: str, pid: int) -> int:
        tid = self._lanes.get(blob_id)
        if tid is None:
            tid = self._lanes[blob_id] = len(self._lanes) + 1
            self._emit({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid, "args": {"name": blob_id}})
        return tid

    def _emit(self, ev: dict) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(ev)

    def span(self, name: str, blob_id: str, t0: float, t1: float,
             pid: int = 0, args: Optional[dict] = None) -> None:
        """Complete span [t0, t1] (virtual seconds) on the blob's lane."""
        ev = {"ph": "X", "name": name, "pid": pid,
              "tid": self._lane(blob_id, pid),
              "ts": t0 * 1e6, "dur": max(0.0, t1 - t0) * 1e6}
        if args:
            ev["args"] = args
        self._emit(ev)

    def instant(self, name: str, t: float, blob_id: Optional[str] = None,
                pid: int = 0, args: Optional[dict] = None) -> None:
        ev = {"ph": "i", "name": name, "pid": pid, "ts": t * 1e6,
              "s": "g" if blob_id is None else "t"}
        if blob_id is not None:
            ev["tid"] = self._lane(blob_id, pid)
        if args:
            ev["args"] = args
        self._emit(ev)

    def to_chrome(self) -> dict:
        return {"traceEvents": self.events,
                "displayTimeUnit": "ms",
                "otherData": {"sample_every": self.sample_every,
                              "dropped_events": self.dropped,
                              "clock": "virtual (1 us trace = 1 us sim)"}}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
            f.write("\n")
