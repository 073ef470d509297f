"""Unified observability layer for the BlobShuffle engine.

One opt-in object (``AsyncShuffleEngine(..., obs=True)`` or
``obs=ObsConfig(...)``) provides four views of a run:

  * a :class:`~repro_torch.obs.registry.MetricsRegistry` of counters / gauges /
    histograms keyed by component and AZ, windowed on the virtual clock
    ("p95 during the rebalance" is a query, not bespoke code);
  * per-record **latency decomposition**: end-to-end latency is split
    exactly into batch_wait + upload + commit_wait + notify + fetch at
    the delivery point (the stage sums reconcile with the end-to-end
    samples by construction — each stage is a difference of adjacent
    lifecycle timestamps);
  * per-blob **lifecycle traces** (deterministically sampled) emitted as
    a Chrome-trace JSON artifact (``chrome://tracing`` / Perfetto);
  * a **conservation-law checker** reconciling every *Stats* dataclass
    at end of run (see ``repro_torch.obs.conservation``).

Disabled (the default, ``obs=None``) the engine takes a single
``is not None`` branch per hook — no allocation, no RNG use, no event
scheduled — so disabled runs stay bit-identical. Enabled, the layer
still never schedules events or consumes engine RNG, so enabling
observability does not change delivery order, latencies, or any digest:
it is a pure side-table of the run.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.obs.conservation import (ConservationError, ConservationReport,
                                    LawResult, check_conservation)
from repro_torch.obs.registry import (Counter, Gauge, Histogram, MetricsRegistry)
from repro_torch.obs.sketch import QuantileSketch
from repro_torch.obs.trace import BlobTracer

#: the exact latency decomposition recorded at every delivery; stage
#: boundaries are adjacent lifecycle timestamps, so per-record sums equal
#: the end-to-end latency to float precision
STAGES = ("batch_wait", "upload", "commit_wait", "notify", "fetch")


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Knobs of the observability layer (all virtual-clock units)."""
    window_s: float = 0.25             # time-series window width
    sketch_alpha: float = 0.01         # histogram relative-error bound
    trace_sample_every: int = 8        # 1-in-N blobs traced (crc32 of id)
    trace_max_events: int = 20000      # trace artifact cap
    check_conservation: bool = True    # reconcile stats at end of run()
    strict_conservation: bool = False  # raise ConservationError on violation


class Observability:
    """Side-table of one engine run: registry + tracer + blob timelines.

    Every hook is called from the engine with plain values already in
    hand — hooks never schedule events, never call into the store or
    caches, and never consume randomness, so an observed run replays
    the exact event sequence of an unobserved one.
    """

    def __init__(self, cfg: Optional[ObsConfig] = None):
        self.cfg = cfg or ObsConfig()
        self.registry = MetricsRegistry(window_s=self.cfg.window_s,
                                        alpha=self.cfg.sketch_alpha)
        self.tracer = BlobTracer(self.cfg.trace_sample_every,
                                 self.cfg.trace_max_events)
        self.report: Optional[ConservationReport] = None
        # blob lifecycle timelines (virtual timestamps)
        self._first_t0: Dict[str, float] = {}      # earliest buffered record
        self._finalized: Dict[str, float] = {}     # blob built
        self._durable: Dict[str, float] = {}       # PUT completed
        self._published: Dict[Tuple[str, int], float] = {}  # note published
        r = self.registry
        self._h_e2e = r.histogram("e2e", "latency")
        self._h_stage = {s: r.histogram(s, "stage") for s in STAGES}
        self._unattributed = r.counter("unattributed_records", "stage")
        # memoized handles for the per-delivery hooks (the registry
        # lookup builds a tuple key per call; these paths run once or
        # more per delivered record range)
        self._c_in: Dict[int, Counter] = {}
        self._c_delivered: Dict[int, Counter] = {}
        self._c_reads: Dict[Tuple[str, int], Tuple[Counter, ...]] = {}
        self._m_finalized: Dict[Tuple[str, int], tuple] = {}
        self._m_durable: Dict[int, tuple] = {}
        self._m_get: Dict[int, tuple] = {}
        # raw rows pending bulk application — the two per-delivery hooks
        # are O(1) appends; _drain_deliveries() expands them into the
        # stage/e2e sketches and windowed counters in bulk
        self._pending_deliveries: list = []
        self._pending_reads: list = []

    # -- ingest / producer side -------------------------------------------
    def on_ingest(self, az: int, n: int, now: float) -> None:
        c = self._c_in.get(az)
        if c is None:
            c = self._c_in[az] = self.registry.counter(
                "records_in", "engine", az)
        c.inc(n, now)

    def on_batch_finalized(self, az: int, blob, why: str,
                           now: float) -> None:
        """Batcher hook: a buffer became a blob (why: size/interval/
        commit)."""
        m = self._m_finalized.get((why, az))
        if m is None:
            r = self.registry
            m = self._m_finalized[(why, az)] = (
                r.counter(f"finalize_{why}", "batcher", az),
                r.histogram("blob_bytes", "batcher", az))
        m[0].inc(1, now)
        m[1].observe(blob.size, now)

    def on_blob_handed_off(self, blob, az: int, first_t0: Optional[float],
                           now: float) -> None:
        """Engine uploader hook: blob entered the upload lane with its
        arrival FIFOs captured."""
        self._finalized[blob.blob_id] = now
        if first_t0 is not None:
            self._first_t0[blob.blob_id] = first_t0

    def on_blob_durable(self, blob_id: str, size: int, az: int, lat: float,
                        now: float) -> None:
        m = self._m_durable.get(az)
        if m is None:
            r = self.registry
            m = self._m_durable[az] = (
                r.counter("uploads", "engine", az),
                r.histogram("put_latency", "store", az))
        m[0].inc(1, now)
        m[1].observe(lat, now)
        self._durable[blob_id] = now
        if self.tracer.sampled(blob_id):
            t_fin = self._finalized.get(blob_id, now - lat)
            t0 = self._first_t0.get(blob_id, t_fin)
            self.tracer.span("pack", blob_id, t0, t_fin,
                             args={"bytes": size})
            self.tracer.span("upload", blob_id, t_fin, now,
                             args={"put_s": lat})

    def on_note_published(self, note, now: float) -> None:
        self._published[(note.blob_id, note.partition)] = now

    # -- consumer side -----------------------------------------------------
    def on_store_get(self, az: int, size: int, lat: float,
                     now: float) -> None:
        m = self._m_get.get(az)
        if m is None:
            r = self.registry
            m = self._m_get[az] = (
                r.counter("store_gets", "cache", az),
                r.histogram("get_latency", "store", az))
        m[0].inc(1, now)
        m[1].observe(lat, now)

    def on_extract(self, az: int, src: str, n_records: int, nbytes: int,
                   now: float) -> None:
        """Debatcher hook: one admitted notification extracted (extract
        itself is instantaneous on the virtual clock — it is the tail of
        the ``fetch`` stage). O(1): the three windowed counters are
        applied in bulk by :meth:`_drain_deliveries`."""
        self._pending_reads.append((src, az, n_records, nbytes, now))

    def on_duplicate_delivery(self, az: int, n: int, now: float) -> None:
        self.registry.counter("duplicates", "engine", az).inc(n, now)

    def on_delivery(self, note, enqueued_at: float, arrivals, src: str,
                    az: int, now: float) -> None:
        """The delivery point: one O(1) append of the raw row — the
        ``len(arrivals)``-record stage decomposition happens vectorized
        in :meth:`_drain_deliveries` (the arrivals list is the engine's
        popped FIFO; it is never mutated after delivery)."""
        n = len(arrivals)
        if n == 0:
            return
        bid = note.blob_id
        self._pending_deliveries.append(
            (bid, note.partition, enqueued_at, now, arrivals, az))
        if len(self._pending_deliveries) >= 4096:
            self._drain_deliveries()
        if self.tracer.sampled(bid):
            t_pub = self._published.get((bid, note.partition), enqueued_at)
            self.tracer.span("notify", bid, t_pub, enqueued_at,
                             pid=note.partition)
            self.tracer.span("fetch", bid, enqueued_at, now,
                             pid=note.partition,
                             args={"src": src, "records": n})
            self.tracer.instant("deliver", now, blob_id=bid,
                                pid=note.partition,
                                args={"records": n, "az": az})

    def _drain_deliveries(self) -> None:
        """Expand pending delivery/extract rows into the e2e + stage
        sketches and windowed counters, one vectorized pass per
        virtual-clock window. Lifecycle timestamps only ever precede the
        delivery that reads them, so resolving them here is equivalent
        to resolving at delivery."""
        ws = self.cfg.window_s
        reads = self._pending_reads
        if reads:
            self._pending_reads = []
            agg: Dict[Tuple[str, int, int], list] = {}
            for src, az, n, nb, now in reads:
                key = (src, az, int(now // ws))
                a = agg.get(key)
                if a is None:
                    agg[key] = [1, n, nb]
                else:
                    a[0] += 1
                    a[1] += n
                    a[2] += nb
            for (src, az, idx), (n_reads, n_recs, n_bytes) in agg.items():
                cs = self._c_reads.get((src, az))
                if cs is None:
                    r = self.registry
                    cs = self._c_reads[(src, az)] = (
                        r.counter(f"reads_{src}", "debatcher", az),
                        r.counter("records_out", "debatcher", az),
                        r.counter("bytes_out", "debatcher", az))
                cs[0]._inc_window(idx, n_reads)
                cs[1]._inc_window(idx, n_recs)
                cs[2]._inc_window(idx, n_bytes)
        pend = self._pending_deliveries
        if not pend:
            return
        self._pending_deliveries = []
        fin, dur, pub = self._finalized, self._durable, self._published
        dlv: Dict[Tuple[int, int], int] = {}   # (az, window) -> records
        nows_l, enqs_l, fins_l, durs_l, pubs_l, ns_l = [], [], [], [], [], []
        t0s_l: list = []
        for bid, part, enq, now, arr, az in pend:
            key = (az, int(now // ws))
            dlv[key] = dlv.get(key, 0) + len(arr)
            t_fin = fin.get(bid)
            t_dur = dur.get(bid)
            t_pub = pub.get((bid, part))
            if t_fin is None or t_dur is None or t_pub is None:
                # incomplete timeline (hook attached mid-run): count the
                # records and keep their e2e, don't guess stages
                self._unattributed.inc(len(arr), now)
                self._h_e2e.observe_many([now - t for t in arr], now)
                continue
            nows_l.append(now)
            enqs_l.append(enq)
            fins_l.append(t_fin)
            durs_l.append(t_dur)
            pubs_l.append(t_pub)
            ns_l.append(len(arr))
            t0s_l.extend(arr)
        for (az, idx), n in dlv.items():
            c = self._c_delivered.get(az)
            if c is None:
                c = self._c_delivered[az] = self.registry.counter(
                    "records_delivered", "engine", az)
            c._inc_window(idx, n)
        if not ns_l:
            return
        nows = np.array(nows_l)
        enqs = np.array(enqs_l)
        fins = np.array(fins_l)
        durs = np.array(durs_l)
        pubs = np.array(pubs_l)
        ns = np.array(ns_l, np.int64)
        t0s = np.array(t0s_l)
        # one expansion pass for the whole batch, then sliced per window:
        # deliveries arrive in virtual-time order, so the window index is
        # nondecreasing and windows are contiguous runs
        per_stage = (
            (self._h_e2e, np.repeat(nows, ns) - t0s),
            (self._h_stage["batch_wait"], np.repeat(fins, ns) - t0s),
            (self._h_stage["upload"], np.repeat(durs - fins, ns)),
            (self._h_stage["commit_wait"], np.repeat(pubs - durs, ns)),
            (self._h_stage["notify"], np.repeat(enqs - pubs, ns)),
            (self._h_stage["fetch"], np.repeat(nows - enqs, ns)),
        )
        idxs = (nows // ws).astype(np.int64)
        bounds = np.flatnonzero(np.diff(idxs)) + 1
        starts = np.concatenate(([0], bounds))
        ends = np.concatenate((bounds, [idxs.size]))
        rec_off = np.concatenate(([0], np.cumsum(ns)))
        for s, e in zip(starts.tolist(), ends.tolist()):
            idx = int(idxs[s])
            r0, r1 = int(rec_off[s]), int(rec_off[e])
            for h, vals in per_stage:
                h._window_sketch(idx).add_many(vals[r0:r1])

    # -- control-plane marks ----------------------------------------------
    def mark(self, label: str, now: float) -> None:
        """Named instant (crash, rebalance trigger/complete, AZ outage)
        — the anchors for windowed metric queries."""
        self.registry.mark(label, now)
        self.tracer.instant(label, now)

    # -- end of run --------------------------------------------------------
    def finalize_run(self, engine) -> None:
        """Engine ``run()`` hook: snapshot end-of-run gauges and run the
        conservation checker."""
        now = engine.loop.now
        self._drain_deliveries()
        r = self.registry
        st = engine.store.stats
        r.gauge("puts", "store").set(st.puts, now)
        r.gauge("gets", "store").set(st.gets, now)
        r.gauge("put_bytes", "store").set(st.put_bytes, now)
        r.gauge("byte_seconds", "store").set(st.byte_seconds, now)
        for az, c in enumerate(engine.caches):
            r.gauge("hits", "cache", az).set(c.stats.hits, now)
            r.gauge("misses", "cache", az).set(c.stats.misses, now)
            r.gauge("coalesced", "cache", az).set(c.stats.coalesced, now)
        if self.cfg.check_conservation:
            self.report = check_conservation(
                engine, strict=self.cfg.strict_conservation)

    # -- queries -----------------------------------------------------------
    def stage_decomposition(self, qs=(50, 95)) -> dict:
        """Per-stage quantiles + means; ``sum_check`` carries the mean
        sums so callers can assert stage ⟂ e2e reconciliation."""
        self._drain_deliveries()
        out = {}
        for s in STAGES:
            h = self._h_stage[s]
            if h.count:
                vals = h.percentiles(list(qs))
                out[s] = {f"p{int(q)}_s": v for q, v in zip(qs, vals)}
                out[s]["mean_s"] = h.mean
            else:
                out[s] = {f"p{int(q)}_s": 0.0 for q in qs}
                out[s]["mean_s"] = 0.0
        e2e = self._h_e2e
        out["e2e"] = ({f"p{int(q)}_s": v for q, v in
                       zip(qs, e2e.percentiles(list(qs)))}
                      if e2e.count else {f"p{int(q)}_s": 0.0 for q in qs})
        out["e2e"]["mean_s"] = e2e.mean if e2e.count else 0.0
        out["sum_check"] = {
            "stage_mean_sum_s": sum(out[s]["mean_s"] for s in STAGES),
            "e2e_mean_s": out["e2e"]["mean_s"],
            "stage_records": self._h_stage["upload"].count,
            "e2e_records": e2e.count,
            "unattributed_records": self._unattributed.total,
        }
        return out

    def e2e_percentile(self, q: float, t0: Optional[float] = None,
                       t1: Optional[float] = None) -> Optional[float]:
        """Windowed end-to-end percentile — e.g. "p95 during the
        rebalance": pass the [t0, t1) window from two marks."""
        self._drain_deliveries()
        return self._h_e2e.percentile(q, t0, t1)


def make_observability(obs) -> Optional[Observability]:
    """Resolve the engine's ``obs=`` argument: None | True | ObsConfig |
    Observability."""
    if obs is None or obs is False:
        return None
    if isinstance(obs, Observability):
        return obs
    if isinstance(obs, ObsConfig):
        return Observability(obs)
    if obs is True:
        return Observability()
    raise TypeError(f"obs must be None, True, ObsConfig or Observability; "
                    f"got {type(obs).__name__}")


__all__ = [
    "STAGES", "ObsConfig", "Observability", "make_observability",
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "QuantileSketch",
    "BlobTracer", "ConservationReport", "ConservationError", "LawResult",
    "check_conservation",
]
