"""Conservation-law checker: reconcile every *Stats* dataclass at end of
run.

The engine carries eight disconnected stats structures (batcher,
debatcher, commit, store, cache, fault, strategy, cluster). Each law
below states an exact flow identity between them, derived from the code
paths that bump the counters — records cannot appear or vanish between
operators, every store GET is led by exactly one cache cluster, every
byte PUT is a finalized blob byte that neither aborted nor died with a
crashed lane, and so on. A violated law means double counting, silent
loss, or a stats regression — the classes of bug that latency averages
hide.

Laws carry an applicability guard: some identities only hold for fully
drained runs without aborts or injected failures (a crash double-counts
replayed records in ``records_in`` by design), so those laws report
``skipped`` instead of failing when their preconditions don't hold.
``check_conservation(engine)`` works on any finished
``AsyncShuffleEngine`` — with or without an attached cluster, for every
shuffle strategy — and is run automatically from ``engine.run()`` when
observability is enabled.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class LawResult:
    name: str
    lhs: float
    rhs: float
    ok: bool
    skipped: bool = False
    detail: str = ""

    def __str__(self) -> str:
        state = "SKIP" if self.skipped else ("ok" if self.ok else "VIOLATED")
        return (f"{state:8s} {self.name}: {self.lhs} == {self.rhs}"
                + (f"  ({self.detail})" if self.detail else ""))


@dataclasses.dataclass
class ConservationReport:
    results: List[LawResult] = dataclasses.field(default_factory=list)

    @property
    def violations(self) -> List[LawResult]:
        return [r for r in self.results if not r.ok and not r.skipped]

    @property
    def checked(self) -> int:
        return sum(1 for r in self.results if not r.skipped)

    def summary(self) -> str:
        head = (f"conservation: {self.checked}/{len(self.results)} laws "
                f"checked, {len(self.violations)} violated")
        if not self.violations:
            return head
        return "\n".join([head] + [str(v) for v in self.violations])

    def to_dict(self) -> dict:
        return {"checked": self.checked, "laws": len(self.results),
                "violations": [str(v) for v in self.violations],
                "skipped": [r.name for r in self.results if r.skipped]}


class ConservationError(AssertionError):
    pass


def check_conservation(engine,
                       strict: bool = False) -> ConservationReport:
    """Evaluate every law against a finished engine run. ``strict``
    raises :class:`ConservationError` on the first report with
    violations instead of returning it."""
    rep = ConservationReport()
    m = engine.metrics
    st = engine.strategy.stats
    store = engine.store.stats
    caches = [c.stats for c in engine.caches]
    debs = [d.stats for d in engine.debatchers]
    bats = [b.stats for b in engine.batchers]
    cluster = engine.cluster

    def law(name, lhs, rhs, skipped=False, detail=""):
        rep.results.append(LawResult(name, lhs, rhs,
                                     ok=(skipped or lhs == rhs),
                                     skipped=skipped, detail=detail))

    # -- record flow -------------------------------------------------------
    law("delivered_records_match_debatchers",
        m.records_delivered, sum(d.records_out for d in debs),
        detail="every delivery goes through Debatcher.complete")
    law("delivered_bytes_match_debatchers",
        m.bytes_delivered, sum(d.bytes_out for d in debs))
    law("batcher_ingress_matches_engine",
        sum(b.records_in for b in bats),
        m.records_in - st.records_combined,
        detail="records buffered = submitted - combined away map-side")

    failures = sum(c.stats.failures_injected for c in engine.coordinators)
    drained = (engine._pending_ingests == 0
               and not engine._work_pending())
    lossless = (m.uploads_aborted == 0 and m.fetches_aborted == 0
                and failures == 0)
    law("records_in_equals_delivered",
        m.records_delivered, m.records_in - st.records_combined,
        skipped=not (drained and lossless),
        detail="end-to-end: needs a drained run with no aborts/crashes "
               f"(aborts={m.uploads_aborted}/{m.fetches_aborted}, "
               f"failures={failures})")
    law("no_duplicates_without_replay",
        m.duplicates_delivered, 0,
        skipped=not (drained and lossless))
    law("replayed_records_match_coordinators",
        m.records_replayed,
        sum(c.stats.records_replayed for c in engine.coordinators))

    # -- GET accounting ----------------------------------------------------
    law("store_gets_led_by_caches",
        store.gets, sum(c.store_gets for c in caches),
        detail="all GET counting routes through begin_store_get")
    law("get_latency_samples_match_store_gets",
        len(m.get_latencies), store.gets,
        detail="one latency sample per issued GET (leads + hedges + merge)")
    law("put_latency_samples_match_store_puts",
        len(m.put_latencies), store.puts)
    law("cache_hits_reconcile",
        sum(c.hits for c in caches),
        sum(d.reads_cache for d in debs) + st.merge_cache_hits,
        skipped=cluster is not None,
        detail="cluster mode can drop a cache-sourced delivery at the "
               "exactly-once gate after the probe counted the hit")

    # -- notification flow -------------------------------------------------
    reads = sum(d.reads_cache + d.reads_store + d.reads_coalesced
                + d.reads_local for d in debs)
    if cluster is None:
        law("deliveries_match_admitted_notifications",
            reads,
            sum(d.notifications - d.duplicates_dropped for d in debs)
            - m.fetches_aborted,
            detail="admitted = notified - deduped; admitted fetches either "
                   "deliver or abort")
    else:
        law("deliveries_match_cluster_gate",
            reads, cluster.stats.delivered,
            detail="on_delivery admits exactly stats.delivered fetches")
        law("published_notes_match_cluster_log",
            len(engine.published), cluster.stats.published)

    # -- byte flow through the store ---------------------------------------
    law("put_bytes_match_finalized_blobs",
        store.put_bytes,
        sum(b.blob_bytes for b in bats) + st.merged_blob_bytes
        - m.uploads_aborted_bytes - m.uploads_lost_bytes,
        detail="every finalized byte is durable, aborted, or lost with a "
               "crashed lane; merged blobs add re-packed bytes")

    # -- strategy-side (two-round merge) -----------------------------------
    if st.notes_intercepted or st.merged_blobs:
        parked = sum(len(v) for v in
                     getattr(engine.strategy, "_pending", {}).values())
        law("merge_notes_conserved",
            st.notes_intercepted,
            st.merged_inputs + st.merge_fallback_notes + st.merge_singles
            + parked,
            detail="every intercepted note is merged, falls back, passes "
                   "through as a single, or is still parked")

    if strict and rep.violations:
        raise ConservationError(rep.summary())
    return rep
