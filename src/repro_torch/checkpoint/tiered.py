"""Checkpointing through the simulated multi-tier blob stores.

``TieredCheckpointStore`` adapts any ``BlobStore`` tier — ``SimulatedS3``,
the zonal ``ExpressOneZoneStore``, or either wrapped in a ``FaultyStore``
fault injector — to the ``CheckpointStore`` shape that
``BlobCheckpointer`` drives (``put``/``get``/``put_manifest``/
``get_manifest``/``manifests``/``run_retention``). This is the paper's
commit pattern applied to model state: leaves are blobs, the manifest is
the notification, and a crash between the two leaves only unreachable
orphans for retention to collect.

Tier semantics handled here rather than in the checkpointer:

* **faults** — ``StoreError`` (503 SlowDown / transient / timeout) raised
  at issue time by a ``FaultyStore`` is retried up to ``max_attempts``
  with the attempt count surfaced in ``.retries`` (the checkpointer
  stays oblivious; a persistent fault still propagates);
* **zonal placement** — an ``az`` hint pins checkpoint objects to one
  zone of an ``ExpressOneZoneStore`` (cross-AZ restore then pays the
  tier's routing penalty, exactly like shuffle blobs);
* **virtual clock** — ``clock`` (e.g. ``lambda: engine.loop.now``) bills
  storage byte·seconds and retention age on the same clock as the
  shuffle traffic sharing the store;
* **namespacing** — keys live under ``<prefix>objects/`` and
  ``<prefix>manifests/`` so checkpoints and shuffle blobs can share one
  store without colliding;
* **retention** — ``run_retention`` is manifest-reachability GC: any
  checkpoint object not referenced by a committed manifest (a crash
  orphan) is deleted through the store's billed ``delete``.
"""

from __future__ import annotations

import json
from typing import Callable, List, Optional

from repro_torch.core.stores import StoreError

_MANIFESTS = "manifests/"
_OBJECTS = "objects/"


def _base(store):
    """Unwrap decorator stores (``FaultyStore.inner`` chains) down to the
    object that owns the key namespace — listing must not consume fault
    budget or billing, it's a control-plane operation."""
    s = store
    while not hasattr(s, "objects") and hasattr(s, "inner"):
        s = s.inner
    return s


class TieredCheckpointStore:
    """``CheckpointStore`` over any simulated ``BlobStore`` tier."""

    def __init__(self, store, *, az: Optional[int] = None,
                 clock: Optional[Callable[[], float]] = None,
                 max_attempts: int = 8, prefix: str = "ckpt/"):
        self.store = store
        self.az = az
        self.prefix = prefix
        self.max_attempts = max_attempts
        self._clock = clock or (lambda: 0.0)
        self.retries = 0            # fault-injected attempts that re-ran

    # -- retry shim ---------------------------------------------------------
    def _attempt(self, fn):
        last: Optional[StoreError] = None
        for _ in range(self.max_attempts):
            try:
                return fn()
            except StoreError as e:
                self.retries += 1
                last = e
        raise last

    def _okey(self, blob_id: str) -> str:
        return self.prefix + _OBJECTS + blob_id

    def _mkey(self, name: str) -> str:
        return self.prefix + _MANIFESTS + name

    # -- CheckpointStore API ------------------------------------------------
    def put(self, blob_id: str, data: bytes) -> None:
        self._attempt(lambda: self.store.put(
            self._okey(blob_id), data, now=self._clock(), az=self.az))

    def get(self, blob_id: str) -> bytes:
        return self._attempt(lambda: self.store.get(
            self._okey(blob_id), None, self._clock(), self.az))[0]

    def put_manifest(self, name: str, manifest: dict) -> None:
        data = json.dumps(manifest, sort_keys=True).encode()
        self._attempt(lambda: self.store.put(
            self._mkey(name), data, now=self._clock(), az=self.az))

    def get_manifest(self, name: str) -> Optional[dict]:
        key = self._mkey(name)
        if not self.store.contains(key):
            return None
        data = self._attempt(
            lambda: self.store.get(key, None, self._clock(), self.az))[0]
        return json.loads(data)

    def manifests(self) -> List[str]:
        pre = self.prefix + _MANIFESTS
        return sorted(k[len(pre):] for k in _base(self.store).objects
                      if k.startswith(pre))

    def run_retention(self, now: Optional[float] = None) -> int:
        """GC checkpoint objects unreachable from any committed manifest
        (orphans from crashes mid-checkpoint). Only keys under this
        adapter's prefix are considered — co-located shuffle blobs are
        governed by the store's own age-based retention."""
        now = self._clock() if now is None else now
        live = set()
        for name in self.manifests():
            m = self.get_manifest(name)
            live.update(self._okey(e["blob"]) for e in m["leaves"])
        pre = self.prefix + _OBJECTS
        base = _base(self.store)
        dead = [k for k in base.objects
                if k.startswith(pre) and k not in live]
        for k in dead:
            base.delete(k, now)
        return len(dead)
