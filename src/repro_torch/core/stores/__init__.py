"""Pluggable object-storage backends behind the ``BlobStore`` protocol.

The dataflow core (cache, engine, pipeline, simulator) depends only on
``BlobStore``; concrete tiers plug in per deployment:

  * ``SimulatedS3``         — S3 Standard, calibrated lognormal latency;
  * ``ExpressOneZoneStore`` — zonal premium tier, low latency, cross-AZ
                              reads route via the home AZ;
  * ``FaultyStore``         — decorator injecting 503-SlowDown throttling
                              (per-prefix token bucket), transient
                              errors, and timeout tails over any backend.
"""

from repro_torch.core.stores.base import (BlobStore, LatencyModel, SlowDownError,
                                    StoreCosts, StoreError, StoreStats,
                                    StoreTimeoutError, TransientStoreError)
from repro_torch.core.stores.simulated_s3 import SimulatedS3, StoredObject
from repro_torch.core.stores.express import ExpressOneZoneStore, express_latency
from repro_torch.core.stores.faulty import FaultStats, FaultyStore

__all__ = [
    "BlobStore", "LatencyModel", "StoreCosts", "StoreStats",
    "StoreError", "SlowDownError", "TransientStoreError",
    "StoreTimeoutError", "SimulatedS3", "StoredObject",
    "ExpressOneZoneStore", "express_latency", "FaultStats", "FaultyStore",
]
