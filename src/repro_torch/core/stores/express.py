"""S3 Express One Zone–style premium tier: zonal buckets, low latency.

Models a directory-bucket deployment with one bucket per AZ: a blob is
written to the writer's *home-AZ* bucket and single-digit-millisecond
access only holds within that AZ. A consumer in another AZ must route
the read via the home AZ and pays ``cross_az_penalty_s`` on top of the
sampled latency (and is counted in ``stats.cross_az_gets`` so cost
models can bill the crossing). Request and storage prices are the
premium-tier prices from ``repro_torch.core.costs.EXPRESS_ONE_ZONE``.

With BlobShuffle's per-AZ batching (the Batcher already groups buffers
by destination AZ), most GETs are same-AZ — exactly the access pattern
this tier is priced for.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.core.stores.base import LatencyModel, StoreCosts
from repro_torch.core.stores.simulated_s3 import SimulatedS3


def express_latency() -> LatencyModel:
    """Single-digit-ms first-byte latency, tighter tail than Standard."""
    return LatencyModel(put_t0_s=0.018, put_bw=220 * 1024 ** 2,
                        get_t0_s=0.004, get_bw=700 * 1024 ** 2,
                        sigma=0.22)


class ExpressOneZoneStore(SimulatedS3):
    """Zonal premium tier: per-AZ buckets, cross-AZ reads pay a penalty."""

    def __init__(self, latency: Optional[LatencyModel] = None,
                 costs: Optional[StoreCosts] = None, seed: int = 0,
                 retention_s: float = 3600.0, num_az: int = 3,
                 cross_az_penalty_s: float = 0.020):
        if costs is None:
            from repro_torch.core.costs import EXPRESS_ONE_ZONE
            costs = EXPRESS_ONE_ZONE.store_costs()
        super().__init__(latency or express_latency(), costs, seed,
                         retention_s)
        self.num_az = num_az
        self.cross_az_penalty_s = cross_az_penalty_s

    def _sample_get(self, size: int, az: Optional[int],
                    blob_id: str) -> float:
        lat = super()._sample_get(size, az, blob_id)
        obj = self.objects.get(blob_id)
        home = obj.home_az if obj is not None else None
        if az is not None and home is not None and az != home:
            # routed via the home AZ: pay the inter-AZ round trip in
            # latency, and the per-GB routing charge on the bill
            self.stats.cross_az_gets += 1
            self.stats.cross_az_get_bytes += size
            lat += self.cross_az_penalty_s
        return lat
