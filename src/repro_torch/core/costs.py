"""Cloud-cost model: BlobShuffle (S3 + EC2) vs native Kafka shuffling.

All prices are AWS us-east-1 list prices as used in the paper (§5.1.4,
§5.3). Anchors reproduced by `benchmarks/paper_fig6_batch_size.py`:
  * S3 cost @1 GiB/s, 1 h retention: 20.63 USD/h (1 MiB) → 0.29 (128 MiB)
  * native Kafka shuffle: 192 USD/h  (≈ (2/3 + 2)·$0.02/GB · 3600 GB/h)
  * 16 MiB total (S3 + EC2): 4.46 USD/h vs 192 → > 40×.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core.analytical import ModelParams, get_rate, put_rate
from repro_torch.core.stores.base import StoreCosts

GiB = 1024 ** 3


@dataclasses.dataclass(frozen=True)
class TierPrices:
    """Per-tier object-storage pricing for the tier sweep.

    ``standard`` matches the paper's S3 us-east-1 list prices; the
    premium tiers are illustrative but directionally correct: lower
    latency is bought with higher request and storage prices, and zonal
    tiers additionally bill cross-AZ routing per GB.
    """
    name: str
    put_per_1k: float
    get_per_1k: float
    storage_gb_month: float
    cross_az_per_gb: float = 0.0
    hours_per_month: float = 730.0

    def store_costs(self) -> StoreCosts:
        """The ``StoreCosts`` a ``BlobStore`` backend bills with."""
        return StoreCosts(put_per_req=self.put_per_1k / 1000.0,
                          get_per_req=self.get_per_1k / 1000.0,
                          storage_per_gb_month=self.storage_gb_month,
                          hours_per_month=self.hours_per_month,
                          cross_az_per_gb=self.cross_az_per_gb)


STANDARD = TierPrices("standard", put_per_1k=5.0e-3, get_per_1k=0.4e-3,
                      storage_gb_month=0.023)
EXPRESS_ONE_ZONE = TierPrices("express-one-zone", put_per_1k=1.0e-2,
                              get_per_1k=0.8e-3, storage_gb_month=0.16,
                              cross_az_per_gb=0.01)
PREMIUM = TierPrices("premium-low-latency", put_per_1k=2.5e-2,
                     get_per_1k=2.0e-3, storage_gb_month=0.30,
                     cross_az_per_gb=0.01)

TIERS: Dict[str, TierPrices] = {t.name: t
                                for t in (STANDARD, EXPRESS_ONE_ZONE,
                                          PREMIUM)}


def dollars_per_gib(cost_usd: float, nbytes: int) -> float:
    """Normalize a dollar figure by the bytes it moved (0 bytes -> 0)."""
    return cost_usd / (nbytes / GiB) if nbytes else 0.0


def shuffle_cost_per_logical_gib(prices: TierPrices, *,
                                 compressed_ratio: float = 1.0,
                                 batch_bytes: int = 16 * 1024 ** 2,
                                 gets_per_blob: float = 9.0,
                                 retention_s: float = 3600.0) -> float:
    """Dollars to shuffle one *logical* (pre-compression) GiB.

    The Batcher triggers on logical buffered bytes, so a wire format that
    compresses blocks at finalize leaves the blob/notification *counts*
    unchanged and shrinks only the shipped bytes: request charges are
    fixed, while storage and cross-AZ routing scale with
    ``compressed_ratio`` (shipped/logical). This is why compression is
    ~free on S3 Standard but pays directly on the per-GB-billed premium
    tiers — the same asymmetry the paper exploits in the other direction
    by batching requests.
    """
    n_blobs = GiB / batch_bytes
    shipped_gb = compressed_ratio * GiB / 1e9
    months = retention_s / 3600.0 / prices.hours_per_month
    return (n_blobs / 1000.0 * prices.put_per_1k
            + n_blobs * gets_per_blob / 1000.0 * prices.get_per_1k
            + shipped_gb * months * prices.storage_gb_month
            + shipped_gb * prices.cross_az_per_gb)


@dataclasses.dataclass(frozen=True)
class AwsPrices:
    s3_put_per_1k: float = 5.0e-3
    s3_get_per_1k: float = 0.4e-3
    s3_storage_gb_month: float = 0.023
    hours_per_month: float = 730.0
    cross_az_per_gb: float = 0.02        # $0.01 egress + $0.01 ingress
    ec2_r6in_xlarge_hour: float = 0.3741  # app nodes (2 instances/node)
    kafka_replication_factor: int = 3


@dataclasses.dataclass(frozen=True)
class CostBreakdown:
    s3_put: float
    s3_get: float
    s3_storage: float
    ec2: float

    @property
    def s3_total(self) -> float:
        return self.s3_put + self.s3_get + self.s3_storage

    @property
    def total(self) -> float:
        return self.s3_total + self.ec2


def blobshuffle_cost_per_hour(p: ModelParams, *, retention_s: float = 3600.0,
                              prices: AwsPrices = AwsPrices(),
                              nodes: int = 0,
                              actual_batch_frac: float = 1.0
                              ) -> CostBreakdown:
    """Hourly cost at the model's throughput.

    ``actual_batch_frac``: mean actual/target batch size (Fig. 6g: ~0.97
    up to 32 MiB, ~0.90 at 128 MiB) — commits finalize batches early,
    increasing the request rates by 1/frac.
    """
    scale = 1.0 / max(actual_batch_frac, 1e-6)
    puts_h = put_rate(p) * scale * 3600.0
    gets_h = get_rate(p) * scale * 3600.0
    stored_gb = p.rate * p.s_rec * retention_s / 1e9
    return CostBreakdown(
        s3_put=puts_h / 1000.0 * prices.s3_put_per_1k,
        s3_get=gets_h / 1000.0 * prices.s3_get_per_1k,
        s3_storage=stored_gb * prices.s3_storage_gb_month
        / prices.hours_per_month,
        ec2=nodes * prices.ec2_r6in_xlarge_hour,
    )


def kafka_shuffle_cost_per_hour(p: ModelParams,
                                prices: AwsPrices = AwsPrices()) -> float:
    """Native Kafka repartitioning cross-AZ cost (paper §5.3).

    Per shuffled GB: producer→leader crosses AZs with prob (N_az−1)/N_az;
    replication sends to (rf−1) followers in other AZs; consumers use
    AZ-aware follower fetching (0 cross-AZ). Each crossing is billed
    $0.01/GB on both sides.
    """
    crossings = (p.n_az - 1) / p.n_az + (prices.kafka_replication_factor - 1)
    gb_per_hour = p.rate * p.s_rec * 3600.0 / 1e9
    return crossings * prices.cross_az_per_gb * gb_per_hour


def actual_batch_frac(s_batch: float) -> float:
    """Fig. 6g interpolation: ≈97–98% of target ≤32 MiB, ~90% at 128 MiB."""
    mib = s_batch / (1024.0 ** 2)
    if mib <= 32:
        return 0.975
    if mib >= 128:
        return 0.90
    # log-linear between 32 and 128 MiB
    import math
    t = (math.log2(mib) - 5.0) / 2.0
    return 0.975 + (0.90 - 0.975) * t
