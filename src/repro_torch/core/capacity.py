"""Throughput-capacity model, calibrated to the paper's measurements.

Per-instance processing time per MiB shuffled (ad-hoc throughput regime):

    τ(S, p, N) = A0 + η·p + ζ·N + (B + C·p)/S + D·max(S − 32, 0)

with S the target batch size in MiB, p = partitions per AZ, N the number
of Kafka Streams instances. Terms:
  * A0      — per-byte record handling (serialize, key, copy),
  * η·p     — per-record partition bookkeeping growing with partitions,
  * ζ·N     — cluster coordination overhead (consumer group, fetches),
  * (B+C·p)/S — per-blob overhead (upload mgmt + p notifications/blob),
  * D·(S−32)⁺  — large-batch memory pressure (buffer churn / GC).

Coefficients are least-squares fitted to the paper's anchor set (Fig. 6a
throughput-vs-batch-size incl. the 1.43 GiB/s peak at 32 MiB, Fig. 8
partition scaling ≈ −26% at 3× partitions, Fig. 9 cluster scaling
144.2 → 102.0 MiB/s per node); see benchmarks/fit_capacity.py.
"""

from __future__ import annotations

import dataclasses

MiB = 1024.0 ** 2


@dataclasses.dataclass(frozen=True)
class CapacityModel:
    a0: float = 0.00957812      # s/MiB
    eta: float = 1.89894e-05    # s/MiB per partition-per-AZ
    zeta: float = 0.000144046   # s/MiB per instance
    b: float = 0.000602981      # s per blob-MiB⁻¹ (per-blob overhead)
    c: float = 0.000314289      # s per notification-MiB⁻¹
    d: float = 4.33962e-05      # s/MiB per MiB above 32

    def tau(self, s_batch_mib: float, parts_per_az: float,
            n_inst: int) -> float:
        """Seconds of instance time per MiB of shuffled data."""
        t = (self.a0 + self.eta * parts_per_az + self.zeta * n_inst
             + (self.b + self.c * parts_per_az) / s_batch_mib
             + self.d * max(s_batch_mib - 32.0, 0.0))
        return t

    def max_throughput(self, s_batch_mib: float, partitions: int,
                       n_inst: int, n_az: int = 3) -> float:
        """Cluster ad-hoc throughput in bytes/s."""
        p = partitions / n_az
        return n_inst / self.tau(s_batch_mib, p, n_inst) * MiB

    def max_throughput_gib(self, s_batch_mib: float, partitions: int,
                           n_inst: int, n_az: int = 3) -> float:
        return self.max_throughput(s_batch_mib, partitions, n_inst,
                                   n_az) / 1024.0 ** 3
