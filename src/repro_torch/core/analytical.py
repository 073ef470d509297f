"""Analytical cost & latency model (paper §4), verbatim equations.

Parameters: N_inst instances, N_az AZs, λ records/s (aggregate), s_rec
bytes/record, S_batch target bytes, T_put/T_get object-storage latencies.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelParams:
    n_inst: int
    n_az: int
    rate: float          # λ, records/s aggregate
    s_rec: float         # bytes
    s_batch: float       # bytes
    t_put: float = 0.6   # seconds
    t_get: float = 0.075


def rate_per_instance(p: ModelParams) -> float:
    """λ_inst = λ / N_inst [records/s]."""
    return p.rate / p.n_inst


def bytes_per_instance(p: ModelParams) -> float:
    """b_inst = λ·s_rec / N_inst [bytes/s]."""
    return p.rate * p.s_rec / p.n_inst


def t_batch(p: ModelParams) -> float:
    """T_batch = S_batch·N_az·N_inst / (λ·s_rec) [s]."""
    return p.s_batch * p.n_az * p.n_inst / (p.rate * p.s_rec)


def batches_per_second_per_instance(p: ModelParams) -> float:
    """μ_batch,inst = λ·s_rec / (S_batch·N_inst)."""
    return p.rate * p.s_rec / (p.s_batch * p.n_inst)


def batches_per_second(p: ModelParams) -> float:
    """μ_batch = λ·s_rec / S_batch."""
    return p.rate * p.s_rec / p.s_batch


def put_rate(p: ModelParams) -> float:
    """μ_put = μ_batch (one PUT per batch)."""
    return batches_per_second(p)


def get_rate(p: ModelParams) -> float:
    """μ_get = μ_batch · (N_az − 1)/N_az (same-AZ reads hit the cache)."""
    return batches_per_second(p) * (p.n_az - 1) / p.n_az


def get_put_ratio(p: ModelParams) -> float:
    """GET:PUT = (N_az−1)/N_az — ≈ 2:3 for N_az=3 (paper Fig. 6f)."""
    return (p.n_az - 1) / p.n_az


def shuffle_latency_max(p: ModelParams) -> float:
    """T_shuffle^max = T_batch + T_put + T_get (upper bound)."""
    return t_batch(p) + p.t_put + p.t_get


def shuffle_latency_mean(p: ModelParams) -> float:
    """Expected latency: uniform arrival within the fill window, GET only
    for the (N_az−1)/N_az cross-AZ fraction."""
    return (t_batch(p) / 2.0 + p.t_put
            + p.t_get * (p.n_az - 1) / p.n_az)
