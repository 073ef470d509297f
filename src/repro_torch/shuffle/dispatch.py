"""Per-rank expert dispatch and combine, the port of
``repro.shuffle.dispatch``: the flat baseline and the blob-hierarchical
exchange, two routings of the same token -> expert repartitioning.

``flat``  the "native Kafka Streams shuffling" analogue: one all-to-all
          over the whole EP domain, a worst-case-sized lane for every
          (source, destination) pair, each crossing the pod axis alone.
``blob``  the BlobShuffle analogue: stage 1 bins units by destination
          model rank and exchanges them inside the pod, so that each rank
          holds one contiguous blob per destination pod; stage 2 moves
          those pooled blobs across the ``pod`` axis once, with a capacity
          pooled over the pod's sources and, optionally, int8 on that leg.

The JAX package runs these inside ``shard_map``; here they run on every
rank of a mesh at once through the mesh's exchange
(``repro_torch.shuffle.exchange.for_mesh``, the ``exchange`` argument):
each argument and result carries a leading axis of this process's ranks
(all of them on a ``StackedMesh``, one on a ``ProcessGroupMesh``), and
the diagnostics come back per rank, summed over the EP axes.

Every scatter into bins and gather out of them is one launch of the
Batcher's pack or the Debatcher's unpack over all of this process's
ranks (``StackedBinning``), bit for bit the index-based
``binning.scatter_to_bins``/``gather_from_bins`` of each rank.

``_cap`` and ``pooled_capacity_factor`` decide which units are dropped,
so they stay plain Python on Python floats, as in the JAX package: a
float difference in ``ceil(expected * factor)`` would move a unit
across the capacity.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Sequence

import torch

from repro_torch.kernels.blob_pack.ops import blob_pack
from repro_torch.kernels.blob_unpack.ops import blob_unpack
from repro_torch.shuffle import compression
from repro_torch.shuffle.binning import pack_sorted, sorted_order


class DispatchDiagnostics(NamedTuple):
    dropped: torch.Tensor       # units dropped to capacity overflow (global)
    expert_load: torch.Tensor   # (E,) tokens routed per expert (global)
    dcn_bytes: torch.Tensor     # payload bytes that crossed the pod axis


def _cap(expected: float, factor: float, align: int = 8) -> int:
    c = int(math.ceil(expected * factor))
    return max(align, -(-c // align) * align)


def pooled_capacity_factor(base: float, pool: int) -> float:
    """Slack needed shrinks ~1/sqrt(pool) when pooling independent demand,
    the statistical-multiplexing win of blob aggregation (paper §4)."""
    return 1.0 + (base - 1.0) / math.sqrt(max(pool, 1))


class StackedBinning:
    """Every rank's units binned at once, the Batcher's layout of each.

    keys (R, U): rank r's unit u goes to bin keys[r, u] of ``num_bins``,
    each of ``capacity`` slots. Rank r's keys are offset by r * num_bins,
    so one stable sort over all ranks orders each rank's units as its own
    sort would, and a slot of the flat (R * num_bins * capacity) layout is
    the rank's own ``bin_pack`` slot offset by r * num_bins * capacity.
    ``counts`` (R, num_bins) is each rank's true demand. Its plain
    version, rank by rank, is ``binning.IndexedBinning``."""

    def __init__(self, keys: torch.Tensor, num_bins: int, capacity: int):
        R, U = keys.shape
        offsets = torch.arange(R, dtype=keys.dtype, device=keys.device)[:, None]
        flat = (keys + offsets * num_bins).reshape(-1)
        self.order, self.starts, counts = sorted_order(flat, R * num_bins)
        self.pack = pack_sorted(flat, self.order, self.starts, counts, capacity)
        self.counts = counts.view(R, num_bins)
        self.num_bins, self.capacity = num_bins, capacity

    def scatter(self, rows: torch.Tensor, unit_row: torch.Tensor | None = None,
                bins: int | None = None) -> torch.Tensor:
        """rows (R, N, w), or (R, N) for one value a row: rank r's unit u
        carries rows[r, unit_row[u]] (its own row u without ``unit_row``).
        Returns (R, bins, capacity[, w]), the first ``bins`` bins of each
        rank (default all): ``scatter_to_bins(...)[:bins]`` of each rank,
        in one pack launch."""
        R, N = rows.shape[:2]
        nb = self.num_bins if bins is None else bins
        src = self.order
        if unit_row is not None:
            base = torch.arange(R, dtype=torch.int32, device=rows.device)[:, None] * N
            src = (base + unit_row[None, :]).reshape(-1)[src]
        starts, counts = self.starts, self.counts.reshape(-1)
        if nb != self.num_bins:
            starts = starts.view(R, self.num_bins)[:, :nb].contiguous().view(-1)
            counts = self.counts[:, :nb].contiguous().view(-1)
        flat = rows.reshape(R * N, -1)     # a 1-D row of int32 is a (U, 1) row
        out = blob_pack(flat, src, starts, counts, capacity=self.capacity)
        return out.view(R, nb, self.capacity, *rows.shape[2:])

    def gather(self, buf: torch.Tensor) -> torch.Tensor:
        """buf (R, num_bins, capacity, w) -> (R, U, w): each rank's
        ``gather_from_bins``, in one unpack launch; dropped units read 0."""
        R = buf.shape[0]
        flat = buf.reshape(R * self.num_bins, self.capacity, buf.shape[-1])
        return blob_unpack(flat, self.pack.slot, self.pack.valid).view(
            R, -1, buf.shape[-1])

    def dropped(self, bins: int | None = None) -> torch.Tensor:
        """(R,) int32: units over capacity in each rank's first ``bins``
        bins (default all)."""
        over = self.counts[:, :bins] - self.capacity
        return torch.clamp(over, min=0).sum(dim=1, dtype=torch.int32)


def _unit_tokens(T_loc: int, k: int, device) -> torch.Tensor:
    return torch.arange(T_loc, dtype=torch.int32, device=device).repeat_interleave(k)


def _combine(sel_w: torch.Tensor, y_units: torch.Tensor) -> torch.Tensor:
    """sum_k sel_w[r, t, k] * y_units[r, t * k + k'] in f32."""
    R, T_loc, k = sel_w.shape
    return torch.einsum("rtk,rtkd->rtd", sel_w,
                        y_units.reshape(R, T_loc, k, -1).float())


# ---------------------------------------------------------------------------
# Flat (baseline) dispatch
# ---------------------------------------------------------------------------

def flat_dispatch_combine(
    x: torch.Tensor,              # (R, T_loc, d) each rank's tokens
    sel_idx: torch.Tensor,        # (R, T_loc, k) selected global expert ids
    sel_w: torch.Tensor,          # (R, T_loc, k) combine weights
    expert_fn: Callable,          # (R, E_loc, C, d) -> (R, E_loc, C, d_out)
    *,
    exchange,                     # the mesh's exchange (exchange.for_mesh)
    num_experts: int,
    ep_axes: Sequence[str],       # axes forming the EP domain, e.g. ("pod", "model")
    capacity_factor: float,
    d_out: int,
):
    """One-stage all-to-all over the whole EP domain."""
    ex = exchange
    R, T_loc, d = x.shape
    k = sel_idx.shape[-1]
    ep = ex.axis_size(ep_axes)
    E_loc = num_experts // ep
    U = T_loc * k

    unit_expert = sel_idx.reshape(R, U)
    # per-(source, expert) lane capacity: fine-grained, worst-case slack
    cap = _cap(U / num_experts, capacity_factor)
    bins = StackedBinning(unit_expert, num_experts, cap)

    send = bins.scatter(x, _unit_tokens(T_loc, k, x.device))   # (R, E, cap, d)
    send = send.reshape(R, ep, E_loc * cap, d)
    recv = ex.all_to_all(send, tuple(ep_axes))
    recv = recv.reshape(R, ep, E_loc, cap, d).transpose(1, 2) \
        .reshape(R, E_loc, ep * cap, d)

    out = expert_fn(recv)                                      # (R, E_loc, ep*cap, d_out)

    back = out.reshape(R, E_loc, ep, cap, d_out).transpose(1, 2) \
        .reshape(R, ep, E_loc * cap, d_out)
    back = ex.all_to_all(back, tuple(ep_axes))
    y_units = bins.gather(back.reshape(R, num_experts, cap, d_out))

    y = _combine(sel_w, y_units)
    # notifications -> diagnostics
    counts_global = ex.psum(bins.counts, tuple(ep_axes))
    dropped = ex.psum(bins.dropped(), tuple(ep_axes))
    dcn = _flat_dcn_bytes(ex, send, ep_axes)
    return y.to(x.dtype), DispatchDiagnostics(dropped, counts_global, dcn)


def _flat_dcn_bytes(ex, send: torch.Tensor, ep_axes: Sequence[str]) -> torch.Tensor:
    """(R,) bytes of the flat all-to-all payload that cross the pod
    boundary, summed over the EP domain: buffer sizes, not valid rows."""
    if "pod" not in ep_axes:
        return send.new_zeros((ex.ranks,), dtype=torch.float32)
    npods = ex.axis_size(["pod"])
    frac_cross = (npods - 1) / npods
    per_dev = send[0].numel() * send.element_size() * frac_cross
    return ex.psum(send.new_full((ex.ranks,), per_dev, dtype=torch.float32),
                   tuple(ep_axes))


# ---------------------------------------------------------------------------
# Blob (hierarchical) dispatch: the paper's technique
# ---------------------------------------------------------------------------

def blob_dispatch_combine(
    x: torch.Tensor,
    sel_idx: torch.Tensor,
    sel_w: torch.Tensor,
    expert_fn: Callable,
    *,
    exchange,
    num_experts: int,
    pod_axis: str,                # outer (expensive) axis
    inner_axes: Sequence[str],    # intra-pod EP axes, e.g. ("model",)
    capacity_factor: float,
    d_out: int,
    compress_dcn: bool = False,   # int8 on the inter-pod leg
):
    """Two-stage hierarchical dispatch: intra-pod aggregation -> pooled
    inter-pod blob transfer -> local expert execution (module docstring)."""
    ex = exchange
    R, T_loc, d = x.shape
    k = sel_idx.shape[-1]
    P = ex.axis_size([pod_axis])
    M = ex.axis_size(inner_axes)
    ep = P * M
    E_loc = num_experts // ep
    U = T_loc * k
    inner = tuple(inner_axes)

    unit_expert = sel_idx.reshape(R, U)
    # expert e lives at (pod p, model m, local l):
    #   p = e // (M*E_loc);  m = (e // E_loc) % M;  l = e % E_loc
    dest_m = (unit_expert // E_loc) % M

    # ---- Stage 1: intra-pod exchange over the model axis (cheap ICI)
    cap1 = _cap(U / M, capacity_factor)
    bins1 = StackedBinning(dest_m, M, cap1)
    payload1 = bins1.scatter(x, _unit_tokens(T_loc, k, x.device))  # (R, M, cap1, d)
    meta1 = bins1.scatter(unit_expert + 1)                         # 0 == empty
    recv1 = ex.all_to_all(payload1, inner)
    rmeta1 = ex.all_to_all(meta1, inner)

    # each rank now aggregates, per destination pod, one contiguous blob
    u1_expert = rmeta1.reshape(R, M * cap1) - 1                   # -1 == empty slot
    u1_valid = u1_expert >= 0
    u1_x = recv1.reshape(R, M * cap1, d)

    dest_p = torch.where(u1_valid, u1_expert // (M * E_loc), P)    # P == drop bin
    # ---- Stage 2: pooled blob capacity; the slack shrinks by ~1/sqrt(M)
    cf2 = pooled_capacity_factor(capacity_factor, M)
    cap2 = _cap(U / P, cf2)
    bins2 = StackedBinning(dest_p, P + 1, cap2)
    payload2 = bins2.scatter(u1_x, bins=P)                         # the drop bin left out
    meta2 = bins2.scatter(u1_expert + 1, bins=P)

    if compress_dcn:
        q, scale = compression.int8_quantize(payload2)
        q = ex.all_to_all(q, (pod_axis,))
        scale = ex.all_to_all(scale, (pod_axis,))
        recv2 = compression.int8_dequantize(q, scale, payload2.dtype)
        dcn_payload_bytes = payload2[0].numel() * 1 + scale[0].numel() * 4
    else:
        recv2 = ex.all_to_all(payload2, (pod_axis,))
        dcn_payload_bytes = payload2[0].numel() * payload2.element_size()
    rmeta2 = ex.all_to_all(meta2, (pod_axis,))

    # ---- Local expert execution ("Debatcher" + processing)
    u2_expert = rmeta2.reshape(R, P * cap2) - 1
    u2_valid = u2_expert >= 0
    u2_x = recv2.reshape(R, P * cap2, d)
    local_e = torch.where(u2_valid, u2_expert % E_loc, E_loc)
    # expected per local expert: U*P*M system units / E experts = U/E_loc
    cf3 = pooled_capacity_factor(capacity_factor, M * P)
    cap_e = _cap(U / E_loc, cf3)
    bins3 = StackedBinning(local_e, E_loc + 1, cap_e)
    ebuf = bins3.scatter(u2_x, bins=E_loc)

    eout = expert_fn(ebuf)                                         # (R, E_loc, cap_e, d_out)

    # ---- Reverse path (slots are symmetric; results ride the same lanes)
    eout_full = torch.cat([eout, eout.new_zeros((R, 1, cap_e, d_out))], dim=1)
    y2 = bins3.gather(eout_full)                                   # (R, P*cap2, d_out)
    back2 = ex.all_to_all(y2.reshape(R, P, cap2, d_out), (pod_axis,))
    y1_full = torch.cat([back2, back2.new_zeros((R, 1, cap2, d_out))], dim=1)
    y1 = bins2.gather(y1_full)                                     # (R, M*cap1, d_out)
    back1 = ex.all_to_all(y1.reshape(R, M, cap1, d_out), inner)
    y_units = bins1.gather(back1)                                  # (R, U, d_out)

    y = _combine(sel_w, y_units)

    all_axes = inner + (pod_axis,)
    offsets = torch.arange(R, dtype=unit_expert.dtype, device=x.device)[:, None]
    counts = torch.bincount((unit_expert + offsets * num_experts).reshape(-1),
                            minlength=R * num_experts)
    counts_global = ex.psum(counts.view(R, num_experts).to(torch.int32), all_axes)
    dropped = ex.psum(bins1.dropped() + bins2.dropped(P) + bins3.dropped(E_loc),
                      all_axes)
    frac_cross = (P - 1) / P
    dcn = ex.psum(x.new_full((R,), dcn_payload_bytes * frac_cross,
                             dtype=torch.float32), all_axes)
    return y.to(x.dtype), DispatchDiagnostics(dropped, counts_global, dcn)
