"""Token binning ("Batcher") primitives, the port of ``repro.shuffle.binning``.

Units are grouped by destination into fixed-capacity contiguous bins, the
"blobs"; ``counts`` is the notification metadata. Index tensors stay
int32 as in the JAX package. The stable argsort, ``bincount`` and
``cumsum`` are library calls, as JAX leaves them to XLA outside Pallas.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels._checks import check_keys


class Packing(NamedTuple):
    slot: torch.Tensor     # (U,) int32: flat slot in the (bins*capacity) buffer
    valid: torch.Tensor    # (U,) bool: False for capacity overflow (dropped)
    counts: torch.Tensor   # (bins,) int32: notification metadata (true demand)


def sorted_order(keys: torch.Tensor, num_bins: int
                 ) -> "tuple[torch.Tensor, torch.Tensor, torch.Tensor]":
    """Stable argsort-by-destination description: (order, starts, counts).

    ``order`` maps sorted position -> unit index; ``starts[b]`` is bin b's
    first position within ``order``; ``counts`` is the true demand."""
    check_keys(keys, num_bins)
    order = torch.argsort(keys, stable=True).to(torch.int32)
    counts = torch.bincount(keys, minlength=num_bins).to(torch.int32)
    starts = torch.cat([counts.new_zeros(1),
                        torch.cumsum(counts, 0)[:-1].to(torch.int32)])
    return order, starts, counts


def bin_pack(keys: torch.Tensor, num_bins: int, capacity: int) -> Packing:
    """Assign each unit a slot = key*capacity + rank-within-key, ranks in
    stable sorted order (records of one destination stay contiguous)."""
    return pack_sorted(keys, *sorted_order(keys, num_bins), capacity)


def pack_sorted(keys: torch.Tensor, order: torch.Tensor, starts: torch.Tensor,
                counts: torch.Tensor, capacity: int) -> Packing:
    """``bin_pack`` from the keys' ``sorted_order`` (order, starts, counts),
    for a caller that also hands that description to the pack kernel."""
    U = keys.shape[0]
    sorted_keys = keys[order]
    rank_sorted = (torch.arange(U, dtype=torch.int32, device=keys.device)
                   - starts[sorted_keys])
    rank = torch.zeros(U, dtype=torch.int32, device=keys.device)
    rank[order] = rank_sorted
    valid = rank < capacity
    slot = (keys.to(torch.int32) * capacity
            + torch.clamp(rank, max=capacity - 1))
    return Packing(slot, valid, counts)


def scatter_to_bins(values: torch.Tensor, pack: Packing, num_bins: int,
                    capacity: int) -> torch.Tensor:
    """values (U, ...) -> (num_bins, capacity, ...). Overflow units go to
    a dump row that is sliced off, so valid units never collide."""
    total = num_bins * capacity
    slot = torch.where(pack.valid, pack.slot, total)
    buf = values.new_zeros((total + 1,) + tuple(values.shape[1:]))
    buf[slot] = values
    return buf[:total].reshape((num_bins, capacity) + tuple(values.shape[1:]))


def gather_from_bins(buf: torch.Tensor, pack: Packing) -> torch.Tensor:
    """Inverse of scatter: (num_bins, capacity, ...) -> (U, ...). Dropped
    units read zeros."""
    flat = buf.reshape((-1,) + tuple(buf.shape[2:]))
    vals = flat[pack.slot]
    mask = pack.valid.reshape((-1,) + (1,) * (vals.dim() - 1))
    return torch.where(mask, vals, vals.new_zeros(()))


def dropped_units(pack: Packing, capacity: int) -> torch.Tensor:
    """Overflow count derived from the notification metadata (int32)."""
    return torch.clamp(pack.counts - capacity, min=0).sum(dtype=torch.int32)


class IndexedBinning:
    """Every rank's units binned rank by rank through the index-based
    helpers above: the plain version of ``dispatch.StackedBinning``, with
    its interface, against which the dispatch's one-launch packs and
    unpacks are held bit for bit.

    keys (R, U): rank r's unit u goes to bin keys[r, u] of ``num_bins``,
    each of ``capacity`` slots."""

    def __init__(self, keys: torch.Tensor, num_bins: int, capacity: int):
        self.packs = [bin_pack(k, num_bins, capacity) for k in keys]
        self.counts = torch.stack([p.counts for p in self.packs])
        self.num_bins, self.capacity = num_bins, capacity

    def scatter(self, rows: torch.Tensor, unit_row: torch.Tensor | None = None,
                bins: int | None = None) -> torch.Tensor:
        """Each rank's ``scatter_to_bins(rows[r][unit_row])[:bins]``."""
        return torch.stack([
            scatter_to_bins(r if unit_row is None else r[unit_row], p,
                            self.num_bins, self.capacity)[:bins]
            for r, p in zip(rows, self.packs)])

    def gather(self, buf: torch.Tensor) -> torch.Tensor:
        """Each rank's ``gather_from_bins(buf[r])``."""
        return torch.stack([gather_from_bins(b, p)
                            for b, p in zip(buf, self.packs)])

    def dropped(self, bins: int | None = None) -> torch.Tensor:
        """(R,) int32: units over capacity in each rank's first ``bins``
        bins (default all)."""
        over = self.counts[:, :bins] - self.capacity
        return torch.clamp(over, min=0).sum(dim=1, dtype=torch.int32)
