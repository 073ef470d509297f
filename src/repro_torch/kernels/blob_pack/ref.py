"""Plain PyTorch version of blob_pack: gather sorted rows into the blob
layout (the Batcher hot path), the port of
``repro.kernels.blob_pack.ref``.

Inputs are the sorted-order description of ``repro_torch.shuffle.binning``:

  x       (T, d)     record rows
  order   (U,)       unit index -> row index, sorted by destination bin
  starts  (bins,)    first position of each bin within ``order``
  counts  (bins,)    true demand per bin (may exceed capacity)

Output: (bins, capacity, d); rows beyond a bin's count are zero.
"""

from __future__ import annotations

import torch


def blob_pack_ref(x: torch.Tensor, order: torch.Tensor, starts: torch.Tensor,
                  counts: torch.Tensor, *, capacity: int) -> torch.Tensor:
    r = torch.arange(capacity, dtype=torch.int32, device=x.device)
    pos = starts[:, None] + r[None, :]                      # (bins, cap)
    valid = r[None, :] < torch.clamp(counts, max=capacity)[:, None]
    tok = order[torch.clamp(pos, 0, order.shape[0] - 1)]    # (bins, cap)
    rows = x[tok]                                           # (bins, cap, d)
    return torch.where(valid[..., None], rows, rows.new_zeros(()))
