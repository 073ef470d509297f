"""Plain PyTorch version of blob_unpack (Debatcher): blob layout -> unit
rows, the port of ``repro.kernels.blob_unpack.ref``."""

from __future__ import annotations

import torch


def blob_unpack_ref(buf: torch.Tensor, slot: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """buf (bins, cap, d); slot (U,) flat slot ids; valid (U,) mask.

    Returns (U, d): unit u reads buf.reshape(-1, d)[slot[u]], zero if
    invalid (capacity-dropped units)."""
    flat = buf.reshape(-1, buf.shape[-1])
    rows = flat[torch.clamp(slot, 0, flat.shape[0] - 1)]
    return torch.where(valid[:, None], rows, rows.new_zeros(()))
