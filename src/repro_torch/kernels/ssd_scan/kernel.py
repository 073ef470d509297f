"""CUDA kernel for the SSD chunk, the port of
``repro.kernels.ssd_scan.kernel.ssd_chunk_pallas``.

``ssd_chunk_fwd`` in ``csrc/ssd_chunk.cu``: one block per (head, chunk,
batch) computes the four outputs of ``ref.ssd_chunk_ref`` in f32 on the
CUDA cores, tiling the chunk's rows and columns by 64 so that no Q x Q
tile is held (the Pallas block keeps one in VMEM). B and C are read
through the group index ``h // (H // G)`` from their (b, nc, Q, G, N)
layout; no repeat to H heads is made. x, B and C are bf16 or f32; dt
and A are f32; every output is f32.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import (GRID_YZ_MAX, check_ssd_chunk,
                                         require_cuda)

#: dtypes of x, B and C the kernel takes (dt and A are float32)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
#: longest chunk: the per-row f32 arrays share the block's shared memory
MAX_CHUNK = 4096

SSD_CHUNK = _build.Kernel("ssd_chunk", "ssd_chunk_fwd",
                          [_build.P] * 9 + [_build.I32] * 8)


def launch(outs, xq, dtq, A, Bq, Cq) -> None:
    """Launch into ``outs`` = (y_intra, states, a_total, y_decay) without
    checks: only for tensors that ``ssd_chunk_cuda`` has accepted."""
    b, nc, Q, H, P = xq.shape
    G, N = Bq.shape[3], Bq.shape[4]
    y, st, at, yd = outs
    SSD_CHUNK(xq.device, xq.data_ptr(), dtq.data_ptr(), A.data_ptr(),
              Bq.data_ptr(), Cq.data_ptr(), y.data_ptr(), st.data_ptr(),
              at.data_ptr(), yd.data_ptr(), b, nc, Q, H, P, G, N,
              int(xq.dtype == torch.bfloat16))


def ssd_chunk_cuda(xq: torch.Tensor, dtq: torch.Tensor, A: torch.Tensor,
                   Bq: torch.Tensor, Cq: torch.Tensor
                   ) -> Tuple[torch.Tensor, ...]:
    """xq (b,nc,Q,H,P); dtq (b,nc,Q,H) f32; A (H,) f32; Bq/Cq
    (b,nc,Q,G,N) -> (y_intra, states, a_total, y_decay), all f32."""
    check_ssd_chunk(xq, dtq, A, Bq, Cq, KERNEL_DTYPES)
    require_cuda(xq=xq, dtq=dtq, A=A, Bq=Bq, Cq=Cq)
    b, nc, Q, H, P = xq.shape
    if Q > MAX_CHUNK or nc > GRID_YZ_MAX or b > GRID_YZ_MAX:
        raise ValueError(f"xq {tuple(xq.shape)}: the kernel takes chunks of "
                         f"at most {MAX_CHUNK} rows and at most "
                         f"{GRID_YZ_MAX} chunks and batch rows")
    N = Bq.shape[4]
    f32 = dict(dtype=torch.float32, device=xq.device)
    outs = (torch.empty((b, nc, Q, H, P), **f32),
            torch.empty((b, nc, H, P, N), **f32),
            torch.empty((b, nc, H), **f32),
            torch.empty((b, nc, Q, H), **f32))
    launch(outs, xq, dtq, A, Bq, Cq)
    return outs
