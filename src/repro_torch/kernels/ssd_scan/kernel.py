"""CUDA kernels for the SSD chunk, the port of
``repro.kernels.ssd_scan.kernel.ssd_chunk_pallas``.

``csrc/ssd_chunk.cu`` holds two kernels; the dtype and shape pick one
(``route``):

- bf16 with Q, P and N multiples of 16, N at most 128 and the shared
  memory of a block of one head within the card's 227 KB:
  ``ssd_chunk_fwd_tc``. One block per (batch, chunk, group, up to 8 heads
  of the group) stages C and B once and runs the three products on the
  tensor cores (``mma.sync``), the f32 operand of two of them split into
  bf16 hi and lo parts, which keeps the f32 outputs within 1e-4 of the
  plain version.
- f32, and every other bf16 shape: ``ssd_chunk_fwd``, one block per
  (head, chunk, batch), f32 products on the CUDA cores in 64 x 64 tiles.

Both compute the four outputs of ``ref.ssd_chunk_ref`` in f32. B and C
are read through the group index ``h // (H // G)`` from their (b, nc, Q,
G, N) layout; no repeat to H heads is made. dt and A are f32.

Each kernel has a second launcher for the bf16-intra mode
(``ssd_chunk_ref(..., intra_bf16=True)``, the mode of the JAX package's
``ssd_chunked(..., intra_bf16=True)``): ``ssd_chunk_fwd_tc_bf16i`` and
``ssd_chunk_fwd_bf16i``, routed by the same dtype and shape rules. The
intra-chunk scores are rounded to bf16 at each step, and the tensor-core
kernel multiplies them with x once, without the lo part. Its block rounds
C . B^T once for all its heads, where the tiles fit in shared memory
beside the rest (Q at most 256; the source decides, the route does not
change), and each head weights them in bf16x2 pairs.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import (GRID_YZ_MAX, check_ssd_chunk,
                                         require_cuda)

#: dtypes of x, B and C the kernels take (dt and A are float32)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
#: longest chunk of the CUDA-core kernel: the per-row f32 arrays share the
#: block's shared memory
MAX_CHUNK = 4096
#: the tensor-core kernel: its largest state width, its most heads a block,
#: the bf16 padding of a row in shared memory, its f32 arrays per row and
#: head, and a block's shared memory
TC_MAX_N = 128
TC_MAX_HEADS = 8
TC_PAD = 8
TC_ROW_ARRAYS = 4
SMEM_MAX = 232448

_ARGS = [_build.P] * 9 + [_build.I32] * 7
SSD_CHUNK_TC = _build.Kernel("ssd_chunk", "ssd_chunk_fwd_tc", _ARGS)
SSD_CHUNK = _build.Kernel("ssd_chunk", "ssd_chunk_fwd", _ARGS + [_build.I32])
SSD_CHUNK_TC_BF16I = _build.Kernel("ssd_chunk", "ssd_chunk_fwd_tc_bf16i", _ARGS)
SSD_CHUNK_BF16I = _build.Kernel("ssd_chunk", "ssd_chunk_fwd_bf16i", _ARGS + [_build.I32])
KERNELS = (SSD_CHUNK_TC, SSD_CHUNK, SSD_CHUNK_TC_BF16I, SSD_CHUNK_BF16I)
#: the CUDA-core launchers, which take x's dtype as their last argument
_CORE = (SSD_CHUNK, SSD_CHUNK_BF16I)


def tc_smem_bytes(Q: int, P: int, N: int, heads: int) -> int:
    """Shared memory of a tensor-core block (``tc_smem_bytes`` in the
    source): C and B, two buffers of x, and four f32 arrays per head."""
    return (2 * Q * (N + TC_PAD) * 2 + 2 * Q * (P + TC_PAD) * 2
            + TC_ROW_ARRAYS * heads * Q * 4)


def tc_heads(Q: int, P: int, N: int) -> int:
    """Heads a tensor-core block takes (``tc_heads`` in the source): the
    most of 8, 4, 2, 1 whose shared memory fits; 0 if none does."""
    heads = TC_MAX_HEADS
    while heads and tc_smem_bytes(Q, P, N, heads) > SMEM_MAX:
        heads //= 2
    return heads


def route(dtype: torch.dtype, Q: int, P: int, N: int,
          intra_bf16: bool = False) -> _build.Kernel:
    """The kernel that serves x, B and C of this dtype and a chunk of Q
    rows, head dim P and state width N, in the bf16-intra mode or not."""
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"no SSD chunk kernel takes {dtype}")
    if (dtype == torch.bfloat16 and Q % 16 == 0 and P % 16 == 0 and N % 16 == 0
            and N <= TC_MAX_N and tc_heads(Q, P, N)):
        return SSD_CHUNK_TC_BF16I if intra_bf16 else SSD_CHUNK_TC
    return SSD_CHUNK_BF16I if intra_bf16 else SSD_CHUNK


def launch(outs, xq, dtq, A, Bq, Cq, kernel=None, intra_bf16: bool = False) -> None:
    """Launch ``kernel`` (default: the routed one) into ``outs`` =
    (y_intra, states, a_total, y_decay) without checks: only for tensors
    that ``ssd_chunk_cuda`` has accepted."""
    b, nc, Q, H, P = xq.shape
    G, N = Bq.shape[3], Bq.shape[4]
    kernel = route(xq.dtype, Q, P, N, intra_bf16) if kernel is None else kernel
    args = [xq.data_ptr(), dtq.data_ptr(), A.data_ptr(), Bq.data_ptr(),
            Cq.data_ptr(), *(t.data_ptr() for t in outs), b, nc, Q, H, P, G, N]
    if kernel in _CORE:
        args.append(int(xq.dtype == torch.bfloat16))
    kernel(xq.device, *args)


def ssd_chunk_cuda(xq: torch.Tensor, dtq: torch.Tensor, A: torch.Tensor,
                   Bq: torch.Tensor, Cq: torch.Tensor, intra_bf16: bool = False
                   ) -> Tuple[torch.Tensor, ...]:
    """xq (b,nc,Q,H,P); dtq (b,nc,Q,H) f32; A (H,) f32; Bq/Cq
    (b,nc,Q,G,N) -> (y_intra, states, a_total, y_decay), all f32;
    ``intra_bf16`` takes the bf16-intra launcher of the routed kernel."""
    check_ssd_chunk(xq, dtq, A, Bq, Cq, KERNEL_DTYPES)
    require_cuda(xq=xq, dtq=dtq, A=A, Bq=Bq, Cq=Cq)
    b, nc, Q, H, P = xq.shape
    if Q > MAX_CHUNK or nc > GRID_YZ_MAX or b > GRID_YZ_MAX:
        raise ValueError(f"xq {tuple(xq.shape)}: the kernel takes chunks of "
                         f"at most {MAX_CHUNK} rows and at most "
                         f"{GRID_YZ_MAX} chunks and batch rows")
    N = Bq.shape[4]
    if (route(xq.dtype, Q, P, N, intra_bf16) not in _CORE
            and any(t.data_ptr() % 16 for t in (xq, Bq, Cq))):
        raise ValueError("xq, Bq and Cq must start on 16-byte boundaries "
                         "(the kernel copies rows in 16-byte pieces)")
    f32 = dict(dtype=torch.float32, device=xq.device)
    outs = (torch.empty((b, nc, Q, H, P), **f32),
            torch.empty((b, nc, H, P, N), **f32),
            torch.empty((b, nc, H), **f32),
            torch.empty((b, nc, Q, H), **f32))
    launch(outs, xq, dtq, A, Bq, Cq, intra_bf16=intra_bf16)
    return outs
