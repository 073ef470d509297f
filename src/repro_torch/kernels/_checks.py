"""Argument checks shared by the blob ops and their kernel wrappers.

Every check raises ``ValueError`` naming the offending shape, so that a
bad call stops in Python and never reaches a kernel: the kernels index
memory with these tensors and do no bounds checks of their own beyond
the clips the Pallas kernels also make.
"""

from __future__ import annotations

import torch

#: payloads the byte-moving pack/unpack kernels are tested on
PAYLOAD_DTYPES = (torch.float32, torch.bfloat16, torch.int32, torch.int8)
#: record rows the int8 codec quantizes
CODEC_DTYPES = (torch.float32, torch.bfloat16)


def _desc(t: torch.Tensor) -> str:
    return f"shape {tuple(t.shape)}, dtype {t.dtype}, device {t.device}"


def _tensor(name: str, t, ndim: int, dtypes) -> None:
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dim() != ndim or t.dtype not in dtypes:
        raise ValueError(f"{name} must be {ndim}-D with dtype in "
                         f"{[str(d) for d in dtypes]}, got {_desc(t)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous, got {_desc(t)} "
                         f"with strides {t.stride()}")
    if ndim > 1 and t.shape[-1] < 1:
        raise ValueError(f"{name} needs a row width of at least 1, "
                         f"got {_desc(t)}")


def _same_device(**tensors: torch.Tensor) -> None:
    devices = {t.device for t in tensors.values()}
    if len(devices) > 1:
        raise ValueError("tensors lie on different devices: " + ", ".join(
            f"{n} {_desc(t)}" for n, t in tensors.items()))


def _capacity(capacity) -> None:
    if not isinstance(capacity, int) or capacity < 1:
        raise ValueError(f"capacity must be an int >= 1, got {capacity!r}")


def check_keys(keys, num_bins: int) -> None:
    """Destination keys: 1-D integer, every key in ``[0, num_bins)``."""
    _tensor("keys", keys, 1, (torch.int32, torch.int64))
    if not isinstance(num_bins, int) or num_bins < 1:
        raise ValueError(f"num_bins must be an int >= 1, got {num_bins!r}")
    if keys.numel():
        lo, hi = (int(v) for v in torch.aminmax(keys))
        if lo < 0 or hi >= num_bins:
            raise ValueError(f"keys ({_desc(keys)}) must lie in "
                             f"[0, {num_bins}), found [{lo}, {hi}]")


def check_pack(x, order, starts, counts, capacity, dtypes=PAYLOAD_DTYPES
               ) -> None:
    """Rows (T, d) plus the sorted-order triple (order, starts, counts)."""
    _tensor("x", x, 2, dtypes)
    for name, t in (("order", order), ("starts", starts),
                    ("counts", counts)):
        _tensor(name, t, 1, (torch.int32,))
    _same_device(x=x, order=order, starts=starts, counts=counts)
    _capacity(capacity)
    if starts.shape != counts.shape or starts.numel() < 1:
        raise ValueError(f"starts ({_desc(starts)}) and counts "
                         f"({_desc(counts)}) must share one non-empty shape")
    if order.numel() < 1 or x.shape[0] < 1:
        raise ValueError(f"nothing to pack: x {_desc(x)}, order "
                         f"{_desc(order)}")
    lo, hi = (int(v) for v in torch.aminmax(order))
    if lo < 0 or hi >= x.shape[0]:
        raise ValueError(f"order ({_desc(order)}) must index the "
                         f"{x.shape[0]} rows of x, found [{lo}, {hi}]")


def _check_slots(buf_name: str, buf, slot, valid) -> None:
    _tensor("slot", slot, 1, (torch.int32,))
    _tensor("valid", valid, 1, (torch.bool,))
    if slot.shape != valid.shape:
        raise ValueError(f"slot ({_desc(slot)}) and valid ({_desc(valid)}) "
                         f"must have the same shape")
    if buf.shape[0] * buf.shape[1] < 1:
        raise ValueError(f"{buf_name} ({_desc(buf)}) holds no slots")


def check_unpack(buf, slot, valid) -> None:
    """Blob layout (bins, capacity, d) plus (slot, valid) per unit."""
    _tensor("buf", buf, 3, PAYLOAD_DTYPES)
    _check_slots("buf", buf, slot, valid)
    _same_device(buf=buf, slot=slot, valid=valid)


def check_unpack_codes(q, scales, slot, valid) -> None:
    """int8 codes (bins, capacity, d), f32 scales (bins, capacity)."""
    _tensor("q", q, 3, (torch.int8,))
    _tensor("scales", scales, 2, (torch.float32,))
    if scales.shape != q.shape[:2]:
        raise ValueError(f"scales ({_desc(scales)}) must have the leading "
                         f"shape of q ({_desc(q)})")
    _check_slots("q", q, slot, valid)
    _same_device(q=q, scales=scales, slot=slot, valid=valid)


def check_layout(name: str, buf, num_bins: int, capacity: int) -> None:
    """A blob layout read back by keys must have the keys' geometry."""
    if not isinstance(buf, torch.Tensor) or tuple(buf.shape[:2]) != (
            num_bins, capacity):
        shape = tuple(buf.shape) if isinstance(buf, torch.Tensor) else buf
        raise ValueError(f"{name} of shape {shape} is not a layout of "
                         f"{num_bins} bins x capacity {capacity}")


def require_cuda(**tensors: torch.Tensor) -> None:
    """Kernel wrappers take CUDA tensors only; the plain versions serve
    the CPU."""
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"a CUDA kernel needs CUDA tensors; {name} has "
                             f"{_desc(t)}")


# ---------------------------------------------------------------------------
# flash attention and the SSD chunk
# ---------------------------------------------------------------------------

#: head dims the flash kernel takes: multiples of 16 up to 256
FLASH_MAX_HEAD_DIM = 256
#: the grid's y and z extents
GRID_YZ_MAX = 65535


def check_attention(q, k, v, dtypes) -> None:
    """q (B, Sq, H, D); k, v (B, Skv, KVH, D) with H % KVH == 0 and D a
    multiple of 16 in [16, 256]; one dtype, one device."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        _tensor(name, t, 4, dtypes)
    _same_device(q=q, k=k, v=v)
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"q, k and v must share one dtype: q {_desc(q)}, "
                         f"k {_desc(k)}, v {_desc(v)}")
    B, Sq, H, D = q.shape
    if (k.shape != v.shape or k.shape[0] != B or k.shape[3] != D
            or min(B, Sq, k.shape[1]) < 1):
        raise ValueError(f"q {_desc(q)} must be (B, Sq, H, D) and k, v "
                         f"(B, Skv, KVH, D) with B, Sq, Skv >= 1: k "
                         f"{_desc(k)}, v {_desc(v)}")
    KVH = k.shape[2]
    if H % KVH:
        raise ValueError(f"q's {H} heads are not a multiple of k's {KVH} "
                         f"kv heads (q {_desc(q)}, k {_desc(k)})")
    if D % 16 or D > FLASH_MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} must be a multiple of 16 in [16, "
                         f"{FLASH_MAX_HEAD_DIM}] (q {_desc(q)})")


def check_ssd_chunk(xq, dtq, A, Bq, Cq, dtypes) -> None:
    """xq (b, nc, Q, H, P); dtq (b, nc, Q, H) f32; A (H,) f32;
    Bq, Cq (b, nc, Q, G, N) in xq's dtype, with H % G == 0."""
    _tensor("xq", xq, 5, dtypes)
    _tensor("dtq", dtq, 4, (torch.float32,))
    _tensor("A", A, 1, (torch.float32,))
    _tensor("Bq", Bq, 5, (xq.dtype,))
    _tensor("Cq", Cq, 5, (xq.dtype,))
    _same_device(xq=xq, dtq=dtq, A=A, Bq=Bq, Cq=Cq)
    b, nc, Q, H, P = xq.shape
    if min(b, nc, Q, H, P) < 1:
        raise ValueError(f"xq ({_desc(xq)}) has an empty dimension")
    if tuple(dtq.shape) != (b, nc, Q, H) or tuple(A.shape) != (H,):
        raise ValueError(f"dtq ({_desc(dtq)}) must be (b, nc, Q, H) and A "
                         f"({_desc(A)}) (H,) for xq {_desc(xq)}")
    if (Bq.shape != Cq.shape or tuple(Bq.shape[:3]) != (b, nc, Q)
            or Bq.shape[3] < 1 or Bq.shape[4] < 1):
        raise ValueError(f"Bq ({_desc(Bq)}) and Cq ({_desc(Cq)}) must both "
                         f"be (b, nc, Q, G, N) for xq {_desc(xq)}")
    if H % Bq.shape[3]:
        raise ValueError(f"xq's {H} heads are not a multiple of the "
                         f"{Bq.shape[3]} groups of Bq ({_desc(Bq)})")
