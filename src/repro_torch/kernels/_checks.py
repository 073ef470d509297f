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
