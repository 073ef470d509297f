#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

1. Prints the card's name and power limit as ``nvidia-smi`` gives them.
2. Builds the Hopper kernels from ``src/repro_torch/kernels/csrc`` with
   ``nvcc`` (into ``build/repro_torch_kernels/``) and holds each kernel
   against its plain PyTorch version on the card, bit for bit, over
   payload dtypes, overflow, empty bins, ragged tiles and two
   rows-per-block values.
3. Runs the deployment round trip through the port's public entry points
   (``repro_torch.shuffle.api``): one second of the paper's offered load,
   3,240,000 records of 1 KiB (512 bf16) over 216 partitions
   (``SimConfig``: 12 nodes x 2 instances x partitions_factor 9), packed
   into blobs and read back, plain and int8-compressed. Capacity is the
   largest partition rounded up to 128, so no record is dropped; the
   plain round trip must return every record bit for bit, the codec
   round trip must equal its plain version bit for bit and lie within
   half a quantization step of each record.
4. Prints one ``kernels`` line: per kernel its launches in that round
   trip, its median time over 20 runs with CUDA events, its bytes and the
   bound they set at 3.35 TB/s, the plain version's time and a
   ``torch.index_select`` gather over the same rows as yardstick.
5. Ends with ``{"ok": true, "device": {...}}``.

Every check raises, so any failure exits non-zero. Without a CUDA device
the script exits non-zero before it prints any result.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

RECORDS = 3_240_000           # 3.16 GiB/s of 1 KiB records, for one second
WIDTH = 512                   # 1 KiB records as bf16 rows
PARTITIONS = 216              # 12 nodes x 2 instances x partitions_factor 9
CAPACITY_ROUND = 128

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_OPS_PER_S = 67e12         # H100 SXM, f32 outside the tensor cores
TIMED_RUNS = 20


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bytes as integers of its element size."""
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32}[t.element_size()])


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(bits(a), bits(b))


def max_abs_diff(a: torch.Tensor, b: torch.Tensor, rows: int = 1 << 18) -> float:
    """max |a - b| in f32, a chunk of rows at a time to bound memory."""
    a2, b2 = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    worst = 0.0
    for i in range(0, a2.shape[0], rows):
        d = (a2[i:i + rows].float() - b2[i:i + rows].float()).abs().max()
        worst = max(worst, float(d))
    return worst


def time_ms(fn, runs: int, warmup: int = 2) -> float:
    """Median device time of ``fn`` over ``runs`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def random_rows(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    if dtype in (torch.int32, torch.int8):
        hi = 100 if dtype == torch.int8 else 1 << 30
        return torch.randint(-hi, hi, shape, generator=gen, device="cuda", dtype=dtype)
    x = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32)
    if shape[0] > 8:
        x[0] = 0.0                       # all-zero row: scale 1.0
        x[1, 1:] = 0.0                   # one live element
        x[2] *= 1e30                     # huge
        x[3] *= 1e-40                    # subnormal
    return x.to(dtype)


# (dtype, rows T, width d, bins, capacity, key range): float32/bf16/int32/
# int8 payloads with 16-byte accesses; 7- and 6-byte rows for the narrow
# paths; an overflowing capacity; a capacity of 37 that neither
# rows-per-block value divides, with keys in half the bins (empty bins).
PACK_CASES = [
    (torch.float32, 5000, 96, 12, 512, 12),
    (torch.bfloat16, 5000, 96, 12, 512, 12),
    (torch.int32, 5000, 96, 12, 512, 12),
    (torch.int8, 5000, 96, 12, 512, 12),
    (torch.int8, 5000, 7, 12, 512, 12),
    (torch.bfloat16, 5000, 3, 12, 512, 12),
    (torch.float32, 5000, 96, 12, 100, 12),
    (torch.bfloat16, 999, 20, 24, 37, 12),
]
CODEC_CASES = [
    (torch.float32, 5000, 96, 12, 512, 12),
    (torch.bfloat16, 5000, 96, 12, 512, 12),
    (torch.bfloat16, 5000, 20, 12, 512, 12),
    (torch.float32, 5000, 7, 12, 512, 12),
    (torch.bfloat16, 5000, 96, 12, 100, 12),
    (torch.float32, 999, 20, 24, 37, 12),
]


def kernel_phases(seed: int, rows_per_block) -> None:
    from repro_torch.kernels.blob_codec.kernel import (
        compress_pack_fused_cuda, unpack_decompress_fused_cuda)
    from repro_torch.kernels.blob_codec.ref import (compress_pack_ref,
                                                    unpack_decompress_ref)
    from repro_torch.kernels.blob_pack.kernel import blob_pack_fused_cuda
    from repro_torch.kernels.blob_pack.ref import blob_pack_ref
    from repro_torch.kernels.blob_unpack.kernel import blob_unpack_fused_cuda
    from repro_torch.kernels.blob_unpack.ref import blob_unpack_ref
    from repro_torch.shuffle.binning import bin_pack, sorted_order

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def layout_inputs(T, bins, cap, key_range):
        keys = torch.randint(0, key_range, (T,), generator=gen, device="cuda",
                             dtype=torch.int32)
        order, starts, counts = sorted_order(keys, bins)
        pack = bin_pack(keys, bins, cap)
        # random slots, some out of range on both sides: the clip is checked
        R = bins * cap
        slot = torch.randint(-5, R + 5, (T,), generator=gen, device="cuda",
                             dtype=torch.int32)
        valid = torch.rand((T,), generator=gen, device="cuda") < 0.8
        return (order, starts, counts), [(pack.slot, pack.valid), (slot, valid)]

    n = {"pack": 0, "unpack": 0, "compress_pack": 0, "unpack_decompress": 0}
    for dtype, T, d, bins, cap, key_range in PACK_CASES:
        x = random_rows(gen, (T, d), dtype)
        (order, starts, counts), slots = layout_inputs(T, bins, cap, key_range)
        want = blob_pack_ref(x, order, starts, counts, capacity=cap)
        for rpb in rows_per_block:
            got = blob_pack_fused_cuda(x, order, starts, counts, capacity=cap,
                                       rows_per_block=rpb)
            check(same_bits(got, want), f"pack {dtype} T={T} d={d} cap={cap} rpb={rpb}")
            n["pack"] += 1
            for slot, valid in slots:
                got_u = blob_unpack_fused_cuda(got, slot, valid, rows_per_block=rpb)
                check(same_bits(got_u, blob_unpack_ref(want, slot, valid)),
                      f"unpack {dtype} d={d} cap={cap} rpb={rpb}")
                n["unpack"] += 1
    for dtype, T, d, bins, cap, key_range in CODEC_CASES:
        x = random_rows(gen, (T, d), dtype)
        (order, starts, counts), slots = layout_inputs(T, bins, cap, key_range)
        q_want, s_want = compress_pack_ref(x, order, starts, counts, capacity=cap)
        for rpb in rows_per_block:
            q, s = compress_pack_fused_cuda(x, order, starts, counts, capacity=cap,
                                            rows_per_block=rpb)
            check(same_bits(q, q_want) and same_bits(s, s_want),
                  f"compress_pack {dtype} d={d} cap={cap} rpb={rpb}")
            n["compress_pack"] += 1
            for slot, valid in slots:
                got = unpack_decompress_fused_cuda(q, s, slot, valid, rows_per_block=rpb)
                want = unpack_decompress_ref(q, s, slot, valid)
                check(same_bits(got, want), f"unpack_decompress d={d} cap={cap} rpb={rpb}")
                n["unpack_decompress"] += 1
    torch.cuda.synchronize()
    emit({"phase": "kernel_checks", "tolerance": "bitwise",
          "rows_per_block": list(rows_per_block), "cases": n, "ok": True})


def deployment(seed: int) -> dict:
    """The round trip at the paper's deployment size; returns the kernels
    line."""
    from repro_torch.kernels.blob_codec import kernel as codec_kernel
    from repro_torch.kernels.blob_codec.ref import (compress_pack_ref,
                                                    unpack_decompress_ref)
    from repro_torch.kernels.blob_pack import kernel as pack_kernel
    from repro_torch.kernels.blob_pack.ref import blob_pack_ref
    from repro_torch.kernels.blob_unpack import kernel as unpack_kernel
    from repro_torch.kernels.blob_unpack.ref import blob_unpack_ref
    from repro_torch.shuffle import api
    from repro_torch.shuffle.binning import bin_pack, dropped_units

    T, d, P = RECORDS, WIDTH, PARTITIONS
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((T, d), generator=gen, device="cuda", dtype=torch.bfloat16)
    keys_np = np.random.default_rng(seed).integers(0, P, T, dtype=np.int32)
    keys = torch.from_numpy(keys_np).cuda()
    cap = int(-(-np.bincount(keys_np, minlength=P).max() // CAPACITY_ROUND)
              * CAPACITY_ROUND)

    kernels = {
        "pack": pack_kernel.PACK,
        "unpack": unpack_kernel.UNPACK,
        "compress_pack": codec_kernel.COMPRESS_PACK,
        "unpack_decompress": codec_kernel.UNPACK_DECOMPRESS,
    }
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    buf, (order, starts, counts) = api.blob_pack_fused(x, keys, num_bins=P, capacity=cap)
    back = api.unpack_from_keys(buf, keys, num_bins=P, capacity=cap)
    (q, scales), _ = api.compress_pack_fused(x, keys, num_bins=P, capacity=cap)
    deq = api.unpack_decompress_fused(q, scales, keys, num_bins=P, capacity=cap)
    torch.cuda.synchronize()
    round_trip_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    check(all(n >= 1 for n in launches.values()), f"every kernel launched: {launches}")

    pack = bin_pack(keys, P, cap)
    slot, valid = pack.slot, pack.valid
    dropped = int(dropped_units(pack, cap))
    check(dropped == 0, f"no record dropped (dropped {dropped})")
    check(same_bits(back, x), "unpack_from_keys(blob_pack_fused(x)) == x bit for bit")

    # each kernel against its plain version at the main path's shapes
    err = {}
    want = blob_pack_ref(x, order, starts, counts, capacity=cap)
    check(same_bits(buf, want), "pack == blob_pack_ref")
    err["pack"] = max_abs_diff(buf, want)
    del want
    want = blob_unpack_ref(buf, slot, valid)
    check(same_bits(back, want), "unpack == blob_unpack_ref")
    err["unpack"] = max_abs_diff(back, want)
    del want
    q_want, s_want = compress_pack_ref(x, order, starts, counts, capacity=cap)
    check(same_bits(q, q_want) and same_bits(scales, s_want),
          "compress_pack == compress_pack_ref")
    err["compress_pack"] = max(max_abs_diff(q, q_want),
                               max_abs_diff(scales[..., None], s_want[..., None]))
    del q_want, s_want
    want = unpack_decompress_ref(q, scales, slot, valid)
    check(same_bits(deq, want), "unpack_decompress == unpack_decompress_ref")
    err["unpack_decompress"] = max_abs_diff(deq, want)
    del want

    # the codec round trip lies within half a step (plus f32 rounding of
    # the divide and the multiply, < 2**-16 of a step) of every record
    row_scale = scales.reshape(-1)[slot.long()]
    worst_steps = 0.0
    for i in range(0, T, 1 << 18):
        e = (deq[i:i + (1 << 18)] - x[i:i + (1 << 18)].float()).abs()
        e = e / row_scale[i:i + (1 << 18), None]
        worst_steps = max(worst_steps, float(e.max()))
    check(worst_steps <= 0.5 + 2.0 ** -16,
          f"codec error within scale/2 (worst {worst_steps} steps)")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    emit({"phase": "deployment_round_trip", "records": T, "width": d, "dtype": "bfloat16",
          "record_bytes": d * 2, "partitions": P, "capacity": cap, "dropped": dropped,
          "round_trip_bit_exact": True, "codec_bitwise_vs_plain": True,
          "codec_worst_error_in_steps": worst_steps, "launches": launches,
          "round_trip_s": round_trip_s, "peak_memory_gb": peak_gb, "ok": True})

    # timing, at the main path's shapes, launching into its outputs
    live = int(torch.clamp(counts, max=cap).sum())
    n_valid = int(valid.sum())
    row_bytes = d * x.element_size()
    pos = starts[:, None] + torch.arange(cap, device="cuda", dtype=torch.int32)
    tok = order[torch.clamp(pos, 0, T - 1)].reshape(-1)
    flat_buf, flat_q = buf.reshape(-1, d), q.reshape(-1, d)
    rows_ops = live * d * 6          # abs, max, divide, round, two clamps
    work = {
        "pack": dict(
            kernel=lambda: pack_kernel.launch(buf, x, order, starts, counts),
            plain=lambda: blob_pack_ref(x, order, starts, counts, capacity=cap),
            library=lambda: torch.index_select(x, 0, tok),
            bytes=live * row_bytes + buf.numel() * 2 + 4 * (T + 2 * P), ops=0,
            replaces="src/repro/kernels/blob_pack/kernel.py:95"),
        "unpack": dict(
            kernel=lambda: unpack_kernel.launch(back, buf, slot, valid),
            plain=lambda: blob_unpack_ref(buf, slot, valid),
            library=lambda: torch.index_select(flat_buf, 0, slot),
            bytes=n_valid * row_bytes + T * row_bytes + 5 * T, ops=0,
            replaces="src/repro/kernels/blob_unpack/kernel.py:79"),
        "compress_pack": dict(
            kernel=lambda: codec_kernel.launch_compress_pack(q, scales, x, order, starts,
                                                             counts),
            plain=lambda: compress_pack_ref(x, order, starts, counts, capacity=cap),
            library=lambda: torch.index_select(x, 0, tok),
            bytes=live * row_bytes + q.numel() + 4 * scales.numel() + 4 * (T + 2 * P),
            ops=rows_ops, replaces="src/repro/kernels/blob_codec/kernel.py:57"),
        "unpack_decompress": dict(
            kernel=lambda: codec_kernel.launch_unpack_decompress(deq, q, scales, slot,
                                                                 valid),
            plain=lambda: unpack_decompress_ref(q, scales, slot, valid),
            library=lambda: torch.index_select(flat_q, 0, slot),
            bytes=n_valid * (d + 4) + 5 * T + 4 * T * d, ops=n_valid * d,
            replaces="src/repro/kernels/blob_codec/kernel.py:107"),
    }
    rows = []
    for name, w in work.items():
        ms = time_ms(w["kernel"], TIMED_RUNS)
        plain_ms = time_ms(w["plain"], 10, warmup=1)
        library_ms = time_ms(w["library"], 10)
        byte_ms = w["bytes"] / HBM_BYTES_PER_S * 1e3
        op_ms = w["ops"] / F32_OPS_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/blob_kernels.cu",
            "replaces": w["replaces"], "launches": launches[name],
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "library_ms": library_ms, "library_call": "torch.index_select",
            "bytes": w["bytes"], "ops": w["ops"],
            "gb_s": w["bytes"] / ms / 1e6,
        })
    # the timed launches rewrote the outputs; they must still be right
    torch.cuda.synchronize()
    check(same_bits(back, x), "outputs unchanged by the timed launches")
    return {"kernels": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs on the GPU only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.blob_pack.kernel import ROWS_PER_BLOCK

    smi = nvidia_smi()
    print(smi, flush=True)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind, "count": count,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    libraries = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "flags": list(_build.NVCC_FLAGS),
          "libraries": [str(p.relative_to(ROOT)) for p in libraries.values()]})

    kernel_phases(args.seed, (ROWS_PER_BLOCK, 128))
    emit(deployment(args.seed))
    torch.cuda.synchronize()
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
