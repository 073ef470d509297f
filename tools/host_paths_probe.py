#!/usr/bin/env python3
"""Probe the host fast paths on this host's CPU: where their time goes.

    python3 tools/host_paths_probe.py [--rows N] [--runs N] [--chunks 1024,8192]

At the deployment's shape (``chip_smoke.py``: 3,240,000 bf16 records of
512 into 216 blobs, keys from the same seed; ``--rows`` cuts the records)
times, each the best of ``--runs`` on the host's clock:

- ``quantize``: the codec's quantizer (``blob_codec.host.quantize_host``)
  at each chunk of rows in ``--chunks``, each chunk's output bit for bit
  the first's, with the minor page faults of one call (the time tracked
  them while each chunk made fresh temporaries);
- ``parts``: the paths' steps as they run them: the sort
  (``sorted_order_np``), the row gather and the code gather on their
  widest integer views (``torch.index_select``), and the block copies
  into a reused arena; beside them the JAX package's numpy moves (fancy
  indexing, slice assignment) on the same views;
- ``paths``: ``blob_pack_fused_host`` and ``compress_pack_fused_host``
  whole, into reused arenas.

Prints one JSON object per line, with the host's cores and torch's
threads. Needs no card.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
RECORDS, WIDTH, PARTITIONS = 3_240_000, 512, 216   # chip_smoke.py's deployment


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def best(fn, runs: int) -> float:
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return min(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=RECORDS)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--chunks", default="512,1024,2048,4096,8192,16384,65536")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.blob_codec import host as codec_host
    from repro_torch.kernels.blob_pack import host as pack_host

    T, d, P = args.rows, WIDTH, PARTITIONS
    gen = torch.Generator().manual_seed(args.seed)
    x = torch.randn((T, d), generator=gen, dtype=torch.bfloat16)
    keys = np.random.default_rng(args.seed).integers(0, P, T, dtype=np.int32)
    cap = int(-(-np.bincount(keys, minlength=P).max() // 128) * 128)
    emit({"probe": "host_paths", "records": T, "width": d, "partitions": P, "capacity": cap,
          "cpu_count": os.cpu_count(), "torch_threads": torch.get_num_threads(),
          "torch": torch.__version__, "numpy": np.__version__, "runs": args.runs})

    want, default = None, codec_host.QUANTIZE_ROWS
    quantize = {}
    for rows in map(int, args.chunks.split(",")):
        codec_host.QUANTIZE_ROWS = rows
        got = codec_host.quantize_host(x)
        if want is None:
            want = got
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise RuntimeError(f"quantize_host at chunks of {rows} rows differs")
        faults = resource.getrusage(resource.RUSAGE_SELF).ru_minflt
        codec_host.quantize_host(x)
        faults = resource.getrusage(resource.RUSAGE_SELF).ru_minflt - faults
        quantize[rows] = {"s": best(lambda: codec_host.quantize_host(x), args.runs),
                          "minor_faults": faults}
    codec_host.QUANTIZE_ROWS = default
    emit({"quantize": quantize})

    order, starts, counts = pack_host.sorted_order_np(keys, P)
    take = np.minimum(counts, cap)
    order_t = torch.from_numpy(order)
    xv, qv = pack_host.widest_view(x), pack_host.widest_view(want[0])
    arena = pack_host.zeros((P, cap, d), x.dtype)
    ov = pack_host.widest_view(arena)
    xs = torch.index_select(xv, 0, order_t)
    xv_np, qv_np, ov_np, xs_np = (t.numpy() for t in (xv, qv, ov, xs))

    def copies_numpy():
        for b in range(P):
            ov_np[b, :take[b]] = xs_np[starts[b]:starts[b] + take[b]]
            ov_np[b, take[b]:] = 0

    parts = {
        "sort": best(lambda: pack_host.sorted_order_np(keys, P), args.runs),
        "gather_rows": best(lambda: torch.index_select(xv, 0, order_t), args.runs),
        "gather_codes": best(lambda: torch.index_select(qv, 0, order_t), args.runs),
        "block_copies": best(lambda: pack_host.block_copies(ov, xs, starts, take, pad=0),
                             args.runs),
        # the JAX package's numpy moves on the same views
        "gather_rows_numpy": best(lambda: xv_np[order], args.runs),
        "gather_codes_numpy": best(lambda: qv_np[order], args.runs),
        "block_copies_numpy": best(copies_numpy, args.runs),
    }
    emit({"parts_s": parts})
    del xs, ov, xs_np, ov_np

    codec_arena = (pack_host.zeros((P, cap, d), torch.int8), torch.ones((P, cap)))
    paths = {
        "blob_pack_fused_host": best(lambda: pack_host.blob_pack_fused_host(
            x, keys, num_bins=P, capacity=cap, out=arena), args.runs),
        "compress_pack_fused_host": best(lambda: codec_host.compress_pack_fused_host(
            x, keys, num_bins=P, capacity=cap, out=codec_arena), args.runs),
    }
    emit({"paths_reused_s": paths, "quantize_rows": codec_host.QUANTIZE_ROWS})
    return 0


if __name__ == "__main__":
    sys.exit(main())
