#!/usr/bin/env python3
"""Probe the wgmma flash-attention kernel on the card: where its time goes.

    python3 tools/flash_probe.py [--shape zamba2|gemma-2b|deepseek-v2-lite ...]
                                 [--batch B ...] [--runs N]
                                 [--compare NAME=SOURCE ...]

Builds ``src/repro_torch/kernels/csrc/flash_attention.cu`` with ``nvcc``
once for each setting of the kernel's ``FLASH_PROBE`` switches (see the
source) into ``build/flash_probe/``, all builds at once:

- ``kernel``: the kernel as it is;
- ``no_softmax``: the consumers skip the softmax (P is the raw scores);
- ``no_products``: the consumers issue no wgmma;
- ``loads_only``: both, leaving the TMA ring, the barriers and the
  epilogue;
- ``wide_tail``: Q and K tail boxes of 64 columns with the 128-byte
  swizzle, zero-filled past D, as V's are;
- ``loads_wide_tail``: ``loads_only`` with that layout;
- ``loads_v_one_box``: ``loads_only`` loading only V's first 64-column box;
- ``other_order``: the order of work items (at ``block_item`` in the
  source) that the launcher does not pick;
- ``trace``: stamps ``clock64()`` at each step of the consumer loop for
  the first item of block 0.

The ``kernel`` build also runs ``ptxas -v``: one line per kernel instance
(the wgmma kernel has one per head dim and item order) gives its
registers a thread, stack frame and spill bytes, and any ptxas warning is
printed.

Each ``--compare NAME=SOURCE`` builds another version of the source as it
is (for example an earlier commit's, unpacked with ``git show``) and times
it as ``NAME``, with its launcher's arguments (an earlier source's
launcher has no ``q_offset``; this one's is passed 0), and reports whether
its output equals the ``kernel`` build's bit for bit. Every build's ``flash_attention_fwd_wgmma`` is timed with
``chip_smoke.time_ms`` (median of ``--runs``) at the shapes of each
``--shape``, beside ``scaled_dot_product_attention`` on the same inputs:
``zamba2`` (the default) is Zamba2-2.7B's prefill shape (B 4, S 4096, 32
heads of 80, causal), with head dims 64 and 128 and non-causal at 80;
``gemma-2b`` is B 1, S 4096, 8 heads, 1 kv head of 256, causal;
``deepseek-v2-lite`` B 1, S 4096, 16 heads of 192, causal. ``--batch``
times each shape at each batch size given instead of its own. Each row
names the order the launcher picks for the ``kernel`` build
(``kernel_order``) from the bytes of K and V (half of them under the
causal mask) against L2's size. Above
head dim 128 the ``mma.sync`` kernel of the ``kernel`` build is timed as
well. ``kernel``, ``wide_tail``, ``other_order`` and the compared sources
must match the plain version by ``chip_smoke.flash_compare``
(``FLASH_TOL``); the others compute something else by design. The trace
prints, per consumer warpgroup, the median clocks of each step over the
steady kv tiles of a non-causal row at the shape's first head dim.

Prints one JSON object per line; exits non-zero without a CUDA device or
when a checked build disagrees with the plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "flash_attention.cu"
OUT = ROOT / "build" / "flash_probe"
# --shape -> the timed shapes (B, S, H, KVH, D, causal); the first one's
# head dim, non-causal, is traced
SHAPES = {
    "zamba2": [(4, 4096, 32, 32, 80, True), (4, 4096, 32, 32, 64, True),
               (4, 4096, 32, 32, 128, True), (4, 4096, 32, 32, 80, False)],
    "gemma-2b": [(1, 4096, 8, 1, 256, True)],
    "deepseek-v2-lite": [(1, 4096, 16, 16, 192, True)],
}
# name -> FLASH_PROBE bits (the switches at kProbe in the source)
VARIANTS = {"kernel": 0, "no_softmax": 1, "no_products": 2, "loads_only": 3,
            "wide_tail": 8, "loads_wide_tail": 11, "loads_v_one_box": 19,
            "other_order": 32, "trace": 4}
CHECKED = {"kernel", "wide_tail", "other_order"}
# the steps between the trace's stamps 0 -> 1 -> ... -> 7 -> the next tile's 0
STEPS = ["wait_k", "turn", "issue_qk", "rescale_wait_v", "issue_pv_wait_s",
         "softmax", "wait_pv", "pack_to_next"]
TRACE_TILES, TRACE_STAMPS = 40, 8


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def build(variants: dict, compare: dict) -> dict:
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    builds = {name: (SOURCE, [f"-DFLASH_PROBE={bits}"]) for name, bits in variants.items()}
    builds["kernel"][1].extend(["-Xptxas", "-v"])
    builds.update({name: (Path(src), []) for name, src in compare.items()})
    for name, (src, flags) in builds.items():
        lib = OUT / f"{name}.so"
        jobs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name} probe:\n{log}")
        if name == "kernel":
            emit_ptxas(log)
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def emit_ptxas(log: str) -> None:
    """One line per kernel instance of ``ptxas -v``'s report, and every
    ptxas warning."""
    entry = None
    for line in log.splitlines():
        if "warning" in line:
            emit({"probe": "ptxas_warning", "line": line.strip()})
        m = re.search(r"Compiling entry function '\w*?flash_fwd_(\w+?)_kernelILi(\d+)E"
                      r"(?:Lb([01])E)?", line)
        if m:
            entry = {"probe": "ptxas", "kernel": m.group(1), "D": int(m.group(2))}
            if m.group(3):   # the wgmma kernel's item order
                entry["order"] = "balanced" if m.group(3) == "1" else "head-major"
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            entry.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                         spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
            emit(entry)
            entry = None


def launcher(lib, symbol="flash_attention_fwd_wgmma", q_offset=True):
    """The launcher's C function, which takes ``q_offset`` after ``causal``
    unless the build's source predates it."""
    fn = getattr(lib, symbol)
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * (8 if q_offset else 7)
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", choices=sorted(SHAPES), nargs="+", default=["zamba2"])
    ap.add_argument("--batch", type=int, nargs="+",
                    help="batch sizes to time each shape at (default: its own)")
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--compare", action="append", default=[], metavar="NAME=SOURCE",
                    help="another flash_attention.cu to build and time as NAME")
    args = ap.parse_args(argv)
    compare = dict(c.split("=", 1) for c in args.compare)
    no_offset = {n for n, src in compare.items() if "q_offset" not in Path(src).read_text()}
    if not torch.cuda.is_available():
        print("flash_probe: no CUDA device; this probe runs on the GPU only",
              file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from chip_smoke import flash_compare, nvidia_smi, time_ms
    from repro_torch.kernels.flash_attention.ref import flash_ref

    l2_bytes = torch.cuda.get_device_properties(0).L2_cache_size
    emit({"probe": "device", "nvidia_smi": nvidia_smi(), "shape": args.shape,
          "batch": args.batch, "l2_bytes": l2_bytes})
    shapes = [(b, *shape[1:]) for name in args.shape for shape in SHAPES[name]
              for b in (args.batch or [shape[0]])]
    libs = build(VARIANTS, compare)
    checked = CHECKED | set(compare)
    timed = [n for n in [*VARIANTS, *compare] if n != "trace"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream

    def qkv(B, S, H, KVH, D):
        return [torch.randn((B, S, n, D), generator=gen, device="cuda").bfloat16()
                for n in (H, KVH, KVH)]

    ok = True
    for B, S, H, KVH, D, causal in shapes:
        q, k, v = qkv(B, S, H, KVH, D)
        out = torch.empty_like(q)
        want = torch.cat([flash_ref(q[i:i + 1], k[i:i + 1], v[i:i + 1], causal=causal)
                          for i in range(B)])
        flops = 4.0 * B * H * D * (S * (S + 1) / 2 if causal else S * S)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        kv_bytes = 2 * B * KVH * S * D * 2
        read = kv_bytes // 2 if causal else kv_bytes   # the launcher's rule
        row = {"probe": "time", "shape": [B, S, H, KVH, D, causal], "gflop": flops / 1e9,
               "kv_bytes": kv_bytes,
               "kernel_order": "balanced" if read <= l2_bytes else "head-major",
               "sdpa_ms": time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=causal, enable_gqa=True), args.runs)}
        runs = [(n, libs[n], "flash_attention_fwd_wgmma") for n in timed]
        if D > 128:
            runs.append(("mma_sync", libs["kernel"], "flash_attention_fwd_mma"))
        for name, lib, symbol in runs:
            fn = launcher(lib, symbol, q_offset=name not in no_offset)
            offset = () if name in no_offset else (0,)

            def call():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, S,
                         H, KVH, D, int(causal), *offset, 1.0 / math.sqrt(D), stream)
                if err:
                    raise RuntimeError(f"{name} probe: CUDA error {err}")

            row[f"{name}_ms"] = time_ms(call, args.runs)
            if name in checked or name == "mma_sync":
                call()
                got = flash_compare(out, want)
                row[f"{name}_check"] = got
                ok = ok and got["ok"]
                if name == "kernel":
                    kernel_out = out.clone()
                elif name in compare:
                    row[f"{name}_bitwise_vs_kernel"] = torch.equal(out, kernel_out)
        emit(row)
        del q, k, v, out, want, qt, kt, vt
    # the trace: a non-causal row at the first shape's head dim
    B, S, H, KVH, D, _ = shapes[0]
    q, k, v = qkv(B, S, H, KVH, D)
    out = torch.empty_like(q)
    fn = launcher(libs["trace"])
    for _ in range(3):
        fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, S, H, KVH, D, 0, 0,
           1.0 / math.sqrt(D), stream)
    torch.cuda.synchronize()
    n = 2 * TRACE_TILES * TRACE_STAMPS
    buf = (ctypes.c_longlong * n)()
    if libs["trace"].flash_probe_trace_read(buf):
        raise RuntimeError("could not read the probe's trace")
    stamps = [[list(buf[(wg * TRACE_TILES + j) * TRACE_STAMPS:
                        (wg * TRACE_TILES + j + 1) * TRACE_STAMPS])
               for j in range(TRACE_TILES)] for wg in range(2)]
    for wg in range(2):
        steps = {name: [] for name in STEPS + ["tile"]}
        for j in range(2, 30):
            marks = stamps[wg][j] + [stamps[wg][j + 1][0]]
            for name, a, b in zip(STEPS, marks, marks[1:]):
                steps[name].append(b - a)
            steps["tile"].append(marks[-1] - marks[0])
        emit({"probe": "trace", "shape": [B, S, H, KVH, D, False], "warpgroup": wg,
              "median_clocks": {n: statistics.median(x) for n, x in steps.items()}})
    emit({"probe": "done", "ok": ok})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
