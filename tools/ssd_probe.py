#!/usr/bin/env python3
"""Probe the tensor-core SSD chunk kernel on the card: where its time goes.

    python3 tools/ssd_probe.py [--runs N] [--compare NAME=SOURCE ...]

Builds ``src/repro_torch/kernels/csrc/ssd_chunk.cu`` with ``nvcc`` once
for each setting of the kernel's ``SSD_PROBE`` switches (see the source)
into ``build/ssd_probe/``, all builds at once:

- ``kernel``: the kernel as it is;
- ``no_y``: no y_intra;
- ``no_states``: no states;
- ``loads_only``: neither, leaving the loads, the scans and y_decay;
- ``no_products``: each m16n8k16 product replaced by one dependent add;
- ``no_weights``: the raw scores split, with no decay weights off the
  diagonal;
- ``no_x_loads``: no x loads after a block's first two heads.

Each ``--compare NAME=SOURCE`` builds another version of the source as it
is (for example an earlier commit's, unpacked with ``git show``) and times
it as ``NAME``. Every build's ``ssd_chunk_fwd_tc`` is timed with
``chip_smoke.time_ms`` (median of ``--runs``), in two rounds taken in
turns, at Zamba2-2.7B's prefill shape (b 4, 16 chunks of 256, 80 heads of
64, N 64, one group) on inputs made as ``chip_smoke.ssd_inputs`` makes
them; the CUDA-core kernel ``ssd_chunk_fwd`` is timed on the same inputs.
``kernel`` and the compared sources must be within ``chip_smoke.SSD_TOL``
of the plain version; the others compute something else by design.

Prints one JSON object per line; exits non-zero without a CUDA device or
when a checked build disagrees with the plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "ssd_chunk.cu"
OUT = ROOT / "build" / "ssd_probe"
# b, S, H, P, G, N, chunk: Zamba2-2.7B's prefill of 4 x 4,096 tokens
SHAPE = (4, 4096, 80, 64, 1, 64, 256)
# name -> SSD_PROBE bits (the switches at kProbe in the source)
VARIANTS = {"kernel": 0, "no_y": 1, "no_states": 2, "loads_only": 3, "no_products": 4,
            "no_weights": 8, "no_x_loads": 16}
ROUNDS = 2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def build(compare: dict) -> dict:
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    builds = {name: (SOURCE, [f"-DSSD_PROBE={bits}"]) for name, bits in VARIANTS.items()}
    builds.update({name: (Path(src), []) for name, src in compare.items()})
    jobs = {}
    for name, (src, flags) in builds.items():
        lib = OUT / f"{name}.so"
        jobs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name} probe:\n{log}")
        fn = ctypes.CDLL(str(lib)).ssd_chunk_fwd_tc
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--compare", action="append", default=[], metavar="NAME=SOURCE",
                    help="another ssd_chunk.cu to build and time as NAME")
    args = ap.parse_args(argv)
    compare = dict(c.split("=", 1) for c in args.compare)
    if not torch.cuda.is_available():
        print("ssd_probe: no CUDA device; this probe runs on the GPU only", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from chip_smoke import nvidia_smi, ssd_inputs, ssd_worst, time_ms
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan.ref import ssd_chunk_ref

    emit({"probe": "device", "nvidia_smi": nvidia_smi()})
    fns = build(compare)
    b, S, H, P, G, N, Q = SHAPE
    nc = S // Q
    gen = torch.Generator(device="cuda").manual_seed(0)
    x, dt, A, Bm, Cm = ssd_inputs(gen, b, S, H, P, G, N, torch.bfloat16)
    xq, dtq, Bq, Cq = (t.reshape(b, nc, Q, *t.shape[2:]) for t in (x, dt, Bm, Cm))
    f32 = dict(dtype=torch.float32, device="cuda")
    outs = (torch.empty((b, nc, Q, H, P), **f32), torch.empty((b, nc, H, P, N), **f32),
            torch.empty((b, nc, H), **f32), torch.empty((b, nc, Q, H), **f32))
    stream = torch.cuda.current_stream().cuda_stream

    def run(fn):
        err = fn(*(t.data_ptr() for t in (xq, dtq, A, Bq, Cq, *outs)), b, nc, Q, H, P, G, N,
                 stream)
        if err:
            raise RuntimeError(f"ssd_chunk_fwd_tc failed to launch: CUDA error {err}")

    ms = {name: [] for name in fns}
    for _ in range(ROUNDS):
        for name, fn in fns.items():
            ms[name].append(time_ms(lambda: run(fn), args.runs))
    core_ms = time_ms(lambda: ssd_kernel.launch(outs, xq, dtq, A, Bq, Cq,
                                                kernel=ssd_kernel.SSD_CHUNK), args.runs)
    want = ssd_chunk_ref(xq, dtq, A, Bq, Cq)
    ok = True
    for name, fn in fns.items():
        row = {"probe": name, "ssd_probe": VARIANTS.get(name), "source": compare.get(name),
               "ms": ms[name]}
        if name == "kernel" or name in compare:
            for o in outs:
                o.fill_(float("nan"))
            run(fn)
            torch.cuda.synchronize()
            try:
                row["max_abs_err"], row["tol_ratio"] = ssd_worst(outs, want)
                row["ok"] = True
            except (AssertionError, RuntimeError) as e:
                row["ok"], row["error"] = False, str(e)[:300]
                ok = False
        emit(row)
    nbytes = (sum(t.numel() * t.element_size() for t in (xq, dtq, A, Bq, Cq))
              + sum(t.numel() * 4 for t in outs))
    emit({"probe": "cuda_core", "symbol": ssd_kernel.SSD_CHUNK.symbol, "ms": core_ms})
    emit({"probe": "bound", "shape": list(SHAPE), "bytes": nbytes,
          "bytes_bound_ms": nbytes / 3.35e12 * 1e3})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
