#!/usr/bin/env python3
"""Probe the tensor-core SSD chunk kernels on the card: where their time goes.

    python3 tools/ssd_probe.py [--runs N] [--compare NAME=SOURCE ...]

Builds ``src/repro_torch/kernels/csrc/ssd_chunk.cu`` with ``nvcc`` once
for each setting of the kernel's ``SSD_PROBE`` switches (see ``kProbe`` in
the source) into ``build/ssd_probe/``, all builds at once:

- ``kernel``: the kernel as it is;
- ``no_y``: no y_intra;
- ``no_states``: no states;
- ``loads_only``: neither, leaving the loads, the scans and y_decay (and,
  in the bf16-intra mode, the block's score tiles);
- ``no_products``: each m16n8k16 product replaced by one dependent add;
- ``no_weights``: the raw scores split, with no decay weights off the
  diagonal (the f32-intra mode only);
- ``no_x_loads``: no x loads after a block's first two heads;
- ``no_exp``: the bf16-intra decays without ``expf`` (the exponent's
  argument in its place);
- ``no_rounding``: the bf16-intra score chain without its bf16 products
  (the rounded decays alone as the operand);
- ``no_exp_no_rounding``: both;
- ``per_head_s``: the bf16-intra scores computed for each head, where the
  block's score tiles would fit.

Each build's two tensor-core launchers, ``ssd_chunk_fwd_tc`` (f32 intra)
and ``ssd_chunk_fwd_tc_bf16i`` (``ssm.intra_bf16``), are timed with
``chip_smoke.time_ms`` (median of ``--runs``), in two rounds taken in
turns; the CUDA-core kernel ``ssd_chunk_fwd`` is timed on the same
inputs. The inputs are the first SSD chunk call of a Zamba2-2.7B prefill
of 4 x 4,096 tokens (b 4, 16 chunks of 256, 80 heads of 64, N 64, one
group), weights and tokens drawn from seed 0 as ``chip_smoke.py``'s
``zamba2`` phase draws them (its captured inputs). ``kernel`` and the
compared sources must be within
``chip_smoke.SSD_TOL`` of the plain version (the bf16-intra y_intra within
``chip_smoke.INTRA_BF16_TOL``); the others compute something else by
design.

The ``kernel`` build also runs ``ptxas -v``: one line per tensor-core
kernel instance (state width N, mode, score tiles shared or not) gives its
registers a thread, stack frame and spill bytes.

Each ``--compare NAME=SOURCE`` builds another version of the source as it
is (for example an earlier commit's, unpacked with ``git show`` under
``build/``), times it as ``NAME``, and reports the largest difference of
each of its outputs from the ``kernel`` build's on the same inputs, for
each launcher, and whether they are its bits.

Prints one JSON object per line; exits non-zero without a CUDA device or
when a checked build disagrees with the plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "ssd_chunk.cu"
OUT = ROOT / "build" / "ssd_probe"
# name -> SSD_PROBE bits (the switches at kProbe in the source)
VARIANTS = {"kernel": 0, "no_y": 1, "no_states": 2, "loads_only": 3, "no_products": 4,
            "no_weights": 8, "no_x_loads": 16, "no_exp": 32, "no_rounding": 64,
            "no_exp_no_rounding": 96, "per_head_s": 128}
# the launchers each build exports: symbol -> plain version's mode (intra_bf16)
LAUNCHERS = {"ssd_chunk_fwd_tc": False, "ssd_chunk_fwd_tc_bf16i": True}
OUTPUTS = ("y_intra", "states", "a_total", "y_decay")
ROUNDS = 2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def build(compare: dict) -> dict:
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    builds = {name: (SOURCE, [f"-DSSD_PROBE={bits}"]) for name, bits in VARIANTS.items()}
    builds["kernel"][1].extend(["-Xptxas", "-v"])
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
        if name == "kernel":
            emit_ptxas(log)
        dll = ctypes.CDLL(str(lib))
        fns[name] = {}
        for symbol in LAUNCHERS:
            fn = getattr(dll, symbol)
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fns[name][symbol] = fn
    return fns


def emit_ptxas(log: str) -> None:
    """One line per tensor-core kernel instance of ``ptxas -v``'s report,
    and every ptxas warning."""
    entry = None
    for line in log.splitlines():
        if "warning" in line:
            emit({"probe": "ptxas_warning", "line": line.strip()})
        m = re.search(r"Compiling entry function '\w*?ssd_chunk_tc_kernelILi(\d+)ELb([01])E"
                      r"(?:Lb([01])E)?", line)
        if m:
            entry = {"probe": "ptxas", "N": int(m.group(1)), "intra_bf16": m.group(2) == "1"}
            if m.group(3):
                entry["shared_scores"] = m.group(3) == "1"
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


class _Captured(Exception):
    """Stops the prefill once the first SSD chunk call is captured."""


def captured_inputs(seed: int = 0):
    """The first SSD chunk call's (xq, dtq, A, Bq, Cq) of a Zamba2-2.7B
    prefill, drawn as ``chip_smoke.zamba2`` draws its weights and tokens."""
    from chip_smoke import ARCH, PREFILL_BATCH, PREFILL_LEN
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import lm
    from repro_torch.models.common import init_params
    from repro_torch.serving import ServeConfig, make_prefill_step

    cfg = get_config(ARCH)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(lm.LM(cfg, device="cuda"), gen)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN),
                           generator=gen, device="cuda", dtype=torch.int32)
    captured = []
    original = ssd_ops.ssd_chunk_cuda

    def capturing(*args, **kwargs):
        captured.append(tuple(t.clone() for t in args))
        raise _Captured

    ssd_ops.ssd_chunk_cuda = capturing
    try:
        make_prefill_step(cfg, ServeConfig())(params, {"tokens": tokens})
    except _Captured:
        pass
    finally:
        ssd_ops.ssd_chunk_cuda = original
    del params
    torch.cuda.empty_cache()
    return captured[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--compare", action="append", default=[], metavar="NAME=SOURCE",
                    help="another ssd_chunk.cu to build, time and hold against the kernel")
    args = ap.parse_args(argv)
    compare = dict(c.split("=", 1) for c in args.compare)
    if not torch.cuda.is_available():
        print("ssd_probe: no CUDA device; this probe runs on the GPU only", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from chip_smoke import nvidia_smi, same_bits, ssd_worst, ssd_worst_bf16i, time_ms
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan.ref import ssd_chunk_ref

    emit({"probe": "device", "nvidia_smi": nvidia_smi()})
    fns = build(compare)
    xq, dtq, A, Bq, Cq = captured_inputs()
    b, nc, Q, H, P = xq.shape
    G, N = Bq.shape[3], Bq.shape[4]
    emit({"probe": "inputs", "shape": [b, nc, Q, H, P, G, N]})
    f32 = dict(dtype=torch.float32, device="cuda")

    def empty_outs():
        return (torch.empty((b, nc, Q, H, P), **f32), torch.empty((b, nc, H, P, N), **f32),
                torch.empty((b, nc, H), **f32), torch.empty((b, nc, Q, H), **f32))

    outs = empty_outs()
    stream = torch.cuda.current_stream().cuda_stream

    def run(fn, into):
        err = fn(*(t.data_ptr() for t in (xq, dtq, A, Bq, Cq, *into)), b, nc, Q, H, P, G, N,
                 stream)
        if err:
            raise RuntimeError(f"an SSD chunk launcher failed to launch: CUDA error {err}")

    ms = {(name, s): [] for name in fns for s in LAUNCHERS}
    for _ in range(ROUNDS):
        for name, by_symbol in fns.items():
            for symbol, fn in by_symbol.items():
                ms[name, symbol].append(time_ms(lambda: run(fn, outs), args.runs))
    core_ms = time_ms(lambda: ssd_kernel.launch(outs, xq, dtq, A, Bq, Cq,
                                                kernel=ssd_kernel.SSD_CHUNK), args.runs)
    ok = True
    for symbol, intra_bf16 in LAUNCHERS.items():
        want = ssd_chunk_ref(xq, dtq, A, Bq, Cq, intra_bf16=intra_bf16)
        mine = empty_outs()
        run(fns["kernel"][symbol], mine)
        for name, by_symbol in fns.items():
            row = {"probe": name, "launcher": symbol, "ssd_probe": VARIANTS.get(name),
                   "source": compare.get(name), "ms": ms[name, symbol]}
            if name == "kernel" or name in compare:
                got = empty_outs()
                for o in got:
                    o.fill_(float("nan"))
                run(by_symbol[symbol], got)
                torch.cuda.synchronize()
                try:
                    if intra_bf16:
                        row["max_abs_err"], row["tol_ratio"], row["y_intra_rel_max"] = \
                            ssd_worst_bf16i(got, want)
                    else:
                        row["max_abs_err"], row["tol_ratio"] = ssd_worst(got, want)
                    row["ok"] = True
                except (AssertionError, RuntimeError) as e:
                    row["ok"], row["error"] = False, str(e)[:300]
                    ok = False
                if name in compare:
                    row["max_abs_diff_to_kernel"] = {
                        o: float((g - m).abs().max()) for o, g, m in zip(OUTPUTS, got, mine)}
                    row["same_bits_as_kernel"] = {
                        o: same_bits(g, m) for o, g, m in zip(OUTPUTS, got, mine)}
                del got
            emit(row)
        del want, mine
    nbytes = (sum(t.numel() * t.element_size() for t in (xq, dtq, A, Bq, Cq))
              + sum(t.numel() * 4 for t in outs))
    emit({"probe": "cuda_core", "symbol": ssd_kernel.SSD_CHUNK.symbol, "ms": core_ms})
    emit({"probe": "bound", "shape": [b, nc, Q, H, P, G, N], "bytes": nbytes,
          "bytes_bound_ms": nbytes / 3.35e12 * 1e3})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
