"""Build the CUDA sources under ``csrc/`` and bind their launchers.

Each ``csrc/<name>.cu`` is compiled at first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, and loaded
with ``ctypes``. Nothing here includes PyTorch's headers, so a build
takes seconds. The library's file name carries a hash of the source and
the flags, so an edited source is never served from a stale build. The
build goes to ``build/repro_torch_kernels/`` at the root of the checkout
(listed in ``.gitignore``). Any build or launch error raises.

Nothing is built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

#: IEEE division and rounding are part of the codec's contract, so the
#: flags never include --use_fast_math.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libraries: dict = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                           "the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    source = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names=None) -> "dict[str, Path]":
    """Compile every named source (default: all of ``csrc/*.cu``) that has
    no current build, one ``nvcc`` per source, all started together.
    Each library is written under a temporary name and renamed into
    place, so concurrent builders never load a partial file."""
    names = sorted(p.stem for p in CSRC.glob("*.cu")) if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    todo = [(n, p) for n, p in paths.items() if not p.exists()]
    compiler = nvcc() if todo else None
    jobs = []
    for name, path in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen([compiler, *NVCC_FLAGS, "-o", tmp,
                                 str(CSRC / f"{name}.cu")],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, path, tmp, proc))
    failures = []
    for name, path, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, path)
        else:
            os.unlink(tmp)
            failures.append(f"nvcc failed on {name}.cu "
                            f"(exit {proc.returncode}):\n{log}")
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    lib = _libraries.get(name)
    if lib is None:
        lib = _libraries[name] = ctypes.CDLL(str(build([name])[name]))
    return lib


class Kernel:
    """One ``extern "C"`` launcher of ``csrc/<source>.cu`` and its count
    of launches. ``argtypes`` lists the launcher's arguments before the
    trailing stream; every pointer is ``c_void_p``."""

    def __init__(self, source: str, symbol: str, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def __call__(self, device: torch.device, *args) -> None:
        if self._fn is None:
            fn = getattr(load(self.source), self.symbol)
            fn.argtypes = [*self.argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = self._fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.symbol} failed to launch: CUDA error "
                               f"{err}")
        self.launches += 1


P = ctypes.c_void_p
I64 = ctypes.c_longlong
I32 = ctypes.c_int
F32 = ctypes.c_float
