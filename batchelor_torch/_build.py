"""Build the CUDA kernels in ``csrc/`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own with
``nvcc`` into ``build/lib<name>-<hash>.so`` beside this file; the hash covers
the source, the shared headers ``csrc/*.cuh`` and the flags, so an edited
source or header is rebuilt. No PyTorch headers are compiled, which keeps a
build at seconds. A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Iterable, Optional

__all__ = ["build", "kernel_function", "KERNELS"]

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
KERNELS = ("chunk_max", "topk_rows", "rescore_chunks", "pass1_norm", "knn_exact",
           "trend_smooth")

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels need the CUDA toolkit "
            "(set CUDA_HOME or put nvcc on PATH)"
        )
    return found


def _library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source, of
    every header in ``csrc/`` (which it may include) and of the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> float:
    """Compile the named kernels (default: all) that are not built yet, one
    ``nvcc`` per source, all started together. Returns the seconds taken."""
    t0 = time.perf_counter()
    todo = [n for n in (names or KERNELS) if not _library_path(n).exists()]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    BUILD.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in todo:
        out = _library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, out))
    errors = []
    for name, proc, tmp, out in jobs:       # wait for every nvcc, then report
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for csrc/{name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def kernel_function(name: str, symbol: str, argtypes):
    """The C function ``symbol`` of kernel library ``name``, built and loaded
    on first use, with its ctypes signature set (returns a cudaError_t)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_library_path(name)))
            _libs[name] = lib
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn
