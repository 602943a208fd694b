"""ctypes bindings to the host C++ runtime (``libbatchelor.cpp``).

The port's copy of the JAX package's ``native/bindings.py``: the same C
entry points, ctypes argument types and wrappers. The library builds with
g++ at first use into ``batchelor_torch/build/libbatchelor-<hash>.so``; the
hash covers the source, the flags and, for ``-march=native``, the target
g++ resolves it to on this machine, so an edited source is rebuilt and a
build directory shared between machines never loads a library built for
another CPU. A build with ``-march=native`` is tried first, then one
without it; if both fail, the call raises with the compiler's error.
Nothing falls back: each wrapper's numpy counterpart is the ``*_plain``
function beside it, which the tests hold the native one against and
nothing else calls.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from .._build import BUILD

__all__ = [
    "get_lib", "mutual_nn_pairs", "union_find", "csr_densify", "csr_row_sums",
    "csr_select_columns", "csr_lognorm_cosine", "csr_unlog_colsums",
    "csr_gene_stats", "csr_rescale_values",
]

SRC = Path(__file__).resolve().parent / "libbatchelor.cpp"
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")
NATIVE_FLAG = "-march=native"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _native_target() -> str:
    """The target options g++ resolves ``-march=native`` to here."""
    try:
        out = subprocess.run(["g++", NATIVE_FLAG, "-Q", "--help=target"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout


def _library_path(flags) -> Path:
    """The library of ``SRC`` built with ``flags``, named by their hash."""
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(flags).encode())
    if NATIVE_FLAG in flags:
        digest.update(_native_target().encode())
    return BUILD / f"libbatchelor-{digest.hexdigest()[:16]}.so"


def _build() -> Path:
    """The built library: with ``-march=native`` if g++ takes it, else
    without; raises with g++'s output when neither builds."""
    errors = []
    for flags in ((*GXX_FLAGS, NATIVE_FLAG), GXX_FLAGS):
        out = _library_path(flags)
        if out.exists():
            return out
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = ["g++", *flags, str(SRC), "-o", str(tmp)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as exc:
            errors.append(f"{' '.join(cmd)}: {exc}")
            continue
        if proc.returncode == 0:
            os.replace(tmp, out)
            return out
        errors.append(f"{' '.join(cmd)}:\n{proc.stderr}")
    raise RuntimeError("the host runtime libbatchelor.cpp did not build:\n" + "\n".join(errors))


def get_lib() -> ctypes.CDLL:
    """The loaded host runtime, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_build()))
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f32p = ctypes.POINTER(ctypes.c_float)
        f64p = ctypes.POINTER(ctypes.c_double)
        i64 = ctypes.c_int64
        f64 = ctypes.c_double
        lib.bt_version.restype = ctypes.c_int
        lib.bt_version.argtypes = []
        lib.bt_mutual_nn.restype = i64
        lib.bt_mutual_nn.argtypes = [i32p, i64, i64, i32p, i64, i64, i32p, i32p, i64]
        lib.bt_union_find.restype = None
        lib.bt_union_find.argtypes = [i64, i64p, i64, i64p]
        lib.bt_csr_densify.restype = None
        lib.bt_csr_densify.argtypes = [f32p, i32p, i64p, i64, i64, i64, f32p]
        lib.bt_csr_row_sums.restype = None
        lib.bt_csr_row_sums.argtypes = [f32p, i64p, i64, f64p]
        lib.bt_csr_select_columns.restype = i64
        lib.bt_csr_select_columns.argtypes = [f32p, i32p, i64p, i64, i32p, f32p, i32p, i64p]
        lib.bt_csr_lognorm_cosine.restype = None
        lib.bt_csr_lognorm_cosine.argtypes = [f32p, i64p, i64, f32p, f64, ctypes.c_int, f32p]
        lib.bt_csr_unlog_colsums.restype = None
        lib.bt_csr_unlog_colsums.argtypes = [f32p, i32p, i64, i64, f64, f64p]
        lib.bt_csr_rescale.restype = None
        lib.bt_csr_rescale.argtypes = [f32p, i32p, i64, f64p, f64, f32p]
        lib.bt_csr_gene_stats.restype = None
        lib.bt_csr_gene_stats.argtypes = [f32p, i32p, i64p, i64, i64, f32p, f64, f64p, f64p, f64p]
        _lib = lib
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _f32(a):
    return np.ascontiguousarray(a, dtype=np.float32)


def _i32(a):
    return np.ascontiguousarray(a, dtype=np.int32)


def _i64(a):
    return np.ascontiguousarray(a, dtype=np.int64)


def mutual_nn_pairs(l2r: np.ndarray, r2l: np.ndarray):
    """Mutual pair lists from two kNN index matrices (0-based). Returns
    (first, second) ordered by left cell then rank."""
    l2r, r2l = _i32(l2r), _i32(r2l)
    n1, k2 = l2r.shape
    n2, k1 = r2l.shape
    lib = get_lib()
    args = (_ptr(l2r, ctypes.c_int32), n1, k2, _ptr(r2l, ctypes.c_int32), n2, k1)
    total = lib.bt_mutual_nn(*args, None, None, 0)
    first = np.empty(total, dtype=np.int32)
    second = np.empty(total, dtype=np.int32)
    lib.bt_mutual_nn(*args, _ptr(first, ctypes.c_int32), _ptr(second, ctypes.c_int32), total)
    return first.astype(np.int64), second.astype(np.int64)


def mutual_nn_pairs_plain(l2r: np.ndarray, r2l: np.ndarray):
    sets = [set(row.tolist()) for row in np.asarray(r2l)]
    firsts, seconds = [], []
    for i, row in enumerate(np.asarray(l2r)):
        for j in row:
            if i in sets[j]:
                firsts.append(i)
                seconds.append(int(j))
    return np.asarray(firsts, dtype=np.int64), np.asarray(seconds, dtype=np.int64)


def union_find(n: int, edges: np.ndarray) -> np.ndarray:
    """Connected-component labels in first-appearance order."""
    edges = _i64(edges).reshape(-1, 2)
    labels = np.empty(n, dtype=np.int64)
    get_lib().bt_union_find(n, _ptr(edges, ctypes.c_int64), edges.shape[0],
                            _ptr(labels, ctypes.c_int64))
    return labels


def union_find_plain(n: int, edges: np.ndarray) -> np.ndarray:
    from ..correct.cluster_mnn import _union_find

    return _union_find(n, edges)


def csr_densify(data, indices, indptr, row_start, row_end, ncols) -> np.ndarray:
    """Dense row-major block of CSR rows [row_start, row_end)."""
    data, indices, indptr = _f32(data), _i32(indices), _i64(indptr)
    out = np.empty((row_end - row_start, ncols), dtype=np.float32)
    get_lib().bt_csr_densify(
        _ptr(data, ctypes.c_float), _ptr(indices, ctypes.c_int32),
        _ptr(indptr, ctypes.c_int64), row_start, row_end, ncols, _ptr(out, ctypes.c_float),
    )
    return out


def csr_densify_plain(data, indices, indptr, row_start, row_end, ncols) -> np.ndarray:
    out = np.zeros((row_end - row_start, ncols), dtype=np.float32)
    for r in range(row_start, row_end):
        sl = slice(indptr[r], indptr[r + 1])
        out[r - row_start, indices[sl]] = data[sl]
    return out


def csr_row_sums(data, indptr, nrows) -> np.ndarray:
    data, indptr = _f32(data), _i64(indptr)
    out = np.empty(nrows, dtype=np.float64)
    get_lib().bt_csr_row_sums(_ptr(data, ctypes.c_float), _ptr(indptr, ctypes.c_int64), nrows,
                              _ptr(out, ctypes.c_double))
    return out


def csr_row_sums_plain(data, indptr, nrows) -> np.ndarray:
    data, indptr = np.asarray(data), np.asarray(indptr)
    out = np.zeros(nrows, np.float64)
    nz = np.diff(indptr) > 0
    if nz.any():
        out[nz] = np.add.reduceat(data.astype(np.float64), indptr[:-1][nz])
    return out


def csr_select_columns(data, indices, indptr, col_map):
    """CSR with columns remapped/dropped per col_map (new id or -1)."""
    data, indices, indptr, col_map = _f32(data), _i32(indices), _i64(indptr), _i32(col_map)
    nrows = indptr.shape[0] - 1
    lib = get_lib()
    args = (_ptr(data, ctypes.c_float), _ptr(indices, ctypes.c_int32),
            _ptr(indptr, ctypes.c_int64), nrows, _ptr(col_map, ctypes.c_int32))
    nnz = lib.bt_csr_select_columns(*args, None, None, None)
    out_data = np.empty(nnz, dtype=np.float32)
    out_indices = np.empty(nnz, dtype=np.int32)
    out_indptr = np.empty(nrows + 1, dtype=np.int64)
    lib.bt_csr_select_columns(*args, _ptr(out_data, ctypes.c_float),
                              _ptr(out_indices, ctypes.c_int32),
                              _ptr(out_indptr, ctypes.c_int64))
    return out_data, out_indices, out_indptr


def csr_select_columns_plain(data, indices, indptr, col_map):
    data, indices, indptr, col_map = (np.asarray(a) for a in (data, indices, indptr, col_map))
    keep = col_map[indices] >= 0
    rows = np.repeat(np.arange(indptr.shape[0] - 1), np.diff(indptr))
    counts = np.bincount(rows[keep], minlength=indptr.shape[0] - 1)
    out_indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return (data[keep].astype(np.float32), col_map[indices[keep]].astype(np.int32),
            out_indptr)


def csr_lognorm_cosine(data, indptr, sf, log_base, cos_norm) -> np.ndarray:
    """Threaded v -> log(v/sf_row + 1)/log(base) [+ per-row L2 norm] over
    the nnz buffer."""
    data, indptr, sf = _f32(data), _i64(indptr), _f32(sf)
    out = np.empty_like(data)
    get_lib().bt_csr_lognorm_cosine(
        _ptr(data, ctypes.c_float), _ptr(indptr, ctypes.c_int64), indptr.shape[0] - 1,
        _ptr(sf, ctypes.c_float), float(log_base), int(bool(cos_norm)),
        _ptr(out, ctypes.c_float),
    )
    return out


def csr_lognorm_cosine_plain(data, indptr, sf, log_base, cos_norm) -> np.ndarray:
    data, indptr = np.asarray(data), np.asarray(indptr)
    counts = np.diff(indptr)
    row_sf = np.repeat(np.asarray(sf, np.float32).astype(np.float64), counts)
    vals = np.log1p(data.astype(np.float64) / row_sf) / np.log(log_base)
    if cos_norm:
        sq = np.zeros(counts.shape[0], np.float64)
        nz = counts > 0
        if nz.any():
            sq[nz] = np.add.reduceat(vals * vals, indptr[:-1][nz])
        vals = vals / np.repeat(np.maximum(np.sqrt(sq), 1e-8), counts)
    return vals.astype(np.float32)


def csr_unlog_colsums(data, indices, ncols, log_base) -> np.ndarray:
    """Per-gene sums of (base^v - 1) over the nnz buffer (count-space
    column sums of a logged CSR matrix)."""
    data, indices = _f32(data), _i32(indices)
    out = np.empty(ncols, dtype=np.float64)
    get_lib().bt_csr_unlog_colsums(
        _ptr(data, ctypes.c_float), _ptr(indices, ctypes.c_int32), data.shape[0], ncols,
        float(log_base), _ptr(out, ctypes.c_double),
    )
    return out


def csr_unlog_colsums_plain(data, indices, ncols, log_base) -> np.ndarray:
    u = np.expm1(np.asarray(data).astype(np.float64) * np.log(log_base))
    return np.bincount(np.asarray(indices), weights=u, minlength=ncols)


def csr_gene_stats(data, indices, indptr, sf, ncols, log_base):
    """Per-gene (sum of v/sf, sum of log-normalized, sum of squares) over
    the nnz buffer in one threaded O(nnz) pass: the host stage of
    quick_correct_csr's statistics. Returns float64 (avg_sums, log_sums,
    log_sq_sums) of length ncols."""
    data, indices, indptr, sf = _f32(data), _i32(indices), _i64(indptr), _f32(sf)
    avg, s1, s2 = (np.empty(ncols, dtype=np.float64) for _ in range(3))
    get_lib().bt_csr_gene_stats(
        _ptr(data, ctypes.c_float), _ptr(indices, ctypes.c_int32),
        _ptr(indptr, ctypes.c_int64), indptr.shape[0] - 1, ncols,
        _ptr(sf, ctypes.c_float), float(log_base),
        _ptr(avg, ctypes.c_double), _ptr(s1, ctypes.c_double), _ptr(s2, ctypes.c_double),
    )
    return avg, s1, s2


def csr_gene_stats_plain(data, indices, indptr, sf, ncols, log_base):
    indices = np.asarray(indices)
    counts = np.diff(np.asarray(indptr))
    row_sf = np.repeat(np.asarray(sf, np.float32).astype(np.float64), counts)
    norm = np.asarray(data).astype(np.float64) / row_sf
    lg = np.log1p(norm) / np.log(log_base)
    avg = np.bincount(indices, weights=norm, minlength=ncols)
    s1 = np.bincount(indices, weights=lg, minlength=ncols)
    s2 = np.bincount(indices, weights=lg * lg, minlength=ncols)
    return avg, s1, s2


def csr_rescale_values(data, indices, scale, log_base) -> np.ndarray:
    """Threaded v -> log1p((base^v - 1) * scale[gene]) / log(base)."""
    data, indices = _f32(data), _i32(indices)
    scale = np.ascontiguousarray(scale, dtype=np.float64)
    out = np.empty_like(data)
    get_lib().bt_csr_rescale(
        _ptr(data, ctypes.c_float), _ptr(indices, ctypes.c_int32), data.shape[0],
        _ptr(scale, ctypes.c_double), float(log_base), _ptr(out, ctypes.c_float),
    )
    return out


def csr_rescale_values_plain(data, indices, scale, log_base) -> np.ndarray:
    u = np.expm1(np.asarray(data).astype(np.float64) * np.log(log_base))
    scale = np.asarray(scale, np.float64)
    return (np.log1p(u * scale[np.asarray(indices)]) / np.log(log_base)).astype(np.float32)
