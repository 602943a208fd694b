"""The exact kNN search in one kernel on the card: K5.

``knn_exact(query, data, k, data_valid)`` returns what ``knn._knn_tiled``
returns (int64 indices and squared distances, ties to the lower data row)
from ``csrc/knn_exact.cu``, which keeps every score in registers and each
query's running top-k in shared memory: no score reaches device memory.
The norms are the same torch reductions as ``_knn_tiled``'s, and the
kernel rounds each score as ``_knn_tiled`` does, with the product an fp32
FMA chain (no TF32). ``query_knn`` takes it for the ``"exact"`` search when
``takes`` says so; ``_knn_tiled`` stays the plain version, and the one
every other case runs.

The kernel gives each CTA 128 queries; when those CTAs fill the card
thinly, it also splits the data rows into ranges, one CTA each, and merges
the ranges' lists in a second kernel (``plan_ranges``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .. import _build
from .topk_cuda import MAX_K

__all__ = ["knn_exact", "takes", "plan_ranges", "MAX_D"]

MAX_D = 128               # widths the kernel's query tile holds
ROWS = 128                # queries a CTA
COLS = 128                # data rows a tile
MAX_SCRATCH_BYTES = 64 << 20
# Extra cost of a range in tiles: its first tiles insert most of their
# scores into an empty list.
_RANGE_START_TILES = 4


def takes(device: torch.device, dtype: torch.dtype, k: int, d: int) -> bool:
    """Whether the exact search runs on K5: on the card, for inputs that
    promote to fp32, k <= 64 and width d <= 128."""
    return (device.type == "cuda" and torch.promote_types(dtype, torch.float32) == torch.float32
            and 1 <= k <= MAX_K and 1 <= d <= MAX_D)


@functools.lru_cache(maxsize=256)
def plan_ranges(nq: int, nd: int, k: int, slots: int) -> Tuple[int, int]:
    """(ranges, tiles a range) for nq queries over nd data rows on a card
    that holds ``slots`` CTAs at once. A CTA's time is about its tiles plus
    a range's start; the search takes waves of ``slots`` CTAs. The plan
    with the fewest (waves x CTA time) wins, the fewest ranges on a tie,
    with the ranges' lists (ranges x nq x k x 8 bytes) within 64 MB."""
    q_blocks = -(-nq // ROWS)
    tiles = -(-nd // COLS)
    best = None
    most = min(tiles, 65535, max(1, -(-16 * slots // q_blocks)))
    for want in range(1, most + 1):
        per = -(-tiles // want)
        ranges = -(-tiles // per)
        if ranges != want:
            continue
        if ranges > 1 and ranges * nq * k * 8 > MAX_SCRATCH_BYTES:
            break
        cost = -(-q_blocks * ranges // slots) * (per + _RANGE_START_TILES)
        if best is None or cost < best[0]:
            best = (cost, ranges, per)
    return best[1], best[2]


def _fns():
    launch = _build.kernel_function(
        "knn_exact", "knn_exact_launch",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 5,
    )
    slots = _build.kernel_function(
        "knn_exact", "knn_exact_slots", [ctypes.c_int] * 3 + [ctypes.c_void_p])
    return launch, slots


@functools.lru_cache(maxsize=64)
def _slots(device_index: int, d: int, k: int, x_mod16: int) -> int:
    """CTAs the card holds at once of the kernel that a launch at width d
    and k over data at an address of ``x_mod16`` modulo 16 runs; the
    launch needs this call on its device first."""
    _, fn = _fns()
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = fn(d, k, x_mod16, ctypes.addressof(out))
    if err != 0 or out.value < 1:
        raise RuntimeError(f"knn_exact_slots failed: cudaError {err}, {out.value} slots")
    return out.value


def _operands(query: torch.Tensor, data: torch.Tensor, data_valid: torch.Tensor):
    """(q, x, |q|^2, |x|^2) as the kernel takes them: fp32 and contiguous,
    x 16-byte aligned where the kernel copies it row by row (d a multiple
    of 32), and the data norms +inf for excluded rows and padded with +inf
    to a whole number of tiles. The norms are _knn_tiled's reductions."""
    q = query.to(torch.float32).contiguous()
    x = data.to(torch.float32).contiguous()
    d, nd = x.shape[1], x.shape[0]
    if d % 32 == 0 and x.data_ptr() % 16:
        x = x.clone()
    qn = (q * q).sum(1)
    dn = torch.full((-(-nd // COLS) * COLS,), float("inf"), device=x.device)
    torch.sum(x * x, 1, out=dn[:nd])
    dn[:nd].masked_fill_(~data_valid, float("inf"))
    return q, x, qn, dn


def knn_exact(query: torch.Tensor, data: torch.Tensor, k: int,
              data_valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(indices (nq, k) int64, squared distances (nq, k) fp32) of the k
    nearest valid rows of ``data`` to each row of ``query``, on the card,
    as ``knn._knn_tiled`` computes them. Needs ``takes(...)`` and at least
    k valid rows (a query short of them gets row 0 at +inf distance)."""
    nq, d = query.shape
    nd = data.shape[0]
    if not takes(query.device, query.dtype, k, d) or data.device != query.device:
        raise ValueError(f"knn_exact takes CUDA tensors that promote to float32, "
                         f"1 <= k <= {MAX_K} and width 1..{MAX_D}; got k={k}, d={d}, "
                         f"{query.dtype} on {query.device}")
    if not 1 <= nd < 2**31 or nq >= 2**31:
        raise ValueError(f"knn_exact takes 1 <= nd and sizes below 2^31, got {nq} x {nd}")
    q, x, qn, dn = _operands(query, data, data_valid)
    idx = torch.empty((nq, k), device=q.device, dtype=torch.long)
    sq = torch.empty((nq, k), device=q.device, dtype=torch.float32)
    if nq == 0:
        return idx, sq
    dev = q.device.index if q.device.index is not None else torch.cuda.current_device()
    ranges, per = plan_ranges(nq, nd, k, _slots(dev, d, k, x.data_ptr() % 16))
    part_s: Optional[torch.Tensor] = None
    part_i: Optional[torch.Tensor] = None
    if ranges > 1:
        part_s = torch.empty((ranges, nq, k), device=q.device, dtype=torch.float32)
        part_i = torch.empty((ranges, nq, k), device=q.device, dtype=torch.int32)
    launch, _ = _fns()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(q.data_ptr(), x.data_ptr(), qn.data_ptr(), dn.data_ptr(), nq, nd, d, k,
                     ranges, per, part_s.data_ptr() if part_s is not None else None,
                     part_i.data_ptr() if part_i is not None else None,
                     idx.data_ptr(), sq.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"knn_exact kernel launch failed: cudaError {err}")
    knn_exact.launches += 1
    return idx, sq


knn_exact.launches = 0
