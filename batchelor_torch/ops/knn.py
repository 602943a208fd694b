"""Brute-force k-nearest-neighbour search.

Counterpart of ``batchelor_tpu/ops/knn.py``: the replacement for
BiocNeighbors' kNN used by the reference for MNN detection
(R/MNN_tree.R:129) and the tricube neighbour search (R/fastMNN.R:605).

The exact search (``_knn_tiled``) computes the score -|q - x|^2 =
2 q.x - |x|^2 - |q|^2 one (query tile x data tile) block at a time with a
matrix product and keeps a running top-k over [best k | tile scores], so
the full distance matrix never exists. Ties go to the lower data index.
On the card it runs as one kernel, K5 (``knn_exact_cuda.py``), where
``knn_exact_cuda.takes`` allows; ``_knn_tiled`` is its plain version. The
two-pass search (``knn_cuda.py``) serves the large searches.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..device import DeviceLike, as_tensor, full_fp32_matmul, resolve_device
from ..utils.telemetry import get_recorder, trace_span
from . import knn_exact_cuda
from .knn_cuda import query_knn_two_pass
from .topk_cuda import select_topk

__all__ = ["query_knn", "KNNResult", "AUTO_MIN_SCORES"]

_DATA_TILE = 8192
# query rows per tile: the (tile, k + _DATA_TILE) score block is ~0.5 GB in
# fp32 at 16384 rows on the card, and K2 runs once per (query, data) tile
_QUERY_TILE = {"cuda": 16384, "cpu": 1024}

# "auto" takes the two-pass bf16 search on the card above this many scores
# (N_q * N_d). tools/knn_crossover.py measured the crossover with the exact
# tiled search on an H100 at about 1.0e8 scores (see PERF.md).
AUTO_MIN_SCORES = 1 << 27


class KNNResult(tuple):
    """(indices, distances) pair; distances are Euclidean unless the search
    asked for squared ones, and None when it asked for indices only."""

    __slots__ = ()

    def __new__(cls, indices, distances):
        return tuple.__new__(cls, (indices, distances))

    @property
    def indices(self):
        return self[0]

    @property
    def distances(self):
        return self[1]


def _knn_tiled(query: torch.Tensor, data: torch.Tensor, k: int,
               data_valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN: tiled scores with a running top-k merge.

    Accumulates in promote(dtype, float32), so fp64 stays fp64. Returns
    (indices (nq, k) int64, squared distances), neighbours by ascending
    distance, ties to the lower data index."""
    acc = torch.promote_types(query.dtype, torch.float32)
    q = query.to(acc)
    x = data.to(acc)
    nq, nd = q.shape[0], x.shape[0]
    qn = (q * q).sum(1, keepdim=True)
    dn = (x * x).sum(1)
    qtile = _QUERY_TILE["cuda" if q.device.type == "cuda" else "cpu"]
    out_i, out_s = [], []
    with full_fp32_matmul():
        for q0 in range(0, nq, qtile):
            qt, qnt = q[q0:q0 + qtile], qn[q0:q0 + qtile]
            best_s = torch.full((qt.shape[0], k), float("-inf"), device=q.device, dtype=acc)
            best_i = torch.zeros((qt.shape[0], k), device=q.device, dtype=torch.long)
            for base in range(0, nd, _DATA_TILE):
                xt = x[base:base + _DATA_TILE]
                score = 2.0 * (qt @ xt.T) - dn[None, base:base + xt.shape[0]] - qnt
                score.masked_fill_(~data_valid[None, base:base + xt.shape[0]], float("-inf"))
                top_s, pos = select_topk(torch.cat([best_s, score], 1), k)
                pos = pos.long()
                from_best = best_i.gather(1, pos.clamp(max=k - 1))
                best_i = torch.where(pos < k, from_best, base + pos - k)
                best_s = top_s
            out_i.append(best_i)
            out_s.append(best_s)
    return torch.cat(out_i), torch.clamp(-torch.cat(out_s), min=0.0)


def _count_search(rec, path: str, nq: int, nd: int, n_valid, d: int, k: int) -> None:
    """One search's counters under ``knn/<path>/``: its brute-force scores
    (queries x valid data rows, whatever the path prunes), their 2 d flops,
    and its bytes: both point sets read once in fp32, k int64 indices and k
    fp32 distances written a query."""
    scores = nq * n_valid
    rec.add(f"knn/{path}/searches")
    rec.add(f"knn/{path}/scores", scores)
    rec.add(f"knn/{path}/flops", 2 * d * scores)
    rec.add(f"knn/{path}/bytes", (nq + nd) * d * 4 + nq * k * 12)


def query_knn(
    query,
    data,
    k: int,
    *,
    n_data_valid: Optional[int] = None,
    data_mask=None,
    squared: bool = False,
    method: str = "exact",
    exact_selection: bool = False,
    indices_only: bool = False,
    max_bytes: Optional[int] = None,
    device: DeviceLike = None,
) -> KNNResult:
    """For each row of ``query``, the ``k`` nearest rows of ``data``.

    Methods, as in the reference's ``query_knn``:
      * "exact": the tiled search (index-stable ties), on the card kernel
        K5 for fp32 with k <= 64 and width <= 128;
      * "chunked": the two-pass search with fp32 selection (kernels K1, K2),
        exact up to ties; ``exact_selection`` uses the 6-product split;
      * "bf16": the two-pass search with bf16 selection (distances exact fp32);
      * "approx": no approximate top-k exists here; it is an alias of "exact";
      * "auto": "bf16" on the card for fp32 inputs with N_q * N_d above
        AUTO_MIN_SCORES and N_d >= 256 k, else "exact" (always on the CPU).
    ``n_data_valid`` or ``data_mask`` exclude data rows; ``k`` must not
    exceed the valid count. ``max_bytes`` bounds the two-pass buffers.
    Indices are int64; distances are Euclidean, squared with ``squared``,
    None with ``indices_only``. The search runs in a ``knn/exact`` or
    ``knn/two_pass`` span and, under a recorder, adds to that path's
    counters (``_count_search``), and to ``knn/exact/fused`` when K5 runs it.
    """
    if k <= 0:
        raise ValueError("k must be positive")
    dev = resolve_device(device)
    query = as_tensor(query, dev)
    data = as_tensor(data, dev)
    nq, nd = query.shape[0], data.shape[0]
    if data_mask is not None:
        valid = as_tensor(data_mask, dev, torch.bool)
    elif n_data_valid is not None:
        valid = torch.arange(nd, device=dev) < n_data_valid
    else:
        valid = torch.ones(nd, device=dev, dtype=torch.bool)
    fp32 = torch.promote_types(query.dtype, torch.float32) == torch.float32
    if method == "auto":
        big = nq * nd > AUTO_MIN_SCORES and nd >= 256 * k
        method = "bf16" if big and fp32 and dev.type == "cuda" else "exact"
    if method == "approx":
        method = "exact"
    if method not in ("exact", "chunked", "bf16"):
        raise ValueError(f"unknown kNN method {method!r}")
    path = "exact" if method == "exact" else "two_pass"
    fused = path == "exact" and knn_exact_cuda.takes(dev, query.dtype, k, query.shape[1])
    rec = get_recorder()
    if rec is not None:
        if data_mask is not None:
            n_valid = valid.sum()                    # read when the recorder sums up
        else:
            n_valid = nd if n_data_valid is None else min(int(n_data_valid), nd)
        _count_search(rec, path, nq, nd, n_valid, query.shape[1], k)
        if fused:
            rec.add("knn/exact/fused")
    with trace_span(f"knn/{path}", mode=method, nq=nq, nd=nd):
        if path == "two_pass":
            idx, sq = query_knn_two_pass(
                query, data, k, valid, bf16=method == "bf16",
                six_pass=exact_selection and method == "chunked",
                with_scores=not indices_only, max_bytes=max_bytes,
            )
        elif fused:
            idx, sq = knn_exact_cuda.knn_exact(query, data, k, valid)
        else:
            idx, sq = _knn_tiled(query, data, k, valid)
    if indices_only:
        return KNNResult(idx, None)
    return KNNResult(idx, sq if squared else torch.sqrt(sq))
