"""fastMNN correction math: averaging, orthogonalization, tricube apply.

Counterpart of ``batchelor_tpu/ops/correction.py``: the reference's
correction helpers (R/fastMNN.R:567-658) and tricube kernel
(R/utils_tricube.R:1-27). Functions take cells-in-rows tensors and run on
their device; pair lists are 0-based host arrays, or tensors on that
device where the fastMNN engine keeps them there.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import as_tensor, full_fp32_matmul
from ..utils.telemetry import trace_span
from .knn import query_knn

__all__ = [
    "average_correction",
    "batch_magnitude",
    "batch_var",
    "center_along_batch_vector",
    "orthogonalize_other",
    "pair_segment_sums",
    "per_batch_var",
    "tricube_average",
    "tricube_weights",
    "tricube_weighted_correction",
]


def tricube_weights(dist: torch.Tensor, ndist: float = 3.0) -> torch.Tensor:
    """Row-normalized tricube weights from ascending neighbour distances.

    Bandwidth = ndist x the middle (ceiling(n/2)-th) neighbour distance,
    floored at 1e-8; relative distances clamp to 1 so farther neighbours get
    zero weight (reference R/utils_tricube.R:1-27). +inf distances get
    weight zero and the middle index shrinks to the finite count
    (R/fastMNN.R:599-608 via min(k, nrow(data)))."""
    finite = torch.isfinite(dist)
    nv = finite.sum(1)
    middle = torch.clamp(-(-nv // 2) - 1, min=0)     # 0-based ceil(nv/2)
    bw = torch.clamp(dist.gather(1, middle[:, None])[:, 0] * ndist, min=1e-8)
    rel = torch.clamp(dist / bw[:, None], max=1.0)
    tri = torch.where(finite, (1.0 - rel ** 3) ** 3, torch.zeros((), dtype=dist.dtype, device=dist.device))
    denom = tri.sum(1, keepdim=True)
    return tri / torch.clamp(denom, min=torch.finfo(tri.dtype).tiny)


def pair_segment_sums(l_rows: torch.Tensor, l2r: torch.Tensor, mutual: torch.Tensor,
                      n_segments: int, *, lo: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of paired left rows, pair count) per right-cell segment.

    For each mutual pair (i, j = l2r[i, p]) adds l_rows[i] to segment j and
    1 to its count, one neighbour position p at a time, so no (N1, k2, d)
    tensor exists. Each position's sums go into fresh zeros that are then
    added to the running sums, in the JAX function's order. ``lo``: only
    l2r values in [lo, lo + n_segments) contribute, shifted by -lo (the
    windowed form of a ring reduce-scatter); the rest go to a trash row
    ``n_segments``. A candidate in the window that is not a pair adds
    zeros to its own segment, which leaves every sum as it was, rather than
    to the trash row, whose atomic adds on the card would all contend for
    one row. Returns (lsums (n_segments, d), counts (n_segments,)), without
    reading anything back to the host."""
    dt = l_rows.dtype
    dev = l_rows.device
    shape = (n_segments + 1, l_rows.shape[1])
    lsums = torch.zeros(shape, device=dev, dtype=dt)
    counts = torch.zeros(n_segments + 1, device=dev, dtype=dt)
    for p in range(l2r.shape[1]):
        col = l2r[:, p]
        window = (col >= lo) & (col < lo + n_segments)
        seg = torch.where(window, col - lo, n_segments).long()
        w = (mutual[:, p] & window).to(dt)
        lsums = lsums + torch.zeros(shape, device=dev, dtype=dt).index_add_(
            0, seg, l_rows * w[:, None])
        counts = counts + torch.zeros(n_segments + 1, device=dev, dtype=dt).index_add_(0, seg, w)
    return lsums[:n_segments], counts[:n_segments]


def average_correction(
    refdata: torch.Tensor,
    mnn1,
    curdata: torch.Tensor,
    mnn2,
) -> Tuple[torch.Tensor, Any]:
    """Per-MNN correction vectors averaged per involved right cell.

    Mirrors .average_correction (reference R/fastMNN.R:567-580): the
    correction for right cell j is the mean over its pairs of
    (ref[i] - cur[j]). Returns (averaged, second): one row per MNN-involved
    right cell, by ascending right-cell index (R rowsum group order), and
    those right-cell indices, the nonzero rows of the per-cell pair counts.
    Pair lists are host arrays (``second`` comes back as one), or tensors
    (it comes back as a tensor on the data's device). A tensor ``mnn2``
    that carries ``involved`` (``mutual_nn.restricted_mnn_on_device``'s)
    gives those cells, and the call waits on nothing; otherwise they are
    read from the counts."""
    dev = curdata.device
    m1 = as_tensor(mnn1, dev, torch.long)
    m2 = as_tensor(mnn2, dev, torch.long)
    n_right = curdata.shape[0]
    diffs = refdata[m1] - curdata[m2]
    sums = torch.zeros((n_right, curdata.shape[1]), device=dev, dtype=diffs.dtype)
    sums.index_add_(0, m2, diffs)
    counts = torch.zeros(n_right, device=dev, dtype=diffs.dtype)
    counts.index_add_(0, m2, torch.ones_like(m2, dtype=diffs.dtype))
    second = getattr(mnn2, "involved", None)
    if second is None:
        second = torch.nonzero(counts)[:, 0]
    averaged = sums[second] / counts[second, None]
    if isinstance(mnn2, torch.Tensor):
        return averaged, second
    return averaged, second.cpu().numpy()


def batch_magnitude(correction: torch.Tensor) -> torch.Tensor:
    """Relative magnitude of the average batch vector (a 0-d tensor).

    sqrt(||mean(correction)||^2 / sum(colMeans(correction^2))); 0 when the
    denominator vanishes. Mirrors .get_batch_magnitude (reference
    R/fastMNN.R:582-595)."""
    ave = correction.mean(0)
    denom = (correction ** 2).mean(0).sum()
    num = (ave ** 2).sum()
    safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    return torch.where(denom == 0, torch.zeros_like(denom), torch.sqrt(num / safe))


def _center_along(mat: torch.Tensor, batch_vec: torch.Tensor,
                  restrict_mask: torch.Tensor) -> torch.Tensor:
    vec = batch_vec / torch.sqrt((batch_vec ** 2).sum())
    with full_fp32_matmul():
        loc = mat @ vec
    w = restrict_mask.to(mat.dtype)
    central = (loc * w).sum() / w.sum()
    return mat + torch.outer(central - loc, vec)


def center_along_batch_vector(
    mat: torch.Tensor,
    batch_vec: torch.Tensor,
    restrict: Optional[np.ndarray] = None,
) -> torch.Tensor:
    """Remove variation along ``batch_vec`` within one matrix.

    Projects cells onto the normalized batch vector and shifts every cell to
    the (restricted) mean position along it. Mirrors
    .center_along_batch_vector (reference R/fastMNN.R:626-640)."""
    n = mat.shape[0]
    mask = torch.zeros(n, device=mat.device, dtype=torch.bool)
    if restrict is None:
        mask[:] = True
    else:
        mask[as_tensor(restrict, mat.device, torch.long)] = True
    return _center_along(mat, as_tensor(batch_vec, mat.device, mat.dtype), mask)


def orthogonalize_other(
    data: torch.Tensor,
    restrict: Optional[np.ndarray],
    vectors: Sequence[torch.Tensor],
) -> torch.Tensor:
    """Replay prior merge steps' batch vectors on a new batch.

    Mirrors .orthogonalize_other (reference R/fastMNN.R:642-647)."""
    for vec in vectors:
        data = center_along_batch_vector(data, vec, restrict)
    return data


def per_batch_var(data: torch.Tensor, labels: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Each batch's sum over dimensions of squared deviations from its
    mean, on the data's device in fp32 (fp64 for fp64 data), with nothing
    read back; :func:`batch_var` makes the variances on the host.

    Mirrors .compute_perbatch_var (reference R/fastMNN.R:651-658).
    ``labels``: each row's batch, 0-based; ``counts``: rows a batch (tensors
    on the data's device). Data are shifted by the global per-dimension
    mean before squaring: the sum-of-squares minus n mu^2 identity cancels
    catastrophically in fp32 when the within-batch variance is small
    against the batch offset. The span ``correction/per_batch_var``."""
    with trace_span("correction/per_batch_var"):
        dev = data.device
        acc = torch.promote_types(data.dtype, torch.float32)
        x = data.to(acc)
        x = x - x.mean(0)[None, :]
        sums = torch.zeros((counts.shape[0], x.shape[1]), device=dev, dtype=acc)
        sums = sums.index_add_(0, labels, x)
        sqs = torch.zeros_like(sums).index_add_(0, labels, x * x)
        cnt = torch.clamp(counts.to(acc), min=1.0)
        return (sqs - sums ** 2 / cnt[:, None]).sum(1)


def batch_var(ssd: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Per-batch sums of sample variances (host float64) from
    :func:`per_batch_var`'s sums and the batches' row counts, with the n-1
    denominator of R's colVars; 0 for a batch of fewer than 2 rows."""
    ssd = np.asarray(ssd).astype(np.float64)
    counts = np.asarray(counts, dtype=np.float64)
    return np.where(counts >= 2, ssd / np.maximum(counts - 1.0, 1.0), 0.0)


def tricube_average(
    vals: torch.Tensor,
    indices: torch.Tensor,
    distances: torch.Tensor,
    ndist: float = 3.0,
    bandwidth: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Tricube-weighted average of neighbour values.

    Bandwidth defaults to ndist x the middle (ceiling(k/2)-th) neighbour
    distance, floored at 1e-8; relative distances clamp to 1 so neighbours
    beyond the bandwidth get zero weight. Mirrors .compute_tricube_average
    (reference R/utils_tricube.R:1-27)."""
    if bandwidth is not None:
        bw = torch.clamp(as_tensor(bandwidth, distances.device, distances.dtype), min=1e-8)
        rel = torch.clamp(distances / bw[:, None], max=1.0)
        tri = (1.0 - rel ** 3) ** 3
        w = tri / tri.sum(1, keepdim=True)
    else:
        w = tricube_weights(distances, ndist)
    with full_fp32_matmul():
        return torch.einsum("nk,nkd->nd", w.to(vals.dtype), vals[indices.long()])


def tricube_weighted_correction(
    curdata: torch.Tensor,
    correction: torch.Tensor,
    in_mnn: np.ndarray,
    k: int = 20,
    ndist: float = 3.0,
) -> torch.Tensor:
    """Apply per-cell corrections smoothed from MNN-involved cells.

    Each right cell queries its nearest MNN-involved right cells and takes
    the tricube-weighted average of their averaged correction vectors.
    Mirrors .tricube_weighted_correction (reference R/fastMNN.R:599-608)."""
    uniq = curdata[as_tensor(in_mnn, curdata.device, torch.long)]
    safe_k = min(k, uniq.shape[0])
    with trace_span("correction/tricube_search"):
        closest = query_knn(curdata, uniq, safe_k, device=curdata.device)
    return curdata + tricube_average(correction, closest.indices, closest.distances, ndist)
