"""The one implementation of the fastMNN merge-step math, single-device form.

Counterpart of ``batchelor_tpu/ops/merge_math.py`` with ``axis=None``: the
JAX package threads optional collectives through these bodies (psum and
all_gather become identities on one device); the port's parallel layer adds
its process-group argument when it ports the SPMD steps. The fused step
(``correct/fused.py``) runs them. Nothing here reads a value back to the
host: pair sets are masks over the (N1, k2) candidates, counts and
decisions are 0-d tensors, and choices are ``torch.where``.

Semantics per helper (reference R/fastMNN.R):
  * center_along       - .center_along_batch_vector (626-640)
  * replay_extras      - .orthogonalize_other (642-647)
  * batch_vector_stats - .average_correction colMeans + .get_batch_magnitude
                         (567-595)
  * perbatch_var       - .compute_perbatch_var (651-658)
  * merge_step_body    - .fast_mnn_core's per-step sequence (448-525)
The tricube weights (``ops/correction.py::tricube_weights``) drop rows with
non-finite distances and shrink the bandwidth's middle index with them, the
reference's k-shrinking for fewer MNN-involved cells than k.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..device import full_fp32_matmul
from .correction import pair_segment_sums, tricube_weights
from .knn import query_knn
from .mutual_nn import _membership

__all__ = [
    "center_along",
    "replay_extras",
    "batch_vector_stats",
    "tricube_weights",
    "perbatch_var",
    "merge_step_body",
    "merge_step_search",
    "merge_step_correct",
]


def center_along(shard: torch.Tensor, stat_mask: torch.Tensor, v: torch.Tensor):
    """Shift every cell to the masked mean position along unit vector ``v``
    (the "kissing"-protection orthogonalization). Returns (centered, mean)."""
    with full_fp32_matmul():
        loc = shard @ v
    total = torch.where(stat_mask, loc, torch.zeros_like(loc)).sum()
    cnt = stat_mask.to(shard.dtype).sum()
    mean = total / cnt
    return shard + torch.outer(mean - loc, v), mean


def replay_extras(shard: torch.Tensor, stat_mask: torch.Tensor,
                  extras: torch.Tensor) -> torch.Tensor:
    """Orthogonalization replay of prior batch vectors, row by row of a
    padded (E, d) table; zero rows leave the shard as it was."""
    for vec in extras:
        nrm = (vec * vec).sum()
        v = vec / torch.sqrt(torch.where(nrm > 0, nrm, torch.ones_like(nrm)))
        cand, _ = center_along(shard, stat_mask, v)
        shard = torch.where(nrm > 0, cand, shard)
    return shard


def batch_vector_stats(avg: torch.Tensor, involved: torch.Tensor):
    """(overall batch vector, relative magnitude) from the per-right-cell
    averaged-correction table; ``involved`` marks the rows that have pairs."""
    n_involved = torch.clamp(involved.sum(), min=1)
    overall = torch.where(involved[:, None], avg, torch.zeros_like(avg)).sum(0) / n_involved
    denom = ((avg * avg).sum(1) * involved).sum() / n_involved
    num = (overall * overall).sum()
    zero = denom == 0
    magnitude = torch.where(
        zero, torch.zeros_like(denom),
        torch.sqrt(num / torch.where(zero, torch.ones_like(denom), denom)))
    return overall, magnitude


def _segment_sum(values: torch.Tensor, seg: torch.Tensor, nb: int) -> torch.Tensor:
    out = torch.zeros((nb,) + tuple(values.shape[1:]), device=values.device, dtype=values.dtype)
    return out.index_add_(0, seg, values)


def perbatch_var(shard: torch.Tensor, origin: torch.Tensor, valid: torch.Tensor,
                 nb: int) -> torch.Tensor:
    """Sum of per-dimension sample variances per batch id in [0, nb) (n-1
    denominator like R's colVars), in two passes (mean, then squared
    deviations). Rows outside ``valid`` count nowhere."""
    w = valid.to(shard.dtype)
    origin = origin.long()
    cnt = _segment_sum(w, origin, nb)
    sums = _segment_sum(shard * w[:, None], origin, nb)
    mu = sums / torch.clamp(cnt, min=1.0)[:, None]
    dev = shard - mu[origin]
    sq = _segment_sum((dev * dev).sum(1) * w, origin, nb)
    return torch.where(cnt >= 2, sq / torch.clamp(cnt - 1.0, min=1.0), torch.zeros_like(sq))


def _mutual_mask(lshard, rshard, lvalid, rvalid, lres, rres, k1: int, k2: int,
                 knn_method: str, max_bytes: Optional[int]):
    """MNN membership mask: (mutual (N1, k2) bool, l2r (N1, k2))."""
    dev = lshard.device
    l2r, _ = query_knn(lshard, rshard, k2, data_mask=rvalid & rres, method=knn_method,
                       indices_only=True, max_bytes=max_bytes, device=dev)
    r2l, _ = query_knn(rshard, lshard, k1, data_mask=lvalid & lres, method=knn_method,
                       indices_only=True, max_bytes=max_bytes, device=dev)
    # membership_rows over all left rows, in blocks that bound the gather
    mutual = _membership(l2r, r2l)
    return mutual & (lres & lvalid)[:, None], l2r


def merge_step_search(
    lshard, rshard, lvalid, rvalid, lres, rres,
    lorigin=None, rorigin=None, lextras=None, rextras=None,
    *,
    k1: int, k2: int, knn_method: str = "exact", nb: int = 2,
    with_var: bool = True, max_bytes: Optional[int] = None,
):
    """Phase 1 of a merge step: pre-merge variances, orthogonalization
    replay, the two kNN searches and the mutual membership test.

    Returns (lshard_replayed, rshard_replayed, mutual, l2r, n_pairs,
    var_old or None)."""
    var_old = None
    if with_var:
        # before the replay, as the host engine computes per_batch_var
        # ahead of orthogonalize_other (reference R/fastMNN.R:467)
        var_old = (perbatch_var(lshard, lorigin, lvalid, nb)
                   + perbatch_var(rshard, rorigin, rvalid, nb))
    if lextras is not None:
        rshard = replay_extras(rshard, rres & rvalid, lextras)
    if rextras is not None:
        lshard = replay_extras(lshard, lres & lvalid, rextras)
    mutual, l2r = _mutual_mask(lshard, rshard, lvalid, rvalid, lres, rres, k1, k2,
                               knn_method, max_bytes)
    return lshard, rshard, mutual, l2r, mutual.sum(), var_old


def merge_step_correct(
    lshard, rshard, lvalid, rvalid, lres, rres, mutual, l2r,
    lorigin=None, rorigin=None,
    *,
    tricube_k: int, ndist: float, min_batch_skip: float,
    knn_method: str = "exact", nb: int = 2, with_var: bool = True,
    max_bytes: Optional[int] = None,
):
    """Phase 2 of a merge step: segment-averaged correction vectors,
    batch-vector stats, orthogonalization of both sides, post variances,
    recomputed averages and the tricube apply, on phase 1's outputs.

    Returns (left_c, right_out, overall, magnitude, var_new or None)."""
    n2 = rshard.shape[0]

    def averaged(l_rows, right):
        # sum over pairs of (left_i - right_j) per segment j equals
        # (sum of paired left rows) - count_j * right_j
        lsums, counts = pair_segment_sums(l_rows, l2r, mutual, n2)
        sums = lsums - right * counts[:, None]
        return sums / torch.clamp(counts, min=1.0)[:, None], counts > 0

    avg, involved = averaged(lshard, rshard)
    overall, magnitude = batch_vector_stats(avg, involved)
    do_correct = magnitude >= min_batch_skip

    v = overall / torch.sqrt((overall * overall).sum())
    lshard_c, _ = center_along(lshard, lres & lvalid, v)
    rshard_c, _ = center_along(rshard, rres & rvalid, v)
    lshard_c = torch.where(do_correct, lshard_c, lshard)
    rshard_c = torch.where(do_correct, rshard_c, rshard)

    var_new = None
    if with_var:
        # post-centering per-batch variance -> lost.var (R/fastMNN.R:500-501)
        var_new = (perbatch_var(lshard_c, lorigin, lvalid, nb)
                   + perbatch_var(rshard_c, rorigin, rvalid, nb))

    avg2, _ = averaged(lshard_c, rshard_c)

    # tricube apply: right rows query the involved right cells
    idx, dist = query_knn(rshard_c, rshard_c, tricube_k, data_mask=involved & rvalid,
                          method=knn_method, max_bytes=max_bytes, device=rshard_c.device)
    w = tricube_weights(dist, ndist)
    # k gathers of (N2, d), accumulated by neighbour position: avg2[idx]
    # whole would be an (N2, k, d) tensor
    correction = torch.zeros_like(rshard_c)
    for p in range(idx.shape[1]):
        correction = correction + w[:, p, None] * avg2[idx[:, p]]
    right_out = torch.where(do_correct, rshard_c + correction, rshard_c)
    return lshard_c, right_out, overall, magnitude, var_new


def merge_step_body(
    lshard, rshard, lvalid, rvalid, lres, rres,
    lorigin=None, rorigin=None, lextras=None, rextras=None,
    *,
    k1: int, k2: int, tricube_k: int, ndist: float, min_batch_skip: float,
    knn_method: str = "exact", nb: int = 2, with_var: bool = True,
    max_bytes: Optional[int] = None,
):
    """One fastMNN merge step (reference .fast_mnn_core body,
    R/fastMNN.R:448-525): MNN detection, batch-vector estimation,
    orthogonalization of both sides, recomputed averages, tricube apply.

    ``lvalid``/``rvalid`` mark real rows (pads are False), ``lres``/``rres``
    the restricted ones. ``lorigin``/``rorigin`` give each row's batch id
    in [0, nb) for the variances. ``lextras``/``rextras``: optional padded
    (E, d) batch-vector tables replayed on the opposite side before the
    search (zero rows skipped). ``with_var`` adds the pre/post per-batch
    variance pair feeding lost.var. ``max_bytes`` bounds the two-pass
    searches' buffers (``query_knn``).

    Returns (left_c, right_out, overall, magnitude, n_pairs, mutual, l2r
             [, var_old, var_new]), all tensors on the inputs' device.
    """
    lshard, rshard, mutual, l2r, n_pairs, var_old = merge_step_search(
        lshard, rshard, lvalid, rvalid, lres, rres, lorigin, rorigin, lextras, rextras,
        k1=k1, k2=k2, knn_method=knn_method, nb=nb, with_var=with_var,
        max_bytes=max_bytes,
    )
    lshard_c, right_out, overall, magnitude, var_new = merge_step_correct(
        lshard, rshard, lvalid, rvalid, lres, rres, mutual, l2r, lorigin, rorigin,
        tricube_k=tricube_k, ndist=ndist, min_batch_skip=min_batch_skip,
        knn_method=knn_method, nb=nb, with_var=with_var, max_bytes=max_bytes,
    )
    out = (lshard_c, right_out, overall, magnitude, n_pairs, mutual, l2r)
    if with_var:
        out = out + (var_old, var_new)
    return out
