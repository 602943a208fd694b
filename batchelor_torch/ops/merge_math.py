"""The one implementation of the fastMNN merge-step math.

Counterpart of ``batchelor_tpu/ops/merge_math.py``. Every execution mode
shares these bodies: the single-device fused step (``correct/fused.py``),
and the gather-mode and ring-mode steps of the parallel layer
(``parallel/driver.py``). A mode differs only in the process group it
threads through (``group=None`` means one device: ``pmaybe`` and
``gmaybe`` are identities, where the JAX package has ``axis=None``). With a
group, each rank holds a row shard of both sides and the sums are
``all_reduce``d. Nothing here reads a value back to the host: pair sets
are masks over the (N1, k2) candidates, counts and decisions are 0-d
tensors, and choices are ``torch.where``.

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

import torch.distributed as dist

from ..device import full_fp32_matmul
from .correction import pair_segment_sums, tricube_weights
from .knn import query_knn
from .mutual_nn import _MEMBERSHIP_BLOCK, membership_rows

__all__ = [
    "pmaybe",
    "gmaybe",
    "center_along",
    "replay_extras",
    "batch_vector_stats",
    "tricube_weights",
    "perbatch_var",
    "merge_step_body",
    "merge_step_search",
    "merge_step_correct",
]


def group_rank(group) -> int:
    """This process's rank in ``group`` (0 without one)."""
    return 0 if group is None else dist.get_rank(group)


def group_size(group) -> int:
    """The ranks in ``group`` (1 without one)."""
    return 1 if group is None else dist.get_world_size(group)


def pmaybe(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (``all_reduce``), or
    ``x`` itself without a group. ``x`` is left as it was."""
    if group is None:
        return x
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


def gmaybe(x: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' ``x`` stacked along rows in rank order (a tiled all-gather),
    or ``x`` itself without a group. Booleans travel as bytes."""
    if group is None:
        return x
    src = x.contiguous()
    if src.dtype == torch.bool:
        return gmaybe(src.to(torch.uint8), group).bool()
    out = torch.empty((group_size(group) * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _all_gather(out, src, group=group)
    return out


# all_gather_single is the newer name of the same call; all_gather_into_tensor
# remains in older releases (and only warns where it is deprecated)
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def center_along(shard: torch.Tensor, stat_mask: torch.Tensor, v: torch.Tensor,
                 group=None):
    """Shift every cell to the masked mean position along unit vector ``v``
    (the "kissing"-protection orthogonalization), the mean taken over every
    rank of ``group``. Returns (centered, mean)."""
    with full_fp32_matmul():
        loc = shard @ v
    total = pmaybe(torch.where(stat_mask, loc, torch.zeros_like(loc)).sum(), group)
    cnt = pmaybe(stat_mask.to(shard.dtype).sum(), group)
    mean = total / cnt
    return shard + torch.outer(mean - loc, v), mean


def replay_extras(shard: torch.Tensor, stat_mask: torch.Tensor,
                  extras: torch.Tensor, group=None) -> torch.Tensor:
    """Orthogonalization replay of prior batch vectors, row by row of a
    padded (E, d) table; zero rows leave the shard as it was."""
    for vec in extras:
        nrm = (vec * vec).sum()
        v = vec / torch.sqrt(torch.where(nrm > 0, nrm, torch.ones_like(nrm)))
        cand, _ = center_along(shard, stat_mask, v, group)
        shard = torch.where(nrm > 0, cand, shard)
    return shard


def batch_vector_stats(avg: torch.Tensor, involved: torch.Tensor, group=None):
    """(overall batch vector, relative magnitude) from the per-right-cell
    averaged-correction table; ``involved`` marks the rows that have pairs.
    Pass ``group`` when the table is sharded (ring mode); a replicated
    table reduces locally."""
    n_involved = torch.clamp(pmaybe(involved.sum(), group), min=1)
    overall = pmaybe(torch.where(involved[:, None], avg, torch.zeros_like(avg)).sum(0),
                     group) / n_involved
    denom = pmaybe(((avg * avg).sum(1) * involved).sum(), group) / n_involved
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
                 nb: int, group=None) -> torch.Tensor:
    """Sum of per-dimension sample variances per batch id in [0, nb) (n-1
    denominator like R's colVars), in two passes (mean, then squared
    deviations), reduced over ``group``. Rows outside ``valid`` count
    nowhere."""
    w = valid.to(shard.dtype)
    origin = origin.long()
    cnt = pmaybe(_segment_sum(w, origin, nb), group)
    sums = pmaybe(_segment_sum(shard * w[:, None], origin, nb), group)
    mu = sums / torch.clamp(cnt, min=1.0)[:, None]
    dev = shard - mu[origin]
    sq = pmaybe(_segment_sum((dev * dev).sum(1) * w, origin, nb), group)
    return torch.where(cnt >= 2, sq / torch.clamp(cnt - 1.0, min=1.0), torch.zeros_like(sq))


def _mutual_mask(lshard, rshard, lvalid, rvalid, lres, rres, k1: int, k2: int,
                 knn_method: str, max_bytes: Optional[int], group=None):
    """MNN membership mask through the all-gathered opposing sets:
    (mutual (N1, k2) bool over this rank's left rows, l2r (N1, k2) of global
    right rows)."""
    dev = lshard.device
    nsl = lshard.shape[0]
    full_right = gmaybe(rshard, group)
    full_left = gmaybe(lshard, group)
    l2r, _ = query_knn(lshard, full_right, k2, data_mask=gmaybe(rvalid & rres, group),
                       method=knn_method, indices_only=True, max_bytes=max_bytes, device=dev)
    r2l, _ = query_knn(rshard, full_left, k1, data_mask=gmaybe(lvalid & lres, group),
                       method=knn_method, indices_only=True, max_bytes=max_bytes, device=dev)
    # a left row's global id: its rank's offset into the padded rows
    my_ids = group_rank(group) * nsl + torch.arange(nsl, device=dev)
    chunk = max(1, min(nsl, _MEMBERSHIP_BLOCK // max(1, k2 * k1)))
    mutual = membership_rows(l2r, gmaybe(r2l, group), my_ids, chunk)
    return mutual & (lres & lvalid)[:, None], l2r


def merge_step_search(
    lshard, rshard, lvalid, rvalid, lres, rres,
    lorigin=None, rorigin=None, lextras=None, rextras=None,
    *,
    k1: int, k2: int, knn_method: str = "exact", nb: int = 2,
    with_var: bool = True, max_bytes: Optional[int] = None, group=None,
):
    """Phase 1 of a merge step: pre-merge variances, orthogonalization
    replay, the two kNN searches and the mutual membership test.

    Returns (lshard_replayed, rshard_replayed, mutual, l2r, n_pairs,
    var_old or None)."""
    var_old = None
    if with_var:
        # before the replay, as the host engine computes per_batch_var
        # ahead of orthogonalize_other (reference R/fastMNN.R:467)
        var_old = (perbatch_var(lshard, lorigin, lvalid, nb, group)
                   + perbatch_var(rshard, rorigin, rvalid, nb, group))
    if lextras is not None:
        rshard = replay_extras(rshard, rres & rvalid, lextras, group)
    if rextras is not None:
        lshard = replay_extras(lshard, lres & lvalid, rextras, group)
    mutual, l2r = _mutual_mask(lshard, rshard, lvalid, rvalid, lres, rres, k1, k2,
                               knn_method, max_bytes, group)
    return lshard, rshard, mutual, l2r, pmaybe(mutual.sum(), group), var_old


def merge_step_correct(
    lshard, rshard, lvalid, rvalid, lres, rres, mutual, l2r,
    lorigin=None, rorigin=None,
    *,
    tricube_k: int, ndist: float, min_batch_skip: float,
    knn_method: str = "exact", nb: int = 2, with_var: bool = True,
    max_bytes: Optional[int] = None, group=None,
):
    """Phase 2 of a merge step: segment-averaged correction vectors,
    batch-vector stats, orthogonalization of both sides, post variances,
    recomputed averages and the tricube apply, on phase 1's outputs. With
    ``group`` the right side is all-gathered, so the averaged-correction
    table is replicated on every rank.

    Returns (left_c, right_out, overall, magnitude, var_new or None)."""
    full_right = gmaybe(rshard, group)
    full_rvalid = gmaybe(rvalid, group)
    n2 = full_right.shape[0]

    def averaged(l_rows, right):
        # sum over pairs of (left_i - right_j) per segment j equals
        # (sum of paired left rows) - count_j * right_j
        lsums, counts = pair_segment_sums(l_rows, l2r, mutual, n2)
        lsums, counts = pmaybe(lsums, group), pmaybe(counts, group)
        sums = lsums - right * counts[:, None]
        return sums / torch.clamp(counts, min=1.0)[:, None], counts > 0

    avg, involved = averaged(lshard, full_right)
    overall, magnitude = batch_vector_stats(avg, involved)
    do_correct = magnitude >= min_batch_skip

    v = overall / torch.sqrt((overall * overall).sum())
    lshard_c, _ = center_along(lshard, lres & lvalid, v, group)
    rshard_c, _ = center_along(rshard, rres & rvalid, v, group)
    lshard_c = torch.where(do_correct, lshard_c, lshard)
    rshard_c = torch.where(do_correct, rshard_c, rshard)

    var_new = None
    if with_var:
        # post-centering per-batch variance -> lost.var (R/fastMNN.R:500-501)
        var_new = (perbatch_var(lshard_c, lorigin, lvalid, nb, group)
                   + perbatch_var(rshard_c, rorigin, rvalid, nb, group))

    full_right_c = gmaybe(rshard_c, group)
    avg2, _ = averaged(lshard_c, full_right_c)

    # tricube apply: this rank's right rows query the involved right cells
    idx, dist_ = query_knn(rshard_c, full_right_c, tricube_k,
                           data_mask=involved & full_rvalid, method=knn_method,
                           max_bytes=max_bytes, device=rshard_c.device)
    w = tricube_weights(dist_, ndist)
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
    max_bytes: Optional[int] = None, group=None,
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
    searches' buffers (``query_knn``). ``group``: the process group whose
    ranks each hold an equal row shard of both sides (the gather-mode
    step of ``parallel/driver.py``); None for one device.

    Returns (left_c, right_out, overall, magnitude, n_pairs, mutual, l2r
             [, var_old, var_new]), all tensors on the inputs' device; the
    row outputs are this rank's shards, ``l2r`` holds global right rows.
    """
    lshard, rshard, mutual, l2r, n_pairs, var_old = merge_step_search(
        lshard, rshard, lvalid, rvalid, lres, rres, lorigin, rorigin, lextras, rextras,
        k1=k1, k2=k2, knn_method=knn_method, nb=nb, with_var=with_var,
        max_bytes=max_bytes, group=group,
    )
    lshard_c, right_out, overall, magnitude, var_new = merge_step_correct(
        lshard, rshard, lvalid, rvalid, lres, rres, mutual, l2r, lorigin, rorigin,
        tricube_k=tricube_k, ndist=ndist, min_batch_skip=min_batch_skip,
        knn_method=knn_method, nb=nb, with_var=with_var, max_bytes=max_bytes,
        group=group,
    )
    out = (lshard_c, right_out, overall, magnitude, n_pairs, mutual, l2r)
    if with_var:
        out = out + (var_old, var_new)
    return out
