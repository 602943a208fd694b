"""Distributed fastMNN step and PCA: cells split by rank, explicit collectives.

Counterpart of ``batchelor_tpu/parallel/distributed.py``. Each rank holds a
row shard of every batch, padded to a multiple of the world size with
masked rows. The opposing set of a merge step is all-gathered for the
distance tiles (d <= ~50, so an (N x d) gather is cheap); MNN membership,
segment-averaged corrections, projection means and variances are
``all_reduce``d; small state is the same on every rank. Every rank calls
these functions with the same full inputs and gets the same full outputs.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import as_tensor, full_fp32_matmul
from ..ops.knn_cuda import default_max_bytes
from ..ops.merge_math import gmaybe, merge_step_body, pmaybe
from ..ops.pca import MultiBatchPCAResult, construct_weight_vector, full_eigh
from .mesh import CellsMesh, cells_sharding, pad_to_multiple

__all__ = ["distributed_merge_step", "distributed_multi_batch_pca", "DistributedMergeOutput"]


class DistributedMergeOutput(NamedTuple):
    left: torch.Tensor
    right: torch.Tensor
    overall: torch.Tensor
    batch_size: torch.Tensor
    n_pairs: torch.Tensor


def _sharded(mesh: CellsMesh, x):
    """(this rank's rows of ``x`` padded to a world-size multiple, its
    valid-row mask, the unpadded row count)."""
    xpad, n = pad_to_multiple(as_tensor(x, mesh.device), mesh.size)
    sh = cells_sharding(mesh)
    valid = torch.arange(xpad.shape[0], device=mesh.device) < n
    return sh.shard(xpad), sh.shard(valid), n


def distributed_merge_step(
    left,
    right,
    mesh: CellsMesh,
    *,
    k1: int = 20,
    k2: int = 20,
    tricube_k: int = 20,
    ndist: float = 3.0,
    min_batch_skip: float = 0.0,
) -> DistributedMergeOutput:
    """One fastMNN merge step with cells split over ``mesh``'s ranks.

    Pads both sets to a world-size multiple with masked rows (the masks
    double as restriction masks: this standalone step has no restriction);
    returns the unpadded corrected coordinates, gathered on every rank,
    and the diagnostics."""
    lsh, lmask, n1 = _sharded(mesh, left)
    rsh, rmask, n2 = _sharded(mesh, right)
    lc, rc, overall, mag, n_pairs = merge_step_body(
        lsh, rsh, lmask, rmask, lmask, rmask,
        k1=k1, k2=k2, tricube_k=tricube_k, ndist=ndist, min_batch_skip=min_batch_skip,
        with_var=False, max_bytes=default_max_bytes(mesh.device), group=mesh.group,
    )[:5]
    return DistributedMergeOutput(
        left=gmaybe(lc, mesh.group)[:n1], right=gmaybe(rc, mesh.group)[:n2],
        overall=overall, batch_size=mag, n_pairs=n_pairs)


# ---------------------------------------------------------------------------
# Distributed multi-batch PCA: per-shard Gram accumulation, the same eigh on
# every rank.


def _masked(x, m):
    return torch.where(m[:, None], x, torch.zeros((), dtype=x.dtype, device=x.device))


def _weighted_stats(xs, masks, weights, group):
    """(centers, counts): the weighted grand mean of the per-batch means
    (reference R/multiBatchPCA.R:270-282) from all-reduced masked sums."""
    means, counts = [], []
    for x, m in zip(xs, masks):
        s = pmaybe(_masked(x, m).sum(0), group)
        c = pmaybe(m.to(x.dtype).sum(), group)
        means.append(s / c)
        counts.append(c)
    centers = sum(mu * w for mu, w in zip(means, weights)) / sum(weights)
    return centers, counts


def _weighted_cross(as_, bs, masks, weights, counts, a_centers, b_centers, group):
    """sum_b (w_b / N_b) (A_b - 1 a^T)^T (B_b - 1 b^T) over masked rows,
    all-reduced (reference R/multiBatchPCA.R:293-318)."""
    out = None
    for a, b, m, w, c in zip(as_, bs, masks, weights, counts):
        ac = _masked(a - a_centers[None, :], m)
        bc = _masked(b - b_centers[None, :], m)
        term = (ac.T @ bc) * (w / c)
        out = term if out is None else out + term
    return pmaybe(out, group)


def distributed_multi_batch_pca(
    batches,
    mesh: CellsMesh,
    d: Optional[int] = 50,
    weights=None,
    *,
    subset_row=None,
    get_all_genes: bool = False,
    get_variance: bool = False,
    batch_names=None,
) -> MultiBatchPCAResult:
    """Weighted multi-batch PCA with cells split over ``mesh``'s ranks, with
    every option of ``ops.pca.multi_batch_pca`` (weight vectors and trees,
    ``subset_row``, ``get_all_genes`` extrapolation, ``get_variance``,
    ``d=None``).

    Each rank accumulates the G x G weighted cross-product of its rows; the
    sum is all-reduced, so every rank runs the same ``eigh`` on the same
    matrix. Components are projected per shard and gathered: every rank
    returns the same full result.
    """
    group = mesh.group
    dev = mesh.device
    batches = [as_tensor(b, dev) for b in batches]
    nb = len(batches)
    w = construct_weight_vector([b.shape[0] for b in batches], weights, batch_names)
    weights_f = [float(x) for x in w]
    names = list(batch_names) if batch_names is not None else None
    g_all = batches[0].shape[1]
    if subset_row is not None:
        subset_row = np.asarray(subset_row)
        sub = [b[:, as_tensor(subset_row, dev, torch.long)] for b in batches]
    else:
        sub = list(batches)

    shards = [_sharded(mesh, b) for b in sub]
    xs = [s[0] for s in shards]
    masks = [s[1] for s in shards]
    ns = [s[2] for s in shards]
    dt = xs[0].dtype

    with full_fp32_matmul():
        centers, counts = _weighted_stats(xs, masks, weights_f, group)
        if d is None:
            return _passthrough(xs, masks, ns, weights_f, counts, centers, g_all, subset_row,
                                get_all_genes, get_variance, names, group)

        gram = _weighted_cross(xs, xs, masks, weights_f, counts, centers, centers, group)
        evals, evecs = full_eigh(gram)
        d_eff = int(min(d, sum(ns), sub[0].shape[1]))
        ev = torch.clamp(evals.flip(0)[:d_eff], min=0.0)
        v = evecs.flip(1)[:, :d_eff]
        comps = [gmaybe(_masked(x - centers[None, :], m) @ v, group)[:n]
                 for x, m, n in zip(xs, masks, ns)]

        if get_all_genes and subset_row is not None:
            keep = np.zeros(g_all, dtype=bool)
            keep[subset_row] = True
            leftover_idx = np.nonzero(~keep)[0]
            lidx = as_tensor(leftover_idx, dev, torch.long)
            lefts = [cells_sharding(mesh).shard(pad_to_multiple(b[:, lidx], mesh.size)[0])
                     for b in batches]
            left_centers, _ = _weighted_stats(lefts, masks, weights_f, group)
            cross = _weighted_cross(lefts, xs, masks, weights_f, counts, left_centers,
                                    centers, group)
            # leftover_u = left_scaled^T u / s = cross v / s^2
            # (reference R/multiBatchPCA.R:396-414)
            leftover_u = (cross @ v) / torch.clamp(ev, min=torch.finfo(dt).tiny)[None, :]
            sidx = as_tensor(subset_row, dev, torch.long)
            rotation = torch.zeros((g_all, d_eff), dtype=dt, device=dev)
            rotation[sidx] = v
            rotation[lidx] = leftover_u
            all_centers = torch.zeros((g_all,), dtype=dt, device=dev)
            all_centers[sidx] = centers
            all_centers[lidx] = left_centers
        else:
            rotation, all_centers = v, centers
        total = None
        if get_variance:
            total = sum((_masked(x - centers[None, :], m) ** 2).sum() * (wi / c)
                        for x, m, wi, c in zip(xs, masks, weights_f, counts))
            total = pmaybe(total, group)

    res = MultiBatchPCAResult(components=comps, rotation=rotation, centers=all_centers,
                              batch_names=names)
    if get_variance:
        res.var_explained = ev.cpu().numpy() / nb
        res.var_total = float(total) / nb
    return res


def _passthrough(xs, masks, ns, weights, counts, centers, g_all, subset_row, get_all_genes,
                 get_variance, names, group):
    """d=None: the centered matrices, an identity (or injection) rotation and
    zero centers (reference R/multiBatchPCA.R:245-255, 439-461); the
    variance is that of the scaled concatenation, n - 1 denominator."""
    dt, dev = xs[0].dtype, xs[0].device
    centered = [_masked(x - centers[None, :], m) for x, m in zip(xs, masks)]
    comps = [gmaybe(c, group)[:n] for c, n in zip(centered, ns)]
    g_sub = xs[0].shape[1]
    if get_all_genes and subset_row is not None:
        rotation = torch.zeros((g_all, g_sub), dtype=dt, device=dev)
        rotation[as_tensor(subset_row, dev, torch.long), torch.arange(g_sub, device=dev)] = 1.0
        out_centers = torch.zeros((g_all,), dtype=dt, device=dev)
    else:
        rotation = torch.eye(g_sub, dtype=dt, device=dev)
        out_centers = torch.zeros((g_sub,), dtype=dt, device=dev)
    res = MultiBatchPCAResult(components=comps, rotation=rotation, centers=out_centers,
                              batch_names=names)
    if get_variance:
        scaled = [c / torch.sqrt(cnt / w) for c, cnt, w in zip(centered, counts, weights)]
        n_tot = sum(counts)
        mu = sum(pmaybe(s.sum(0), group) for s in scaled) / n_tot
        sq = sum(pmaybe((_masked(s - mu[None, :], m) ** 2).sum(0), group)
                 for s, m in zip(scaled, masks))
        var = sq / (n_tot - 1.0)
        res.var_explained = var.cpu().numpy()
        res.var_total = float(var.sum())
    return res
