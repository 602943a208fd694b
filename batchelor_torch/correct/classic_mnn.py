"""Classic mnnCorrect: gene-space MNN correction with Gaussian smoothing.

Counterpart of ``batchelor_tpu/correct/classic_mnn.py`` (reference
mnnCorrect, R/mnnCorrect.R:125-538): MNN pairs in (cosine-normalized) gene
space, per-cell correction vectors from Gaussian-kernel smoothing of
per-MNN averages, optional biological-subspace removal (svd_dim) and
quantile-matching variance adjustment (var_adj).

Returns per-gene corrected values, unlike fastMNN's low-dimensional output.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, as_tensor, resolve_device
from ..ops.correction import average_correction
from ..ops.cosine_norm import apply_cosine_norm, cosine_norm
from ..ops.gaussian_kernel import smooth_gaussian_kernel
from ..ops.mutual_nn import restricted_mnn
from ..ops.shift_variance import adjust_shift_variance
from ..ops.svd import get_bio_span_pair, subtract_bio
from ..utils.batching import (
    check_batch_consistency,
    check_restrictions,
    combine_restrict,
    divide_into_batches,
    finish_output,
)
from ..utils.trees import MergeNode, StepOutcome, walk_merge_tree
from .fast_mnn import MNNResult

__all__ = ["mnn_correct"]

_HOST_PAIR_CHUNK = 1 << 18  # MNN-pair rows moved to the device at a time


def _compute_correction_vectors(data1, data2, s1, s2, dist_data, sigma):
    """Smoothed per-cell correction vectors (reference
    .compute_correction_vectors, R/mnnCorrect.R:451-460): average the pair
    differences per involved right cell, then Gaussian-smooth over all right
    cells using distances in ``dist_data`` space."""
    averaged, uniq = average_correction(data1, s1, data2, s2)
    return smooth_gaussian_kernel(averaged, uniq, dist_data, sigma)


def _host_average_correction(left_out, right_out, s1, s2, sigma, dist_data):
    """_compute_correction_vectors for host-resident out-matrices: only the
    paired rows are gathered on the host, ``_HOST_PAIR_CHUNK`` at a time,
    and summed per right cell on ``dist_data``'s device, so the device
    holds O(chunk x G_out + N_right x G_out) and never the left matrix
    (reference R/mnnCorrect.R:282-284 densifies per merge-loop need)."""
    dev = dist_data.device
    n_right = right_out.shape[0]
    dt = torch.from_numpy(left_out[:0]).dtype
    sums = torch.zeros((n_right, left_out.shape[1]), device=dev, dtype=dt)
    counts = torch.zeros(n_right, device=dev, dtype=dt)
    for a in range(0, s1.shape[0], _HOST_PAIR_CHUNK):
        b = min(s1.shape[0], a + _HOST_PAIR_CHUNK)
        seg = as_tensor(s2[a:b], dev, torch.long)
        diff = as_tensor(left_out[s1[a:b]], dev) - as_tensor(right_out[s2[a:b]], dev)
        sums.index_add_(0, seg, diff)
        counts.index_add_(0, seg, torch.ones(b - a, device=dev, dtype=dt))
    averaged_full = sums / torch.clamp(counts, min=1.0)[:, None]
    uniq = np.unique(np.asarray(s2))
    averaged = averaged_full[as_tensor(uniq, dev, torch.long)]
    return smooth_gaussian_kernel(averaged, uniq, dist_data, sigma)


def _prepare_input_data(batches, cos_norm_in, cos_norm_out, subset_row,
                        correct_all, device, host_out=False):
    """in/out matrix preparation (reference .prepare_input_data,
    R/mnnCorrect.R:398-442). Returns (in_batches, out_batches, subset, same_set).

    With ``host_out`` the out-matrices stay host numpy arrays (scaled on the
    host); only the gene-subset in-matrices move to ``device``. Requires
    subset_row + correct_all (the regime where in != out and the out-space
    is the large one)."""
    in_batches = list(batches)
    out_batches = list(batches)
    same_set = True

    if subset_row is not None:
        subset_row = np.asarray(subset_row)
        if np.array_equal(subset_row, np.arange(batches[0].shape[1])):
            subset_row = None
            if host_out:        # in == out: the whole matrices are the working set
                in_batches = out_batches = [as_tensor(b, device) for b in batches]
        else:
            if host_out:
                in_batches = [as_tensor(b[:, subset_row], device) for b in batches]
            else:
                cols = as_tensor(subset_row, device, torch.long)
                in_batches = [b[:, cols] for b in in_batches]
            if correct_all:
                same_set = False
            else:
                out_batches = list(in_batches)

    norm_scaling = None
    if cos_norm_in:
        normed, norm_scaling = [], []
        for b in in_batches:
            mat, l2 = cosine_norm(b, mode="all")
            normed.append(mat)
            norm_scaling.append(l2)
        in_batches = normed
    if cos_norm_out:
        if not cos_norm_in:
            norm_scaling = [cosine_norm(b, mode="l2norm") for b in in_batches]
        if host_out and not same_set:
            # scale the host rows on the host (never densify on the device)
            out_batches = [
                np.asarray(o) / np.maximum(l2.cpu().numpy(), 1e-8)[:, None]
                for o, l2 in zip(out_batches, norm_scaling)
            ]
        else:
            out_batches = [apply_cosine_norm(o, l2) for o, l2 in zip(out_batches, norm_scaling)]
    if cos_norm_out != cos_norm_in:
        same_set = False
    return in_batches, out_batches, subset_row, same_set


def _rows(mat, idx: np.ndarray, device: torch.device) -> torch.Tensor:
    """``mat[idx]`` as a tensor on ``device``; a host matrix is gathered on
    the host first."""
    if isinstance(mat, np.ndarray):
        return as_tensor(mat[idx], device)
    return mat[as_tensor(idx, mat.device, torch.long)]


def _count_pairs_noorth(left: MergeNode, right: MergeNode, k, prop_k) -> int:
    """MNN pairs between two nodes (auto-merge's count, reference
    R/MNN_tree.R:160-167)."""
    pairs = restricted_mnn(left.data, left.restrict, right.data, right.restrict, k=k,
                           prop_k=prop_k, device=left.data.device)
    return int(pairs.first.shape[0])


def _merge_step(mdx: int, left: MergeNode, right: MergeNode, *, k, prop_k, sigma, svd_dim,
                var_adj, same_set, subset_row, knn_method, device, nb) -> StepOutcome:
    """One mnnCorrect merge (the merge loop of reference R/mnnCorrect.R):
    MNN pairs in the "in" space, Gaussian-smoothed correction vectors for
    the right side in the "in" and, when they differ, the "out" space
    (``extras[0]``), then the biological subspace and the variance
    adjustment."""
    left_out = left.extras[0]
    right_out = right.extras[0]

    pairs = restricted_mnn(
        left.data, left.restrict, right.data, right.restrict,
        k=k, prop_k=prop_k, method=knn_method, device=device,
    )
    if pairs.first.shape[0] == 0:
        raise ValueError(f"no MNN pairs found at merge step {mdx}")
    s1, s2 = pairs.first, pairs.second

    host_out = not same_set and isinstance(left_out, np.ndarray)
    corr_in = _compute_correction_vectors(left.data, right.data, s1, s2, right.data, sigma)
    if not same_set:
        # distances come from the "in" coordinates so the kernel scale
        # matches sigma (reference R/mnnCorrect.R:299-304)
        if host_out:
            corr_out = _host_average_correction(left_out, right_out, s1, s2, sigma,
                                                right.data)
        else:
            corr_out = _compute_correction_vectors(left_out, right_out, s1, s2,
                                                   right.data, sigma)

    if svd_dim > 0:
        u1 = np.unique(s1)
        u2 = np.unique(s2)
        span1, span2 = get_bio_span_pair(_rows(left.data, u1, device),
                                         _rows(right.data, u2, device), svd_dim)
        corr_in = subtract_bio(corr_in, span1, span2)
        if not same_set:
            ospan1, ospan2 = get_bio_span_pair(
                _rows(left_out, u1, device), _rows(right_out, u2, device), svd_dim,
                subset_row=subset_row,
            )
            corr_out = subtract_bio(corr_out, ospan1, ospan2, subset_row=subset_row)

    if var_adj:
        corr_in = adjust_shift_variance(
            left.data, right.data, corr_in, sigma,
            restrict1=left.restrict, restrict2=right.restrict,
        )
        if not same_set:
            corr_out = adjust_shift_variance(
                left_out, right_out, corr_out, sigma,
                restrict1=left.restrict, restrict2=right.restrict,
                subset_row=subset_row,
            )

    right_data = right.data + corr_in
    if not same_set:
        if host_out:
            right_out = right_out + corr_out.cpu().numpy()
        else:
            right_out = right_out + corr_out

    if same_set:
        merged_out = None
    elif host_out:
        merged_out = np.concatenate([left_out, right_out], axis=0)
    else:
        merged_out = torch.cat([left_out, right_out], 0)
    merged = MergeNode(
        index=list(left.index) + list(right.index),
        data=torch.cat([left.data, right_data], 0),
        restrict=combine_restrict(
            left.data.shape[0], left.restrict, right_data.shape[0], right.restrict
        ),
        origin=np.concatenate([left.origin, right.origin]),
        extras=[merged_out],
    )
    return StepOutcome(node=merged, pairs=np.stack([s1, s2], axis=1),
                       lost_var=np.full(nb, np.nan))


def mnn_correct(
    batches_or_single,
    batch: Optional[Sequence] = None,
    *,
    k: int = 20,
    prop_k: Optional[float] = None,
    sigma: float = 0.1,
    cos_norm_in: bool = True,
    cos_norm_out: bool = True,
    svd_dim: int = 0,
    var_adj: bool = True,
    subset_row: Optional[np.ndarray] = None,
    correct_all: bool = False,
    restrict=None,
    merge_order=None,
    auto_merge: bool = False,
    batch_names: Optional[Sequence[str]] = None,
    knn_method: str = "exact",
    cell_names=None,
    gene_names=None,
    out_on_host: bool = False,
    device: DeviceLike = None,
) -> MNNResult:
    """Classic MNN correction (reference mnnCorrect, R/mnnCorrect.R:125-168).

    Input: list of (N_b, G) matrices (cells in rows) or a single matrix plus
    ``batch``, arrays or tensors, moved to ``device`` (default: the CUDA
    device; raises without one unless ``device="cpu"``). Output
    ``corrected`` is (N_total, G_out) per-gene values in input cell order
    (G_out = subset size unless correct_all). ``cell_names``/``gene_names``
    propagate to the result like the reference's .rename_output
    (R/utils_multibatch.R:3-33).

    ``out_on_host`` (requires a list input with ``subset_row`` +
    ``correct_all``) keeps the full-gene out-matrices as host numpy arrays
    for the whole run: only the gene-subset in-matrices and per-step
    operands (gathered MNN rows, the right side's correction) occupy device
    memory, and ``corrected`` is a host array.
    """
    dev = resolve_device(device)
    single = not isinstance(batches_or_single, (list, tuple))
    if out_on_host:
        if single:
            raise ValueError("out_on_host requires a list of per-batch matrices")
        if subset_row is None or not correct_all:
            raise ValueError(
                "out_on_host only applies when subset_row is given with "
                "correct_all=True (otherwise in == out and the working set "
                "is already the subset)"
            )
    if single:
        x = as_tensor(batches_or_single, dev)
        if batch is None:
            raise ValueError("'batch' must be specified for a single input matrix")
        divided = divide_into_batches(
            np.arange(x.shape[0]), batch, cells_in_rows=True, restrict=restrict
        )
        batches = [x[as_tensor(idx, dev, torch.long)] for idx in divided.batches]
        restrict = divided.restricted
        if batch_names is None:
            batch_names = [str(n) for n in divided.names]
    else:
        divided = None
        if out_on_host:
            batches = [b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
                       for b in batches_or_single]
        else:
            batches = [as_tensor(b, dev) for b in batches_or_single]
        if len(batches) < 2:
            raise ValueError("at least two batches must be specified")
        check_batch_consistency(batches, cells_in_rows=True)
        restrict = check_restrictions(batches, restrict, cells_in_rows=True)

    nb = len(batches)
    in_b, out_b, subset_row, same_set = _prepare_input_data(
        batches, cos_norm_in, cos_norm_out, subset_row, correct_all, dev,
        host_out=out_on_host,
    )
    if restrict is None:
        restrict = [None] * nb

    step = functools.partial(_merge_step, k=k, prop_k=prop_k, sigma=sigma, svd_dim=svd_dim,
                             var_adj=var_adj, same_set=same_set, subset_row=subset_row,
                             knn_method=knn_method, device=dev, nb=nb)
    corrected, labels, merge_info = walk_merge_tree(
        [MergeNode.leaf(i, in_b[i], restrict[i], extras=[None] if same_set else [out_b[i]])
         for i in range(nb)],
        step, merge_order=merge_order, names=batch_names, auto_merge=auto_merge,
        count=functools.partial(_count_pairs_noorth, k=k, prop_k=prop_k),
        output=lambda node: node.data if same_set else node.extras[0],
    )
    out = MNNResult(
        corrected=corrected,
        batch=labels,
        merge_info=merge_info,
        batch_names=list(batch_names) if batch_names is not None else None,
    )
    return finish_output(out, divided, [b.shape[0] for b in batches], cell_names=cell_names,
                         gene_names=gene_names, subset_row=subset_row,
                         correct_all=correct_all)
