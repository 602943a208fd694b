"""Scaling normalization across batches.

Counterpart of ``batchelor_tpu/ops/normalization.py``: multiBatchNorm
(reference R/multiBatchNorm.R:92-280) plus the scuttle primitives it leans
on (librarySizeFactors, calculateAverage, logNormCounts, reference
NAMESPACE:125-132). Per-batch size factors are rescaled by DESeq-style
median ratios so every batch matches the lowest-coverage batch, then the
counts are log-transformed. The per-cell and per-gene reductions run on the
tensors' device; the pairwise median ratios (a few gene vectors) on the
host in numpy, as in the JAX package.

Orientation: cells in rows (N, G); per-cell size factors are length N.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, as_tensor, resolve_device
from ..utils.batching import divide_into_batches
from .cosine_norm import subset_columns

__all__ = [
    "library_size_factors",
    "calculate_average",
    "log_norm_counts",
    "rescale_size_factors",
    "multi_batch_norm",
    "MultiBatchNormResult",
]


def library_size_factors(counts: torch.Tensor, subset_row=None) -> torch.Tensor:
    """Per-cell library-size factors, centred to unit mean
    (scuttle::librarySizeFactors equivalent)."""
    x = counts if subset_row is None else subset_columns(counts, subset_row)
    lib = x.sum(1)
    return lib / lib.mean()


def calculate_average(counts: torch.Tensor, size_factors: torch.Tensor,
                      subset_row=None) -> torch.Tensor:
    """Per-gene average of size-factor-normalized counts
    (scuttle::calculateAverage equivalent)."""
    x = counts if subset_row is None else subset_columns(counts, subset_row)
    sf = size_factors / size_factors.mean()
    return (x / sf[:, None]).mean(0)


def log_norm_counts(
    counts: torch.Tensor,
    size_factors: torch.Tensor,
    pseudo_count: float = 1.0,
    log_base: float = 2.0,
    center: bool = False,
) -> torch.Tensor:
    """log_base(count/sf + pseudo) (scuttle::logNormCounts equivalent).

    multiBatchNorm always passes center.size.factors=FALSE since the factors
    are already cross-batch rescaled (reference R/multiBatchNorm.R:141)."""
    sf = size_factors / size_factors.mean() if center else size_factors
    # the divisor rounded to the counts' dtype first, as jnp.log(asarray(base))
    base = torch.log(torch.tensor(log_base, dtype=counts.dtype))
    return torch.log(counts / sf[:, None] + pseudo_count) / base.to(counts.device)


def rescale_size_factors(
    averages: Sequence,
    size_factors: Sequence,
    min_mean: float = 1.0,
) -> List:
    """Median-ratio rescaling to the lowest-coverage batch.

    Mirrors .rescale_size_factors (reference R/multiBatchNorm.R:237-280):
    for each batch pair, genes passing the min_mean filter on the pair's
    grand mean contribute a median count ratio; all batches are divided by
    their ratio against the lowest-coverage batch. Ratios are computed in
    both directions for order invariance, exactly as the reference does.
    Host arrays give host arrays; tensors stay on their device.
    """
    nb = len(averages)
    avgs = [a.detach().cpu().double().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a, dtype=np.float64) for a in averages]
    ratios = np.ones((nb, nb))
    for first in range(nb - 1):
        fa = avgs[first]
        fs = fa.sum()
        for second in range(first + 1, nb):
            sa = avgs[second]
            ss = sa.sum()
            grand = (fa / fs + sa / ss) / 2 * (fs + ss) / 2
            keep = grand >= min_mean
            kf, ks = fa[keep], sa[keep]
            with np.errstate(divide="ignore", invalid="ignore"):
                r1 = np.median(ks / kf)
                r2 = np.median(kf / ks)
            if not np.isfinite(r1) or r1 == 0 or not np.isfinite(r2) or r2 == 0:
                raise ValueError(
                    "median ratio of averages between batches is not finite"
                )
            ratios[first, second] = r1
            ratios[second, first] = r2

    smallest = int(np.argmin(ratios.min(axis=0)))
    rescaling = ratios[:, smallest]
    out = []
    for i, sf in enumerate(size_factors):
        if isinstance(sf, torch.Tensor):
            # the ratio rounded to the factors' dtype, as the JAX package does
            out.append(sf / torch.tensor(rescaling[i], dtype=sf.dtype).to(sf.device))
        else:
            sf = np.asarray(sf)
            out.append((sf / rescaling[i]).astype(sf.dtype, copy=False))
    return out


@dataclass
class MultiBatchNormResult:
    """Outputs of :func:`multi_batch_norm`: per-batch log-normalized
    matrices and the rescaled per-cell size factors (lists for list input;
    a single input-order matrix/vector for single-input
    ``preserve_single``, mirroring the reference's return contract)."""

    logcounts: Any
    size_factors: Any


def multi_batch_norm(
    batches,
    batch: Optional[Sequence] = None,
    *,
    size_factors: Optional[Sequence] = None,
    min_mean: float = 1.0,
    subset_row=None,
    normalize_all: bool = False,
    pseudo_count: float = 1.0,
    log_base: float = 2.0,
    preserve_single: bool = True,
    device: DeviceLike = None,
) -> MultiBatchNormResult:
    """Cross-batch scaling normalization (reference multiBatchNorm).

    ``batches``: per-batch count matrices (N_b, G), or a single (N, G)
    matrix together with a per-cell ``batch`` factor
    (reference R/multiBatchNorm.R:93-121); arrays or tensors, moved to
    ``device`` (default: the CUDA device; raises without one unless
    ``device="cpu"``). With a single input and ``preserve_single`` (the
    default, like the reference), the result's ``logcounts``/
    ``size_factors`` are the single re-assembled (N, G) matrix / (N,)
    vector in the input cell order (R/multiBatchNorm.R:57, :105-116);
    otherwise the input is fragmented per batch level (sorted like R
    factors) and a list is returned.

    Per-batch statistics use ``subset_row`` genes; the output is subsetted
    too unless ``normalize_all`` (reference R/multiBatchNorm.R:140-170).
    """
    dev = resolve_device(device)
    opts = dict(min_mean=min_mean, subset_row=subset_row, normalize_all=normalize_all,
                pseudo_count=pseudo_count, log_base=log_base)
    if not isinstance(batches, (list, tuple)):
        x = as_tensor(batches, dev)
        if batch is None:
            raise ValueError(
                "'batch' must be specified if a single matrix is supplied"
            )
        divided = divide_into_batches(
            np.arange(x.shape[0]), batch, cells_in_rows=True
        )
        idx_per = [as_tensor(np.asarray(i), dev, torch.long) for i in divided.batches]
        per = [x[i] for i in idx_per]
        per_sf = None
        if size_factors is not None:
            sfv = as_tensor(size_factors, dev)
            if sfv.shape[0] != x.shape[0]:
                raise ValueError(
                    "'size_factors' must have one entry per cell for a "
                    "single input"
                )
            per_sf = [sfv[i] for i in idx_per]
        out = multi_batch_norm(per, size_factors=per_sf, device=dev, **opts)
        if not preserve_single:
            return out
        # re-assemble in input cell order (reference preserve.single)
        inv = as_tensor(divided.reorder, dev, torch.long)
        logc = torch.cat(out.logcounts, 0)[inv]
        sf = torch.cat(out.size_factors, 0)[inv]
        return MultiBatchNormResult(logcounts=logc, size_factors=sf)

    if batch is not None:
        raise ValueError("'batch' is only used with a single input matrix")
    batches = [as_tensor(b, dev) for b in batches]
    if len(batches) == 0:
        raise ValueError("at least one batch must be supplied")

    sfs, avgs = [], []
    for i, b in enumerate(batches):
        sf = None if size_factors is None else size_factors[i]
        if sf is None:
            sf = library_size_factors(b, subset_row=subset_row)
        else:
            sf = as_tensor(sf, dev)
            sf = sf / sf.mean()
        sfs.append(sf)
        avgs.append(calculate_average(b, sf, subset_row=subset_row))

    rescaled = rescale_size_factors(avgs, sfs, min_mean=min_mean)

    out = []
    for b, sf in zip(batches, rescaled):
        mat = b
        if subset_row is not None and not normalize_all:
            mat = subset_columns(mat, np.asarray(subset_row))
        out.append(log_norm_counts(mat, sf, pseudo_count=pseudo_count,
                                   log_base=log_base, center=False))
    return MultiBatchNormResult(logcounts=out, size_factors=rescaled)
