"""Quantile-matching variance adjustment of correction vectors.

Counterpart of ``batchelor_tpu/ops/shift_variance.py`` (reference C++
kernel src/adjust_shift_variance.cpp:29-164), the anti-"kissing" scaling of
classic mnnCorrect. The per-cell loop with inner O(N) passes becomes dense
products over (C x N2) and (C x N1) blocks of query cells plus a sorted
cumulative sum.

For each cell c of batch 2 with correction vector v_c:
  * project every batch-2 cell onto g_c = v_c/||v_c||; weight each by a
    Gaussian kernel on its squared distance to the line through c along g_c;
  * the cell's within-batch quantile = weighted fraction of (restricted)
    batch-2 cells with projection <= its own;
  * find the matching weighted quantile among (restricted) batch-1 cells'
    projections; the scaling is (ref_quantile - own_projection)/||v_c||.
Scaling is clamped to >= 1 (reference R/mnnCorrect.R:479).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import as_tensor, full_fp32_matmul
from .knn_cuda import default_max_bytes

__all__ = ["adjust_shift_variance"]

_RADIX_BITS = 24      # quantization resolution (2^-24 of the per-row range)
_BLOCK_TEMPS = 16     # (C, N1 + N2) temporaries a block holds at once, the sort's included


def _block_rows(n1: int, n2: int, itemsize: int, max_bytes: int) -> int:
    """Query cells per block so that a block's (C, N1 + N2) temporaries stay
    within ``max_bytes``."""
    return max(1, min(n2, max_bytes // (_BLOCK_TEMPS * itemsize * max(1, n1 + n2))))


def _ref_quantile_radix(proj, w, valid, target, bits: int = _RADIX_BITS):
    """Weighted-quantile crossing value per row by bitwise radix descent.

    For each row c, (approximately) the smallest projection p among valid
    cells with  sum_{proj[c,k] <= p} w[c,k] >= target[c]  (reference
    src/adjust_shift_variance.cpp:120-141). Projections are quantized to
    ``bits`` bits of the per-row [min, max] range and the quantile bin is
    found one bit at a time by one masked row sum a bit, with no sort. The
    crossing cell is resolved to 2^-bits of the row range. ``w`` must be 0
    at invalid cells. Rows whose target exceeds the total weight take the
    max valid projection, like the sort path."""
    acc = proj.dtype
    inf = float("inf")
    lo = torch.where(valid, proj, inf).amin(1)
    hi = torch.where(valid, proj, -inf).amax(1)
    span = torch.clamp(hi - lo, min=torch.finfo(acc).tiny)
    nbins = 2.0 ** bits
    idx = torch.clamp(torch.floor((proj - lo[:, None]) / span[:, None] * nbins),
                      0.0, nbins - 1.0).to(torch.int32)
    pref = torch.zeros(proj.shape[0], device=proj.device, dtype=torch.int32)
    c0 = torch.zeros(proj.shape[0], device=proj.device, dtype=acc)
    for k in range(bits - 1, -1, -1):
        # weight in the left half of the current prefix at bit k
        match_left = (idx >> k) == (pref << 1)[:, None]
        s_left = torch.where(match_left, w, 0.0).sum(1)
        go_left = c0 + s_left >= target
        pref = (pref << 1) | (~go_left).to(torch.int32)
        c0 = torch.where(go_left, c0, c0 + s_left)
    in_bin = valid & (idx == pref[:, None])
    q = torch.where(in_bin, proj, inf).amin(1)
    # fp safety nets: empty bin -> smallest value at/above the bin floor;
    # no crossing at all -> max valid projection (the sort path's last_valid)
    bin_lo = lo + pref.to(acc) / nbins * span
    above = valid & (proj >= bin_lo[:, None])
    q_above = torch.where(above, proj, inf).amin(1)
    q = torch.where(torch.isfinite(q), q, q_above)
    crossed = w.sum(1) >= target
    return torch.where(crossed & torch.isfinite(q), q, hi)


def _block(gch, d2ch, sq2ch, l2ch, rows, d1, d2, sq1, sq2, sigma2, mask1, mask2,
           n_valid, use_radix: bool):
    """Scalings of one block of query cells: every matrix is (C, N1) or
    (C, N2), so memory stays O(C N) while the work is O(N^2 G).

    Weights are Gaussian log-probs shifted by the row max and exponentiated
    once (w = exp(lp - max lp)): every comparison below is between weight
    sums scaled by the same per-row constant, so the quantile search is
    exact, and the shifted form cannot underflow to an all-zero row at
    small sigma."""
    n2 = d2.shape[0]
    with full_fp32_matmul():
        P2 = gch @ d2.T                                 # (C, N2)
        G22 = d2ch @ d2.T
        P1 = gch @ d1.T                                 # (C, N1)
        C12 = d2ch @ d1.T
    # own projection read from the same product row: duplicated cells then
    # compare bitwise-equal to their twins, as the C++ does
    curproj = P2.gather(1, torch.clamp(rows, 0, n2 - 1)[:, None])[:, 0]
    diff_par = curproj[:, None] - P2
    dist2 = sq2ch[:, None] + sq2[None, :] - 2.0 * G22 - diff_par * diff_par
    lp2 = -torch.clamp(dist2, min=0.0) / sigma2
    eye = rows[:, None] == torch.arange(n2, device=rows.device)[None, :]
    lp2 = torch.where(eye, 0.0, lp2)                    # self: log-prob 0
    add_mask = (P2 <= curproj[:, None]) | eye
    lp2_all = torch.where(mask2[None, :], lp2, float("-inf"))
    m2 = lp2_all.amax(1, keepdim=True)
    m2 = torch.where(torch.isfinite(m2), m2, 0.0)
    w2 = torch.exp(lp2_all - m2)                        # (C, N2), in [0, 1]
    den2 = w2.sum(1)
    num2 = torch.where(add_mask, w2, 0.0).sum(1)
    # empty numerator (cell outside restrict2 with no admissible cells):
    # the C++ leaves the accumulator at log-prob 0 (weight 1 unscaled)
    num2 = torch.where(num2 == 0.0, torch.exp(-m2[:, 0]), num2)
    prob2 = num2 / den2                                 # the scale cancels

    diff_par1 = curproj[:, None] - P1
    dist1 = sq2ch[:, None] + sq1[None, :] - 2.0 * C12 - diff_par1 * diff_par1
    lw1 = torch.where(mask1[None, :], -torch.clamp(dist1, min=0.0) / sigma2, float("-inf"))
    m1 = lw1.amax(1, keepdim=True)
    m1 = torch.where(torch.isfinite(m1), m1, 0.0)
    w1 = torch.exp(lw1 - m1)                            # shared exp(-m1) scale

    if use_radix:
        valid1 = mask1[None, :].expand_as(P1)
        ref_quan = _ref_quantile_radix(P1, w1, valid1, prob2 * w1.sum(1))
        return (ref_quan - curproj) / l2ch
    key = torch.where(mask1[None, :], P1, float("inf"))
    proj_sorted, perm = torch.sort(key, dim=1, stable=True)
    cum = torch.cumsum(w1.gather(1, perm), 1)
    # the total weight is the cumsum's own last entry, so a cell at the top
    # of its batch (prob2 = 1) crosses where the cumsum reaches it, whatever
    # order another reduction would add the weights in
    crossed = cum >= (prob2 * cum[:, -1])[:, None]
    first = crossed.to(torch.int8).argmax(1)            # first crossing
    last = torch.clamp(n_valid - 1, min=0).view(1, 1).expand(proj_sorted.shape[0], 1)
    last_valid = proj_sorted.gather(1, last)[:, 0]
    ref_quan = torch.where(crossed.any(1), proj_sorted.gather(1, first[:, None])[:, 0],
                           last_valid)
    return (ref_quan - curproj) / l2ch


def _adjust(data1, data2, correction, sigma2, mask1, mask2, use_radix: bool,
            block_rows: int):
    acc = torch.promote_types(data1.dtype, torch.float32)
    d1 = data1.to(acc)
    d2 = data2.to(acc)
    corr = correction.to(acc)
    sigma2 = sigma2.to(acc)
    l2 = torch.sqrt((corr * corr).sum(1))               # (N2,)
    grads = torch.where(l2[:, None] > 0, corr / torch.where(l2 == 0, 1.0, l2)[:, None], corr)
    sq2 = (d2 * d2).sum(1)
    sq1 = (d1 * d1).sum(1)
    n_valid = mask1.sum()
    rows = torch.arange(d2.shape[0], device=d2.device)
    out = []
    for c0 in range(0, d2.shape[0], block_rows):
        sl = slice(c0, c0 + block_rows)
        out.append(_block(grads[sl], d2[sl], sq2[sl], l2[sl], rows[sl], d1, d2, sq1, sq2,
                          sigma2, mask1, mask2, n_valid, use_radix))
    return torch.cat(out)


def _row_mask(n: int, restrict, device: torch.device) -> torch.Tensor:
    m = np.zeros(n, dtype=bool)
    if restrict is None:
        m[:] = True
    else:
        m[np.asarray(restrict)] = True
    return as_tensor(m, device)


def adjust_shift_variance(
    data1,
    data2,
    correction,
    sigma2: float,
    restrict1: Optional[np.ndarray] = None,
    restrict2: Optional[np.ndarray] = None,
    subset_row: Optional[np.ndarray] = None,
    quantile_method: str = "sort",
    *,
    block_rows: Optional[int] = None,
) -> torch.Tensor:
    """Per-cell scaled correction vectors (reference .adjust_shift_variance,
    R/mnnCorrect.R:462-481).

    data1/data2: (N1, G)/(N2, G) cell-row matrices, tensors or host arrays;
    correction: an (N2, G) tensor, on whose device the work runs. With
    ``subset_row``, locations are computed on the gene subset (host arrays
    are sliced on the host, so only their subset columns reach the device)
    while the returned scaling applies to the full correction. Scaling is
    clamped to >= 1; zero-norm correction vectors are left unscaled (the C++
    gives NaN there).

    ``quantile_method``: "sort" (default; exact sorted-cumsum crossing) or
    "radix" (sort-free 24-bit descent, ``_ref_quantile_radix``; in fp32 its
    partial sums round differently from the sorted cumsum, so knife-edge
    crossings may flip by one element). Query cells go in blocks of
    ``block_rows`` (default: as many as keep a block's temporaries within
    a quarter of the device's free memory).
    """
    if quantile_method not in ("sort", "radix"):
        raise ValueError(f"unknown quantile_method {quantile_method!r}")
    dev = correction.device
    if subset_row is not None:
        s = np.asarray(subset_row)

        def _loc(x):
            if isinstance(x, np.ndarray):
                return as_tensor(x[:, s], dev)
            return as_tensor(x, dev)[:, as_tensor(s, dev, torch.long)]

        loc1, loc2 = _loc(data1), _loc(data2)
        corr_loc = correction[:, as_tensor(s, dev, torch.long)]
    else:
        loc1, loc2, corr_loc = as_tensor(data1, dev), as_tensor(data2, dev), correction

    n1, n2 = loc1.shape[0], loc2.shape[0]
    if block_rows is None:
        acc = torch.promote_types(loc1.dtype, torch.float32)
        itemsize = torch.empty((), dtype=acc).element_size()
        block_rows = _block_rows(n1, n2, itemsize, default_max_bytes(dev))
    sig = torch.full((), sigma2, dtype=loc1.dtype, device=dev)
    scaling = _adjust(loc1, loc2, corr_loc, sig, _row_mask(n1, restrict1, dev),
                      _row_mask(n2, restrict2, dev), quantile_method == "radix", block_rows)
    scaling = torch.where(torch.isfinite(scaling), scaling, 1.0)
    scaling = torch.clamp(scaling, min=1.0)
    return scaling[:, None] * correction
