"""Plain quickCorrect up to the HVGs, written from the published algorithm:
the reference that decides ``correct`` for a ``quick_correct`` cell's
normalization, variance model and HVG choice, and, at a lower precision,
its control. Its fastMNN part is ``gpubench/reference.py`` plus the
rotation of every gene (``all_gene_rotation``).

It imports nothing of the program. The steps, on batches of raw counts
(cells in rows), each batch worked through in blocks of rows so that no
float64 copy of a whole batch exists:

  * ``size_factors`` (batchelor's multiBatchNorm, R/multiBatchNorm.R, with
    scuttle's librarySizeFactors and calculateAverage): each cell's
    library size over its batch's mean; each gene's average of the counts
    over those factors; for every pair of batches the median ratio of
    their averages over the genes whose grand mean (the two batches'
    shares averaged, times their mean total) is at least ``min_mean``, in
    both directions; every batch's factors divided by its ratio to the
    batch of lowest coverage (the column of the ratio table with the
    smallest entry).
  * ``log_counts``: log2(count / factor + 1).
  * ``variance_model`` (scran's modelGeneVar, combineVar, getTopHVGs): each
    batch's per-gene mean and variance (n - 1); the trend of variance on
    mean (``fit_trend``); ``tech`` the trend at each gene's mean, ``bio``
    the variance less ``tech``; the batches averaged with equal weights;
    the HVGs the genes of largest ``bio`` above 0, ranked stably.
  * ``fit_trend`` (scran's fitTrendVar, parametric): the curve
    y = a x / (x^n + b) fitted to the genes of positive mean and variance
    by least squares in log space, with ``a`` in closed form for each
    (n, b) of a 15 x 29 grid, n from 0.5 to 4 and b around
    median(x)^mean(n) from e^-7 to e^7, then again on a 9 x 9 grid around
    the winner (n +- 0.3, b e^+-0.7); then a tricube local-linear smoother
    of log(y / curve) against x, each query's window the ceil(0.3 m)
    genes (of the m fitted) that sit around the query's place in the
    sorted means, its bandwidth the window's farthest gene; the trend is
    the curve times exp of that smooth, which may be negative, so the trend
    may fall below its curve, as scran's does.

Departures from scran, which the program's stand-in makes and this
reference follows, so that the comparison reads the program's
arithmetic and not its choice of method: the curve is fitted on a grid
and not by ``nls`` from a start; the smoother is one local-linear pass
with no robustness iterations, its window the run of sorted genes
centred on the query's place (loess takes the query's nearest
neighbours); every gene of positive mean and variance is fitted (scran
leaves out means below 0.1); where the curve cannot be fitted, the
variances themselves are smoothed (scran smooths their log);
``combineVar`` averages with equal weights and no p-values.

``dtype``: ``torch.float64`` is the reference. The control passes
``torch.float32`` with ``bf16=True``: the log-counts rounded to bfloat16
before the moments, the moments, the factors and the trend fit in
float32.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np
import torch

__all__ = ["size_factors", "log_counts", "fit_trend", "variance_model", "VarianceModel",
           "hvg_log_counts", "all_gene_rotation", "FIELDS"]

FIELDS = ("mean", "total", "tech", "bio")
_BLOCK_ELEMS = 1 << 26          # elements of one block of rows
_SPAN = 0.3


def _blocks(x: torch.Tensor):
    step = max(1, _BLOCK_ELEMS // max(1, x.shape[1]))
    for r0 in range(0, x.shape[0], step):
        yield r0, x[r0:r0 + step]


def log_counts(block: torch.Tensor, factors: torch.Tensor, dtype=torch.float64,
               bf16: bool = False) -> torch.Tensor:
    """log2(count / factor + 1) of a block of rows and their factors."""
    out = torch.log2(block.to(dtype) / factors.to(dtype)[:, None] + 1.0)
    return out.to(torch.bfloat16).to(dtype) if bf16 else out


def size_factors(counts: Sequence[torch.Tensor], min_mean: float = 1.0,
                 dtype=torch.float64) -> List[torch.Tensor]:
    """Each batch's per-cell size factors, rescaled across batches."""
    factors, averages = [], []
    for x in counts:
        lib = torch.cat([b.to(dtype).sum(1) for _, b in _blocks(x)])
        sf = lib / lib.mean()
        avg = torch.zeros(x.shape[1], dtype=dtype, device=x.device)
        for r0, b in _blocks(x):
            avg += (b.to(dtype) / sf[r0:r0 + b.shape[0], None]).sum(0)
        factors.append(sf)
        averages.append((avg / x.shape[0]).cpu().numpy().astype(np.float64))
    nb = len(counts)
    ratios = np.ones((nb, nb))
    for i in range(nb):
        for j in range(i + 1, nb):
            a, b = averages[i], averages[j]
            ta, tb = a.sum(), b.sum()
            grand = (a / ta + b / tb) / 2 * (ta + tb) / 2
            keep = grand >= min_mean
            with np.errstate(divide="ignore", invalid="ignore"):
                ratios[i, j] = np.median(b[keep] / a[keep])
                ratios[j, i] = np.median(a[keep] / b[keep])
    if not np.all(np.isfinite(ratios) & (ratios > 0)):
        raise ValueError("a median ratio of averages between batches is not finite and positive")
    lowest = int(np.argmin(ratios.min(axis=0)))
    return [sf / float(ratios[i, lowest]) for i, sf in enumerate(factors)]


def _moments(x: torch.Tensor, sf: torch.Tensor, dtype, bf16: bool):
    """Per-gene mean and variance (n - 1) of a batch's log-counts, in two
    passes over its blocks."""
    total = torch.zeros(x.shape[1], dtype=dtype, device=x.device)
    for r0, b in _blocks(x):
        total += log_counts(b, sf[r0:r0 + b.shape[0]], dtype, bf16).sum(0)
    mean = total / x.shape[0]
    sq = torch.zeros_like(mean)
    for r0, b in _blocks(x):
        sq += ((log_counts(b, sf[r0:r0 + b.shape[0]], dtype, bf16) - mean) ** 2).sum(0)
    return mean, sq / (x.shape[0] - 1)


def _median(x: torch.Tensor) -> torch.Tensor:
    s = torch.sort(x).values
    n = s.numel()
    return s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2


def _curve_fit(x: torch.Tensor, y: torch.Tensor):
    """(a, b, n) of y ~ a x / (x^n + b), or None where the fit is not finite."""
    lx, ly = torch.log(x), torch.log(y)

    def best(n_grid, b_grid):
        pen = torch.log(x[None, None, :] ** n_grid[:, None, None] + b_grid[None, :, None])
        la = (ly - lx + pen).mean(-1)
        sse = ((ly - (la[..., None] + lx - pen)) ** 2).sum(-1)
        i = int(torch.argmin(sse.reshape(-1)))
        r, c = divmod(i, b_grid.numel())
        return float(sse[r, c]), math.exp(float(la[r, c])), float(b_grid[c]), float(n_grid[r])

    opts = dict(dtype=x.dtype, device=x.device)
    n_grid = torch.linspace(0.5, 4.0, 15, **opts)
    b_grid = float(_median(x)) ** float(n_grid.mean()) * torch.exp(torch.linspace(-7.0, 7.0, 29, **opts))
    _, a, b, n = best(n_grid, b_grid)
    n_grid = torch.linspace(max(n - 0.3, 0.1), n + 0.3, 9, **opts)
    b_grid = b * torch.exp(torch.linspace(-0.7, 0.7, 9, **opts))
    sse, a, b, n = best(n_grid, b_grid)
    return (a, b, n) if math.isfinite(sse) else None


def _curve(q: torch.Tensor, a: float, b: float, n: float) -> torch.Tensor:
    q = torch.clamp(q, min=0.0)
    return a * q / (q ** n + b)


def _smooth(x: torch.Tensor, y: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The tricube local-linear smoother of y on x at the queries q. Each
    query's window is the ceil(0.3 m) points (of the m given) around its
    place in the sorted x, its bandwidth the window's farthest point; a
    window whose points all sit at the query weighs them alike; a window
    whose x are all equal, or whose weights are all 0, gives its mean."""
    order = torch.argsort(x, stable=True)
    xs, ys = x[order], y[order]
    m = xs.numel()
    window = max(math.ceil(_SPAN * m), 2)
    offs = torch.arange(window, device=x.device)
    out = torch.empty_like(q)
    rows = max(1, _BLOCK_ELEMS // window)
    for c0 in range(0, q.numel(), rows):
        qi = q[c0:c0 + rows, None]
        lo = torch.clamp(torch.searchsorted(xs, qi[:, 0]) - window // 2, 0, m - window)
        idx = lo[:, None] + offs
        xw, yw = xs[idx], ys[idx]
        dist = (xw - qi).abs()
        h = dist.amax(1, keepdim=True)
        u = torch.where(h > 0, dist / torch.where(h > 0, h, torch.ones_like(h)),
                        torch.zeros_like(dist))
        w = (1 - u ** 3) ** 3
        sw = w.sum(1, keepdim=True)
        ok = sw[:, 0] > 0
        sw = torch.where(sw > 0, sw, torch.ones_like(sw))
        xm, ym = (w * xw).sum(1, keepdim=True) / sw, (w * yw).sum(1, keepdim=True) / sw
        den = (w * (xw - xm) ** 2).sum(1)
        num = (w * (xw - xm) * (yw - ym)).sum(1)
        slope = torch.where(den > 0, num / torch.where(den > 0, den, torch.ones_like(den)),
                            torch.zeros_like(den))
        fit = ym[:, 0] + slope * (qi[:, 0] - xm[:, 0])
        out[c0:c0 + rows] = torch.where(ok, fit, yw.mean(1))
    return out


def fit_trend(mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """The fitted trend of variance on mean, at each gene's mean: the curve
    times exp of the smoothed log-ratio, which may be negative. Where fewer
    than 4 genes have positive mean and variance, or the curve's fit is not
    finite, the smoother of the variances themselves, floored at 0; with
    fewer than 2 genes, their mean."""
    ok = torch.isfinite(mean) & torch.isfinite(var)
    x, y = mean[ok], var[ok]
    if x.numel() < 2:
        return torch.full_like(mean, float(y.mean()) if y.numel() else 0.0)
    pos = (x > 0) & (y > 0)
    fit = _curve_fit(x[pos], y[pos]) if int(pos.sum()) >= 4 else None
    if fit is None:
        return torch.clamp(_smooth(x, y, mean), min=0.0)
    xp = x[pos]
    ratio = _smooth(xp, torch.log(y[pos] / _curve(xp, *fit)), mean)
    out = _curve(mean, *fit) * torch.exp(ratio)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


@dataclass
class VarianceModel:
    """The pipeline's result up to the HVGs: each batch's size factors, the
    combined decomposition (``FIELDS``, host float64) and the HVGs."""

    factors: List[torch.Tensor]
    dec: Dict[str, np.ndarray]
    hvgs: np.ndarray


def variance_model(counts: Sequence[torch.Tensor], min_mean: float, hvg_n: int,
                   dtype=torch.float64, bf16: bool = False) -> VarianceModel:
    """Normalization, each batch's variance model, their equal-weight
    combination and the top ``hvg_n`` genes by ``bio``."""
    factors = size_factors(counts, min_mean, dtype)
    sums = {f: 0.0 for f in FIELDS}
    for x, sf in zip(counts, factors):
        mean, total = _moments(x, sf, dtype, bf16)
        tech = fit_trend(mean, total)
        for f, v in zip(FIELDS, (mean, total, tech, total - tech)):
            sums[f] = sums[f] + v
    dec = {f: (v / len(counts)).cpu().numpy().astype(np.float64) for f, v in sums.items()}
    order = np.argsort(-dec["bio"], kind="stable")
    hvgs = order[dec["bio"][order] > 0][:hvg_n]
    return VarianceModel(factors=factors, dec=dec, hvgs=hvgs)


def hvg_log_counts(counts: Sequence[torch.Tensor], factors: Sequence[torch.Tensor],
                   hvgs: np.ndarray, dtype=torch.float64, bf16: bool = False) -> List[torch.Tensor]:
    """Each batch's log-counts of the genes ``hvgs``, in that order."""
    cols = torch.as_tensor(np.asarray(hvgs), device=counts[0].device)
    return [torch.cat([log_counts(b[:, cols], sf[r0:r0 + b.shape[0]], dtype, bf16)
                       for r0, b in _blocks(x)]) for x, sf in zip(counts, factors)]


def all_gene_rotation(ar, counts: Sequence[torch.Tensor], factors: Sequence[torch.Tensor],
                      hvgs: np.ndarray, pcs: Sequence[torch.Tensor] = None,
                      rotation: torch.Tensor = None, bf16: bool = False):
    """(rotation (G, d), centers (G,)) of every gene, as R/multiBatchPCA.R's
    ``get.all.genes`` gives them: each cell's log-counts of all genes over
    its L2 norm on the HVGs, centred by the equal-weight mean of the batch
    means, projected on the PCA's left singular vectors: rotation =
    sum_b X_b^T P_b / N_b / s^2, with P_b the batch's PCs and s^2 = sum_b
    |P_b|^2 / N_b each component's eigenvalue. On the HVGs this gives the
    eigenvectors back. The PCs are ``pcs`` (from ``reference.pca`` on
    ``hvgs``), or, given the HVGs' ``rotation`` (len(hvgs), d) instead,
    the HVG part of each centred row times it. ``ar``:
    ``reference.Arith`` of the products."""
    cols = torch.as_tensor(np.asarray(hvgs), device=counts[0].device)

    def normed(x, sf):
        for r0, b in _blocks(x):
            lc = log_counts(b, sf[r0:r0 + b.shape[0]], ar.dtype, bf16)
            l2 = torch.clamp(torch.sqrt((lc[:, cols] ** 2).sum(1, keepdim=True)), min=1e-8)
            yield r0, ar.other(lc / l2)

    means = [sum(b.sum(0) for _, b in normed(x, sf)) / x.shape[0] for x, sf in zip(counts, factors)]
    centers = sum(means) / len(counts)
    d = (pcs[0] if rotation is None else rotation).shape[1]
    acc = torch.zeros((counts[0].shape[1], d), dtype=ar.dtype, device=counts[0].device)
    eig = torch.zeros(d, dtype=ar.dtype, device=counts[0].device)
    rot = None if rotation is None else ar.cast(rotation)
    for i, (x, sf) in enumerate(zip(counts, factors)):
        p = ar.cast(pcs[i]) if rotation is None else None
        for r0, b in normed(x, sf):
            c = b - centers
            pb = p[r0:r0 + b.shape[0]] if rot is None else ar.mm(c[:, cols], rot)
            acc += ar.mm(c.T, pb) / x.shape[0]
            eig += (pb * pb).sum(0) / x.shape[0]
    return acc / eig, centers
