"""Diagnostics: mnnDeltaVariance and cluster-abundance checks.

Counterpart of ``batchelor_tpu/correct/diagnostics.py`` (reference
R/mnnDeltaVariance.R:95-201, R/diagnostics-cluster.R:57-83). The trend fit
of host arrays is host numpy, a copy of the JAX package's but for the floor
under its smoothed log-ratio (scran has none; see ``fit_trend_var``); of
moments on the card it runs there in float64, its smoother the kernel K6.
The per-gene moments over MNN pairs and the abundance statistics run on
the port's device.
"""
from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, as_tensor, resolve_device
from ..io.csr import CSRCells, row_l2_norms
from ..ops import trend_cuda
from ..ops.cosine_norm import apply_cosine_norm, cosine_norm
from ..utils.telemetry import get_recorder, trace_span

__all__ = [
    "fit_trend_var",
    "mnn_delta_variance",
    "mnn_delta_variance_blocked",
    "cluster_abundance_test",
    "cluster_abundance_var",
    "MnnDeltaVarianceResult",
]


def _fit_parametric_curve(x: np.ndarray, y: np.ndarray):
    """Least-squares fit of y ~ a*x / (x^n + b) in log space.

    The parametric component of scran::fitTrendVar (its parametric=TRUE
    default): the curve captures the Poisson-driven rise and saturation of
    log-expression variance against the mean. Fit by a coarse (n, b) grid
    with closed-form ``a`` per point, then one refinement pass around the
    winner. Returns (curve callable, sse) or None when unfittable.
    """
    if x.size < 4:
        return None
    lx, ly = np.log(x), np.log(y)
    med = float(np.median(x))

    def solve(n_grid, b_grid):
        best = None
        for n_ in n_grid:
            xn = np.power(x, n_)
            for b_ in b_grid:
                pen = np.log(xn + b_)
                la = np.mean(ly - lx + pen)
                sse = float(np.sum((ly - (la + lx - pen)) ** 2))
                if best is None or sse < best[0]:
                    best = (sse, float(np.exp(la)), b_, n_)
        return best

    n_grid = np.linspace(0.5, 4.0, 15)
    b_grid = (med ** n_grid.mean()) * np.exp(np.linspace(-7.0, 7.0, 29))
    sse, a, b, n_ = solve(n_grid, b_grid)
    n_grid2 = np.linspace(max(n_ - 0.3, 0.1), n_ + 0.3, 9)
    b_grid2 = b * np.exp(np.linspace(-0.7, 0.7, 9))
    sse, a, b, n_ = solve(n_grid2, b_grid2)
    if not np.isfinite(sse):
        return None

    def curve(q):
        q = np.asarray(q, dtype=np.float64)
        qq = np.maximum(q, 0.0)
        return a * qq / (np.power(qq, n_) + b)

    return curve


def fit_trend_var(
    means,
    variances,
    span: float = 0.3,
    parametric: bool = True,
) -> Callable:
    """Mean-variance trend fit (scran::fitTrendVar equivalent).

    The reference delegates to scran's trend (R/mnnDeltaVariance.R:158),
    whose default is a parametric curve y = a*x/(x^n + b) fit by nls,
    multiplied by a loess smooth of the log-ratio residuals. Here:
    the same parametric curve (log-space grid+refine least squares), then a
    tricube-weighted local linear regression (loess degree 1) on the
    log-ratio. ``parametric=False`` falls back to smoothing the raw
    (mean, variance) pairs directly.

    Moments in CUDA tensors are fitted on their card in float64
    (``_fit_trend_tensors``, the smoother K6) and give a trend that takes
    and returns CUDA tensors; arrays and CPU tensors take the host numpy
    below. Each fit is a span ``trend/fit`` (``path`` ``card`` or ``host``,
    ``genes``, the ``points`` fitted and the smoother's ``window``) and
    counts in ``trend/card_fits`` or ``trend/host_fits``; each call of the
    returned trend, where the smoother runs, is a span ``trend/evaluate``.
    """
    if isinstance(means, torch.Tensor) and trend_cuda.takes(means.device):
        return _fit_trend_tensors(means, variances, span, parametric)
    means = np.asarray(means, dtype=np.float64)
    variances = np.asarray(variances, dtype=np.float64)
    ok = np.isfinite(means) & np.isfinite(variances)
    x, y = means[ok], variances[ok]
    pos = (x > 0) & (y > 0)
    curved = parametric and pos.sum() >= 4
    with _recorded_fit("host", means.size, int(pos.sum()) if curved else x.size, span):
        if x.size < 2:
            const = float(np.nanmean(y)) if y.size else 0.0
            return lambda q: np.full(np.asarray(q).shape, const)

        curve = _fit_parametric_curve(x[pos], y[pos]) if curved else None
        if curve is not None:
            # smooth the log-ratio residuals, like scran's loess on the ratio;
            # the smooth is not floored, so the trend may fall below its curve
            # as scran's does (the JAX package floors it at 0)
            ratio_trend = _local_linear(x[pos], np.log(y[pos] / curve(x[pos])), span)

            def trend_parametric(q):
                q = np.atleast_1d(np.asarray(q, dtype=np.float64))
                out = curve(q) * np.exp(ratio_trend(q))
                return np.maximum(np.where(np.isfinite(out), out, 0.0), 0.0)

            return _evaluated("host", trend_parametric)

        smooth = _local_linear(x, y, span)
        return _evaluated("host", lambda q: np.maximum(smooth(q), 0.0))


@contextlib.contextmanager
def _recorded_fit(path: str, genes: int, points: int, span: float):
    """One fit's span ``trend/fit`` and its count in ``trend/<path>_fits``."""
    rec = get_recorder()
    if rec is not None:
        rec.add(f"trend/{path}_fits")
    window = _window(span, points) if points >= 2 else 0
    with trace_span("trend/fit", path=path, genes=int(genes), points=int(points), window=window):
        yield


def _evaluated(path: str, trend: Callable) -> Callable:
    """``trend`` with each call a span ``trend/evaluate``."""
    def evaluate(q):
        with trace_span("trend/evaluate", path=path):
            return trend(q)

    return evaluate


def _window(span: float, n: int) -> int:
    """The smoother's window over n points."""
    return max(int(np.ceil(span * n)), 2)


def _local_linear(x: np.ndarray, y: np.ndarray, span: float) -> Callable[[np.ndarray], np.ndarray]:
    """The tricube-weighted local linear smoother of y on x (at least two
    points), unfloored."""
    order = np.argsort(x)
    return _sorted_local_linear(x[order], y[order], _window(span, x.size))


def _sorted_local_linear(xs: np.ndarray, ys: np.ndarray,
                         window: int) -> Callable[[np.ndarray], np.ndarray]:
    """The smoother of ys on xs, sorted by xs, over windows of ``window``
    points: the plain version of K6 (``ops/trend_cuda.py``)."""
    n = xs.size

    def trend(q):
        """Tricube-weighted local linear fit, vectorized over query points
        in chunks: each chunk's (chunk, window) arrays hold ~2^16 elements
        (0.5 MB) and stay in the core's cache; at 2^22 (32 MB) they went
        through memory and a fit of 12,303 genes took about twice as long.
        A query's numbers do not depend on the chunk it falls in."""
        q = np.atleast_1d(np.asarray(q, dtype=np.float64))
        out = np.empty(q.shape)
        step = max(1, (1 << 16) // max(window, 1))
        offs = np.arange(window)
        for c0 in range(0, q.size, step):
            qi = q[c0 : c0 + step]                       # (C,)
            pos = np.searchsorted(xs, qi)
            lo = np.clip(pos - window // 2, 0, n - window)
            idx = lo[:, None] + offs                     # (C, W)
            xw, yw = xs[idx], ys[idx]
            dist = np.abs(xw - qi[:, None])
            h = np.maximum(dist.max(axis=1, keepdims=True), 1e-12)
            w = (1 - np.minimum(dist / h, 1.0) ** 3) ** 3
            sw = w.sum(axis=1)
            sw_safe = np.maximum(sw, 1e-300)
            xm = (w * xw).sum(axis=1) / sw_safe
            ym = (w * yw).sum(axis=1) / sw_safe
            dx = xw - xm[:, None]
            den = (w * dx**2).sum(axis=1)
            num = (w * dx * (yw - ym[:, None])).sum(axis=1)
            slope = np.where(den > 1e-12, num / np.maximum(den, 1e-12), 0.0)
            fit = ym + slope * (qi - xm)
            out[c0 : c0 + step] = np.where(sw > 0, fit, yw.mean(axis=1))
        return out

    return trend


def _fit_trend_tensors(means: torch.Tensor, variances, span: float,
                       parametric: bool) -> Callable[[torch.Tensor], torch.Tensor]:
    """``fit_trend_var`` in float64 on the device of ``means``: the host's
    steps in torch, each parametric grid one batched evaluation
    (``_grid_winner``), the smoother ``trend_cuda.local_linear`` (K6 on the
    card) over the points in the order of a stable sort. The host reads two
    things a fit: the counts of finite and of positive points, which size
    the arrays and pick the degenerate branches, and whether the curve's
    least squares came out finite. The trend it returns takes and gives
    tensors on that device."""
    dev = means.device
    x = means.reshape(-1).to(torch.float64)
    y = torch.as_tensor(variances, device=dev).reshape(-1).to(torch.float64)
    ok = torch.isfinite(x) & torch.isfinite(y)
    pos = ok & (x > 0) & (y > 0)
    n_ok, n_pos = torch.stack([ok.sum(), pos.sum()]).tolist()
    curved = parametric and n_pos >= 4
    path = "card" if trend_cuda.takes(dev) else "host"
    with _recorded_fit(path, x.numel(), n_pos if curved else n_ok, span):
        if n_ok < 2:
            const = float(y[ok].mean()) if n_ok else 0.0
            return lambda q: torch.full(torch.as_tensor(q).shape, const, dtype=torch.float64,
                                        device=dev)

        def query(q):
            return torch.atleast_1d(torch.as_tensor(q, device=dev).to(torch.float64))

        if curved:
            xs, ys = _sorted_points(x, y, pos, n_pos)
            a, b, n, sse = _parametric_curve_tensors(xs, ys)
            if bool(torch.isfinite(sse)):
                def curve(q):
                    qq = q.clamp_min(0.0)
                    return a * qq / (qq**n + b)

                ratio = torch.log(ys / curve(xs))
                window = _window(span, n_pos)

                def trend_parametric(q):
                    q = query(q)
                    out = curve(q) * torch.exp(trend_cuda.local_linear(xs, ratio, q, window))
                    return torch.where(torch.isfinite(out), out, 0.0).clamp_min(0.0)

                return _evaluated(path, trend_parametric)

        xs, ys = _sorted_points(x, y, ok, n_ok)
        window = _window(span, n_ok)
        return _evaluated(
            path, lambda q: trend_cuda.local_linear(xs, ys, query(q), window).clamp_min(0.0))


def _sorted_points(x: torch.Tensor, y: torch.Tensor, keep: torch.Tensor, count: int):
    """The ``count`` points that ``keep`` marks, sorted by x (stable)."""
    key, order = torch.sort(torch.where(keep, x, torch.inf), stable=True)
    return key[:count], y[order[:count]]


@functools.lru_cache(maxsize=8)
def _grid_steps(device: torch.device):
    """``_fit_parametric_curve``'s grid constants, from the same numpy, on
    ``device``: the exponents, the coarse and the refined steps of b, and
    0..8 for the refined exponents."""
    return tuple(torch.as_tensor(v, device=device) for v in (
        np.linspace(0.5, 4.0, 15), np.exp(np.linspace(-7.0, 7.0, 29)),
        np.exp(np.linspace(-0.7, 0.7, 9)), np.arange(9, dtype=np.float64)))


def _parametric_curve_tensors(xs: torch.Tensor, ys: torch.Tensor):
    """``_fit_parametric_curve`` on 4 or more positive points sorted by x,
    on their device: its grids and its winners, with no host read. Returns
    (a, b, n, sse), one-element tensors."""
    n_grid, steps, steps2, ar9 = _grid_steps(xs.device)
    lx, ly = torch.log(xs), torch.log(ys)
    m = xs.numel()
    med = (xs[(m - 1) // 2] + xs[m // 2]) / 2            # np.median of sorted points
    b_grid = med ** float(np.linspace(0.5, 4.0, 15).mean()) * steps
    _, _, b, n = _grid_winner(xs, lx, ly, n_grid, b_grid)
    # np.linspace(max(n - 0.3, 0.1), n + 0.3, 9), rounded as numpy rounds it
    start, stop = (n - 0.3).clamp_min(0.1), n + 0.3
    n_grid2 = torch.cat([ar9[:8] * ((stop - start) / 8) + start, stop])
    sse, la, b, n = _grid_winner(xs, lx, ly, n_grid2, b * steps2)
    return torch.exp(la), b, n, sse


def _grid_winner(x, lx, ly, n_grid: torch.Tensor, b_grid: torch.Tensor):
    """The host loop of ``_fit_parametric_curve``'s ``solve`` over n_grid x
    b_grid as one (n, b, point) evaluation: la = mean(ly - lx + pen), then
    sse = sum((ly - (la + lx - pen))^2), pen = log(x^n + b), and its winner
    (``_first_strict_min`` in n-outer order). Returns the winner's (sse,
    la, b, n), one-element tensors."""
    pen = torch.log((x ** n_grid[:, None])[:, None, :] + b_grid[None, :, None])
    la = (ly - lx + pen).mean(-1)
    sse = (ly - (la[..., None] + lx - pen)).square().sum(-1).reshape(-1)
    i = _first_strict_min(sse).reshape(1)
    nb = b_grid.numel()
    return (sse.index_select(0, i), la.reshape(-1).index_select(0, i),
            b_grid.index_select(0, i % nb), n_grid.index_select(0, i // nb))


def _first_strict_min(v: torch.Tensor) -> torch.Tensor:
    """The index that a loop keeping the first strict minimum of v picks:
    a NaN never displaces a number, and a NaN first stays."""
    key = torch.where(torch.isnan(v), torch.inf, v)
    return torch.where(torch.isnan(v[0]), 0, torch.argmin(key))


@dataclass
class MnnDeltaVarianceResult:
    """Per-gene delta-variance table (reference mnnDeltaVariance output).

    mean/total/trend/adjusted: combined (pair-count-weighted) across steps;
    per_step: list of per-merge-step dicts with the same fields.
    """

    mean: np.ndarray
    total: np.ndarray
    trend: np.ndarray
    adjusted: np.ndarray
    per_step: List[dict]


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _step_entry(mean: np.ndarray, var: np.ndarray, subset, trend_span: float) -> dict:
    """One merge step's row of the table: the trend is fitted on the
    ``subset`` genes (all when None) and evaluated on every gene."""
    sel_mean, sel_var = (mean, var) if subset is None else (mean[subset], var[subset])
    trend = fit_trend_var(sel_mean, sel_var, span=trend_span)(mean)
    return {"mean": mean, "total": var, "trend": trend, "adjusted": var - trend}


def mnn_delta_variance(
    batches: Sequence,
    pairs: Sequence[np.ndarray],
    *,
    cos_norm: bool = False,
    subset_row: Optional[np.ndarray] = None,
    compute_all: bool = False,
    trend_span: float = 0.3,
    device: DeviceLike = None,
) -> MnnDeltaVarianceResult:
    """Variance of per-gene differences across MNN pairs, trend-adjusted.

    ``batches``: per-batch (N_b, G) matrices (arrays or tensors, moved to
    ``device``: default the CUDA device; raises without one unless
    ``device="cpu"``), concatenated in input order to interpret the
    0-based pair indices (as produced by fast_mnn merge_info).
    ``pairs``: list of (P, 2) arrays, one per merge step.
    Mirrors mnnDeltaVariance (reference R/mnnDeltaVariance.R:95-201); the
    trend uses :func:`fit_trend_var`.
    """
    dev = resolve_device(device)
    mats = [as_tensor(b, dev) for b in batches]
    if cos_norm:
        l2 = [cosine_norm(m, mode="l2norm", subset_row=subset_row) for m in mats]
        ml2 = float(np.mean([float(v.mean()) for v in l2]))
        mats = [apply_cosine_norm(m, v / ml2) for m, v in zip(mats, l2)]
    x = torch.cat(mats, 0)
    if subset_row is not None and not compute_all:
        x = x[:, as_tensor(np.asarray(subset_row), dev, torch.long)]
        subset_row = None

    per_step, npairs = [], []
    for p in pairs:
        p = np.asarray(p)
        b1 = x[as_tensor(p[:, 0], dev, torch.long)]
        b2 = x[as_tensor(p[:, 1], dev, torch.long)]
        n = p.shape[0]
        var = (_host(torch.var(b1 - b2, dim=0, correction=1)) if n >= 2
               else np.full(x.shape[1], np.nan))
        mean = _host((b1.mean(0) + b2.mean(0)) / 2)
        sub = None if subset_row is None else np.asarray(subset_row)
        per_step.append(_step_entry(mean, var, sub, trend_span))
        npairs.append(n)

    return _combine_steps(per_step, npairs)


def _combine_steps(per_step, npairs) -> MnnDeltaVarianceResult:
    # combine across steps, weighting by RAW pair count, steps with >=2
    # pairs: the reference passes weights=npairs / valid=npairs>=2L
    # explicitly to scran::combineBlocks (R/mnnDeltaVariance.R:168-173),
    # overriding combineBlocks' default d.f. weighting, so raw counts are
    # the parity behavior, not a deviation.
    w = np.asarray(npairs, dtype=np.float64)
    valid = w >= 2
    if not valid.any():
        raise ValueError("no merge step has >= 2 MNN pairs")
    wv = w * valid
    wv = wv / wv.sum()

    def comb(field):
        return sum(wi * ps[field] for wi, ps in zip(wv, per_step))

    return MnnDeltaVarianceResult(
        mean=comb("mean"),
        total=comb("total"),
        trend=comb("trend"),
        adjusted=comb("adjusted"),
        per_step=per_step,
    )


def mnn_delta_variance_blocked(
    batches: Sequence,
    pairs: Sequence[np.ndarray],
    *,
    cos_norm: bool = False,
    subset_row: Optional[np.ndarray] = None,
    compute_all: bool = False,
    trend_span: float = 0.3,
    chunk_pairs: int = 2048,
    device: DeviceLike = None,
) -> MnnDeltaVarianceResult:
    """Block-processed mnn_delta_variance for host-resident batches.

    ``batches``: per-batch host arrays (cells in rows) or CSRCells stores.
    Nothing moves to ``device`` (default: the CUDA device; raises without
    one unless ``device="cpu"``) beyond two (chunk_pairs, G) float32 blocks
    of the pairs' rows at a time, and no store densifies beyond those rows,
    so the full-gene-space diagnostic runs at atlas scale (the reference
    streams the same computation over row blocks via blockApply,
    R/mnnDeltaVariance.R:145). Matches :func:`mnn_delta_variance` on dense
    inputs: per-step variances are accumulated on the device as fp64 moment
    sums over the pair chunks.
    """
    dev = resolve_device(device)
    if not all(isinstance(b, (np.ndarray, torch.Tensor, CSRCells)) for b in batches):
        raise TypeError("mnn_delta_variance_blocked takes dense per-batch arrays or "
                        "CSRCells stores")
    mats = [b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else b for b in batches]
    offsets = np.concatenate([[0], np.cumsum([b.shape[0] for b in mats])])
    g = mats[0].shape[1]

    # cosine-norm row scales (reference R/mnnDeltaVariance.R:137-143 via
    # cosineNorm; the dense path scales by l2 / mean-of-batch-mean-l2)
    row_scale = None
    if cos_norm:
        sub = None if subset_row is None else np.asarray(subset_row)
        l2s = []
        for b in mats:
            if isinstance(b, CSRCells):
                l2s.append(row_l2_norms(b, sub))
                continue
            x = np.asarray(b, dtype=np.float64)
            if sub is not None:
                x = x[:, sub]
            l2s.append(np.sqrt(np.sum(x * x, axis=1)))
        ml2 = float(np.mean([v.mean() for v in l2s]))
        row_scale = np.concatenate(
            [ml2 / np.maximum(v, 1e-8) for v in l2s]
        ).astype(np.float32)

    keep = None
    subset_after = None
    if subset_row is not None and not compute_all:
        keep = np.asarray(subset_row)
        g_out = keep.size
    else:
        g_out = g
        subset_after = None if subset_row is None else np.asarray(subset_row)

    def gather(rows: np.ndarray) -> torch.Tensor:
        """(len(rows), g_out) float32 rows of the virtual concat, on the device."""
        out = np.empty((rows.size, g_out), np.float32)
        which = np.searchsorted(offsets, rows, side="right") - 1
        for bi in np.unique(which):
            sel = np.nonzero(which == bi)[0]
            local = rows[sel] - offsets[bi]
            b = mats[bi]
            dense = (b.select_cells(local).to_dense() if isinstance(b, CSRCells)
                     else np.asarray(b)[local])
            if keep is not None:
                dense = dense[:, keep]
            out[sel] = dense
        if row_scale is not None:
            out *= row_scale[rows][:, None]
        return torch.from_numpy(out).to(dev)

    per_step, npairs = [], []
    for p in pairs:
        p = np.asarray(p)
        n = p.shape[0]
        sums = torch.zeros((4, g_out), dtype=torch.float64, device=dev)
        for lo in range(0, n, chunk_pairs):
            a = gather(p[lo:lo + chunk_pairs, 0]).double()
            b = gather(p[lo:lo + chunk_pairs, 1]).double()
            d = a - b
            sums += torch.stack([a.sum(0), b.sum(0), d.sum(0), (d * d).sum(0)])
        s1, s2, sd, sdd = _host(sums)
        mean = (s1 / n + s2 / n) / 2.0
        if n >= 2:
            var = np.maximum(sdd - n * (sd / n) ** 2, 0.0) / (n - 1)
        else:
            var = np.full(g_out, np.nan)
        per_step.append(_step_entry(mean, var, subset_after, trend_span))
        npairs.append(n)

    return _combine_steps(per_step, npairs)


def _abundance_table(x, batch, dev: torch.device) -> torch.Tensor:
    """Cluster-by-batch contingency table in fp64 on ``dev``, levels sorted
    (reference ._create_abundance_table); ``x`` is the table itself when
    ``batch`` is None."""
    if batch is None:
        return as_tensor(x, dev, torch.float64)
    rows, ri = np.unique(np.asarray(x), return_inverse=True)
    cols, ci = np.unique(np.asarray(batch), return_inverse=True)
    flat = as_tensor(ri.ravel() * cols.size + ci.ravel(), dev, torch.long)
    counts = torch.bincount(flat, minlength=rows.size * cols.size)
    return counts.to(torch.float64).reshape(rows.size, cols.size)


def cluster_abundance_test(x, batch=None, *, device: DeviceLike = None) -> np.ndarray:
    """Chi-squared test of within-cluster batch abundances against overall
    batch proportions; one p-value per cluster
    (reference clusterAbundanceTest, R/diagnostics-cluster.R:57-63).

    ``x``: a (clusters, batches) count table, or per-cell cluster labels
    with per-cell ``batch`` labels. The table and the statistics are fp64
    on ``device`` (default: the CUDA device; raises without one unless
    ``device="cpu"``)."""
    tab = _abundance_table(x, batch, resolve_device(device))
    props = tab.sum(0) / tab.sum()
    expected = tab.sum(1, keepdim=True) * props[None, :]
    stat = ((tab - expected) ** 2 / expected).sum(1)
    df = torch.full_like(stat, (tab.shape[1] - 1) / 2.0)
    return _host(torch.special.gammaincc(df, stat / 2.0))


def cluster_abundance_var(x, batch=None, pseudo_count: float = 10.0, *,
                          device: DeviceLike = None) -> np.ndarray:
    """Variance of log-normalized abundances across batches per cluster
    (reference clusterAbundanceVar, R/diagnostics-cluster.R:73-83); the
    table and the statistics are fp64 on ``device``, as in
    :func:`cluster_abundance_test`."""
    tab = _abundance_table(x, batch, resolve_device(device))
    libs = tab.sum(0)
    sf = libs / libs.mean()
    norm = torch.log2(tab / sf[None, :] + pseudo_count)
    return _host(torch.var(norm, dim=1, correction=1))
