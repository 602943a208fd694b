"""Weighted multi-batch PCA as a Gram-matrix eigendecomposition.

Counterpart of ``batchelor_tpu/ops/pca.py`` (reference multiBatchPCA,
R/multiBatchPCA.R:139-557): the weighted cross-product of the centred,
batch-scaled cells on the smaller side is eigendecomposed exactly, with no
iterative solver unless ``method="randomized"`` asks for one.

Semantics kept from the reference:
  * the centering vector is the weighted grand mean of per-batch gene means
    (R/multiBatchPCA.R:270-282),
  * each batch's covariance contribution is divided by N_b / w_b
    (R/multiBatchPCA.R:293-318), equalizing batches by default,
  * per-batch outputs are the *unscaled* centered matrices projected onto
    the rotation (R/multiBatchPCA.R:236-239),
  * rotation extrapolation to unselected genes when get_all_genes
    (R/multiBatchPCA.R:396-435), variance reporting, and the d=None
    passthrough mode (R/multiBatchPCA.R:245-255, 439-461).

Every product runs in full fp32 on the card (no TF32), like the reference's
distance products. Orientation: cells in rows (N_b x G).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..device import DeviceLike, as_tensor, full_fp32_matmul, resolve_device
from ..utils.telemetry import trace_span
from ..utils.trees import tree_weights
from .cosine_norm import subset_columns

__all__ = ["multi_batch_pca", "construct_weight_vector", "MultiBatchPCAResult",
           "full_eigh", "full_eigh_many"]

RANDOM_ITERS = 8
RANDOM_OVERSAMPLE = 16


def construct_weight_vector(
    ncells: Sequence[int],
    weights: Union[None, bool, Sequence[float], list],
    names: Optional[Sequence[str]] = None,
) -> np.ndarray:
    """Per-batch weights (reference .construct_weight_vector).

    None/True -> 1 per batch (equal batch contributions); False -> N_b (no
    reweighting); a numeric vector is used directly; a nested list is a
    weight tree (equal split at each level, R/multiBatchPCA.R:329-381).
    """
    ncells = np.asarray(ncells, dtype=np.float64)
    nb = ncells.shape[0]
    if weights is None or weights is True:
        return np.ones(nb)
    if weights is False:
        return ncells.copy()
    if isinstance(weights, list) and any(isinstance(w, (list, tuple)) for w in weights):
        return tree_weights(weights, nb, names)
    w = np.asarray(weights, dtype=np.float64)
    if w.shape[0] != nb:
        raise ValueError("'weights' should have one entry per batch")
    return w


@dataclass
class MultiBatchPCAResult:
    """Outputs of :func:`multi_batch_pca`.

    components: per-batch (N_b, d) PC coordinates.
    rotation: (G, d) rotation matrix (G = reported genes).
    centers: (G,) centering vector.
    var_explained / var_total: weighted variance metadata (if requested).
    """

    components: List[torch.Tensor]
    rotation: torch.Tensor
    centers: torch.Tensor
    var_explained: Optional[np.ndarray] = None
    var_total: Optional[float] = None
    batch_names: Optional[list] = None


def _start_block(g: int, p: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The randomized method's (g, p) standard-normal start block, drawn on
    the CPU from a generator seeded 0, so the card and the CPU start alike."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    return torch.randn((g, p), generator=gen, dtype=dtype).to(device)


def _randomized_psd_eigh(gram: torch.Tensor, d: int, iters: int = RANDOM_ITERS,
                         oversample: int = RANDOM_OVERSAMPLE, start=None):
    """Top-d eigenpairs (descending) of a PSD matrix by subspace iteration.

    Power iterations with CholeskyQR re-orthonormalization, then a small
    Rayleigh-Ritz eigh (the reference's RandomParam/rsvd option,
    R/multiBatchPCA.R:72-74). ``start``: the (g, min(d + oversample, g))
    start block; default ``_start_block``. The JAX package draws its block
    from ``jax.random``, so only a block passed in reproduces its bits.
    """
    g = gram.shape[0]
    p = min(d + oversample, g)
    if start is None:
        q = _start_block(g, p, gram.dtype, gram.device)
    else:
        q = as_tensor(start, gram.device, gram.dtype)
        if tuple(q.shape) != (g, p):
            raise ValueError(f"start block must be {(g, p)}, got {tuple(q.shape)}")
    eye = torch.eye(p, dtype=gram.dtype, device=gram.device)

    def chol_qr(y):
        r = torch.linalg.cholesky(y.T @ y + 1e-30 * eye)
        return torch.linalg.solve_triangular(r, y.T, upper=False).T

    q = chol_qr(q)
    for _ in range(iters):
        q = chol_qr(gram @ q)
    b = q.T @ (gram @ q)
    b = (b + b.T) / 2
    w, u = torch.linalg.eigh(b)
    return w.flip(0)[:d], (q @ u.flip(1))[:, :d]


def full_eigh(gram: torch.Tensor):
    """Full symmetric eigendecomposition, ascending (``torch.linalg.eigh``)."""
    return torch.linalg.eigh(gram)


def full_eigh_many(grams):
    """``full_eigh`` of each Gram matrix: a list of (evals, evecs)."""
    return [full_eigh(g) for g in grams]


def _tiny(t: torch.Tensor) -> float:
    return torch.finfo(t.dtype).tiny


def _svd_direct(scaled: torch.Tensor, d: int):
    with trace_span("pca/svd"):
        u, s, vt = torch.linalg.svd(scaled, full_matrices=False)
    return vt[:d].T, s[:d], u[:, :d]


def _svd_randomized(scaled: torch.Tensor, d: int, transpose: bool, start=None):
    with trace_span("pca/gram"):
        gram = _gram_of(scaled, transpose)
    with trace_span("pca/eigh"):
        evals, vec = _randomized_psd_eigh(gram, d, start=start)
    with trace_span("pca/project"):
        s = torch.sqrt(torch.clamp(evals, min=0.0))
        safe = torch.clamp(s, min=_tiny(scaled))[None, :]
        if transpose:
            return vec, s, (scaled @ vec) / safe
        return (scaled.T @ vec) / safe, s, vec


def _gram_of(scaled: torch.Tensor, transpose: bool) -> torch.Tensor:
    return scaled.T @ scaled if transpose else scaled @ scaled.T


def _gram_project(scaled, evals, evecs, d: int, transpose: bool):
    """Top-d (V, s, U) from an ascending eigh of the smaller-side Gram."""
    ev = evals.flip(0)[:d]
    vec = evecs.flip(1)[:, :d]
    s = torch.sqrt(torch.clamp(ev, min=0.0))
    safe = torch.clamp(s, min=_tiny(scaled))[None, :]
    if transpose:                                     # Gram was (G, G)
        return vec, s, (scaled @ vec) / safe
    return (scaled.T @ vec) / safe, s, vec           # Gram was (sumN, sumN)


def _scaled_svd(scaled: torch.Tensor, d: int, method: str, start=None):
    """Top-d right singular vectors of ``scaled`` (sum-N x G).

    Returns (V (G, d), singvals (d,), U (sumN, d)). ``method``: "gram" is
    the exact eigendecomposition of the smaller-side cross-product;
    "randomized" is subspace iteration on it (``start``: its start block);
    "direct" a full SVD (most accurate, most FLOPs). The Gram, its
    eigendecomposition and the projection run in the spans ``pca/gram``,
    ``pca/eigh`` and ``pca/project``; the full SVD in ``pca/svd``.
    """
    n, g = scaled.shape
    if method == "direct":
        return _svd_direct(scaled, d)
    if method == "randomized":
        return _svd_randomized(scaled, d, g <= n, start)
    if method != "gram":
        raise ValueError(f"unknown svd method {method!r}")
    transpose = g <= n
    with trace_span("pca/gram"):
        gram = _gram_of(scaled, transpose)
    with trace_span("pca/eigh"):
        evals, evecs = full_eigh(gram)
    with trace_span("pca/project"):
        return _gram_project(scaled, evals, evecs, d, transpose)


def _center_and_scale(mats: Sequence[torch.Tensor], weights: np.ndarray):
    """Grand-mean centering + per-batch 1/sqrt(N_b/w_b) scaling.

    Returns (centered list, scaled concat (sumN, G), centers (G,))."""
    means = [m.mean(0) for m in mats]
    wsum = float(np.sum(weights))
    centers = sum(mu * float(w) for mu, w in zip(means, weights)) / wsum
    centered = [m - centers[None, :] for m in mats]
    scaled = torch.cat(
        [c / np.sqrt(m.shape[0] / w) for c, m, w in zip(centered, mats, weights)], 0
    )
    return centered, scaled, centers


def multi_batch_pca(
    batches: Sequence,
    d: Optional[int] = 50,
    *,
    weights: Union[None, bool, Sequence[float], list] = None,
    subset_row: Optional[np.ndarray] = None,
    get_all_genes: bool = False,
    get_variance: bool = False,
    method: str = "gram",
    batch_names: Optional[Sequence[str]] = None,
    start=None,
    device: DeviceLike = None,
) -> MultiBatchPCAResult:
    """Weighted PCA across batches projecting all cells to a common space.

    ``batches``: list of (N_b, G) matrices (cells in rows; arrays or
    tensors, moved to ``device``: default the CUDA device, raises without
    one unless ``device="cpu"``). ``subset_row`` selects feature columns
    used for the PCA; with ``get_all_genes`` the rotation/centers are
    extrapolated back to all G features (reference R/multiBatchPCA.R:396-435).
    ``d=None`` skips the PCA and returns centered matrices with an identity
    rotation (reference R/multiBatchPCA.R:245-255). ``method``: "gram",
    "randomized" or "direct"; ``start`` is the randomized method's start
    block (default: standard normal from a CPU generator seeded 0).
    """
    dev = resolve_device(device)
    batches = [as_tensor(b, dev) for b in batches]
    nb = len(batches)
    if nb == 0:
        raise ValueError("at least one batch must be specified")
    w = construct_weight_vector([b.shape[0] for b in batches], weights, batch_names)
    names = list(batch_names) if batch_names is not None else None

    g_all = batches[0].shape[1]
    if subset_row is not None:
        subset_row = np.asarray(subset_row)
        sub = [subset_columns(b, subset_row) for b in batches]
    else:
        sub = list(batches)

    with full_fp32_matmul():
        with trace_span("pca/center_scale"):
            centered, scaled, centers = _center_and_scale(sub, w)
        if d is None:
            return _passthrough(centered, scaled, g_all, subset_row, get_all_genes,
                                get_variance, names)

        d_eff = int(min(d, scaled.shape[0], scaled.shape[1]))
        v, s, u = _scaled_svd(scaled, d_eff, method, start)
        with trace_span("pca/project"):
            components = [c @ v for c in centered]

        if get_all_genes and subset_row is not None:
            keep = np.zeros(g_all, dtype=bool)
            keep[subset_row] = True
            leftover_idx = np.nonzero(~keep)[0]
            left = [subset_columns(b, leftover_idx) for b in batches]
            with trace_span("pca/center_scale"):
                _, left_scaled, left_centers = _center_and_scale(left, w)
            # leftover rotation rows: project unused genes into the cell space
            # (reference R/multiBatchPCA.R:396-414): u_left = scaled_left^T U / s.
            with trace_span("pca/project"):
                leftover_u = (left_scaled.T @ u) / torch.clamp(s, min=_tiny(scaled))[None, :]
            sub_t = as_tensor(subset_row, dev)
            left_t = as_tensor(leftover_idx, dev)
            rotation = torch.zeros((g_all, d_eff), dtype=scaled.dtype, device=dev)
            rotation[sub_t] = v
            rotation[left_t] = leftover_u
            all_centers = torch.zeros((g_all,), dtype=scaled.dtype, device=dev)
            all_centers[sub_t] = centers
            all_centers[left_t] = left_centers
        else:
            rotation, all_centers = v, centers

    res = MultiBatchPCAResult(components=components, rotation=rotation,
                              centers=all_centers, batch_names=names)
    if get_variance:
        res.var_explained = (s * s).cpu().numpy() / nb
        res.var_total = float((scaled * scaled).sum()) / nb
    return res


def _passthrough(centered, scaled, g_all, subset_row, get_all_genes, get_variance, names):
    """d=None: centered data, identity/injection rotation, zero centers
    (reference .make_fake_metadata R/multiBatchPCA.R:439-461)."""
    g_sub = centered[0].shape[1]
    dev, dt = scaled.device, scaled.dtype
    if get_all_genes and subset_row is not None:
        rotation = torch.zeros((g_all, g_sub), dtype=dt, device=dev)
        rotation[as_tensor(subset_row, dev), torch.arange(g_sub, device=dev)] = 1.0
        out_centers = torch.zeros((g_all,), dtype=dt, device=dev)
    else:
        rotation = torch.eye(g_sub, dtype=dt, device=dev)
        out_centers = torch.zeros((g_sub,), dtype=dt, device=dev)
    res = MultiBatchPCAResult(components=centered, rotation=rotation,
                              centers=out_centers, batch_names=names)
    if get_variance:
        n = scaled.shape[0]
        mu = scaled.mean(0)
        var = ((scaled - mu[None, :]) ** 2).sum(0) / (n - 1)
        res.var_explained = var.cpu().numpy()
        res.var_total = float(var.sum())
    return res
