"""Exact SVD helpers: biological-subspace estimation and removal.

Counterpart of ``batchelor_tpu/ops/svd.py`` (reference .get_bio_span /
.subtract_bio, R/mnnCorrect.R:487-538): the top singular vectors come from
an exact eigendecomposition of the smaller-side cross-product of the
column-centred matrix (``ops/pca.py::full_eigh``, on the device), equal to
the thin SVD's. Eigenvectors carry an arbitrary sign per column.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import as_tensor, full_fp32_matmul
from .pca import _tiny, full_eigh, full_eigh_many

__all__ = ["get_bio_span", "get_bio_span_pair", "subtract_bio"]


def _span_prepare(x: torch.Tensor, ndim: int, subset_row: Optional[np.ndarray]):
    """Gram-construction phase of get_bio_span: (state, gram)."""
    g_all = x.shape[1]
    if subset_row is None:
        sub, subset_np = x, None
    else:
        subset_np = np.asarray(subset_row)
        sub = x[:, as_tensor(subset_np, x.device, torch.long)]
    ndim = int(min(ndim, sub.shape[0], sub.shape[1]))
    transpose = sub.shape[0] > sub.shape[1]
    centered = sub - sub.mean(0, keepdim=True)
    with full_fp32_matmul():
        gram = centered.T @ centered if transpose else centered @ centered.T
    return (x, centered, ndim, transpose, g_all, subset_np), gram


def _span_finish(state, eig) -> torch.Tensor:
    x, centered, ndim, transpose, g_all, subset_row = state
    evals, evecs = eig
    s = torch.sqrt(torch.clamp(evals.flip(0)[:ndim], min=0.0))
    vec = evecs.flip(1)[:, :ndim]
    safe_s = torch.clamp(s, min=_tiny(centered))[None, :]
    with full_fp32_matmul():
        if transpose:
            v, u = vec, (centered @ vec) / safe_s
        else:
            v, u = (centered.T @ vec) / safe_s, vec
    if subset_row is None:
        return v
    keep = np.zeros(g_all, dtype=bool)
    keep[subset_row] = True
    leftover = as_tensor(np.nonzero(~keep)[0], x.device, torch.long)
    # leftover rows: project the unused genes into the same cell space
    left = x[:, leftover]
    left_centered = left - left.mean(0, keepdim=True)
    with full_fp32_matmul():
        left_v = (left_centered.T @ u) / torch.clamp(s, min=_tiny(x))[None, :]
    out = torch.zeros((g_all, ndim), device=x.device, dtype=x.dtype)
    out[as_tensor(subset_row, x.device, torch.long)] = v.to(x.dtype)
    out[leftover] = left_v.to(x.dtype)
    return out


def get_bio_span(x: torch.Tensor, ndim: int,
                 subset_row: Optional[np.ndarray] = None) -> torch.Tensor:
    """Gene-space basis of the biological subspace of ``x`` (cells x genes).

    Columns are centred per gene; the top ``ndim`` right singular vectors
    span the "biology". With ``subset_row``, the decomposition runs on the
    subset and the basis rows for leftover genes are back-projected
    (reference .get_bio_span, R/mnnCorrect.R:487-521)."""
    state, gram = _span_prepare(x, ndim, subset_row)
    return _span_finish(state, full_eigh(gram))


def get_bio_span_pair(x1: torch.Tensor, x2: torch.Tensor, ndim: int,
                      subset_row: Optional[np.ndarray] = None):
    """Both sides' bio spans, as two get_bio_span calls."""
    st1, g1 = _span_prepare(x1, ndim, subset_row)
    st2, g2 = _span_prepare(x2, ndim, subset_row)
    e1, e2 = full_eigh_many([g1, g2])
    return _span_finish(st1, e1), _span_finish(st2, e2)


def subtract_bio(correction: torch.Tensor, span1: torch.Tensor, span2: torch.Tensor,
                 subset_row: Optional[np.ndarray] = None) -> torch.Tensor:
    """Remove the components of ``correction`` parallel to two bio bases.

    Projects out span1 then span2 (the order is irrelevant per the
    reference comment). With ``subset_row``, magnitudes are computed on the
    subset only (reference .subtract_bio, R/mnnCorrect.R:523-538)."""
    dev = correction.device
    s = None if subset_row is None else as_tensor(np.asarray(subset_row), dev, torch.long)
    with full_fp32_matmul():
        for span in (span1, span2):
            span = as_tensor(span, dev)
            mag = correction @ span if s is None else correction[:, s] @ span[s]
            correction = correction - mag @ span.T
    return correction
