"""Cosine (L2) normalization of per-cell expression vectors.

Counterpart of ``batchelor_tpu/ops/cosine_norm.py`` (reference cosineNorm,
R/cosineNorm.R:53-82). Cells are rows here; the reference normalizes
columns. Plain PyTorch: the reference runs it in XLA, outside any kernel.
"""
from __future__ import annotations

import torch

from ..device import as_tensor

__all__ = ["cosine_norm", "l2_norms", "apply_cosine_norm"]

_L2_FLOOR = 1e-8  # zero-norm guard, reference R/cosineNorm.R:80


def l2_norms(x: torch.Tensor) -> torch.Tensor:
    """Per-cell (row) L2 norms: sqrt(sum_g x[c, g]^2)."""
    return torch.sqrt((x * x).sum(1))


def apply_cosine_norm(x: torch.Tensor, l2: torch.Tensor) -> torch.Tensor:
    """Divide each row by max(l2, 1e-8) (reference .apply_cosine_norm)."""
    safe = torch.clamp(l2.to(x.dtype), min=_L2_FLOOR)
    return x / safe[:, None]


def subset_columns(x: torch.Tensor, subset_row) -> torch.Tensor:
    """``x[:, subset_row]`` for an index or boolean vector (host or tensor)."""
    return x[:, as_tensor(subset_row, x.device)]


def cosine_norm(x: torch.Tensor, mode: str = "matrix", subset_row=None):
    """Cosine-normalize cells (rows) of ``x``.

    mode="matrix" returns the normalized matrix; "l2norm" the norms;
    "all" a (matrix, l2norm) tuple. ``subset_row`` restricts the features
    used to compute the norms (columns here), mirroring the reference's
    subset.row; normalization is then applied to the subsetted matrix,
    exactly as the reference subsets before normalizing.
    """
    if subset_row is not None:
        x = subset_columns(x, subset_row)
    l2 = l2_norms(x)
    if mode == "l2norm":
        return l2
    mat = apply_cosine_norm(x, l2)
    if mode == "matrix":
        return mat
    if mode == "all":
        return mat, l2
    raise ValueError(f"unknown mode {mode!r}")
