"""Lazy linear-model residuals (ResidualMatrix equivalent).

Counterpart of ``batchelor_tpu/ops/residual.py``, the analog of the
ResidualMatrix used by regressBatches (reference R/regressBatches.R:148).
The residual operator R = X - D (D'D)^+ D' X is kept in factored form so it
can be fused into downstream products without materializing a dense
residual matrix; ``materialize`` realizes it when per-gene values are
wanted.

Semantics kept:
  * ``keep``: columns of the design whose fitted contribution is retained
    (not subtracted);
  * ``restrict``: coefficients are estimated from a subset of cells and the
    correction extrapolated to all cells.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import as_tensor, full_fp32_matmul

__all__ = ["ResidualOp", "one_hot_design", "pinv"]


def one_hot_design(batch: Sequence, levels=None, device=None) -> torch.Tensor:
    """model.matrix(~0 + factor(batch)) equivalent: (N, n_levels) fp64
    one-hot, on ``device`` (the CPU unless given)."""
    batch = np.asarray(batch)
    if levels is None:
        levels = sorted(set(batch.tolist()))
    lookup = {lv: i for i, lv in enumerate(levels)}
    idx = np.array([lookup[b] for b in batch.tolist()], dtype=np.int64)
    return torch.as_tensor(np.eye(len(levels))[idx], device=device)


def pinv(a: torch.Tensor) -> torch.Tensor:
    """Moore-Penrose inverse with the JAX package's cut-off: singular values
    at or below 10 max(M, N) eps times the largest are dropped
    (``jnp.linalg.pinv``'s default; ``torch.linalg.pinv``'s is 10x lower,
    and on a rank-deficient design would keep other directions)."""
    rtol = 10.0 * max(a.shape[-2:]) * torch.finfo(a.dtype).eps
    return torch.linalg.pinv(a, rtol=rtol)


@dataclass(frozen=True)
class ResidualOp:
    """Factored residual operator over a (N, G) matrix.

    residuals = x - design[:, drop] @ beta[drop]  with
    beta = pinv(D'D) D'X over the restricted cells.
    """

    x: torch.Tensor           # (N, G)
    design: torch.Tensor      # (N, P)
    beta: torch.Tensor        # (P, G)
    drop: np.ndarray          # coefficient indices subtracted

    @staticmethod
    def fit(
        x: torch.Tensor,
        design,
        keep: Optional[Sequence[int]] = None,
        restrict: Optional[np.ndarray] = None,
    ) -> "ResidualOp":
        design = as_tensor(design, x.device, x.dtype)
        if restrict is not None:
            ridx = as_tensor(np.asarray(restrict), x.device, torch.long)
            dfit, xfit = design[ridx], x[ridx]
        else:
            dfit, xfit = design, x
        # normal equations via pinv for rank safety (matches lm residuals)
        with full_fp32_matmul():
            beta = pinv(dfit.T @ dfit) @ (dfit.T @ xfit)
        p = design.shape[1]
        if keep is None:
            drop = np.arange(p)
        else:
            drop = np.setdiff1d(np.arange(p), np.asarray(keep))
        return ResidualOp(x=x, design=design, beta=beta, drop=drop)

    @property
    def shape(self):
        return self.x.shape

    def _dropped(self):
        idx = as_tensor(self.drop, self.x.device, torch.long)
        return self.design[:, idx], self.beta[idx]

    def materialize(self) -> torch.Tensor:
        d, b = self._dropped()
        with full_fp32_matmul():
            return self.x - d @ b

    def matmul(self, other) -> torch.Tensor:
        """(residuals @ other) without materializing: X v - D_drop (B_drop v)."""
        d, b = self._dropped()
        other = as_tensor(other, self.x.device, self.x.dtype)
        with full_fp32_matmul():
            return self.x @ other - d @ (b @ other)

    def rmatmul(self, other) -> torch.Tensor:
        """(other @ residuals) = other X - (other D_drop) B_drop."""
        d, b = self._dropped()
        other = as_tensor(other, self.x.device, self.x.dtype)
        with full_fp32_matmul():
            return other @ self.x - (other @ d) @ b
