"""Lazy low-rank reconstruction operator.

Counterpart of ``batchelor_tpu/ops/lowrank.py``, the analog of
BiocSingular::LowRankMatrix as used by the reference's ``reconstructed``
assay (reference R/convertPCsToSCE.R:50-72): the per-gene corrected values
``rotation @ corrected.T`` (G x N) are never materialized; blocks are
computed on demand and products go through the factors.

At 1M cells x 5k genes the dense product is ~20 GB; a (rows, cols) block is
O(|rows| * |cols|) and a right product is two skinny products through the
rank dimension d.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..device import as_tensor

__all__ = ["LowRankOp"]


def _norm_index(idx, n: int, device: torch.device):
    if idx is None:
        return None
    if isinstance(idx, slice):
        return torch.arange(*idx.indices(n), device=device)
    return as_tensor(idx, device)


@dataclass(frozen=True)
class LowRankOp:
    """Represents ``left @ right.T`` (shape (G, N)) without materializing it.

    left: (G, d) factor (the rotation); right: (N, d) factor (the corrected
    coordinates). ``transposed`` flips the logical orientation to (N, G).
    """

    left: torch.Tensor
    right: torch.Tensor
    transposed: bool = False

    @property
    def shape(self) -> Tuple[int, int]:
        a, b = self.left.shape[0], self.right.shape[0]
        return (b, a) if self.transposed else (a, b)

    @property
    def ndim(self) -> int:
        return 2

    @property
    def dtype(self):
        return self.left.dtype

    @property
    def T(self) -> "LowRankOp":
        return LowRankOp(self.left, self.right, not self.transposed)

    def _factors(self):
        """(row factor, col factor) in the logical orientation."""
        if self.transposed:
            return self.right, self.left
        return self.left, self.right

    def _operand(self, other) -> torch.Tensor:
        if isinstance(other, LowRankOp):
            other = other.materialize()
        return as_tensor(other, self.left.device, self.left.dtype)

    def block(self, rows=None, cols=None) -> torch.Tensor:
        """Materialize the (rows, cols) sub-block in O(|rows| x |cols|)
        memory, the blockwise access pattern DelayedArray uses on the
        reference's LowRankMatrix."""
        rf, cf = self._factors()
        ri = _norm_index(rows, rf.shape[0], rf.device)
        ci = _norm_index(cols, cf.shape[0], cf.device)
        if ri is not None:
            rf = rf[ri]
        if ci is not None:
            cf = cf[ci]
        return rf @ cf.T

    def materialize(self) -> torch.Tensor:
        return self.block()

    def __getitem__(self, key) -> torch.Tensor:
        if not isinstance(key, tuple):
            key = (key, None)
        rows, cols = key[0], key[1] if len(key) > 1 else None
        squeeze_r = isinstance(rows, (int, np.integer))
        squeeze_c = isinstance(cols, (int, np.integer))
        if squeeze_r:
            rows = [int(rows)]
        if squeeze_c:
            cols = [int(cols)]
        out = self.block(rows, cols)
        if squeeze_c:
            out = out[:, 0]
        if squeeze_r:
            out = out[0]
        return out

    def __matmul__(self, other) -> torch.Tensor:
        """self @ other without densifying: (rf @ (cf.T @ other))."""
        rf, cf = self._factors()
        return rf @ (cf.T @ self._operand(other))

    def __rmatmul__(self, other) -> torch.Tensor:
        rf, cf = self._factors()
        return (self._operand(other) @ rf) @ cf.T

    def __array__(self, dtype=None, copy=None):
        out = self.materialize().detach().cpu().numpy()
        return out.astype(dtype) if dtype is not None else out

    def row_sums(self) -> torch.Tensor:
        rf, cf = self._factors()
        return rf @ cf.sum(0)

    def col_sums(self) -> torch.Tensor:
        rf, cf = self._factors()
        return cf @ rf.sum(0)
