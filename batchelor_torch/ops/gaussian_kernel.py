"""Gaussian-kernel smoothing of per-MNN correction vectors.

Counterpart of ``batchelor_tpu/ops/gaussian_kernel.py`` (reference C++
kernel src/smooth_gaussian_kernel.cpp:10-118). The C++ manages log-space
underflow with a per-entry running-max trick; here the whole computation is
a log-softmax over the dense (n_mnn x n_cells) logit matrix: two distance
products plus max-subtraction, numerically equivalent.

Weight of MNN group i at cell c:
    w[i, c] = exp(-d2(i, c)/sigma2) / density_i,    normalized over i,
    density_i = sum_j exp(-d2(i, j)/sigma2) over MNN cell locations j
(the density division stops high-density regions dominating the smoothing).
Output for cell c = sum_i w[i, c] * averaged[i].
"""
from __future__ import annotations

import torch

from ..device import as_tensor, full_fp32_matmul

__all__ = ["smooth_gaussian_kernel"]


def _sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n_a, n_b) squared Euclidean distances by one matrix product, in
    full fp32 at least (TF32 would break the extreme-distance regime)."""
    acc = torch.promote_types(a.dtype, torch.float32)
    a, b = a.to(acc), b.to(acc)
    an = (a * a).sum(1)
    bn = (b * b).sum(1)
    with full_fp32_matmul():
        prod = a @ b.T
    return torch.clamp(an[:, None] + bn[None, :] - 2.0 * prod, min=0.0)


def smooth_gaussian_kernel(averaged, index, data, sigma2: float) -> torch.Tensor:
    """Smooth per-MNN-group vectors over all cells.

    averaged: (M, G) per-group averaged correction vectors (group order =
      ascending involved-cell index, see average_correction).
    index: (M,) row positions of the MNN-involved cells within ``data``.
    data: (N, Gd) tensor of the coordinates used for distances (may differ
      from the value space, reference R/mnnCorrect.R:297-304); the work
      runs on its device.
    sigma2: bandwidth; the reference passes its ``sigma`` parameter straight
      through as the squared bandwidth (src/smooth_gaussian_kernel.cpp:51).

    Returns (N, G) smoothed correction vectors on ``data``'s device.
    """
    dev = data.device
    averaged = as_tensor(averaged, dev)
    mnn_pos = data[as_tensor(index, dev, torch.long)]
    d2 = _sq_dists(mnn_pos, data)                      # (M, N)
    logw = -d2 / sigma2
    # density over the MNN locations themselves (the mnn block)
    dens = torch.logsumexp(-_sq_dists(mnn_pos, mnn_pos) / sigma2, dim=1)
    w = torch.softmax(logw - dens[:, None], dim=0)     # normalized over groups
    dt = torch.promote_types(w.dtype, averaged.dtype)
    with full_fp32_matmul():
        return w.T.to(dt) @ averaged.to(dt)            # (N, G)
