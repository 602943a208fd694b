"""Out-of-core multi-batch PCA over CSR-backed batches.

Counterpart of ``batchelor_tpu/ops/pca_outofcore.py`` (the reference's
deferred ScaledMatrix PCA, R/multiBatchPCA.R:76-78, 288-301): the centering
never materializes. The weighted Gram matrix is accumulated in fp32 from
streamed dense blocks with the centering expanded algebraically,

    sum_b w_b/N_b (X_b - 1 c^T)^T (X_b - 1 c^T)
      = sum_b w_b/N_b [ X_b^T X_b - s_b c^T - c s_b^T + N_b c c^T ],

where s_b = X_b^T 1 (per-gene sums). Only G x G accumulators and one dense
block live on the device; the projections stream back block by block.
Every product runs in full fp32 (no TF32). With a cells mesh each rank
densifies and accumulates its own rows of every block, and the Gram and the
sums are ``all_reduce``d (the reference feeds DelayedArray blocks to
BPPARAM-parallel PCA the same way, R/multiBatchPCA.R:217-219).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..device import DeviceLike, full_fp32_matmul, resolve_device
from ..io.csr import CSRCells, device_dense_blocks
from .merge_math import gmaybe, pmaybe
from .pca import MultiBatchPCAResult, _randomized_psd_eigh, construct_weight_vector, full_eigh

__all__ = ["multi_batch_pca_csr"]


def multi_batch_pca_csr(
    batches: Sequence[CSRCells],
    d: int = 50,
    *,
    weights: Union[None, bool, Sequence[float], list] = None,
    subset_row: Optional[np.ndarray] = None,
    block_rows: int = 8192,
    eig_method: str = "auto",
    batch_names: Optional[Sequence[str]] = None,
    mesh=None,
    device: DeviceLike = None,
) -> MultiBatchPCAResult:
    """Weighted multi-batch PCA streaming CSR batches block by block.

    Equivalent to ``multi_batch_pca`` on the densified inputs (the same
    grand-mean centering and per-batch 1/sqrt(N_b/w_b) scaling), but no
    batch is ever dense at once. The Gram matrix and the gene sums are
    accumulated in fp32 on ``device`` (default: the CUDA device; raises
    without one unless ``device="cpu"``), which the blocks reach as their
    nonzeros (:func:`device_dense_blocks`; the JAX package's ``transfer``
    option is not taken: on an H100 host the host densify was slower at
    every density up to 100%, PERF.md). ``eig_method``: "exact" (full ``eigh``), "randomized",
    or "auto" (randomized above 1,024 genes). The components come back as
    host numpy arrays; the rotation and centers stay on the device.

    ``mesh`` (a ``parallel.mesh.CellsMesh``; its device is used): every rank
    calls with the same stores, streams only its own rows of each block
    (``device_dense_blocks(mesh=)``), and the Gram and the gene sums are
    summed over the ranks; every rank solves the same eigenproblem and
    returns the same components, gathered block by block.
    """
    dev = mesh.device if mesh is not None else resolve_device(device)
    group = mesh.group if mesh is not None else None

    # a mesh rounds the blocks up to a world-size multiple of rows
    step = block_rows if mesh is None else -(-block_rows // mesh.size) * mesh.size

    def blocks(csr, pad):
        if mesh is None:
            return device_dense_blocks(csr, block_rows, pad=pad, device=dev)
        return device_dense_blocks(csr, block_rows, pad=pad, mesh=mesh)

    if subset_row is not None:
        batches = [c.select_genes(subset_row) for c in batches]
    g = batches[0].n_genes
    ns = [c.n_cells for c in batches]
    w = construct_weight_vector(ns, weights, batch_names)
    dd = int(min(d, g))

    with full_fp32_matmul():
        # pass 1: per-batch gene sums and raw Gram accumulators
        grams, sums = [], []
        for csr in batches:
            acc_g = torch.zeros((g, g), dtype=torch.float32, device=dev)
            acc_s = torch.zeros((g,), dtype=torch.float32, device=dev)
            for block, _ in blocks(csr, pad=False):
                acc_g += block.T @ block
                acc_s += block.sum(0)
            grams.append(pmaybe(acc_g, group))
            sums.append(pmaybe(acc_s, group))

        wsum = float(np.sum(w))
        centers = sum((s / n) * float(wi) for s, n, wi in zip(sums, ns, w)) / wsum
        gram = torch.zeros((g, g), dtype=torch.float32, device=dev)
        for gb, sb, n, wi in zip(grams, sums, ns, w):
            centered = (gb - torch.outer(sb, centers) - torch.outer(centers, sb)
                        + n * torch.outer(centers, centers))
            gram += (float(wi) / n) * centered
        gram = (gram + gram.T) / 2

        if eig_method == "randomized" or (eig_method == "auto" and g > 1024):
            _, v = _randomized_psd_eigh(gram, dd)
        else:
            _, evec = full_eigh(gram)
            v = evec.flip(1)[:, :dd]

        # pass 2: project each block of the (unscaled) centered batches; the
        # components stay host numpy (at atlas scale the largest long-lived
        # arrays, which the merge engine moves to the device itself)
        # (with a mesh: each rank projects its rows of the padded block, and
        # the ranks' rows, gathered in rank order, are the block's rows)
        components: List[np.ndarray] = []
        for csr in batches:
            outs = []
            for start, (block, _) in zip(range(0, csr.n_cells, step),
                                         blocks(csr, pad=mesh is not None)):
                proj = gmaybe((block - centers[None, :]) @ v, group)
                outs.append(proj[:max(0, csr.n_cells - start)].cpu().numpy())
            components.append(np.concatenate(outs, axis=0) if outs
                              else np.zeros((0, dd), np.float32))

    return MultiBatchPCAResult(
        components=components,
        rotation=v,
        centers=centers,
        batch_names=list(batch_names) if batch_names is not None else None,
    )
