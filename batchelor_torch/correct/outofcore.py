"""Out-of-core corrections over CSR stores: quickCorrect, rescale, regress
and classic mnnCorrect.

Counterpart of ``batchelor_tpu/correct/outofcore.py``. Counts never
densify beyond one streamed block. ``quick_correct_csr`` mirrors
quickCorrect (reference R/quickCorrect.R:66-120) with every gene-space
stage expressed as statistics of the CSR buffers:

1. size factors: CSR row sums (host C++ runtime);
2. median-ratio rescaling to the lowest-coverage batch
   (``ops.normalization.rescale_size_factors`` on host arrays);
3. HVG modelling: per-gene moments of the log-normalized expression in
   one O(nnz) host pass (``csr_gene_stats``), then the host trend fit;
4. log-normalize + cosine-norm as a value transform of the CSR buffers:
   with pseudo_count=1, log(x/sf + 1) keeps zeros zero and per-cell L2
   scaling keeps the pattern, so the HVG subset stays sparse at rest;
5. ``multi_batch_pca_csr`` (the streamed Gram PCA on the device), then
   ``reduced_mnn`` on the (N, d) coordinates.

Peak host memory: O(nnz of the HVG subset); peak device memory:
O(block_rows x G) + O(N x d).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, as_tensor, full_fp32_matmul, resolve_device
from ..io.checkpoint import load_pca_stage, save_pca_stage
from ..io.csr import CSRCells, device_dense_blocks
from ..native.bindings import (
    csr_gene_stats,
    csr_lognorm_cosine,
    csr_rescale_values,
    csr_unlog_colsums,
)
from ..ops.normalization import rescale_size_factors
from ..ops.pca import MultiBatchPCAResult
from ..ops.pca_outofcore import multi_batch_pca_csr
from ..ops.stats import GeneVarResult, combine_var, get_top_hvgs
from ..parallel.driver import distributed_fast_mnn
from ..parallel.mesh import barrier
from ..utils.telemetry import trace_span
from .diagnostics import fit_trend_var
from .experiments import QuickCorrectResult
from .fast_mnn import MNNResult, reduced_mnn

__all__ = [
    "quick_correct_csr",
    "rescale_batches_csr",
    "regress_batches_csr",
    "mnn_correct_csr",
    "CSRResidualOp",
]


def _stream_stats(store: CSRCells, sf: np.ndarray, log_base: float):
    """One O(nnz) host pass: per-gene average of sf-normalized counts and
    the log-expression's mean and variance. With pseudo_count=1 zeros add
    nothing, so the sums come straight off the nnz buffer."""
    avg_s, s1, s2 = csr_gene_stats(store.data, store.indices, store.indptr, sf,
                                   store.n_genes, log_base)
    n = store.n_cells
    mean = (s1 / n).astype(np.float64)
    var = (s2 - n * mean**2) / max(n - 1, 1)
    return avg_s / n, mean, np.maximum(var, 0.0)


def _decompose(mean: np.ndarray, var: np.ndarray, span: float) -> GeneVarResult:
    tech = fit_trend_var(mean, var, span=span)(mean)
    return GeneVarResult(mean=mean, total=var, tech=tech, bio=var - tech)


def _lognorm_cosine_csr(store: CSRCells, sf: np.ndarray, log_base: float,
                        cos_norm: bool) -> CSRCells:
    """Value transform v -> log(v/sf + 1)/log(base), then per-cell L2
    normalization (cosineNorm's zero guard, reference R/cosineNorm.R:80),
    on the nnz buffer: zeros stay zero, so the CSR pattern is unchanged."""
    vals = csr_lognorm_cosine(store.data, store.indptr, sf, log_base, cos_norm)
    return CSRCells(data=vals, indices=store.indices, indptr=store.indptr,
                    n_genes=store.n_genes, gene_names=store.gene_names)


def quick_correct_csr(
    stores: Sequence[CSRCells],
    *,
    hvg_n: int = 5000,
    d: int = 50,
    k: int = 20,
    prop_k: Optional[float] = None,
    knn_method: str = "auto",
    merge_order=None,
    auto_merge: bool = False,
    min_batch_skip: Optional[float] = 0.0,
    ndist: float = 3.0,
    min_mean: float = 1.0,
    log_base: float = 2.0,
    cos_norm: bool = True,
    span: float = 0.3,
    block_rows: int = 8192,
    weights=None,
    batch_names: Optional[Sequence[str]] = None,
    mesh=None,
    memory: str = "gather",
    pad_buckets: bool = False,
    checkpoint_dir: Optional[str] = None,
    pca_cache_dir: Optional[str] = None,
    progress: bool = False,
    device: DeviceLike = None,
) -> QuickCorrectResult:
    """quickCorrect over out-of-core CSR stores (raw counts, cells in rows).

    The streaming counterpart of ``quick_correct`` (see the module docstring
    for its stages), restricted to pseudo_count=1, which keeps the log
    transform sparse. Stages 1-4 run on the host; the PCA and the merge on
    ``device`` (default: the CUDA device; raises without one unless
    ``device="cpu"``). Returns a QuickCorrectResult (variance decomposition,
    HVG indices, an MNNResult with rotation and centers).

    ``pca_cache_dir`` saves the PCA stage (``io.checkpoint.save_pca_stage``)
    and reuses it on a re-run, skipping the PCA; var_explained is not
    cached. ``checkpoint_dir`` checkpoints the merge (``reduced_mnn``).

    With ``mesh`` (a ``parallel.mesh.CellsMesh``; its device is used) every
    rank calls with the same stores: the streamed PCA splits each block
    over the ranks (``multi_batch_pca_csr(mesh=)``) and the merge is
    ``parallel.driver.distributed_fast_mnn`` (``memory``, ``pad_buckets``,
    ``checkpoint_dir`` and ``progress`` pass through; ``knn_method="auto"``
    means "exact" there, as in the JAX package); rank 0 writes the PCA
    cache. Every rank returns the same result.
    """
    dev = mesh.device if mesh is not None else resolve_device(device)
    if len(stores) < 2:
        raise ValueError("at least two batches must be specified")
    g = stores[0].n_genes
    names0 = stores[0].gene_names
    for s in stores[1:]:
        if s.n_genes != g:
            raise ValueError("number of features is not the same across batches")
        if (s.gene_names is None) != (names0 is None) or (
            names0 is not None and list(s.gene_names) != list(names0)
        ):
            raise ValueError("gene names differ across stores; align them with "
                             "CSRCells.select_genes first")

    # stages 1-3: one host pass a batch
    sfs: List[np.ndarray] = []
    avgs: List[np.ndarray] = []
    decs: List[GeneVarResult] = []
    with trace_span("quickcsr/stats"):
        for store in stores:
            lib = store.row_sums()
            if not np.all(lib > 0):
                raise ValueError("all cells must have positive library sizes")
            sf = (lib / lib.mean()).astype(np.float32)
            sfs.append(sf)
            avg, mean, var = _stream_stats(store, sf, log_base)
            avgs.append(avg)
            decs.append(_decompose(mean, var, span))

    with trace_span("quickcsr/rescale"):
        rescaled = [np.asarray(r, np.float32)
                    for r in rescale_size_factors(avgs, sfs, min_mean=min_mean)]

    # the HVG statistics follow the rescaled normalization: a batch whose
    # factors moved is measured again
    with trace_span("quickcsr/restats"):
        decs2: List[GeneVarResult] = []
        for store, sf0, sf1, dec in zip(stores, sfs, rescaled, decs):
            if np.allclose(sf0, sf1, rtol=1e-6):
                decs2.append(dec)
                continue
            _, mean, var = _stream_stats(store, sf1, log_base)
            decs2.append(_decompose(mean, var, span))
    with trace_span("quickcsr/hvg"):
        dec = combine_var(decs2)
        hvgs = get_top_hvgs(dec, n=hvg_n)

    # stage 4: sparse value transform on the HVG subset
    with trace_span("quickcsr/transform"):
        transformed = [_lognorm_cosine_csr(store.select_genes(hvgs), sf, log_base, cos_norm)
                       for store, sf in zip(stores, rescaled)]

    # stage 5: streamed Gram PCA, then the merge on its coordinates
    names = list(batch_names) if batch_names is not None else None
    with trace_span("quickcsr/pca"):
        cached = load_pca_stage(pca_cache_dir) if pca_cache_dir is not None else None
        if cached is not None:
            comps, rot, cen, _ = cached
            pca = MultiBatchPCAResult(components=comps, rotation=as_tensor(rot, dev),
                                      centers=as_tensor(cen, dev), batch_names=names)
        else:
            pca = multi_batch_pca_csr(transformed, d=d, weights=weights, block_rows=block_rows,
                                      batch_names=batch_names, mesh=mesh, device=dev)
            if pca_cache_dir is not None:
                if mesh is None or mesh.rank == 0:
                    save_pca_stage(pca_cache_dir, pca.components, pca.rotation, pca.centers,
                                   names)
                if mesh is not None:
                    barrier(mesh)
    with trace_span("quickcsr/merge"):
        if mesh is None:
            res = reduced_mnn(
                pca.components, k=k, prop_k=prop_k, ndist=ndist, merge_order=merge_order,
                auto_merge=auto_merge, min_batch_skip=min_batch_skip, batch_names=batch_names,
                knn_method=knn_method, checkpoint_dir=checkpoint_dir, device=dev,
            )
        else:
            res = distributed_fast_mnn(
                pca.components, mesh, k=k, prop_k=prop_k, ndist=ndist,
                merge_order=merge_order, auto_merge=auto_merge,
                min_batch_skip=0.0 if min_batch_skip is None else min_batch_skip,
                knn_method="exact" if knn_method == "auto" else knn_method,
                memory=memory, pad_buckets=pad_buckets, checkpoint_dir=checkpoint_dir,
                progress=progress,
            )
            if batch_names is not None:
                res.batch = np.asarray(list(batch_names))[np.asarray(res.batch)]
                for info in res.merge_info:
                    info.left = [batch_names[i] for i in info.left]
                    info.right = [batch_names[i] for i in info.right]
                res.batch_names = list(batch_names)
    res = MNNResult(
        corrected=res.corrected,
        batch=res.batch,
        merge_info=res.merge_info,
        rotation=pca.rotation,
        centers=pca.centers,
        var_explained=pca.var_explained,
        var_total=pca.var_total,
        batch_names=res.batch_names,
    )
    return QuickCorrectResult(dec=dec, hvgs=hvgs, corrected=res)


# ---------------------------------------------------------------------------
# Sparse gene-space corrections over CSR stores: sparse at rest, per-gene
# statistics streamed from the CSR buffers, dense only for the working set
# (the reference's dgCMatrix methods, R/rescaleBatches.R:150-182, and lazy
# ResidualMatrix, R/regressBatches.R:148; classic mnnCorrect densifies by
# design, R/mnnCorrect.R:282-284).


def rescale_batches_csr(
    stores: Sequence[CSRCells],
    *,
    log_base: float = 2.0,
    pseudo_count: float = 1.0,
    restrict: Optional[Sequence[Optional[np.ndarray]]] = None,
    subset_row: Optional[np.ndarray] = None,
    correct_all: bool = False,
) -> List[CSRCells]:
    """Sparsity-preserving rescaleBatches over CSR stores, on the host.

    Matches ``rescale_batches`` on values (reference .rescale_batches,
    R/rescaleBatches.R:102-148): unlog each value, scale every gene to the
    minimum per-batch (restricted) average in count space, relog. With
    pseudo_count=1 zeros map to zeros at every stage, so the CSR pattern is
    unchanged and no dense (N, G) matrix ever exists. Returns one corrected
    CSRCells per batch.
    """
    if len(stores) < 2:
        raise ValueError("at least two batches must be specified")
    if pseudo_count != 1.0:
        raise ValueError(
            "pseudo_count must be 1 for the sparsity-preserving CSR path "
            "(log(0/sf + pc) != 0 otherwise); use the dense rescale_batches"
        )
    if correct_all:
        subset_row = None
    if subset_row is not None:
        stores = [s.select_genes(np.asarray(subset_row)) for s in stores]
    g = stores[0].n_genes
    for s in stores[1:]:
        if s.n_genes != g:
            raise ValueError("number of features is not the same across batches")

    lb = float(log_base)
    averages = []
    for i, s in enumerate(stores):
        sub = s
        if restrict is not None and restrict[i] is not None:
            sub = s.select_cells(np.asarray(restrict[i]))
        averages.append(csr_unlog_colsums(sub.data, sub.indices, g, lb) / max(sub.n_cells, 1))

    reference = np.minimum.reduce(averages)
    out = []
    for s, a in zip(stores, averages):
        with np.errstate(invalid="ignore", divide="ignore"):
            scale = reference / a
        scale[~np.isfinite(scale)] = 0.0
        out.append(CSRCells(data=csr_rescale_values(s.data, s.indices, scale, lb),
                            indices=s.indices, indptr=s.indptr, n_genes=g,
                            gene_names=s.gene_names))
    return out


@dataclass
class CSRResidualOp:
    """Lazy residual operator over a CSR store (out-of-core ResidualMatrix).

    residuals = X - design[:, drop] @ beta[drop], on the host; a block
    materializes in O(block x G) memory and the CSR base stays sparse.
    """

    store: CSRCells
    design: np.ndarray        # (N, P)
    beta: np.ndarray          # (P, G)
    drop: np.ndarray

    @property
    def shape(self):
        return self.store.shape

    def block(self, row_start: int, row_end: int) -> np.ndarray:
        dense = self.store.to_dense(row_start, row_end)
        d = self.design[row_start:row_end][:, self.drop]
        return dense - d @ self.beta[self.drop]

    def materialize(self) -> np.ndarray:
        return self.block(0, self.store.n_cells)

    def blocks(self, block_rows: int = 8192):
        n = self.store.n_cells
        for start in range(0, n, block_rows):
            yield self.block(start, min(start + block_rows, n)), start


def regress_batches_csr(
    stores: Sequence[CSRCells],
    *,
    design: Optional[np.ndarray] = None,
    keep: Optional[Sequence[int]] = None,
    restrict: Optional[Sequence[Optional[np.ndarray]]] = None,
    block_rows: int = 8192,
    device: DeviceLike = None,
) -> CSRResidualOp:
    """Lazy linear-model residuals over the row-concatenated CSR stores.

    Out-of-core counterpart of ``regress_batches`` (reference
    regressBatches, R/regressBatches.R:93-158): design^T X is accumulated in
    fp32 on ``device`` (default: the CUDA device; raises without one unless
    ``device="cpu"``) over streamed blocks, the (P, G) coefficients are
    ``np.linalg.pinv(design^T design) @ design^T X`` in fp64 on the host,
    and :class:`CSRResidualOp` yields the residuals block by block.
    """
    dev = resolve_device(device)
    if len(stores) < 1:
        raise ValueError("at least one batch must be specified")
    g = stores[0].n_genes
    sizes = [s.n_cells for s in stores]
    n = int(np.sum(sizes))
    if design is None:
        design = np.eye(len(stores))[np.repeat(np.arange(len(stores)), sizes)]
    else:
        design = np.asarray(design, dtype=np.float64)
        if design.shape[0] != n:
            raise ValueError("'design' should have one row per cell")
    p = design.shape[1]

    fit_mask = np.ones(n, dtype=bool)
    if restrict is not None:
        fit_mask[:] = False
        off = 0
        for r, sz in zip(restrict, sizes):
            if r is None:
                fit_mask[off:off + sz] = True
            else:
                fit_mask[np.asarray(r) + off] = True
            off += sz

    dfit = np.where(fit_mask[:, None], design, 0.0)
    xtx = dfit.T @ dfit                               # (P, P), host
    dty = torch.zeros((p, g), dtype=torch.float32, device=dev)
    off = 0
    with full_fp32_matmul():
        for s in stores:
            for block, n_valid in device_dense_blocks(s, block_rows, pad=False, device=dev):
                db = as_tensor(dfit[off:off + n_valid], dev, torch.float32)
                dty += db.T @ block
                off += n_valid
    beta = np.linalg.pinv(xtx) @ dty.cpu().numpy().astype(np.float64)
    drop = np.arange(p) if keep is None else np.setdiff1d(np.arange(p), np.asarray(keep))

    # one concatenated store for blockwise access
    indptr = [np.asarray(stores[0].indptr, dtype=np.int64)]
    shift = int(stores[0].indptr[-1])
    for s in stores[1:]:
        indptr.append(np.asarray(s.indptr[1:], dtype=np.int64) + shift)
        shift += int(s.indptr[-1])
    combined = CSRCells(
        data=np.concatenate([s.data for s in stores]),
        indices=np.concatenate([s.indices for s in stores]),
        indptr=np.concatenate(indptr), n_genes=g, gene_names=stores[0].gene_names,
    )
    return CSRResidualOp(store=combined, design=design, beta=beta, drop=drop)


def _densify_on_device(store: CSRCells, block_rows: int, dev: torch.device) -> torch.Tensor:
    """(N, G) dense device matrix built from streamed sparse blocks: the
    host never holds a dense block."""
    blocks = [block for block, _ in device_dense_blocks(store, block_rows, pad=False,
                                                        device=dev)]
    if not blocks:
        return torch.zeros((0, store.n_genes), dtype=torch.float32, device=dev)
    return blocks[0] if len(blocks) == 1 else torch.cat(blocks, 0)


def mnn_correct_csr(
    stores: Sequence[CSRCells],
    *,
    subset_row: Optional[np.ndarray] = None,
    correct_all: bool = False,
    block_rows: int = 16384,
    device: DeviceLike = None,
    **kwargs,
) -> MNNResult:
    """Classic mnnCorrect over CSR stores, on ``device`` (default: the CUDA
    device; raises without one unless ``device="cpu"``).

    Genes are subset on the CSR side (``CSRCells.select_genes``). Without
    ``correct_all`` the working set is the gene subset, densified on the
    device from streamed blocks. With ``correct_all`` and ``subset_row`` the
    full-gene out-matrices densify on the host and the merge runs with
    ``out_on_host=True`` (``classic_mnn.mnn_correct``): the device holds the
    subset in-matrices and each step's operands, and ``corrected`` is a host
    array (classic mode's result is dense by definition, reference
    R/mnnCorrect.R:282-284). ``correct_all`` without ``subset_row`` corrects
    every gene on the device.
    """
    from .classic_mnn import mnn_correct

    dev = resolve_device(device)
    if subset_row is not None and not correct_all:
        ins = [s.select_genes(np.asarray(subset_row)) for s in stores]
        dense = [_densify_on_device(s, block_rows, dev) for s in ins]
        return mnn_correct(dense, subset_row=None, correct_all=False, device=dev, **kwargs)
    if subset_row is not None and correct_all:
        return mnn_correct([s.to_dense() for s in stores], subset_row=subset_row,
                           correct_all=True, out_on_host=True, device=dev, **kwargs)
    dense = [_densify_on_device(s, block_rows, dev) for s in stores]
    return mnn_correct(dense, subset_row=subset_row, correct_all=correct_all, device=dev,
                       **kwargs)
