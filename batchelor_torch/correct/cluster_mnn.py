"""clusterMNN: cluster-level MNN correction with per-cell propagation.

Counterpart of ``batchelor_tpu/correct/cluster_mnn.py`` (reference
clusterMNN, R/clusterMNN.R:101-312), dense and out-of-core: per-batch cluster
centroids -> full-rank multi-batch PCA of the centroids -> reducedMNN with
k=1 on the centroids -> per-cell propagation by a variable-bandwidth
Gaussian kernel -> meta-clusters as connected components of the centroid
MNN-pair graph. The cells' nearest-centroid search is the port's
``query_knn`` (on the card kernel K5 while the centroids' PCs are at most
128 wide); every distance product runs in full fp32. ``cluster_mnn_csr`` takes CSR stores: its
centroids are host means over the nonzeros, and the cells' projection
streams through the device block by block; both share the merge and the
propagation.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, as_tensor, full_fp32_matmul, resolve_device
from ..ops.cosine_norm import apply_cosine_norm, cosine_norm, subset_columns
from ..ops.knn import query_knn
from ..ops.lowrank import LowRankOp
from ..io.csr import CSRCells, device_dense_blocks, row_l2_norms
from ..ops.pca import multi_batch_pca
from ..ops.pca_outofcore import multi_batch_pca_csr
from ..utils.batching import check_batch_consistency, check_restrictions, divide_into_batches
from .fast_mnn import MNNResult, reduced_mnn

__all__ = ["cluster_mnn", "cluster_mnn_csr", "kmeans_clusters", "ClusterMNNResult"]


def _sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(N, C) squared distances |x|^2 - 2 x.c + |c|^2 in full fp32."""
    with full_fp32_matmul():
        return (x * x).sum(1)[:, None] - 2 * (x @ c.T) + (c * c).sum(1)[None, :]


def lloyd_step(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """One Lloyd iteration: assign each row to its nearest centre (ties to
    the lower centre), then move each centre to its rows' mean; a centre
    that keeps no row stays where it was."""
    assign = torch.argmin(_sq_dists(x, centers), 1)
    sums = torch.zeros_like(centers).index_add_(0, assign, x)
    counts = torch.bincount(assign, minlength=centers.shape[0]).to(x.dtype)
    return torch.where(counts[:, None] > 0, sums / counts.clamp(min=1)[:, None], centers)


def kmeans_clusters(x, n_clusters: int, n_iter: int = 50, seed: int = 0, *,
                    device: DeviceLike = None) -> np.ndarray:
    """Deterministic k-means (k-means++ init) for the auto-clustering path
    (reference's BlusterParam option, R/clusterMNN.R:200-218).

    ``x``: (N, d) rows, moved to ``device`` (default: the CUDA device;
    raises without one unless ``device="cpu"``). The k-means++ draws come
    from a CPU ``torch.Generator`` seeded by ``seed`` (one uniform number a
    centre, inverted on the device through the cumulative D^2 weights), so
    the card and the CPU draw the same numbers; they are not the JAX
    package's ``jax.random`` draws, so its partitions agree with JAX's only
    up to relabelling and the local optimum reached. Returns host labels.
    """
    dev = resolve_device(device)
    x = as_tensor(x, dev)
    n = x.shape[0]
    u = torch.rand(n_clusters, generator=torch.Generator().manual_seed(seed),
                   dtype=torch.float64).to(dev)
    centers = torch.empty((n_clusters, x.shape[1]), dtype=x.dtype, device=dev)
    centers[0] = x[(u[0] * n).long().clamp(max=n - 1)]
    for i in range(1, n_clusters):
        d2 = _sq_dists(x, centers[:i]).amin(1).clamp(min=0).double()
        cum = torch.cumsum(d2, 0)
        pick = torch.searchsorted(cum, (u[i] * cum[-1]).reshape(1), right=True)
        centers[i] = x[pick.clamp(max=n - 1)][0]
    for _ in range(n_iter):
        centers = lloyd_step(x, centers)
    return torch.argmin(_sq_dists(x, centers), 1).cpu().numpy()


def _union_find(n: int, edges: np.ndarray) -> np.ndarray:
    """Connected components, labelled in order of first appearance
    (igraph membership style); mirrors igraph::components usage at
    reference R/clusterMNN.R:162-165."""
    parent = np.arange(n)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for u, v in np.asarray(edges).reshape(-1, 2):
        ru, rv = find(int(u)), find(int(v))
        if ru != rv:
            parent[max(ru, rv)] = min(ru, rv)
    labels = {}
    out = np.empty(n, dtype=np.int64)
    for i in range(n):
        out[i] = labels.setdefault(find(i), len(labels))
    return out


@dataclass
class ClusterMNNResult:
    """clusterMNN outputs.

    corrected: (N_total, d) per-cell corrected coordinates (input order).
    batch: per-cell batch label; cluster: per-cell cluster label.
    cluster_meta: per-centroid table (cluster label, batch, meta component).
    centroid_result: the underlying reducedMNN result on centroids.
    rotation/centers: PCA metadata for low-rank reconstruction.
    """

    corrected: torch.Tensor
    batch: np.ndarray
    cluster: np.ndarray
    cluster_meta: dict
    centroid_result: MNNResult
    rotation: Optional[torch.Tensor] = None
    centers: Optional[torch.Tensor] = None

    def reconstructed(self) -> LowRankOp:
        """Lazy low-rank per-gene values (cf. MNNResult.reconstructed)."""
        return LowRankOp(self.rotation, self.corrected)


def _compute_centroids(batches, clusters, restrict):
    """Per-batch, per-cluster mean profiles over restricted cells
    (reference .compute_centroids, R/clusterMNN.R:228-242).
    Returns (centers list [(C_b, G)], level lists)."""
    centers, levels = [], []
    for i, (b, cl) in enumerate(zip(batches, clusters)):
        cl = np.asarray(cl)
        bsel = b
        if restrict is not None and restrict[i] is not None:
            ridx = np.asarray(restrict[i])
            cl = cl[ridx]
            bsel = b[as_tensor(ridx, b.device, torch.long)]
        lv, assign = np.unique(cl, return_inverse=True)
        seg = as_tensor(assign.ravel(), b.device, torch.long)
        sums = torch.zeros((lv.size, b.shape[1]), dtype=b.dtype, device=b.device)
        sums.index_add_(0, seg, bsel)
        counts = np.bincount(assign.ravel(), minlength=lv.size).astype(np.float64)
        centers.append(sums / as_tensor(counts, b.device, b.dtype)[:, None])
        levels.append(lv.tolist())
    return centers, levels


def _median(v: torch.Tensor) -> torch.Tensor:
    """Median with ``jnp.median``'s rule: the mean of the two middle values
    of an even count (``torch.median`` returns the lower one)."""
    s = torch.sort(v).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) / 2


def _propagate(proj, cent, delta, restrict_idx):
    """Softmax-weighted centroid deltas (the reference's
    .smooth_gaussian_from_centroids, R/clusterMNN.R:289-312); sigma is the
    median distance of the (restricted) cells to their nearest centroid."""
    q = proj if restrict_idx is None else proj[as_tensor(restrict_idx, proj.device, torch.long)]
    _, dist = query_knn(q, cent, 1, device=proj.device)
    sigma = _median(dist[:, 0])
    w = torch.softmax(-_sq_dists(proj, cent) / (sigma * sigma), dim=1)
    with full_fp32_matmul():
        return proj + w @ delta


def cluster_mnn(
    batches_or_single,
    batch: Optional[Sequence] = None,
    *,
    clusters,
    restrict=None,
    cos_norm: bool = True,
    merge_order=None,
    auto_merge: bool = False,
    min_batch_skip: Optional[float] = 0.0,
    subset_row: Optional[np.ndarray] = None,
    correct_all: bool = False,
    batch_names: Optional[Sequence[str]] = None,
    device: DeviceLike = None,
) -> ClusterMNNResult:
    """Cluster-level MNN correction (reference clusterMNN, R/clusterMNN.R:101-176).

    Input: a list of (N_b, G) matrices (cells in rows) or a single matrix
    plus ``batch``, arrays or tensors, moved to ``device`` (default: the
    CUDA device; raises without one unless ``device="cpu"``).
    ``clusters``: list of per-batch cluster label vectors (or a single vector
    for single-matrix input), or an int K to auto-cluster each batch with
    k-means on its top-50 PCs.
    """
    dev = resolve_device(device)
    single = not isinstance(batches_or_single, (list, tuple))
    if single:
        x = as_tensor(batches_or_single, dev)
        if batch is None:
            raise ValueError("'batch' must be specified for a single input matrix")
        divided = divide_into_batches(
            np.arange(x.shape[0]), batch, cells_in_rows=True, restrict=restrict
        )
        batches = [x[as_tensor(idx, dev, torch.long)] for idx in divided.batches]
        restrict = divided.restricted
        if batch_names is None:
            batch_names = [str(n) for n in divided.names]
        if not isinstance(clusters, int):
            cl = np.asarray(clusters)
            clusters = [cl[idx] for idx in divided.batches]
    else:
        batches = [as_tensor(b, dev) for b in batches_or_single]
        check_batch_consistency(batches, cells_in_rows=True)
        restrict = check_restrictions(batches, restrict, cells_in_rows=True)

    nb = len(batches)
    if isinstance(clusters, int):
        kk = clusters
        clusters = []
        for b in batches:
            sub = b if subset_row is None else subset_columns(b, np.asarray(subset_row))
            d = min(50, sub.shape[0] - 1, sub.shape[1])
            pcs = multi_batch_pca([sub], d=d, device=dev).components[0]
            clusters.append(kmeans_clusters(pcs, kk, device=dev))
    if len(clusters) != nb:
        raise ValueError("'clusters' should have one entry per batch")

    if cos_norm:
        l2s = [cosine_norm(b, mode="l2norm", subset_row=subset_row) for b in batches]
        batches_n = [apply_cosine_norm(b, l2) for b, l2 in zip(batches, l2s)]
    else:
        batches_n = batches

    centers, levels = _compute_centroids(batches_n, clusters, restrict)

    def project(i, rotation, adj):
        b = batches_n[i]
        sub = b if subset_row is None else subset_columns(b, np.asarray(subset_row))
        with full_fp32_matmul():
            return sub @ rotation - adj[None, :]

    res = _correct_by_centroids(
        centers, levels, clusters, project, [b.shape[0] for b in batches], restrict,
        subset_row=subset_row, correct_all=correct_all, merge_order=merge_order,
        auto_merge=auto_merge, min_batch_skip=min_batch_skip, batch_names=batch_names,
        device=dev)
    if single:
        reo = divided.reorder
        res.corrected = res.corrected[as_tensor(reo, dev, torch.long)]
        res.batch = res.batch[reo]
        res.cluster = res.cluster[reo]
    return res


def _correct_by_centroids(centers, levels, clusters, project, n_cells, restrict, *,
                          subset_row, correct_all, merge_order, auto_merge,
                          min_batch_skip, batch_names, device) -> ClusterMNNResult:
    """What ``cluster_mnn`` and ``cluster_mnn_csr`` share once each batch's
    centroids are known: the centroids' full-rank PCA, their reducedMNN
    merge with k=1, the per-cell propagation and the meta-clusters.
    ``project(i, rotation, adj)`` returns batch i's (N_i, d) cells in the
    centroids' PCs; the result is in batch order."""
    dev = device
    nb = len(centers)
    # full-rank PCA of the centroids (reference .full_rank_pca,
    # R/clusterMNN.R:174-184): d = total#centroids - 1, exact; "gram" takes
    # the smaller-side cross-product, a (n_centroids x n_centroids) eigh
    total_centroids = sum(c.shape[0] for c in centers)
    pca = multi_batch_pca(
        centers,
        d=total_centroids - 1,
        subset_row=subset_row,
        get_all_genes=correct_all and subset_row is not None,
        method="gram",
        batch_names=batch_names,
        device=dev,
    )
    merge_out = reduced_mnn(
        pca.components,
        k=1,
        merge_order=merge_order,
        auto_merge=auto_merge,
        min_batch_skip=min_batch_skip,
        batch_names=batch_names,
        device=dev,
    )

    # per-cell propagation (reference .propagate_to_cells,
    # R/clusterMNN.R:250-312)
    rotation, centers_vec = pca.rotation, pca.centers
    if correct_all and subset_row is not None:
        s = as_tensor(np.asarray(subset_row), dev, torch.long)
        rotation, centers_vec = rotation[s], centers_vec[s]
    with full_fp32_matmul():
        adj = centers_vec @ rotation

    corrected_blocks = []
    last = 0
    for i in range(nb):
        cent = pca.components[i]
        ncent = cent.shape[0]
        delta = merge_out.corrected[last:last + ncent] - cent
        last += ncent
        r = None if restrict is None else restrict[i]
        corrected_blocks.append(_propagate(project(i, rotation, adj), cent, delta, r))

    origin = np.repeat(np.arange(nb), n_cells)
    # meta-clusters: connected components of the centroid pair graph
    # (reference R/clusterMNN.R:162-165)
    all_pairs = (np.concatenate([info.pairs for info in merge_out.merge_info])
                 if merge_out.merge_info else np.empty((0, 2), dtype=np.int64))
    centroid_batches = np.repeat(np.arange(nb), [len(lv) for lv in levels])
    return ClusterMNNResult(
        corrected=torch.cat(corrected_blocks, 0),
        batch=np.asarray(batch_names)[origin] if batch_names is not None else origin,
        cluster=np.concatenate([np.asarray(c) for c in clusters]),
        cluster_meta={
            "cluster": np.concatenate([np.asarray(lv) for lv in levels]),
            "batch": (np.asarray(batch_names)[centroid_batches]
                      if batch_names is not None else centroid_batches),
            "meta": _union_find(total_centroids, all_pairs),
        },
        centroid_result=merge_out,
        rotation=pca.rotation,
        centers=pca.centers,
    )


# --------------------------------------------------------------- out of core


def _csr_cluster_means(csr: CSRCells, assign: np.ndarray, n_clusters: int,
                       row_scale: np.ndarray, nnz_chunk: int = 1 << 26) -> np.ndarray:
    """(n_clusters, G) float32 means of the scaled rows of each cluster,
    one bincount pass over the nonzeros in chunks, on the host. ``assign``
    is -1 for rows left out (not restricted). The out-of-core
    sumCountsAcrossCells centroids (R/clusterMNN.R:228-242)."""
    g = csr.n_genes
    counts = np.diff(csr.indptr)
    assign_nnz = np.repeat(assign, counts)
    scale_nnz = np.repeat(row_scale, counts)
    sums = np.zeros(n_clusters * g, np.float64)
    nnz = csr.data.shape[0]
    for lo in range(0, nnz, nnz_chunk):
        hi = min(lo + nnz_chunk, nnz)
        a = assign_nnz[lo:hi]
        keep = a >= 0
        flat = a[keep].astype(np.int64) * g + csr.indices[lo:hi][keep]
        w = np.asarray(csr.data[lo:hi][keep], np.float64) * scale_nnz[lo:hi][keep]
        sums += np.bincount(flat, weights=w, minlength=n_clusters * g)
    ncells = np.bincount(assign[assign >= 0], minlength=n_clusters).astype(np.float64)
    return (sums.reshape(n_clusters, g) / np.maximum(ncells, 1.0)[:, None]).astype(np.float32)


def _proj_block(block, l2, rotation, adj):
    """Cosine-normalize rows as apply_cosine_norm does (the same fp32
    division) and project them onto the centroid rotation."""
    safe = l2.to(block.dtype).clamp(min=1e-8)
    with full_fp32_matmul():
        return (block / safe[:, None]) @ rotation - adj[None, :]


def cluster_mnn_csr(
    batches: Sequence,
    *,
    clusters,
    restrict=None,
    cos_norm: bool = True,
    merge_order=None,
    auto_merge: bool = False,
    min_batch_skip: Optional[float] = 0.0,
    subset_row: Optional[np.ndarray] = None,
    correct_all: bool = False,
    batch_names: Optional[Sequence[str]] = None,
    block_rows: int = 16384,
    device: DeviceLike = None,
) -> ClusterMNNResult:
    """Out-of-core clusterMNN over CSRCells stores.

    Matches :func:`cluster_mnn` on the densified inputs, but no expression
    matrix densifies beyond one (block_rows, G_sub) block: the centroids
    are host means over the nonzeros (no transfer of the expression), and
    the cells' projection streams subset-gene blocks through ``device``
    (default: the CUDA device; raises without one unless ``device="cpu"``)
    as nonzeros. The reference runs this on
    file-backed matrices through block-processed cosineNorm
    (R/cosineNorm.R:59-61) and streamed centroids (R/clusterMNN.R:228-242).

    ``clusters``: a list of per-batch label vectors, or an int K to cluster
    each batch with k-means on its top-50 streamed PCs.
    """
    dev = resolve_device(device)
    if not isinstance(batches, (list, tuple)) or not all(
        isinstance(b, CSRCells) for b in batches
    ):
        raise ValueError("cluster_mnn_csr expects a list of CSRCells stores")
    nb = len(batches)
    if nb < 2:
        raise ValueError("at least two batches must be specified")
    g = batches[0].n_genes
    if any(b.n_genes != g for b in batches):
        raise ValueError("all batches must have the same genes")
    if restrict is None:
        restrict = [None] * nb
    sub = None if subset_row is None else np.asarray(subset_row)

    if isinstance(clusters, int):
        kk = clusters
        clusters = []
        for b in batches:
            s = b if sub is None else b.select_genes(sub)
            pcs = multi_batch_pca_csr([s], d=min(50, s.n_cells - 1, s.n_genes),
                                      block_rows=block_rows, device=dev).components[0]
            clusters.append(kmeans_clusters(pcs, kk, device=dev))
    if len(clusters) != nb:
        raise ValueError("'clusters' should have one entry per batch")

    # cosine-norm scales per cell: l2 over the subset genes, applied to all
    # (as the dense path, reference R/clusterMNN.R:138-141)
    if cos_norm:
        l2s = [row_l2_norms(b, sub) for b in batches]
    else:
        l2s = [np.full(b.n_cells, 1.0) for b in batches]
    scales = [1.0 / np.maximum(l2, 1e-8) for l2 in l2s]

    # centroids over the restricted cells
    centers, levels = [], []
    for i, (b, cl) in enumerate(zip(batches, clusters)):
        cl = np.asarray(cl)
        keep = np.ones(b.n_cells, bool)
        if restrict[i] is not None:
            keep[:] = False
            keep[np.asarray(restrict[i])] = True
        lv = sorted(set(cl[keep].tolist()))
        assign = np.full(b.n_cells, -1, dtype=np.int64)
        assign[keep] = np.searchsorted(np.asarray(lv), cl[keep])
        centers.append(as_tensor(_csr_cluster_means(b, assign, len(lv), scales[i]), dev))
        levels.append(lv)

    # the cells' projection streams through the device; (N_b, d) stays there
    l2s = [as_tensor(l2.astype(np.float32), dev) for l2 in l2s]

    def project(i, rotation, adj):
        store = batches[i] if sub is None else batches[i].select_genes(sub)
        projs, row0 = [], 0
        for block, n_valid in device_dense_blocks(store, block_rows, pad=False, device=dev):
            projs.append(_proj_block(block, l2s[i][row0:row0 + n_valid], rotation, adj))
            row0 += n_valid
        return torch.cat(projs, 0)

    return _correct_by_centroids(
        centers, levels, clusters, project, [b.n_cells for b in batches], restrict,
        subset_row=sub, correct_all=correct_all, merge_order=merge_order,
        auto_merge=auto_merge, min_batch_skip=min_batch_skip, batch_names=batch_names,
        device=dev)
