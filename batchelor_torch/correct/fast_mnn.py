"""fastMNN and reducedMNN: PC-space mutual-nearest-neighbour batch correction.

Counterpart of ``batchelor_tpu/correct/fast_mnn.py`` (reference
R/fastMNN.R:283-658, R/reducedMNN.R:61-95). ``fast_mnn`` starts from gene
space: cosine-norm -> multi_batch_pca -> the merge loop; ``reduced_mnn``
starts from precomputed low-dimensional coordinates. The merge-tree walk is
host-side Python (``utils/trees.py::walk_merge_tree``); this module supplies
its merge step, whose numeric work (kNN/MNN, averaging, orthogonalization,
tricube apply) runs on the tensors' device. Each merge step finds MNN pairs
between the left and right sets, removes variation along the average batch
vector ("kissing" protection, R/fastMNN.R:84-88), then applies
tricube-smoothed per-cell corrections.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, as_tensor, resolve_device
from ..io.checkpoint import MergeCheckpointer
from ..ops.correction import (
    average_correction,
    batch_magnitude,
    batch_var,
    center_along_batch_vector,
    orthogonalize_other,
    per_batch_var,
    tricube_weighted_correction,
)
from ..ops.cosine_norm import apply_cosine_norm, cosine_norm
from ..ops.lowrank import LowRankOp
from ..ops.mutual_nn import choose_k, restricted_mnn, restricted_mnn_on_device
from ..ops.pca import multi_batch_pca
from ..utils.batching import (
    check_batch_consistency,
    check_restrictions,
    combine_restrict,
    divide_into_batches,
    finish_output,
)
from ..utils.telemetry import get_recorder, trace_span
from ..utils.trees import MergeNode, MergeStepInfo, StepOutcome, walk_merge_tree

__all__ = ["fast_mnn", "reduced_mnn", "MNNResult", "MergeStepInfo"]


@dataclass
class MNNResult:
    """Corrected coordinates plus diagnostics.

    corrected: (N_total, d) corrected coordinates (a tensor), input cell order.
    batch: per-cell batch label (int index or name).
    merge_info: one MergeStepInfo per merge step.
    rotation/centers: PCA metadata when fast_mnn ran the PCA itself; the
      ``reconstructed`` low-rank per-gene matrix is rotation @ corrected.T.
    """

    corrected: torch.Tensor
    batch: np.ndarray
    merge_info: List[MergeStepInfo]
    rotation: Optional[torch.Tensor] = None
    centers: Optional[torch.Tensor] = None
    var_explained: Optional[np.ndarray] = None
    var_total: Optional[float] = None
    batch_names: Optional[list] = None
    cell_names: Optional[np.ndarray] = None   # per output cell (input order)
    gene_names: Optional[np.ndarray] = None   # rows of ``rotation``

    def reconstructed(self, rows=None, cols=None):
        """Low-rank per-gene corrected values (genes x cells) as a lazy
        operator (reference LowRankMatrix, R/convertPCsToSCE.R:50-72).

        Returns a :class:`~batchelor_torch.ops.lowrank.LowRankOp`; with
        ``rows``/``cols`` the materialized block, in O(block) memory.
        """
        if self.rotation is None:
            raise ValueError("no rotation available (d=None or reduced input)")
        op = LowRankOp(self.rotation, self.corrected)
        if rows is not None or cols is not None:
            return op.block(rows, cols)
        return op


# --------------------------------------------------------------------------
# the merge step (reference .fast_mnn_core, R/fastMNN.R:436-562); the walk
# over the merge tree is utils/trees.py's


def _count_pairs(left: MergeNode, right: MergeNode, k, prop_k) -> int:
    """MNN pairs between two nodes, each side orthogonalized against the
    other's batch vectors first (auto-merge's count, reference
    R/MNN_tree.R:160-167)."""
    rd = orthogonalize_other(right.data, right.restrict, left.extras)
    ld = orthogonalize_other(left.data, left.restrict, right.extras)
    pairs = restricted_mnn(ld, left.restrict, rd, right.restrict, k=k, prop_k=prop_k,
                           device=ld.device)
    return int(pairs.first.shape[0])


def _read(value: torch.Tensor):
    """A value of the card read on the host, counted as
    ``fastmnn/host_reads``: the merge step's waits for the card."""
    rec = get_recorder()
    if rec is not None:
        rec.add("fastmnn/host_reads")
    return value.tolist()


def _layout(node: MergeNode):
    """The node's (row labels, row counts) on its data's device, which
    ``per_batch_var`` takes: a leaf's are made there, a merged node's are its
    sides' (set by ``_merge_step``); a node loaded from a checkpoint copies
    its ``origin`` over once."""
    if node.layout is None:
        dev, n = node.data.device, node.data.shape[0]
        if len(node.index) == 1:
            node.layout = (torch.zeros(n, device=dev, dtype=torch.long),
                           torch.full((1,), n, device=dev, dtype=torch.long))
        else:
            mapping = np.zeros(max(node.index) + 1, dtype=np.int64)
            mapping[node.index] = np.arange(len(node.index))
            labels = mapping[np.asarray(node.origin)]
            node.layout = (as_tensor(labels, dev, torch.long),
                           as_tensor(np.bincount(labels, minlength=len(node.index)), dev))
    return node.layout


def _lost_var(ssd: torch.Tensor, left: list, right: list, sizes: np.ndarray) -> np.ndarray:
    """lost.var per input batch (reference R/fastMNN.R:500-501) from a
    step's ``per_batch_var`` sums, copied to the host in the order left old,
    right old, left new, right new; batches outside the step keep ratio 1."""
    lo, ro, ln, rn = np.split(ssd.numpy(), np.cumsum([len(left), len(right), len(left)]))
    var_kept = np.ones(len(sizes), dtype=np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        var_kept[left] = batch_var(ln, sizes[left]) / batch_var(lo, sizes[left])
        var_kept[right] = batch_var(rn, sizes[right]) / batch_var(ro, sizes[right])
    return 1.0 - var_kept


def _merge_step(mdx: int, left: MergeNode, right: MergeNode, *, k, prop_k, ndist,
                min_batch_skip, knn_method, sizes) -> StepOutcome:
    """One fastMNN merge: MNN pairs between the two sides, the batch vector
    removed from both (R/fastMNN.R:84-88), then the right side corrected by
    tricube-smoothed per-cell vectors.

    The step reads one value of the card, the pair counts that size the
    pairs; the rest stays there until the walk ends: the pairs, the
    variance sums and the batch size leave by copies that do not wait.
    ``min_batch_skip`` reads the batch size when it is set."""
    (l_labels, l_counts), (r_labels, r_counts) = _layout(left), _layout(right)

    def sums(left_data, right_data):
        return [per_batch_var(left_data, l_labels, l_counts),
                per_batch_var(right_data, r_labels, r_counts)]

    old = sums(left.data, right.data)

    # Replay earlier batch vectors on the opposite side before MNN search
    # (reference R/fastMNN.R:472-474).
    with trace_span("fastmnn/orthogonalize", step=mdx):
        right_data = orthogonalize_other(right.data, right.restrict, left.extras)
        left_data = orthogonalize_other(left.data, left.restrict, right.extras)

    with trace_span("fastmnn/mnn_search", step=mdx):
        first, second = restricted_mnn_on_device(
            left_data, left.restrict, right_data, right.restrict,
            k=k, prop_k=prop_k, method=knn_method, device=left_data.device, read=_read,
        )
    n_pairs = first.shape[0]
    if n_pairs == 0:
        raise ValueError(
            f"no MNN pairs found at merge step {mdx}; increase k or check inputs"
        )

    averaged, _second = average_correction(left_data, first, right_data, second)
    overall = averaged.mean(0)

    # batch.size is always reported (reference R/fastMNN.R:484-492);
    # min.batch.skip only gates the skip decision, and the scalar is read
    # here only when that gate can fire: else its copy lands as the walk ends.
    batch_size = batch_magnitude(averaged)
    skipped = False
    if min_batch_skip is not None and min_batch_skip > 0.0:
        batch_size = _read(batch_size)
        skipped = batch_size < min_batch_skip
    else:
        batch_size = batch_size.to("cpu", non_blocking=True)

    if not skipped:
        with trace_span("fastmnn/correct", step=mdx):
            left_data = center_along_batch_vector(left_data, overall, left.restrict)
            right_data = center_along_batch_vector(right_data, overall, right.restrict)
            new = sums(left_data, right_data)
            to_add = [overall]
            re_avg, involved = average_correction(left_data, first, right_data, second)
            right_data = tricube_weighted_correction(
                right_data,
                re_avg,
                involved,
                k=choose_k(k, prop_k, right_data.shape[0]),
                ndist=ndist,
            )
    else:
        to_add = []
        new = sums(left_data, right_data)

    rec = get_recorder()
    if rec is not None:
        rec.add("merge_steps")
        rec.add("mnn_pairs", float(n_pairs))
        rec.add("cells_merged", float(left.data.shape[0] + right.data.shape[0]))

    merged = MergeNode(
        index=list(left.index) + list(right.index),
        data=torch.cat([left_data, right_data], 0),
        restrict=combine_restrict(
            left_data.shape[0], left.restrict, right_data.shape[0], right.restrict
        ),
        origin=np.concatenate([left.origin, right.origin]),
        extras=list(left.extras) + list(right.extras) + to_add,
        layout=(torch.cat([l_labels, r_labels + len(left.index)]),
                torch.cat([l_counts, r_counts])),
    )
    ssd = torch.cat(old + new).to("cpu", non_blocking=True)
    return StepOutcome(
        node=merged,
        pairs=torch.stack([first, second], 1).to("cpu", non_blocking=True),
        lost_var=functools.partial(_lost_var, ssd, list(left.index), list(right.index), sizes),
        batch_size=batch_size,
        skipped=skipped)


def _fast_mnn_core(
    batches: Sequence[torch.Tensor],
    restrict: Optional[Sequence[Optional[np.ndarray]]],
    *,
    k: int = 20,
    prop_k: Optional[float] = None,
    ndist: float = 3.0,
    merge_order=None,
    auto_merge: bool = False,
    min_batch_skip: Optional[float] = 0.0,
    batch_names: Optional[Sequence[str]] = None,
    checkpoint_dir: Optional[str] = None,
    knn_method: str = "exact",
):
    checkpointer = None if checkpoint_dir is None else MergeCheckpointer(checkpoint_dir)
    if restrict is None:
        restrict = [None] * len(batches)
    step = functools.partial(_merge_step, k=k, prop_k=prop_k, ndist=ndist,
                             min_batch_skip=min_batch_skip, knn_method=knn_method,
                             sizes=np.array([b.shape[0] for b in batches]))
    corrected, labels, merge_info = walk_merge_tree(
        [MergeNode.leaf(i, b, r) for i, (b, r) in enumerate(zip(batches, restrict))],
        step, merge_order=merge_order, names=batch_names, auto_merge=auto_merge,
        count=functools.partial(_count_pairs, k=k, prop_k=prop_k),
        checkpointer=checkpointer, device=batches[0].device, span="fastmnn/step",
    )
    return MNNResult(
        corrected=corrected,
        batch=labels,
        merge_info=merge_info,
        batch_names=list(batch_names) if batch_names is not None else None,
    )


# --------------------------------------------------------------------------
# public entry point


def reduced_mnn(
    batches_or_single,
    batch: Optional[Sequence] = None,
    *,
    k: int = 20,
    prop_k: Optional[float] = None,
    restrict=None,
    ndist: float = 3.0,
    merge_order=None,
    auto_merge: bool = False,
    min_batch_skip: Optional[float] = 0.0,
    batch_names: Optional[Sequence[str]] = None,
    checkpoint_dir: Optional[str] = None,
    knn_method: str = "exact",
    cell_names=None,
    device: DeviceLike = None,
) -> MNNResult:
    """MNN correction on precomputed low-dimensional coordinates.

    Equivalent of reducedMNN (reference R/reducedMNN.R:61-95): either a list
    of (N_b, d) matrices, or a single (N, d) matrix plus a ``batch`` vector.
    Inputs may be arrays or tensors; they are moved to ``device`` (default:
    the CUDA device; raises without one unless ``device="cpu"``).
    ``cell_names``: per-batch name vectors (list input) or one input-order
    vector (single input), carried to the output like the reference's
    .rename_output (R/utils_multibatch.R:3-33). ``checkpoint_dir``: save
    each merge step there and resume from the steps it already holds
    (``io/checkpoint.py``; the JAX package's format).
    """
    with trace_span("fastmnn/call", entry="reduced_mnn"):
        dev = resolve_device(device)
        opts = dict(k=k, prop_k=prop_k, ndist=ndist, merge_order=merge_order,
                    auto_merge=auto_merge, min_batch_skip=min_batch_skip,
                    checkpoint_dir=checkpoint_dir, knn_method=knn_method)
        if isinstance(batches_or_single, (list, tuple)):
            batches = [as_tensor(b, dev) for b in batches_or_single]
            check_batch_consistency(batches, cells_in_rows=True)
            restrict = check_restrictions(batches, restrict, cells_in_rows=True)
            divided = None
        else:
            x = as_tensor(batches_or_single, dev)
            divided = divide_into_batches(
                np.arange(x.shape[0]), batch, cells_in_rows=True, restrict=restrict
            )
            batches = [x[as_tensor(idx, dev, torch.long)] for idx in divided.batches]
            restrict = divided.restricted
            batch_names = [str(n) for n in divided.names]
        out = _fast_mnn_core(batches, restrict, batch_names=batch_names, **opts)
        return finish_output(out, divided, [b.shape[0] for b in batches],
                             cell_names=cell_names)


def fast_mnn(
    batches_or_single,
    batch: Optional[Sequence] = None,
    *,
    k: int = 20,
    prop_k: Optional[float] = None,
    restrict=None,
    cos_norm: bool = True,
    ndist: float = 3.0,
    d: Optional[int] = 50,
    weights=None,
    get_variance: bool = False,
    merge_order=None,
    auto_merge: bool = False,
    min_batch_skip: Optional[float] = 0.0,
    subset_row: Optional[np.ndarray] = None,
    correct_all: bool = False,
    svd_method: str = "gram",
    svd_start=None,
    batch_names: Optional[Sequence[str]] = None,
    checkpoint_dir: Optional[str] = None,
    knn_method: str = "exact",
    cell_names=None,
    gene_names=None,
    device: DeviceLike = None,
) -> MNNResult:
    """Fast MNN batch correction from gene space (reference fastMNN,
    R/fastMNN.R:283-331).

    Accepts a list of (N_b, G) matrices (cells in rows) or a single matrix
    plus ``batch``; arrays or tensors, moved to ``device`` (default: the
    CUDA device; raises without one unless ``device="cpu"``). Output cells
    are always in input order. ``svd_start`` is the start block of
    ``svd_method="randomized"`` (see ``multi_batch_pca``).
    ``cell_names``/``gene_names`` are carried onto the result like the
    reference's .rename_output (R/utils_multibatch.R:3-33); gene names
    follow the rotation rows (subset by ``subset_row`` unless
    ``correct_all``). ``checkpoint_dir``: save each merge step there and
    resume from the steps it already holds, as ``reduced_mnn`` does.
    """
    with trace_span("fastmnn/call", entry="fast_mnn"):
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
        else:
            divided = None
            batches = [as_tensor(b, dev) for b in batches_or_single]
            if len(batches) < 2:
                raise ValueError("at least two batches must be specified")
            check_batch_consistency(batches, cells_in_rows=True)
            restrict = check_restrictions(batches, restrict, cells_in_rows=True)

        # Cosine norm: L2 computed on the gene subset, applied to the full
        # matrix; PCA handles subsetting (reference R/fastMNN.R:348-354, 371-377).
        if cos_norm:
            with trace_span("fastmnn/cosine_norm"):
                l2s = [cosine_norm(b, mode="l2norm", subset_row=subset_row) for b in batches]
                batches = [apply_cosine_norm(b, l2) for b, l2 in zip(batches, l2s)]

        with trace_span("fastmnn/pca"):
            pca = multi_batch_pca(
                batches,
                d=d,
                weights=weights,
                subset_row=subset_row,
                get_all_genes=correct_all and subset_row is not None,
                get_variance=get_variance,
                method=svd_method,
                batch_names=batch_names,
                start=svd_start,
                device=dev,
            )
        out = _fast_mnn_core(
            pca.components,
            restrict,
            k=k,
            prop_k=prop_k,
            ndist=ndist,
            merge_order=merge_order,
            auto_merge=auto_merge,
            min_batch_skip=min_batch_skip,
            batch_names=batch_names,
            checkpoint_dir=checkpoint_dir,
            knn_method=knn_method,
        )
        out.rotation = pca.rotation
        out.centers = pca.centers
        out.var_explained = pca.var_explained
        out.var_total = pca.var_total
        return finish_output(out, divided, [b.shape[0] for b in batches],
                             cell_names=cell_names, gene_names=gene_names,
                             subset_row=subset_row, correct_all=correct_all)
