"""Linear baselines: rescaleBatches, regressBatches, noCorrect.

Counterpart of ``batchelor_tpu/correct/linear.py`` (reference
R/rescaleBatches.R:63-182, R/regressBatches.R:93-158, R/noCorrect.R:45-76).
Cells in rows; outputs are per-gene matrices in input cell order, on the
port's device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, as_tensor, resolve_device
from ..ops.cosine_norm import subset_columns
from ..ops.pca import multi_batch_pca
from ..ops.residual import ResidualOp, one_hot_design
from ..utils.batching import (
    check_batch_consistency,
    check_restrictions,
    divide_into_batches,
    generate_cell_names,
)

__all__ = ["rescale_batches", "regress_batches", "no_correct", "LinearCorrectionResult"]


@dataclass
class LinearCorrectionResult:
    corrected: torch.Tensor         # (N_total, G)
    batch: np.ndarray               # per-cell batch label
    corrected_pcs: Optional[torch.Tensor] = None  # regress_batches with d set
    residual_op: Optional[ResidualOp] = None
    cell_names: Optional[np.ndarray] = None      # per output cell
    gene_names: Optional[np.ndarray] = None      # per output gene


def _output_names(cell_names, gene_names, batches, reorder, subset_row, correct_all):
    """Resolve output dimnames (reference .rename_output,
    R/utils_multibatch.R:3-33): cell names concatenate per batch (single
    input passes through, since output is input order); gene names follow
    the output gene subset."""
    cn = None
    if cell_names is not None:
        if reorder is not None:  # single-matrix input: names in input order
            cn = np.asarray(cell_names, dtype=object)
        else:
            cn = generate_cell_names(cell_names, [b.shape[0] for b in batches])
    gn = None
    if gene_names is not None:
        gn = np.asarray(gene_names, dtype=object)
        if subset_row is not None and not correct_all:
            gn = gn[np.asarray(subset_row)]
    return cn, gn


def _normalize_inputs(batches_or_single, batch, restrict, batch_names, dev):
    if not isinstance(batches_or_single, (list, tuple)):
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
        reorder = divided.reorder
    else:
        batches = [as_tensor(b, dev) for b in batches_or_single]
        check_batch_consistency(batches, cells_in_rows=True)
        restrict = check_restrictions(batches, restrict, cells_in_rows=True)
        reorder = None
    return batches, restrict, batch_names, reorder


def _batch_labels(batches, batch_names):
    sizes = [b.shape[0] for b in batches]
    origin = np.repeat(np.arange(len(batches)), sizes)
    if batch_names is not None:
        if len(set(batch_names)) != len(batch_names):
            raise ValueError("names of batches should be unique")
        return np.asarray(batch_names)[origin]
    return origin


def _input_order(out: torch.Tensor, labels: np.ndarray, reorder):
    """Rows of a single input back in its cell order."""
    if reorder is None:
        return out, labels
    return out[as_tensor(reorder, out.device, torch.long)], labels[reorder]


def rescale_batches(
    batches_or_single,
    batch: Optional[Sequence] = None,
    *,
    restrict=None,
    log_base: float = 2.0,
    pseudo_count: float = 1.0,
    subset_row: Optional[np.ndarray] = None,
    correct_all: bool = False,
    batch_names: Optional[Sequence[str]] = None,
    cell_names=None,
    gene_names=None,
    device: DeviceLike = None,
) -> LinearCorrectionResult:
    """Scale each gene so every batch matches the lowest per-batch average,
    in count space (reference .rescale_batches, R/rescaleBatches.R:102-148).

    Restricted cells define the averages; the scaling applies to all cells.
    Inputs are a list of (N_b, G) log-expression matrices or a single
    matrix plus ``batch``, arrays or tensors, moved to ``device`` (default:
    the CUDA device; raises without one unless ``device="cpu"``).
    """
    dev = resolve_device(device)
    batches, restrict, batch_names, reorder = _normalize_inputs(
        batches_or_single, batch, restrict, batch_names, dev
    )
    if len(batches) < 2:
        raise ValueError("at least two batches must be specified")
    if correct_all:
        subset_row = None
    if subset_row is not None:
        batches = [subset_columns(b, np.asarray(subset_row)) for b in batches]

    unlogged = [torch.pow(log_base, b) - pseudo_count for b in batches]
    averages = []
    for i, u in enumerate(unlogged):
        cur = u
        if restrict is not None and restrict[i] is not None:
            cur = u[as_tensor(restrict[i], dev, torch.long)]
        averages.append(cur.mean(0))

    reference = averages[0]
    for a in averages[1:]:
        reference = torch.minimum(reference, a)

    corrected = []
    for u, a in zip(unlogged, averages):
        scale = reference / a
        scale = torch.where(torch.isfinite(scale), scale, 0.0)
        base = torch.log(torch.tensor(log_base, dtype=u.dtype)).to(dev)
        corrected.append(torch.log(u * scale[None, :] + pseudo_count) / base)

    out, labels = _input_order(torch.cat(corrected, 0), _batch_labels(batches, batch_names),
                               reorder)
    cn, gn = _output_names(
        cell_names, gene_names, batches, reorder, subset_row, correct_all
    )
    return LinearCorrectionResult(
        corrected=out, batch=labels, cell_names=cn, gene_names=gn
    )


def regress_batches(
    batches_or_single,
    batch: Optional[Sequence] = None,
    *,
    design=None,
    keep: Optional[Sequence[int]] = None,
    restrict=None,
    subset_row: Optional[np.ndarray] = None,
    correct_all: bool = False,
    d: Optional[int] = None,
    batch_names: Optional[Sequence[str]] = None,
    cell_names=None,
    gene_names=None,
    device: DeviceLike = None,
) -> LinearCorrectionResult:
    """Linear-model residual correction (reference regressBatches,
    R/regressBatches.R:93-158). The residual operator is kept factored
    (ResidualOp) and only materialized for the output matrix; with ``d`` a
    multi_batch_pca runs on the residuals. Inputs as in
    :func:`rescale_batches`, on ``device``."""
    dev = resolve_device(device)
    batches, restrict, batch_names, reorder = _normalize_inputs(
        batches_or_single, batch, restrict, batch_names, dev
    )
    cn, gn = _output_names(
        cell_names, gene_names, batches, reorder, subset_row, correct_all
    )
    sizes = [b.shape[0] for b in batches]
    combined = torch.cat(batches, 0)
    origin = np.repeat(np.arange(len(batches)), sizes)
    labels = _batch_labels(batches, batch_names)

    flat_restrict = None
    if restrict is not None:
        offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        flat_restrict = np.concatenate([
            (np.arange(n) if r is None else np.asarray(r)) + off
            for r, n, off in zip(restrict, sizes, offsets)
        ])

    if not correct_all and subset_row is not None:
        combined = subset_columns(combined, np.asarray(subset_row))
        subset_row = None

    if design is None:
        design = one_hot_design(origin, device=dev)
    else:
        design = as_tensor(design, dev)
        if design.shape[0] != combined.shape[0]:
            raise ValueError("'design' should have one row per cell")

    op = ResidualOp.fit(combined, design, keep=keep, restrict=flat_restrict)
    corrected = op.materialize()

    pcs = None
    if d is not None:
        per_batch = list(torch.split(corrected, sizes, 0))
        pca = multi_batch_pca(per_batch, d=d, subset_row=subset_row, device=dev)
        pcs = torch.cat(pca.components, 0)

    if reorder is not None:
        ridx = as_tensor(reorder, dev, torch.long)
        corrected = corrected[ridx]
        labels = labels[reorder]
        if pcs is not None:
            pcs = pcs[ridx]
    return LinearCorrectionResult(
        corrected=corrected, batch=labels, corrected_pcs=pcs, residual_op=op,
        cell_names=cn, gene_names=gn,
    )


def no_correct(
    batches_or_single,
    batch: Optional[Sequence] = None,
    *,
    subset_row: Optional[np.ndarray] = None,
    correct_all: bool = False,
    batch_names: Optional[Sequence[str]] = None,
    cell_names=None,
    gene_names=None,
    device: DeviceLike = None,
) -> LinearCorrectionResult:
    """cbind-only negative control (reference noCorrect, R/noCorrect.R:45-76),
    on ``device`` as :func:`rescale_batches`."""
    dev = resolve_device(device)
    batches, _, batch_names, reorder = _normalize_inputs(
        batches_or_single, batch, None, batch_names, dev
    )
    cn, gn = _output_names(
        cell_names, gene_names, batches, reorder, subset_row, correct_all
    )
    if subset_row is not None and not correct_all:
        batches = [subset_columns(b, np.asarray(subset_row)) for b in batches]
    out, labels = _input_order(torch.cat(batches, 0), _batch_labels(batches, batch_names),
                               reorder)
    return LinearCorrectionResult(
        corrected=out, batch=labels, cell_names=cn, gene_names=gn
    )
