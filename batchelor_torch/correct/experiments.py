"""Dataset container + high-level pipelines.

Counterpart of ``batchelor_tpu/correct/experiments.py``, the analogs of
the reference's SingleCellExperiment-level layer:
  * SingleCellDataset: a minimal AnnData/SCE-like container (assays keyed
    by name, per-cell/per-gene metadata, reduced dims, alternative
    experiments);
  * correct_experiments: run batch_correct and graft the uncorrected
    assays/metadata back on (reference R/correctExperiments.R:72-227),
    including the single-input ``add_single`` prepending mode
    (R/correctExperiments.R:79-80, .add.single_sce at :206-227) and the
    warn-on-conflict overlap elimination (.eliminate_overlaps at :145-151);
  * quick_correct: intersect -> multiBatchNorm -> HVG modelling ->
    batch_correct (reference R/quickCorrect.R:66-120);
  * apply_multi: apply a correction over main + alternative experiments
    (reference R/applyMultiSCE.R:115-213) with simplify-back re-assembly
    (SingleCellExperiment::simplifyToSCE semantics, :178-202).
Assays and results are tensors on the port's device (``correct_experiments``
and ``quick_correct`` take ``device``); ``apply_multi`` passes its keyword
arguments, a ``device`` among them, to the function it applies.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, as_tensor, resolve_device
from ..ops.cosine_norm import subset_columns
from ..ops.lowrank import LowRankOp
from ..ops.normalization import multi_batch_norm
from ..ops.stats import combine_var, get_top_hvgs, model_gene_var
from ..utils.batching import generate_cell_names, intersect_rows
from ..utils.telemetry import get_recorder, trace_span
from .dispatch import BatchelorParams, batch_correct
from .fast_mnn import MNNResult

__all__ = [
    "SingleCellDataset",
    "correct_experiments",
    "quick_correct",
    "apply_multi",
    "QuickCorrectResult",
]


@dataclass
class SingleCellDataset:
    """Minimal single-cell container: cells in rows.

    assays: name -> (N, G) matrix; gene_names: length G; cell_names: length N.
    cell_meta/gene_meta: column name -> length-N / length-G arrays.
    reduced: name -> (N, d) matrices. alts: name -> nested datasets.
    """

    assays: Dict[str, Any]
    gene_names: Optional[List[str]] = None
    cell_names: Optional[List[str]] = None
    cell_meta: Dict[str, np.ndarray] = field(default_factory=dict)
    gene_meta: Dict[str, Any] = field(default_factory=dict)
    reduced: Dict[str, Any] = field(default_factory=dict)
    alts: Dict[str, "SingleCellDataset"] = field(default_factory=dict)
    metadata: Dict[str, Any] = field(default_factory=dict)

    @property
    def n_cells(self) -> int:
        return next(iter(self.assays.values())).shape[0]

    @property
    def n_genes(self) -> int:
        return next(iter(self.assays.values())).shape[1]

    def assay(self, name: str = "logcounts"):
        return self.assays[name]


def _as_matrices(inputs, assay_type, dev):
    # a bare matrix/dataset is a single input (reference .unpackLists);
    # iterating a 2-D array here would silently treat every row as a batch
    if not isinstance(inputs, (list, tuple)):
        inputs = [inputs]
    return [as_tensor(x.assay(assay_type) if isinstance(x, SingleCellDataset) else x, dev)
            for x in inputs]


def _eliminate_overlaps(priority, other, msg="fields"):
    """Drop entries of ``other`` already present in ``priority``, warning
    once (reference .eliminate_overlaps, R/correctExperiments.R:145-151)."""
    priority = set(priority)
    if any(nm in priority for nm in other):
        warnings.warn(
            f"ignoring {msg} with same name as 'batch_correct' output"
        )
        other = [nm for nm in other if nm not in priority]
    return list(other)


def _identical(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype.kind != b.dtype.kind:
        return False
    return bool(np.all(a == b))


def _accumulate_gene_meta(inputs: Sequence["SingleCellDataset"]) -> Dict[str, Any]:
    """Union of per-gene metadata fields across inputs; fields whose values
    disagree between inputs are dropped with a warning (reference
    .accumulate_rowdata, R/correctExperiments.R:154-199)."""
    universe: List[str] = []
    for x in inputs:
        for nm in x.gene_meta:
            if nm not in universe:
                universe.append(nm)
    existing: Dict[str, Any] = {}
    blacklisted = set()
    for x in inputs:
        for nm, values in x.gene_meta.items():
            if nm in blacklisted:
                continue
            if nm not in existing:
                existing[nm] = values
            elif not _identical(existing[nm], values):
                warnings.warn(
                    f"ignoring non-identical '{nm}' field in 'gene_meta'"
                )
                blacklisted.add(nm)
    return {nm: v for nm, v in existing.items() if nm not in blacklisted}


def _result_to_dataset(
    res,
    *,
    gene_names=None,
    cell_names=None,
) -> SingleCellDataset:
    """Wrap a correction result in a SingleCellDataset: the analog of what
    batchCorrect methods return as an SCE (corrected assay or reconstructed
    LowRank assay + corrected reducedDim, merge.info metadata)."""
    assays: Dict[str, Any] = {}
    reduced: Dict[str, Any] = {}
    gene_meta: Dict[str, Any] = {}
    meta: Dict[str, Any] = {}
    corrected = res.corrected
    if isinstance(res, MNNResult) and res.rotation is not None:
        # lazy (N, G) low-rank view; never densified here
        # (reference LowRankMatrix assay, R/convertPCsToSCE.R:50-72)
        assays["reconstructed"] = LowRankOp(res.rotation, corrected).T
        reduced["corrected"] = corrected
        gene_meta["rotation"] = res.rotation
    else:
        assays["corrected"] = corrected

    cell_meta: Dict[str, np.ndarray] = {"batch": np.asarray(res.batch)}
    if isinstance(res, MNNResult):
        meta["merge_info"] = res.merge_info
        meta["pca_info"] = {
            "centers": res.centers,
            "var_explained": res.var_explained,
            "var_total": res.var_total,
        }
    if cell_names is None:
        cell_names = getattr(res, "cell_names", None)
    return SingleCellDataset(
        assays=assays,
        gene_names=list(gene_names) if gene_names is not None else None,
        cell_names=list(cell_names) if cell_names is not None else None,
        cell_meta=cell_meta,
        gene_meta=gene_meta,
        reduced=reduced,
        metadata=meta,
    )


def _add_single_dataset(
    original: SingleCellDataset,
    merged: SingleCellDataset,
    subset_row,
    correct_all: bool,
    dev: torch.device,
) -> SingleCellDataset:
    """Prepend the correction output onto the original single dataset
    (reference .add.single_sce, R/correctExperiments.R:206-227): merged
    fields take priority, same-named original fields are dropped with a
    warning."""
    gidx = None
    if not correct_all and subset_row is not None:
        gidx = np.asarray(subset_row)

    assays = dict(merged.assays)
    for nm in _eliminate_overlaps(assays, original.assays, msg="'assays'"):
        mat = as_tensor(original.assays[nm], dev)
        assays[nm] = subset_columns(mat, gidx) if gidx is not None else mat

    reduced = dict(merged.reduced)
    for nm in _eliminate_overlaps(reduced, original.reduced, msg="'reduced'"):
        reduced[nm] = original.reduced[nm]

    cell_meta = dict(merged.cell_meta)
    for nm in _eliminate_overlaps(
        cell_meta, original.cell_meta, msg="'cell_meta' fields"
    ):
        cell_meta[nm] = original.cell_meta[nm]

    gene_meta = dict(merged.gene_meta)
    for nm in _eliminate_overlaps(
        gene_meta, original.gene_meta, msg="'gene_meta' fields"
    ):
        v = original.gene_meta[nm]
        gene_meta[nm] = np.asarray(v)[gidx] if gidx is not None else v

    metadata = dict(merged.metadata)
    for nm in _eliminate_overlaps(metadata, original.metadata, msg="'metadata'"):
        metadata[nm] = original.metadata[nm]

    gene_names = merged.gene_names
    if gene_names is None and original.gene_names is not None:
        gene_names = list(np.asarray(original.gene_names, dtype=object)[gidx]) \
            if gidx is not None else list(original.gene_names)
    cell_names = merged.cell_names or original.cell_names

    return SingleCellDataset(
        assays=assays,
        gene_names=gene_names,
        cell_names=cell_names,
        cell_meta=cell_meta,
        gene_meta=gene_meta,
        reduced=reduced,
        alts=dict(original.alts),
        metadata=metadata,
    )


def correct_experiments(
    inputs: Sequence,
    batch: Optional[Sequence] = None,
    *,
    restrict=None,
    subset_row=None,
    correct_all: bool = False,
    assay_type: str = "logcounts",
    params: Optional[BatchelorParams] = None,
    batch_names: Optional[Sequence[str]] = None,
    combine_assays: Optional[Sequence[str]] = None,
    combine_cell_meta: Optional[Sequence[str]] = None,
    include_gene_meta: bool = True,
    add_single: bool = True,
    device: DeviceLike = None,
) -> SingleCellDataset:
    """Run batch_correct and graft the original (uncorrected) assays,
    cell metadata and gene metadata onto the merged result
    (reference correctExperiments, R/correctExperiments.R:72-227).

    With a single dataset input and ``add_single=True``, the correction
    output is prepended onto the original dataset (alts and all) instead of
    building a fresh combined one (reference :79-80). Fields of the inputs
    that collide with correction-output names are dropped with a warning
    (reference .eliminate_overlaps). Assays are moved to ``device``
    (default: the CUDA device; raises without one unless ``device="cpu"``),
    where the correction runs.
    """
    dev = resolve_device(device)
    if not isinstance(inputs, (list, tuple)):
        inputs = [inputs]
    mats = _as_matrices(inputs, assay_type, dev)
    ds_inputs = [x for x in inputs if isinstance(x, SingleCellDataset)]
    all_ds = len(ds_inputs) == len(inputs)

    res = batch_correct(
        mats if len(mats) > 1 else mats[0],
        batch,
        restrict=restrict,
        subset_row=subset_row,
        correct_all=correct_all,
        params=params,
        batch_names=batch_names,
        device=dev,
    )

    keep_genes = None
    if subset_row is not None and not correct_all:
        keep_genes = np.asarray(subset_row)

    gene_names = None
    if ds_inputs and inputs[0].gene_names is not None:
        gene_names = list(inputs[0].gene_names)
        if keep_genes is not None:
            gene_names = [gene_names[i] for i in keep_genes]

    cell_names = None
    if all_ds and len(inputs) > 1:
        cell_names = generate_cell_names(
            [x.cell_names for x in inputs], [x.n_cells for x in inputs]
        )
        if cell_names is not None:
            cell_names = list(cell_names)
    elif all_ds:
        cell_names = inputs[0].cell_names

    merged = _result_to_dataset(res, gene_names=gene_names, cell_names=cell_names)

    if len(inputs) == 1 and add_single and all_ds:
        return _add_single_dataset(inputs[0], merged, subset_row, correct_all, dev)

    # fresh combined dataset (reference .create_fresh_combined_sce, :88-143)
    if all_ds and len(inputs) > 1:
        if combine_assays is None:
            combine_assays = [
                nm for nm in inputs[0].assays
                if all(nm in x.assays for x in inputs[1:])
            ]
        combine_assays = _eliminate_overlaps(
            merged.assays, combine_assays, msg="'assays'"
        )
        for nm in combine_assays:
            stacked = torch.cat([as_tensor(x.assays[nm], dev) for x in inputs], 0)
            if keep_genes is not None:
                stacked = subset_columns(stacked, keep_genes)
            merged.assays[nm] = stacked

        if combine_cell_meta is None:
            combine_cell_meta = [
                nm for nm in inputs[0].cell_meta
                if all(nm in x.cell_meta for x in inputs[1:])
            ]
        combine_cell_meta = _eliminate_overlaps(
            merged.cell_meta, combine_cell_meta, msg="'cell_meta' fields"
        )
        for nm in combine_cell_meta:
            merged.cell_meta[nm] = np.concatenate(
                [np.asarray(x.cell_meta[nm]) for x in inputs]
            )

        if include_gene_meta:
            combined = _accumulate_gene_meta(inputs)
            if keep_genes is not None:
                combined = {
                    nm: np.asarray(v)[keep_genes] for nm, v in combined.items()
                }
            leftover = _eliminate_overlaps(
                merged.gene_meta, combined, msg="'gene_meta' fields"
            )
            for nm in leftover:
                merged.gene_meta[nm] = combined[nm]

    return merged


@dataclass
class QuickCorrectResult:
    """quick_correct outputs: variance decomposition, chosen HVGs, and the
    corrected result (reference R/quickCorrect.R return value)."""

    dec: Any
    hvgs: np.ndarray
    corrected: Any


def quick_correct(
    inputs: Sequence,
    batch: Optional[Sequence] = None,
    *,
    restrict=None,
    correct_all: bool = True,
    assay_type: str = "counts",
    params: Optional[BatchelorParams] = None,
    precomputed=None,
    hvg_n: int = 5000,
    min_mean: float = 1.0,
    gene_names: Optional[Sequence[Sequence[str]]] = None,
    batch_names: Optional[Sequence[str]] = None,
    device: DeviceLike = None,
) -> QuickCorrectResult:
    """End-to-end pipeline: intersect genes -> multi_batch_norm -> per-batch
    HVG modelling -> batch_correct on top HVGs
    (reference quickCorrect, R/quickCorrect.R:66-120). Every step runs on
    ``device`` (default: the CUDA device; raises without one unless
    ``device="cpu"``). Counter: ``quickcorrect/hvgs``, the HVGs handed
    to the correction (``hvg_n`` unless fewer genes have positive ``bio``).
    """
    dev = resolve_device(device)
    mats = _as_matrices(inputs, assay_type, dev)
    if gene_names is not None:
        mats, _ = intersect_rows(mats, gene_names)

    single = len(mats) == 1
    if single and batch is None:
        raise ValueError("'batch' must be specified with a single input")
    with trace_span("quickcorrect/normalize"):
        if single:
            batch = np.asarray(batch)
            # preserve.single path (reference R/quickCorrect.R:81-85): the
            # normalized object keeps the input cell order.
            norm = multi_batch_norm(mats[0], batch=batch, min_mean=min_mean, device=dev)
            stacked = norm.logcounts
            split = [np.nonzero(batch == b)[0] for b in sorted(set(batch.tolist()))]
            logs = [stacked[as_tensor(i, dev, torch.long)] for i in split]
        else:
            norm = multi_batch_norm(mats, min_mean=min_mean, device=dev)
            logs = norm.logcounts

    with trace_span("quickcorrect/model_gene_var"):
        if precomputed is None:
            decs = [model_gene_var(lg, device=dev) for lg in logs]
            dec = combine_var(decs) if len(decs) > 1 else decs[0]
        else:
            dec = combine_var(list(precomputed)) if len(mats) > 1 else precomputed[0]
        hvgs = get_top_hvgs(dec, n=hvg_n)

        rec = get_recorder()
        if rec is not None:
            rec.add("quickcorrect/hvgs", float(len(hvgs)))

    with trace_span("quickcorrect/correct"):
        corrected = batch_correct(
            stacked if single else logs, batch if single else None, restrict=restrict,
            subset_row=hvgs, correct_all=correct_all, params=params,
            batch_names=batch_names, device=dev,
        )
    return QuickCorrectResult(dec=dec, hvgs=hvgs, corrected=corrected)


def _simplify_results(
    results: Dict[str, Any], use_main: bool
) -> Optional[SingleCellDataset]:
    """Re-assemble per-experiment results into one dataset with alts
    (SingleCellExperiment::simplifyToSCE semantics as used at reference
    R/applyMultiSCE.R:178-202). Returns None when not simplifiable."""
    if not use_main:
        warnings.warn("cannot simplify results without a main experiment")
        return None
    main = results.get("main")
    if not isinstance(main, SingleCellDataset):
        return None
    n = main.n_cells
    alts = {}
    for nm, r in results.items():
        if nm == "main":
            continue
        if not isinstance(r, SingleCellDataset) or r.n_cells != n:
            warnings.warn(
                f"cannot simplify: result for {nm!r} is not a compatible dataset"
            )
            return None
        alts[nm] = r
    out = SingleCellDataset(
        assays=dict(main.assays),
        gene_names=main.gene_names,
        cell_names=main.cell_names,
        cell_meta=dict(main.cell_meta),
        gene_meta=dict(main.gene_meta),
        reduced=dict(main.reduced),
        alts={**dict(main.alts), **alts},
        metadata=dict(main.metadata),
    )
    return out


def apply_multi(
    inputs: Sequence[SingleCellDataset],
    fn: Callable[..., Any],
    *,
    which_alts: Optional[Sequence[str]] = None,
    main_args: Optional[dict] = (),
    alt_args: Optional[Dict[str, dict]] = None,
    simplify: bool = True,
    **kwargs,
):
    """Apply a correction over the main and alternative experiments of
    multiple datasets (reference applyMultiSCE, R/applyMultiSCE.R:115-213).

    ``main_args``/``alt_args`` are per-experiment extra kwargs merged over
    the common ``**kwargs`` (reference MAIN.ARGS/ALT.ARGS/.dedup_args);
    pass ``main_args=None`` to skip the main experiment. Alternative
    experiments present in every input are processed (or ``which_alts``).

    With ``simplify=True`` and dataset-valued results, the per-alt results
    are re-assembled as alts of the main result (reference SIMPLIFY branch,
    :178-202, via simplifyToSCE); when re-assembly is impossible a warning
    is emitted and the plain ``{"main": ..., "<alt>": ...}`` dict is
    returned. Element-wise simplification of tuple-valued results
    (reference :186-199) is applied per position.
    """
    use_main = main_args is not None
    results: Dict[str, Any] = {}
    if use_main:
        margs = dict(kwargs)
        if main_args:
            margs.update(main_args)
        try:
            results["main"] = fn(list(inputs), **margs)
        except Exception as err:
            raise RuntimeError(
                f"'fn' failed on the main experiments: {err}"
            ) from err
    if which_alts is None:
        common = set(inputs[0].alts)
        for other in inputs[1:]:
            common &= set(other.alts)
        which_alts = sorted(common)
    for nm in which_alts:
        aargs = dict(kwargs)
        if alt_args and nm in alt_args:
            aargs.update(alt_args[nm])
        try:
            results[nm] = fn([x.alts[nm] for x in inputs], **aargs)
        except Exception as err:
            raise RuntimeError(
                f"'fn' failed on the alternative experiments {nm!r}: {err}"
            ) from err

    if simplify:
        vals = list(results.values())
        if any(isinstance(v, SingleCellDataset) for v in vals):
            out = _simplify_results(results, use_main)
            if out is not None:
                return out
        elif vals and all(isinstance(v, (list, tuple)) for v in vals):
            lens = {len(v) for v in vals}
            if len(lens) == 1:
                n_out = lens.pop()
                attempts = []
                ok = True
                for i in range(n_out):
                    collated = {nm: results[nm][i] for nm in results}
                    attempt = _simplify_results(collated, use_main)
                    if attempt is None:
                        ok = False
                        break
                    attempts.append(attempt)
                if ok:
                    return type(vals[0])(attempts)
            else:
                warnings.warn(
                    "failed to simplify results with variable numbers of outputs"
                )
    return results
