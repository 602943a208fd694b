"""Dispatch API: typed parameter objects + the batch_correct generic.

Counterpart of ``batchelor_tpu/correct/dispatch.py``, the reference's S4
dispatch layer (R/AllGenerics.R:4-5, R/AllClasses.R:5-25,
R/BatchelorParam.R:42-76, R/batchCorrect.R:65-98): data-agnostic method
parameters live in the PARAM object, data-specific arguments (batch,
restrict, subset_row, correct_all) are arguments of the generic, the
documented extension contract (reference vignettes/extension.Rmd:94-125).
The parameter objects carry no device: ``batch_correct`` resolves its
``device`` argument and hands it to the engine as the keyword ``device``.

Third parties register new methods with ``@register_correction(MyParams)``;
the registered function is called as ``fn(batches, batch, restrict,
subset_row, correct_all, batch_names, params, device=..., **names)``.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any, Callable, Dict, Optional, Sequence, Type

import numpy as np

from ..device import DeviceLike, resolve_device
from .classic_mnn import mnn_correct
from .fast_mnn import fast_mnn
from .linear import no_correct, regress_batches, rescale_batches

__all__ = [
    "BatchelorParams",
    "FastMNNParams",
    "ClassicMNNParams",
    "RescaleParams",
    "RegressParams",
    "NoCorrectParams",
    "batch_correct",
    "register_correction",
]


@dataclass
class BatchelorParams:
    """Base class for correction parameter objects."""


@dataclass
class FastMNNParams(BatchelorParams):
    k: int = 20
    prop_k: Optional[float] = None
    cos_norm: bool = True
    ndist: float = 3.0
    d: Optional[int] = 50
    weights: Any = None
    get_variance: bool = False
    merge_order: Any = None
    auto_merge: bool = False
    min_batch_skip: Optional[float] = 0.0
    svd_method: str = "gram"
    knn_method: str = "exact"


@dataclass
class ClassicMNNParams(BatchelorParams):
    k: int = 20
    prop_k: Optional[float] = None
    sigma: float = 0.1
    cos_norm_in: bool = True
    cos_norm_out: bool = True
    svd_dim: int = 0
    var_adj: bool = True
    merge_order: Any = None
    auto_merge: bool = False
    knn_method: str = "exact"


@dataclass
class RescaleParams(BatchelorParams):
    log_base: float = 2.0
    pseudo_count: float = 1.0


@dataclass
class RegressParams(BatchelorParams):
    design: Any = None
    keep: Optional[Sequence[int]] = None
    d: Optional[int] = None


@dataclass
class NoCorrectParams(BatchelorParams):
    pass


def asdict(p) -> dict:
    """Shallow field dict (dataclasses.asdict deep-copies, which breaks on
    tensors in fields like RegressParams.design)."""
    return {f.name: getattr(p, f.name) for f in fields(p)}


_REGISTRY: Dict[type, Callable] = {}


def register_correction(param_cls: Type[BatchelorParams]):
    """Register a correction backend for a parameter class."""

    def deco(fn):
        _REGISTRY[param_cls] = fn
        return fn

    return deco


def _engine(fn, with_restrict=True):
    """A backend that forwards the generic's arguments and the params'
    fields to ``fn``."""

    def run(batches, batch, restrict, subset_row, correct_all, batch_names, p, **kw):
        if with_restrict:
            kw["restrict"] = restrict
        return fn(batches, batch, subset_row=subset_row, correct_all=correct_all,
                  batch_names=batch_names, **kw, **asdict(p))

    return run


register_correction(FastMNNParams)(_engine(fast_mnn))
register_correction(ClassicMNNParams)(_engine(mnn_correct))
register_correction(RescaleParams)(_engine(rescale_batches))
register_correction(RegressParams)(_engine(regress_batches))
# noCorrect ignores restrict (reference R/batchCorrect.R:89-93)
register_correction(NoCorrectParams)(_engine(no_correct, with_restrict=False))


def batch_correct(
    batches_or_single,
    batch: Optional[Sequence] = None,
    *,
    restrict=None,
    subset_row: Optional[np.ndarray] = None,
    correct_all: bool = False,
    batch_names: Optional[Sequence[str]] = None,
    params: BatchelorParams = None,
    cell_names=None,
    gene_names=None,
    device: DeviceLike = None,
):
    """Generic batch-correction entry point dispatching on ``params`` type
    (reference batchCorrect generic, R/batchCorrect.R:65-98).

    ``device`` (default: the CUDA device; raises without one unless
    ``device="cpu"``) reaches the backend as the keyword ``device``.
    ``cell_names``/``gene_names`` (the .rename_output analog) are forwarded
    as keyword arguments only when given.
    """
    if params is None:
        params = FastMNNParams()
    kw = {"device": resolve_device(device)}
    if cell_names is not None:
        kw["cell_names"] = cell_names
    if gene_names is not None:
        kw["gene_names"] = gene_names
    for cls in type(params).__mro__:
        if cls in _REGISTRY:
            return _REGISTRY[cls](
                batches_or_single, batch, restrict, subset_row, correct_all,
                batch_names, params, **kw,
            )
    raise TypeError(f"no correction registered for {type(params).__name__}")
