"""Per-gene variance modelling and HVG selection.

Counterpart of ``batchelor_tpu/ops/stats.py``: stand-ins for the scran
machinery that quickCorrect leans on (reference R/quickCorrect.R:88-114):
modelGeneVar -> combineVar -> getTopHVGs. Means and variances are
reductions on the tensors' device, and so is the mean-variance trend
(``correct/diagnostics.py::fit_trend_var``: on the card in float64, on the
CPU its host numpy); the ranking is a stable numpy sort on the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..correct.diagnostics import fit_trend_var
from ..device import DeviceLike, as_tensor, resolve_device

__all__ = ["model_gene_var", "combine_var", "get_top_hvgs", "GeneVarResult"]


@dataclass
class GeneVarResult:
    """Per-gene variance decomposition (scran::modelGeneVar analog)."""

    mean: np.ndarray
    total: np.ndarray
    tech: np.ndarray
    bio: np.ndarray


def model_gene_var(
    x,
    block: Optional[Sequence] = None,
    span: float = 0.3,
    *,
    device: DeviceLike = None,
) -> GeneVarResult:
    """Decompose per-gene variance of log-expression into a fitted
    mean-variance trend ("technical") and the residual ("biological").

    ``x``: (N, G) log-expression, cells in rows (an array or tensor, moved
    to ``device``: default the CUDA device; raises without one unless
    ``device="cpu"``). ``block``: optional batch vector; statistics are
    computed per block and averaged, mirroring modelGeneVar's block=
    handling.
    """
    dev = resolve_device(device)
    x = as_tensor(x, dev)
    if block is None:
        blocks = [None]
    else:
        block = np.asarray(block)
        blocks = [np.nonzero(block == b)[0] for b in sorted(set(block.tolist()))]

    results = []
    for idx in blocks:
        sub = x if idx is None else x[as_tensor(idx, dev, torch.long)]
        mean = sub.mean(0)
        total = torch.var(sub, dim=0, correction=1)
        tech = torch.as_tensor(fit_trend_var(mean, total, span=span)(mean), device=dev)
        results.append(GeneVarResult(mean=mean, total=total, tech=tech, bio=total - tech))
    dec = combine_var(results)
    # one copy to the host; mean and total keep their type (fp64 holds them exactly)
    host = torch.stack([dec.mean.double(), dec.total.double(), dec.tech, dec.bio]).cpu()
    return GeneVarResult(mean=host[0].to(dec.mean.dtype).numpy(),
                         total=host[1].to(dec.total.dtype).numpy(),
                         tech=host[2].numpy(), bio=host[3].numpy())


def combine_var(results: Sequence[GeneVarResult]) -> GeneVarResult:
    """Average variance decompositions across blocks/batches
    (scran::combineVar analog, equal weights)."""
    n = len(results)
    return GeneVarResult(
        mean=sum(r.mean for r in results) / n,
        total=sum(r.total for r in results) / n,
        tech=sum(r.tech for r in results) / n,
        bio=sum(r.bio for r in results) / n,
    )


def get_top_hvgs(
    stats: GeneVarResult,
    n: int = 5000,
    prop: Optional[float] = None,
    var_threshold: float = 0.0,
) -> np.ndarray:
    """Indices of the top highly-variable genes by biological variance
    (scran::getTopHVGs analog): genes with bio > var_threshold, ranked
    descending, top n (or top prop fraction)."""
    bio = np.asarray(stats.bio)
    order = np.argsort(-bio, kind="stable")
    keep = order[bio[order] > var_threshold]
    if prop is not None:
        n = max(int(np.ceil(prop * bio.shape[0])), 1)
    return keep[:n]
