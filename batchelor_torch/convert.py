"""Conversion between the JAX package's arrays and the port's tensors.

The system has no weights: its state is the batches, the restrictions and
the merge results. ``from_numpy`` puts arrays as the JAX package takes or
returns them (via ``np.asarray``) on a device as tensors;
``result_to_numpy`` and ``pca_to_numpy`` give the port's results back as
numpy for a side-by-side comparison with the JAX package's results.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .correct.cluster_mnn import ClusterMNNResult
from .correct.fast_mnn import MNNResult
from .correct.linear import LinearCorrectionResult
from .device import DeviceLike, as_tensor, resolve_device
from .ops.pca import MultiBatchPCAResult

__all__ = ["from_numpy", "result_to_numpy", "pca_to_numpy"]


def from_numpy(x, device: DeviceLike = None, dtype=None):
    """An array, or a list/tuple of arrays, as tensor(s) on ``device``
    (default: the CUDA device). ``None`` entries stay ``None``."""
    dev = resolve_device(device)
    if x is None:
        return None
    if isinstance(x, (list, tuple)):
        return type(x)(from_numpy(v, dev, dtype) for v in x)
    return as_tensor(np.asarray(x), dev, dtype)


def _host(t):
    return None if t is None else t.detach().cpu().numpy()


def result_to_numpy(res):
    """A copy of a correction result whose tensors are host numpy arrays:
    ``corrected``, ``rotation`` and ``centers`` of an ``MNNResult``; those
    and the centroid result of a ``ClusterMNNResult``; ``corrected`` and
    ``corrected_pcs`` of a ``LinearCorrectionResult`` (its ``residual_op``
    stays on the device)."""
    if isinstance(res, LinearCorrectionResult):
        return dataclasses.replace(res, corrected=_host(res.corrected),
                                   corrected_pcs=_host(res.corrected_pcs))
    if not isinstance(res, (MNNResult, ClusterMNNResult)):
        raise TypeError(f"no numpy form for {type(res).__name__}")
    out = dataclasses.replace(res, corrected=_host(res.corrected),
                              rotation=_host(res.rotation), centers=_host(res.centers))
    if isinstance(res, ClusterMNNResult):
        out.centroid_result = result_to_numpy(res.centroid_result)
    return out


def pca_to_numpy(res: MultiBatchPCAResult) -> MultiBatchPCAResult:
    """A copy of ``res`` whose components, rotation and centers are host
    numpy arrays."""
    return dataclasses.replace(res, components=[_host(c) for c in res.components],
                               rotation=_host(res.rotation), centers=_host(res.centers))
