"""Fused fastMNN merge step that never waits for the host.

Counterpart of ``batchelor_tpu/correct/fused.py``. The host-orchestrated
engine in ``fast_mnn.py`` is the reference-parity path: it materializes
pair lists per step for diagnostics. This step keeps everything on the
device: the variable-size MNN pair set is a mask over the dense (N1, k2)
candidate array, segment reductions run over full-size right-cell arrays,
and the pair count, batch-vector magnitude and skip decision stay 0-d
tensors, chosen between with ``torch.where``. After a warm-up call it runs
under ``torch.cuda.set_sync_debug_mode("error")``.

The per-step math is ``ops/merge_math.merge_step_body``, so the step
equals the host engine (reference R/fastMNN.R:436-562), including the
degenerate case of fewer MNN-involved cells than the tricube k, where the
bandwidth's middle index shrinks with the valid neighbour count.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..device import DeviceLike, as_tensor, resolve_device
from ..ops.knn_cuda import default_max_bytes
from ..ops.merge_math import merge_step_body

__all__ = ["fused_merge_step", "FusedMergeOutput"]


class FusedMergeOutput(NamedTuple):
    left: torch.Tensor          # corrected left coordinates
    right: torch.Tensor         # corrected right coordinates
    overall: torch.Tensor       # average batch vector (d,)
    batch_size: torch.Tensor    # 0-d relative batch-effect magnitude
    n_pairs: torch.Tensor       # 0-d number of MNN pairs
    pair_mask: torch.Tensor     # (N1, k2) bool: which candidates are MNN pairs
    pair_targets: torch.Tensor  # (N1, k2) right-cell index per candidate


def fused_merge_step(
    left,
    right,
    k1: int,
    k2: int,
    tricube_k: int = 20,
    ndist: float = 3.0,
    min_batch_skip: float = 0.0,
    knn_method: str = "exact",
    *,
    max_bytes: Optional[int] = None,
    device: DeviceLike = None,
) -> FusedMergeOutput:
    """One fastMNN merge: MNN detection, orthogonalization, tricube apply.

    left: (N1, d) reference set; right: (N2, d) set being corrected; arrays
    or tensors, moved to ``device`` (default: the CUDA device; raises
    without one unless ``device="cpu"``). k1/k2: neighbours searched in
    left/right respectively. ``knn_method`` selects the kNN search
    ("exact" | "chunked" | "bf16" | "approx" | "auto"; see
    ``ops.knn.query_knn``). ``max_bytes`` bounds the two-pass searches'
    buffers; by default it is read from the device once, before the step.
    Every output is a tensor on the device; nothing is read back.
    """
    dev = resolve_device(device)
    left = as_tensor(left, dev)
    right = as_tensor(right, dev)
    if max_bytes is None:
        max_bytes = default_max_bytes(dev)
    ones_l = torch.ones(left.shape[0], device=dev, dtype=torch.bool)
    ones_r = torch.ones(right.shape[0], device=dev, dtype=torch.bool)
    left_c, right_out, overall, magnitude, n_pairs, mutual, l2r = merge_step_body(
        left, right, ones_l, ones_r, ones_l, ones_r,
        k1=k1, k2=k2, tricube_k=tricube_k, ndist=ndist,
        min_batch_skip=min_batch_skip, knn_method=knn_method, with_var=False,
        max_bytes=max_bytes,
    )
    return FusedMergeOutput(
        left=left_c,
        right=right_out,
        overall=overall,
        batch_size=magnitude,
        n_pairs=n_pairs,
        pair_mask=mutual,
        pair_targets=l2r,
    )
