"""Mutual nearest-neighbour detection between two batches.

Counterpart of ``batchelor_tpu/ops/mutual_nn.py``: the replacement for
BiocNeighbors::findMutualNN, whose algorithm the reference states in
src/find_mutual_nns.cpp:7-41. The membership test is a gather + compare.

Semantics (reference R/MNN_tree.R:113-146):
  * ``k1`` = neighbours searched in the left batch (for each right cell);
  * ``k2`` = neighbours searched in the right batch (for each left cell);
  * pair (i, j) is mutual iff j is one of i's k2 NNs in right AND i is one
    of j's k1 NNs in left;
  * pairs are emitted ordered by left cell, then by the distance rank of
    the right neighbour (the C++ iteration order).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..device import DeviceLike, as_tensor, resolve_device
from ..utils.telemetry import trace_span
from .knn import query_knn

__all__ = ["mutual_nn_masks", "find_mutual_nn", "restricted_mnn", "restricted_mnn_on_device",
           "choose_k", "membership_rows", "MNNPairs"]

# gathered (row, k2, k1) int64 entries per membership block
_MEMBERSHIP_BLOCK = 1 << 22


class MNNPairs(NamedTuple):
    """MNN pair lists (host int64): ``first`` indexes left cells, ``second``
    right cells."""

    first: np.ndarray
    second: np.ndarray


def choose_k(k: int, prop_k: Optional[float], n: int) -> int:
    """Adapt k to the batch size via prop.k (reference R/MNN_tree.R:140-146).

    Uses banker's rounding like R's round()."""
    if prop_k is None:
        return k
    return int(min(n, max(k, round(prop_k * n))))


def membership_rows(l2r: torch.Tensor, r2l: torch.Tensor, row_ids: torch.Tensor,
                    chunk: int = 1 << 16) -> torch.Tensor:
    """mask[i, p] = row_ids[i] in r2l[l2r[i, p]], in row blocks of ``chunk``
    so the (N1, k2, k1) gather never exists at once."""
    n1 = l2r.shape[0]
    out = torch.empty(l2r.shape, device=l2r.device, dtype=torch.bool)
    for r0 in range(0, n1, max(1, chunk)):
        rows = l2r[r0:r0 + chunk].long()
        ids = row_ids[r0:r0 + chunk]
        out[r0:r0 + chunk] = (r2l[rows] == ids[:, None, None]).any(-1)
    return out


def _membership(l2r: torch.Tensor, r2l: torch.Tensor) -> torch.Tensor:
    """mask[i, pos] = i in r2l[l2r[i, pos]]."""
    n1, k2 = l2r.shape
    chunk = max(1, min(n1, _MEMBERSHIP_BLOCK // max(1, k2 * r2l.shape[1])))
    ids = torch.arange(n1, device=l2r.device)
    return membership_rows(l2r, r2l, ids, chunk)


def mutual_nn_masks(left: torch.Tensor, right: torch.Tensor, k1: int, k2: int,
                    method: str = "exact"):
    """MNN detection on the tensors' device.

    Returns (mutual_mask (N1, k2) bool, left_to_right_indices (N1, k2),
    left_to_right_distances)."""
    dev = left.device
    nn_l2r = query_knn(left, right, k2, method=method, device=dev)  # left's k2 NNs in right
    nn_r2l = query_knn(right, left, k1, method=method, device=dev)  # right's k1 NNs in left
    with trace_span("mnn/pairs"):
        mask = _membership(nn_l2r.indices, nn_r2l.indices)
    return mask, nn_l2r.indices, nn_l2r.distances


def _pairs_on_device(ld: torch.Tensor, rd: torch.Tensor, k1: int, k2: int, method: str,
                     read: Callable, left_restrict=None, right_restrict=None):
    """(first, second) MNN pair lists on the tensors' device, in the
    reference's order, with ``second.involved``: the right cells that have a
    pair, ascending (``np.unique(second)``'s order), which
    ``correction.average_correction`` takes instead of reading the pairs.

    The pair count and the count of involved right cells (those with a
    mutual entry in ``l2r``, summed by ``index_add_``) reach the host
    together through ``read``, the one wait; they size the compaction, which
    waits no more. ``nonzero_static`` walks the mask row-major, the
    reference emission order (left cell, then distance rank,
    src/find_mutual_nns.cpp:30-38). A restriction maps the indices back to
    full-batch rows on the card (R/MNN_tree.R:113-138). The membership test
    is one ``mnn/pairs`` span, the counts and the compaction another."""
    mask, l2r, _ = mutual_nn_masks(ld, rd, k1, k2, method=method)
    with trace_span("mnn/pairs"):
        hits = torch.zeros(rd.shape[0], device=mask.device, dtype=torch.int32)
        hits.index_add_(0, l2r.reshape(-1), mask.reshape(-1).to(torch.int32))
        n_pairs, n_involved = read(torch.stack([mask.sum(), (hits > 0).sum()]))
        rows, cols = torch.nonzero_static(mask, size=n_pairs).unbind(1)
        first, second = rows, l2r[rows, cols]
        involved = torch.nonzero_static(hits, size=n_involved)[:, 0]
        if left_restrict is not None:
            first = as_tensor(left_restrict, first.device, torch.long)[first]
        if right_restrict is not None:
            rr = as_tensor(right_restrict, second.device, torch.long)
            second, involved = rr[second], torch.sort(rr[involved]).values
        second.involved = involved
        return first, second


def _to_host(first: torch.Tensor, second: torch.Tensor) -> MNNPairs:
    both = torch.stack([first, second]).cpu().numpy()
    return MNNPairs(first=both[0], second=both[1])


def find_mutual_nn(left, right, k1: int, k2: int, method: str = "exact",
                   device: DeviceLike = None) -> MNNPairs:
    """Materialized MNN pair lists (host numpy), in the reference's order:
    the pairs of :func:`_pairs_on_device` copied to the host."""
    dev = resolve_device(device)
    return _to_host(*_pairs_on_device(as_tensor(left, dev), as_tensor(right, dev), k1, k2,
                                      method, torch.Tensor.tolist))


def restricted_mnn_on_device(
    left_data,
    left_restrict: Optional[np.ndarray],
    right_data,
    right_restrict: Optional[np.ndarray],
    k: int,
    prop_k: Optional[float] = None,
    method: str = "exact",
    device: DeviceLike = None,
    read: Callable = torch.Tensor.tolist,
):
    """:func:`restricted_mnn` with the pairs left on the device: (first,
    second) tensors, ``second.involved`` the involved right cells
    ascending. ``read(t)`` gives the host the two counts of ``t``, the
    call's one wait (the engine's step counts it)."""
    dev = resolve_device(device)
    ld = as_tensor(left_data, dev)
    rd = as_tensor(right_data, dev)
    if left_restrict is not None:
        ld = ld[as_tensor(left_restrict, dev, torch.long)]
    if right_restrict is not None:
        rd = rd[as_tensor(right_restrict, dev, torch.long)]
    k1 = choose_k(k, prop_k, ld.shape[0])
    k2 = choose_k(k, prop_k, rd.shape[0])
    return _pairs_on_device(ld, rd, k1, k2, method, read, left_restrict, right_restrict)


def restricted_mnn(
    left_data,
    left_restrict: Optional[np.ndarray],
    right_data,
    right_restrict: Optional[np.ndarray],
    k: int,
    prop_k: Optional[float] = None,
    method: str = "exact",
    device: DeviceLike = None,
) -> MNNPairs:
    """MNN search on restricted subsets, mapped back to full-batch indices.

    Mirrors .restricted_mnn (reference R/MNN_tree.R:113-138)."""
    return _to_host(*restricted_mnn_on_device(left_data, left_restrict, right_data,
                                              right_restrict, k, prop_k, method, device))
