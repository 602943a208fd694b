"""Ring-rotated cross-batch kNN and reductions: the ring-attention analog for
cells.

Counterpart of ``batchelor_tpu/parallel/ring.py``. For atlases whose
all-gathered opposing batch (N x d) stops fitting in a device's memory,
each rank keeps only its shard; blocks rotate around the ring of ranks
(one ``batch_isend_irecv`` pair a step, where the JAX package has
``lax.ppermute``) while every rank merges a running top-k of its own query
rows against the visiting block. Peak memory a rank: one shard plus the
(S1, k) running best, independent of the total N.

The visiting orders are the JAX package's: at step t a rank holds the
block of rank (rank + t) % W in ``ring_query_knn_local``,
``ring_membership`` and ``ring_weighted_gather`` (blocks travel to the
previous rank), and ``ring_segment_reduce``'s accumulators travel the
other way, so ties resolve as the JAX ring resolves them. The functions run
on every rank of ``group`` together (``group=None``: a ring of one).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from ..ops.correction import pair_segment_sums
from ..ops.knn import query_knn
from ..ops.merge_math import group_rank, group_size
from ..ops.topk_cuda import select_topk

__all__ = [
    "ring_query_knn_local",
    "ring_membership",
    "ring_segment_reduce",
    "ring_weighted_gather",
]


def ring_shift(x: torch.Tensor, group, to: int) -> torch.Tensor:
    """Send ``x`` to the rank ``to`` places on and return what the rank ``to``
    places back sent (``lax.ppermute`` with perm i -> (i + to) % W). Every
    rank of ``group`` calls it together; booleans travel as bytes."""
    w = group_size(group)
    if w == 1:
        return x
    if x.dtype == torch.bool:
        return ring_shift(x.to(torch.uint8), group, to).bool()
    me = group_rank(group)
    send = x.contiguous()
    out = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dist.get_global_rank(group, (me + to) % w), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (me - to) % w), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def ring_query_knn_local(
    qshard: torch.Tensor,
    dshard: torch.Tensor,
    dvalid: torch.Tensor,
    k: int,
    n_devices: int,
    group=None,
    method: str = "exact",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest rows of the *global* data (split over the ranks as
    ``dshard`` blocks of equal size, ``dvalid`` masking rows) for each of
    this rank's query rows: (global indices (S1, k), distances).

    Blocks arrive in ascending order from this rank's own, and the running
    top-k prefers earlier entries on ties, as ``lax.top_k`` does in the JAX
    ring."""
    s2 = dshard.shape[0]
    my = group_rank(group)
    acc = torch.promote_types(qshard.dtype, torch.float32)
    best_s = torch.full((qshard.shape[0], k), float("-inf"), dtype=acc, device=qshard.device)
    best_i = torch.zeros((qshard.shape[0], k), dtype=torch.long, device=qshard.device)
    block, bvalid = dshard, dvalid
    for t in range(n_devices):
        src = (my + t) % n_devices
        idx, sq = query_knn(qshard, block, min(k, s2), data_mask=bvalid, squared=True,
                            method=method, device=qshard.device)
        all_s = torch.cat([best_s, -sq.to(acc)], 1)
        all_i = torch.cat([best_i, idx + src * s2], 1)
        best_s, pos = select_topk(all_s, k)
        best_i = all_i.gather(1, pos.long())
        if t + 1 < n_devices:
            block = ring_shift(block, group, -1)
            bvalid = ring_shift(bvalid, group, -1)
    return best_i, torch.sqrt(torch.clamp(-best_s, min=0.0))


def ring_membership(
    l2r: torch.Tensor,
    r2l_shard: torch.Tensor,
    my_ids: torch.Tensor,
    s2: int,
    n_devices: int,
    group=None,
) -> torch.Tensor:
    """mutual[i, p] = my_ids[i] in r2l[l2r[i, p]] with r2l split by right
    cells: the MNN membership test (reference src/find_mutual_nns.cpp:7-41)
    without gathering the (N2, k1) neighbour table. Each visiting block
    resolves the l2r entries in its global range, in row chunks that bound
    the (chunk, k2, k1) gather."""
    nsl, k2 = l2r.shape
    k1 = r2l_shard.shape[1]
    my = group_rank(group)
    chunk = max(1, min(nsl, (1 << 22) // max(1, k1 * k2)))
    mut = torch.zeros((nsl, k2), dtype=torch.bool, device=l2r.device)
    block = r2l_shard
    for t in range(n_devices):
        lo = ((my + t) % n_devices) * s2
        for r0 in range(0, nsl, chunk):
            rows = l2r[r0:r0 + chunk].long()
            inr = (rows >= lo) & (rows < lo + s2)
            safe = torch.clamp(rows - lo, 0, s2 - 1)
            hit = (block[safe] == my_ids[r0:r0 + chunk, None, None]).any(-1)
            mut[r0:r0 + chunk] |= hit & inr
        if t + 1 < n_devices:
            block = ring_shift(block, group, -1)
    return mut


def ring_segment_reduce(
    l_rows: torch.Tensor,
    l2r: torch.Tensor,
    mutual: torch.Tensor,
    s2: int,
    n_devices: int,
    group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ring reduce-scatter of per-pair left-row sums into right-cell
    segments: (lsums (S2, d), counts (S2,)) for this rank's right shard,
    summed over every rank.

    The accumulator of shard s starts at rank s, walks the whole ring
    collecting each rank's contribution (``pair_segment_sums`` over the
    window [s * S2, (s + 1) * S2)) and arrives home reduced: memory
    O(S2 x d) a rank, independent of the global cell count."""
    my = group_rank(group)
    lsums = torch.zeros((s2, l_rows.shape[1]), dtype=l_rows.dtype, device=l_rows.device)
    counts = torch.zeros((s2,), dtype=l_rows.dtype, device=l_rows.device)
    for t in range(n_devices):
        lo = ((my - t) % n_devices) * s2       # the shard this accumulator serves
        dl, dc = pair_segment_sums(l_rows, l2r, mutual, s2, lo=lo)
        lsums = ring_shift(lsums + dl, group, 1)
        counts = ring_shift(counts + dc, group, 1)
    return lsums, counts


def ring_weighted_gather(
    idx: torch.Tensor,
    w: torch.Tensor,
    table_shard: torch.Tensor,
    s2: int,
    n_devices: int,
    group=None,
) -> torch.Tensor:
    """sum_p w[:, p] * table[idx[:, p]] with ``table`` split by right cells
    (the tricube apply from a distributed correction table), accumulated by
    visiting block, then by neighbour position."""
    my = group_rank(group)
    out = torch.zeros((idx.shape[0], table_shard.shape[1]), dtype=table_shard.dtype,
                      device=table_shard.device)
    block = table_shard
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    for t in range(n_devices):
        lo = ((my + t) % n_devices) * s2
        for p in range(idx.shape[1]):
            col = idx[:, p]
            inr = (col >= lo) & (col < lo + s2)
            safe = torch.clamp(col - lo, 0, s2 - 1)
            out = out + torch.where(inr, w[:, p], zero)[:, None] * block[safe]
        if t + 1 < n_devices:
            block = ring_shift(block, group, -1)
    return out
