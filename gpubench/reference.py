"""Plain fastMNN, written from batchelor's published algorithm: the
reference that decides ``correct``, and, at a lower precision, its control.

It imports nothing of the program: ``pca`` is the cosine normalisation
and the equal-weight multi-batch PCA (Gram matrix of the centred cells
scaled by 1/sqrt(N_b), eigendecomposed whole); ``merge`` is the merge in
input order, each step with a brute-force kNN (every distance computed,
``torch.topk`` over it), mutual pairs, the averaged correction, the batch
vector removed from both sides and the tricube-smoothed correction of the
right batch (batchelor's R/fastMNN.R, R/utils_tricube.R,
R/multiBatchPCA.R).

``precision``:
  * ``"fp64"``: the reference. Every product and the eigensolver in float64.
  * ``"tf32"``: the control. float32 storage; every matrix product takes
    its operands rounded to TF32 (10 mantissa bits, round to nearest even)
    and accumulates in float32, as the tensor cores' TF32 mode does, and
    the cosine-normalised cells, float32 outside any product, are rounded
    to bfloat16. The rounding is done by hand, so the control reads the
    same on any device.
``selection``: how the MNN searches choose neighbours. ``"exact"`` ranks
all candidates by the distance of ``precision``. ``"fp8"`` is the
two-pass design one precision below bf16: scores from float8 (e4m3)
operands choose, for each query, the k best 32-row sub-chunks by their
maximum, and only the rows of those sub-chunks are ranked exactly.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

__all__ = ["Arith", "pca", "merge", "knn", "tf32_round"]

_BLOCK_ELEMS = 1 << 27          # elements of one (query block x data) score block
_SUB = 32                       # rows of a sub-chunk in the two-pass selection


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10-bit mantissa, to nearest even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0x0FFF + lsb) & -0x2000).view(torch.float32)


class Arith:
    """The products and the eigensolver of one precision.

    ``share``: where several processes compute the same reference, one a
    card, an object with their ``rank``, ``size`` and ``gather(obj)``
    (every rank's ``obj`` in rank order). Each kNN search then takes a
    contiguous share of its query blocks and the ranks gather the rows;
    every block is computed as it is alone, so the result is the same."""

    def __init__(self, precision: str, share=None):
        if precision not in ("fp64", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.dtype = torch.float64 if precision == "fp64" else torch.float32
        self.tf32 = precision == "tf32"
        self.share = share if share is not None and share.size > 1 else None

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype)

    def other(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as the precision keeps values outside a product."""
        return x.to(torch.bfloat16).to(self.dtype) if self.tf32 else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            a, b = tf32_round(a), tf32_round(b)
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return a @ b
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old


def _rows_per_block(n_data: int) -> int:
    return max(1, _BLOCK_ELEMS // max(1, n_data))


def knn(ar: Arith, query: torch.Tensor, data: torch.Tensor, k: int,
        selection: str = "exact"):
    """(indices (nq, k) int64, distances (nq, k)) of each query's k nearest
    data rows, by ascending distance."""
    qn = (query * query).sum(1)
    dn = (data * data).sum(1)
    if selection == "fp8":
        n_sub = -(-data.shape[0] // _SUB)
        pad = n_sub * _SUB - data.shape[0]
        data8 = data.float().to(torch.float8_e4m3fn).float()
        dn_pad = torch.cat([dn.float(), dn.new_full((pad,), float("inf"), dtype=torch.float32)])
        rows_of = torch.arange(n_sub * _SUB, device=data.device).view(n_sub, _SUB)
    elif selection != "exact":
        raise ValueError(f"unknown selection {selection!r}")
    out_i, out_d = [], []
    step = _rows_per_block(data.shape[0])
    if selection == "fp8":
        step = min(step, _rows_per_block(k * _SUB * data.shape[1]))
    starts = range(0, query.shape[0], step)
    if ar.share is not None:
        n, r = len(starts), ar.share.rank
        starts = starts[n * r // ar.share.size:n * (r + 1) // ar.share.size]
    for q0 in starts:
        q = query[q0:q0 + step]
        if selection == "exact":
            sq = qn[q0:q0 + step, None] + dn[None, :] - 2.0 * ar.mm(q, data.T)
            dist, idx = torch.topk(sq, k, dim=1, largest=False, sorted=True)
        else:
            q8 = q.float().to(torch.float8_e4m3fn).float()
            approx = dn_pad[None, :].expand(q.shape[0], -1).clone()
            approx[:, :data.shape[0]] -= 2.0 * (q8 @ data8.T)
            sub_best = approx.view(q.shape[0], n_sub, _SUB).amin(2)
            chosen = torch.topk(sub_best, min(k, n_sub), dim=1, largest=False).indices
            cand = rows_of[chosen].reshape(q.shape[0], -1)
            cand = torch.where(cand < data.shape[0], cand, torch.zeros_like(cand))
            valid = rows_of[chosen].reshape(q.shape[0], -1) < data.shape[0]
            xc = data[cand]                                    # (b, k*32, d)
            dots = ar.mm(xc, q[:, :, None])[:, :, 0]
            sq = qn[q0:q0 + step, None] + dn[cand] - 2.0 * dots
            sq = torch.where(valid, sq, torch.full_like(sq, float("inf")))
            dist, pos = torch.topk(sq, k, dim=1, largest=False, sorted=True)
            idx = cand.gather(1, pos)
        out_i.append(idx)
        out_d.append(torch.sqrt(torch.clamp(dist, min=0.0)))
    if ar.share is None:
        return torch.cat(out_i), torch.cat(out_d)
    mine = [torch.cat(out).cpu() if out else None for out in (out_i, out_d)]
    every = [part for part in ar.share.gather(mine) if part[0] is not None]
    return tuple(torch.cat([part[j] for part in every]).to(query.device) for j in range(2))


def _mutual_pairs(ar, left, right, k, selection):
    """(first, second) host int64 pairs, ordered by left cell then by the
    rank of the right neighbour (batchelor's findMutualNN order)."""
    l2r, _ = knn(ar, left, right, k, selection)
    r2l, _ = knn(ar, right, left, k, selection)
    rows = torch.arange(left.shape[0], device=left.device)
    mutual = torch.zeros(l2r.shape, dtype=torch.bool, device=left.device)
    step = _rows_per_block(8 * k * k)
    for r0 in range(0, left.shape[0], step):
        back = r2l[l2r[r0:r0 + step]]                          # (b, k, k)
        mutual[r0:r0 + step] = (back == rows[r0:r0 + step, None, None]).any(-1)
    i, p = torch.nonzero(mutual, as_tuple=True)
    return i.cpu().numpy(), l2r[i, p].cpu().numpy()


def _average_correction(left, first, right, second):
    """Mean of (left[i] - right[j]) over the pairs of each involved right
    cell j; rows by ascending j."""
    dev = right.device
    f = torch.as_tensor(first, device=dev)
    s = torch.as_tensor(second, device=dev)
    sums = torch.zeros_like(right).index_add_(0, s, left[f] - right[s])
    counts = torch.zeros(right.shape[0], dtype=right.dtype, device=dev)
    counts.index_add_(0, s, torch.ones_like(s, dtype=right.dtype))
    involved = np.unique(second)
    sel = torch.as_tensor(involved, device=dev)
    return sums[sel] / counts[sel, None], involved


def _center_along(ar, mat, vec):
    unit = vec / torch.sqrt((vec * vec).sum())
    loc = ar.mm(mat, unit[:, None])[:, 0]
    return mat + torch.outer(loc.mean() - loc, unit)


def _tricube(ar, right, correction, involved, k, ndist):
    data = right[torch.as_tensor(involved, device=right.device)]
    idx, dist = knn(ar, right, data, min(k, data.shape[0]))
    middle = -(-dist.shape[1] // 2) - 1
    bandwidth = torch.clamp(dist[:, middle] * ndist, min=1e-8)
    rel = torch.clamp(dist / bandwidth[:, None], max=1.0)
    w = (1.0 - rel ** 3) ** 3
    w = w / w.sum(1, keepdim=True)
    smoothed = ar.mm(w[:, None, :], correction[idx])[:, 0, :]
    return right + smoothed


def merge(ar: Arith, pcs: Sequence[torch.Tensor], k: int, ndist: float,
          selection: str = "exact", follow=None, first_pairs=None):
    """The merge in input order. Returns (corrected (N, d), each step's own
    MNN pairs with indices into the output rows).

    ``follow``: one (P, 2) pair array a step, in the same indexing, as the
    merge under judgement made them. Each step then still finds its own
    pairs on its own state, and returns them, but corrects with the
    followed ones, so that its state keeps to the judged merge's: a pair
    that a near-tie decides differently in an early step does not carry
    into every later step, and each step's pairs are judged on their own.

    ``first_pairs``: the first step's own pairs as an earlier merge of the
    same ``pcs`` at the same precision and selection returned them. The
    first step's state is the input in every merge, so its own pairs are
    the same, and they are taken instead of searched for again.
    """
    left = pcs[0]
    extras: List[torch.Tensor] = []
    pairs = []
    for step, right in enumerate(pcs[1:]):
        for vec in extras:
            right = _center_along(ar, right, vec)
        n_left = left.shape[0]
        if step == 0 and first_pairs is not None:
            own = np.asarray(first_pairs, dtype=np.int64)
            first, second = own[:, 0], own[:, 1] - n_left
        else:
            first, second = _mutual_pairs(ar, left, right, k, selection)
        pairs.append(np.stack([first, second + n_left], axis=1))
        if follow is not None:
            given = np.asarray(follow[step], dtype=np.int64)
            first, second = given[:, 0], given[:, 1] - n_left
        if first.size == 0:
            raise ValueError("no MNN pairs to correct with")
        averaged, _ = _average_correction(left, first, right, second)
        overall = averaged.mean(0)
        left = _center_along(ar, left, overall)
        right = _center_along(ar, right, overall)
        re_avg, involved = _average_correction(left, first, right, second)
        right = _tricube(ar, right, re_avg, involved, k, ndist)
        left = torch.cat([left, right], 0)
        extras.append(overall)
    return left, pairs


def pca(ar: Arith, batches: Sequence[torch.Tensor], d: int):
    """Cosine norm, then the equal-weight multi-batch PCA. Returns
    (per-batch PCs, rotation (G, d), centers (G,)). Works through each
    batch in blocks of rows, so the float64 copy never exists whole."""
    genes = batches[0].shape[1]
    step = _rows_per_block(genes)

    def blocks(x):
        for r0 in range(0, x.shape[0], step):
            b = ar.cast(x[r0:r0 + step])
            yield ar.other(b / torch.clamp(torch.sqrt((b * b).sum(1, keepdim=True)), min=1e-8))

    means = []
    for x in batches:
        means.append(sum(b.sum(0) for b in blocks(x)) / x.shape[0])
    centers = sum(means) / len(batches)
    gram = torch.zeros((genes, genes), dtype=ar.dtype, device=batches[0].device)
    for x in batches:
        for b in blocks(x):
            c = b - centers
            gram += ar.mm(c.T, c) / x.shape[0]
    _, vecs = torch.linalg.eigh(gram)
    rotation = vecs.flip(1)[:, :d].contiguous()
    pcs = [torch.cat([ar.mm(b - centers, rotation) for b in blocks(x)]) for x in batches]
    return pcs, rotation, centers
