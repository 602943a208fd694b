"""Distributed fastMNN: whole merge trees with cells split over the ranks.

Counterpart of ``batchelor_tpu/parallel/driver.py``. The merge orchestration
is the host engines' walk (``utils/trees.py::walk_merge_tree``); this module
supplies its step, which runs on each rank's row shards with explicit
collectives: the gather mode all-gathers the opposing set for the kNN
searches (``ops/merge_math.merge_step_body``, the same body the fused step
runs), the ring mode rotates blocks so that no array of global length
exists on a rank (``ring.py``). Restriction masks and the replayed batch
vectors are device tensors.

One process per rank (``torch.distributed``): every rank calls
:func:`distributed_fast_mnn` with the same full batches, keeps its own row
shard of each padded node, and returns the same full result, gathered at
the end. The JAX package's TPU workarounds have no counterpart: no split or
phased steps, no compile caches, no memory budgets set as module globals
(the search's buffer bound is an argument, read from the device once).

This is the scale-out path for BASELINE configs 4/5 (1M/10M cells), with
the host engine's features: lost-variance diagnostics (reference
R/fastMNN.R:500-501), auto-merge ordering (R/MNN_tree.R:154-226),
restriction, ``min_batch_skip`` and per-step checkpoints.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..correct.fast_mnn import MNNResult
from ..device import as_tensor
from ..io.checkpoint import MergeCheckpointer
from ..ops.correction import tricube_weights
from ..ops.knn_cuda import default_max_bytes
from ..ops.merge_math import (
    _mutual_mask,
    batch_vector_stats,
    center_along,
    gmaybe,
    merge_step_body,
    perbatch_var,
    pmaybe,
    replay_extras,
)
from ..ops.mutual_nn import choose_k
from ..utils.telemetry import trace_span
from ..utils.trees import MergeNode, StepOutcome, walk_merge_tree
from .mesh import CellsMesh, barrier
from .ring import (
    ring_membership,
    ring_query_knn_local,
    ring_segment_reduce,
    ring_weighted_gather,
)

__all__ = ["distributed_fast_mnn"]

MEMORY_MODES = ("gather", "ring")


def _mutual_mask_ring(lshard, rshard, lvalid, rvalid, lres, rres, k1, k2, knn_method,
                      mesh: CellsMesh):
    """MNN membership mask with constant memory a rank (ring rotation):
    (mutual, l2r of global right rows)."""
    nsl, s2 = lshard.shape[0], rshard.shape[0]
    l2r, _ = ring_query_knn_local(lshard, rshard, rvalid & rres, k2, mesh.size, mesh.group,
                                  method=knn_method)
    r2l, _ = ring_query_knn_local(rshard, lshard, lvalid & lres, k1, mesh.size, mesh.group,
                                  method=knn_method)
    my_ids = mesh.rank * nsl + torch.arange(nsl, device=lshard.device)
    mutual = ring_membership(l2r, r2l, my_ids, s2, mesh.size, mesh.group)
    return mutual & (lres & lvalid)[:, None], l2r


def _step_local_ring(lshard, rshard, lvalid, rvalid, lres, rres, lorigin, rorigin,
                     lextras, rextras, *, k1: int, k2: int, tricube_k: int, ndist: float,
                     min_batch_skip: float, knn_method: str, nb: int, mesh: CellsMesh):
    """Constant-memory merge step: no array of global length exists on a
    rank. The opposing batch rotates around the ring for the kNN searches,
    the membership test walks the split neighbour table, the per-right-cell
    correction table comes from a ring reduce-scatter (so it stays split)
    and the tricube apply gathers from the split table. The same semantics
    as the gather step up to the order of floating-point sums."""
    g, w = mesh.group, mesh.size
    s2 = rshard.shape[0]
    var_old = (perbatch_var(lshard, lorigin, lvalid, nb, g)
               + perbatch_var(rshard, rorigin, rvalid, nb, g))
    if lextras is not None:
        rshard = replay_extras(rshard, rres & rvalid, lextras, g)
    if rextras is not None:
        lshard = replay_extras(lshard, lres & lvalid, rextras, g)
    mutual, l2r = _mutual_mask_ring(lshard, rshard, lvalid, rvalid, lres, rres, k1, k2,
                                    knn_method, mesh)
    n_pairs = pmaybe(mutual.sum(), g)

    def averaged(l_rows, r_rows):
        lsums, counts = ring_segment_reduce(l_rows, l2r, mutual, s2, w, g)
        sums = lsums - r_rows * counts[:, None]
        return sums / torch.clamp(counts, min=1.0)[:, None], counts > 0

    avg, involved = averaged(lshard, rshard)
    # the averaged-correction table stays split: its stats reduce over the ranks
    overall, magnitude = batch_vector_stats(avg, involved, g)
    do_correct = magnitude >= min_batch_skip
    v = overall / torch.sqrt((overall * overall).sum())
    lshard_c, _ = center_along(lshard, lres & lvalid, v, g)
    rshard_c, _ = center_along(rshard, rres & rvalid, v, g)
    lshard_c = torch.where(do_correct, lshard_c, lshard)
    rshard_c = torch.where(do_correct, rshard_c, rshard)
    var_new = (perbatch_var(lshard_c, lorigin, lvalid, nb, g)
               + perbatch_var(rshard_c, rorigin, rvalid, nb, g))
    avg2, _ = averaged(lshard_c, rshard_c)
    idx, dist_ = ring_query_knn_local(rshard_c, rshard_c, involved & rvalid, tricube_k, w, g,
                                      method=knn_method)
    correction = ring_weighted_gather(idx, tricube_weights(dist_, ndist), avg2, s2, w, g)
    right_out = torch.where(do_correct, rshard_c + correction, rshard_c)
    return (lshard_c, right_out, overall, magnitude, n_pairs, mutual, l2r, var_old, var_new)


@dataclass
class _DevBatch:
    """A node's rows on this rank (the padded node split by rank) and its
    bookkeeping, the same on every rank."""

    data: torch.Tensor         # (S, d) this rank's rows
    valid: torch.Tensor        # (S,) padding mask
    res: torch.Tensor          # (S,) restriction mask
    origin_dev: torch.Tensor   # (S,) batch id of each row (pads: 0)
    n: int                     # valid cells of the whole node
    res_host: np.ndarray       # (n,) restriction mask of the whole node
    origin: np.ndarray         # (n,) batch id of each cell
    index: list
    extras: list               # (d,) batch vectors, the same on every rank


def _repad_dev(mesh: CellsMesh, data: torch.Tensor, res_mask, origin, index,
               extras) -> _DevBatch:
    """A node from its whole compact state (valid rows only, the same on
    every rank): padded to a world-size multiple, this rank's rows kept.
    Valid rows are always the leading [0, n) prefix of the padded node."""
    n = data.shape[0]
    s = -(-n // mesh.size)
    lo, hi = mesh.rank * s, (mesh.rank + 1) * s
    part = data[lo:min(hi, n)]
    if part.shape[0] < s:
        part = torch.cat([part, part.new_zeros((s - part.shape[0], data.shape[1]))])
    res_pad = np.zeros(s * mesh.size, dtype=bool)
    res_pad[:n] = np.asarray(res_mask)
    odev = np.zeros(s * mesh.size, dtype=np.int64)
    odev[:n] = origin
    dev = mesh.device
    return _DevBatch(
        data=part.clone(),
        valid=torch.arange(lo, hi, device=dev) < n,
        res=as_tensor(res_pad[lo:hi], dev),
        origin_dev=as_tensor(odev[lo:hi], dev),
        n=n,
        res_host=np.asarray(res_mask, dtype=bool),
        origin=np.asarray(origin),
        index=list(index),
        extras=list(extras),
    )


def _make_dev_batch(mesh: CellsMesh, x, i: int, restrict) -> _DevBatch:
    data = as_tensor(x, mesh.device)
    n = data.shape[0]
    res = np.ones(n, dtype=bool)
    if restrict is not None:
        res[:] = False
        res[np.asarray(restrict)] = True
    return _repad_dev(mesh, data, res, np.full(n, i, dtype=np.int64), [i], [])


def _concat_dev(mesh: CellsMesh, left: _DevBatch, right: _DevBatch, lc, rc, overall,
                skipped: bool):
    """The merged node: each side gathered and cut to its valid prefix,
    concatenated, padded and split again (compacting keeps padding from
    cascading across merges). Returns (node, its whole compact data)."""
    data = torch.cat([gmaybe(lc, mesh.group)[:left.n], gmaybe(rc, mesh.group)[:right.n]])
    extras = list(left.extras) + list(right.extras) + ([] if skipped else [overall])
    node = _repad_dev(mesh, data, np.concatenate([left.res_host, right.res_host]),
                      np.concatenate([left.origin, right.origin]),
                      list(left.index) + list(right.index), extras)
    return node, data


def _extras_table(extras) -> Optional[torch.Tensor]:
    """The replayed batch vectors as an (E, d) table, or None. The JAX
    package pads the table to nb - 1 rows for compile reuse; zero rows
    change nothing, so the port passes the real rows only."""
    return torch.stack(extras) if extras else None


def _collect_pairs(mesh: CellsMesh, mutual, l2r, left_n: int, right_n: int) -> np.ndarray:
    """The MNN pair list of the step, in the order of ``nonzero`` over the
    whole gathered mask (left cell, then distance rank; reference
    src/find_mutual_nns.cpp:30-38): each rank compacts its own block,
    the counts are all-gathered, then the pairs padded to the largest
    count. Every rank enters both gathers, also one that holds no pair.
    Padded row ids are the compact ids, since valid rows are the prefix of
    every padded node; asserted here."""
    nsl = mutual.shape[0]
    rows, cols = torch.nonzero(mutual, as_tuple=True)
    local = torch.stack([rows + mesh.rank * nsl, l2r[rows, cols].long()], 1)
    if mesh.group is None:
        pairs = local.cpu().numpy()
    else:
        counts = gmaybe(torch.tensor([local.shape[0]], device=local.device),
                        mesh.group).cpu().numpy()
        cmax = int(counts.max())
        if cmax == 0:
            return np.empty((0, 2), dtype=np.int64)
        padded = local.new_zeros((cmax, 2))
        padded[:local.shape[0]] = local
        every = gmaybe(padded, mesh.group).cpu().numpy().reshape(mesh.size, cmax, 2)
        pairs = np.concatenate([every[s, :counts[s]] for s in range(mesh.size)])
    pairs = pairs.astype(np.int64)
    if pairs.size:
        assert int(pairs[:, 0].max()) < left_n and int(pairs[:, 1].max()) < right_n, (
            "padded-prefix invariant violated in pair compaction")
    return pairs


def _count_pairs_dev(mesh: CellsMesh, left: _DevBatch, right: _DevBatch, k, prop_k,
                     knn_method, memory, max_bytes) -> int:
    """MNN pair count between two nodes with orthogonalization replay (the
    analog of _count_pairs in correct/fast_mnn.py, reference
    R/MNN_tree.R:160-167)."""
    k1 = choose_k(k, prop_k, left.n)
    k2 = choose_k(k, prop_k, right.n)
    g = mesh.group
    lex, rex = _extras_table(left.extras), _extras_table(right.extras)
    rshard = right.data if lex is None else replay_extras(
        right.data, right.res & right.valid, lex, g)
    lshard = left.data if rex is None else replay_extras(
        left.data, left.res & left.valid, rex, g)
    args = (lshard, rshard, left.valid, right.valid, left.res, right.res, k1, k2, knn_method)
    if memory == "gather":
        mutual = _mutual_mask(*args, max_bytes, g)[0]
    else:
        mutual = _mutual_mask_ring(*args, mesh)[0]
    return int(pmaybe(mutual.sum(), g))


def _node_record(node: _DevBatch, data: torch.Tensor) -> MergeNode:
    """A node as the checkpoint store keeps it: its whole compact data."""
    restrict = None
    if not bool(node.res_host.all()):
        restrict = np.nonzero(node.res_host)[0].astype(np.int64)
    return MergeNode(index=list(node.index), data=data, restrict=restrict,
                     origin=np.asarray(node.origin), extras=list(node.extras))


def _record_to_dev(mesh: CellsMesh, rec: MergeNode) -> _DevBatch:
    n = rec.data.shape[0]
    res_mask = np.ones(n, dtype=bool)
    if rec.restrict is not None:
        res_mask[:] = False
        res_mask[np.asarray(rec.restrict)] = True
    return _repad_dev(mesh, as_tensor(rec.data, mesh.device), res_mask,
                      np.asarray(rec.origin), list(rec.index),
                      [as_tensor(e, mesh.device) for e in rec.extras])


class _RankStore:
    """The checkpoint store as every rank walks it: nodes stored whole as
    the store's ``MergeNode`` and loaded back split over the ranks; rank 0
    writes, and every rank leaves a save with the store written (the other
    ranks' count of completed steps stays below the step, so they make the
    same resume decisions as rank 0)."""

    def __init__(self, mesh: CellsMesh, directory: str):
        self.mesh = mesh
        self.store = MergeCheckpointer(directory)

    @property
    def completed_steps(self) -> int:
        return self.store.completed_steps

    def load_step(self, mdx: int, device):
        tree_path, chosen, rec, diag = self.store.load_step(mdx, device)
        return tree_path, chosen, _record_to_dev(self.mesh, rec), diag

    def save_step(self, mdx: int, tree_path, chosen, record: MergeNode, diag: dict) -> None:
        if self.mesh.rank == 0:
            self.store.save_step(mdx, tree_path, chosen, record, diag)
        barrier(self.mesh)


def distributed_fast_mnn(
    batches: Sequence,
    mesh: CellsMesh,
    *,
    k: int = 20,
    prop_k: Optional[float] = None,
    ndist: float = 3.0,
    merge_order=None,
    auto_merge: bool = False,
    min_batch_skip: float = 0.0,
    restrict: Optional[Sequence[Optional[np.ndarray]]] = None,
    collect_pairs: bool = True,
    knn_method: str = "exact",
    pad_buckets: bool = False,
    memory: str = "gather",
    checkpoint_dir: Optional[str] = None,
    progress: bool = False,
) -> MNNResult:
    """Full fastMNN correction on precomputed coordinates, cells split over
    ``mesh``'s ranks. Every rank calls it with the same ``batches`` (arrays
    or tensors) and returns the same result, its ``corrected`` on the
    mesh's device. The host engine's features (``reduced_mnn``): predefined
    merge orders and trees and ``auto_merge`` (reference
    R/MNN_tree.R:154-226), ``restrict``, ``min_batch_skip``, per-step lost
    variance (R/fastMNN.R:500-501), and checkpoints in ``checkpoint_dir``
    (the store of ``io/checkpoint.py``: rank 0 writes, every rank resumes).

    ``memory``: "gather" all-gathers the opposing batch a step (fastest
    while (N, d) fits a device); "ring" keeps every array of global length
    split and rotates blocks around the ring (constant memory a rank; see
    ``_step_local_ring``). ``pad_buckets`` is accepted for the JAX
    package's signature and changes nothing: it only rounded padded sizes
    up so that XLA could reuse compiled shapes. ``progress`` prints each
    step's seconds on rank 0.
    """
    nb = len(batches)
    if nb < 2:
        raise ValueError("at least two batches must be specified")
    if memory not in MEMORY_MODES:
        raise ValueError(f"unknown memory mode {memory!r}")
    if auto_merge and merge_order is not None:
        raise ValueError("cannot specify both 'merge_order' and 'auto_merge'")
    if restrict is None:
        restrict = [None] * nb
    max_bytes = default_max_bytes(mesh.device)
    # consume the input list: each source is dropped once its shard exists
    batches = list(batches)
    nodes = []
    for i in range(nb):
        b, batches[i] = batches[i], None
        nodes.append(_make_dev_batch(mesh, b, i, restrict[i]))
        del b

    store = None if checkpoint_dir is None else _RankStore(mesh, checkpoint_dir)

    def step(mdx: int, left: _DevBatch, right: _DevBatch) -> StepOutcome:
        k1 = choose_k(k, prop_k, left.n)
        k2 = choose_k(k, prop_k, right.n)
        tric_k = min(choose_k(k, prop_k, right.n), right.n)
        args = (left.data, right.data, left.valid, right.valid, left.res, right.res,
                left.origin_dev, right.origin_dev,
                _extras_table(left.extras), _extras_table(right.extras))
        opts = dict(k1=k1, k2=k2, tricube_k=tric_k, ndist=ndist,
                    min_batch_skip=min_batch_skip, knn_method=knn_method, nb=nb)
        t0 = time.perf_counter()
        with trace_span("driver/step", step=mdx):
            if memory == "gather":
                out = merge_step_body(*args, **opts, with_var=True, max_bytes=max_bytes,
                                      group=mesh.group)
            else:
                out = _step_local_ring(*args, **opts, mesh=mesh)
            lc, rc, overall, mag, _n_pairs, mutual, l2r, var_old, var_new = out
            mag_f = float(mag)
        if progress and mesh.rank == 0:
            print(f"[distributed_fast_mnn] step {mdx}: L={left.n} R={right.n} "
                  f"{time.perf_counter() - t0:.2f}s", flush=True)
        skipped = mag_f < min_batch_skip
        pairs = np.empty((0, 2), dtype=np.int64)
        if collect_pairs:
            with trace_span("driver/pairs", step=mdx):
                pairs = _collect_pairs(mesh, mutual, l2r, left.n, right.n)
        del mutual, l2r
        left.data = right.data = None

        # lost.var per input batch (reference R/fastMNN.R:500-501): batches
        # outside the merged sides keep ratio 1
        vo = var_old.double().cpu().numpy()
        vn = var_new.double().cpu().numpy()
        with np.errstate(invalid="ignore", divide="ignore"):
            ratio = vn / vo
        var_kept = np.ones(nb, dtype=np.float64)
        for b in list(left.index) + list(right.index):
            var_kept[b] = ratio[b]

        merged, merged_data = _concat_dev(mesh, left, right, lc, rc, overall, skipped)
        del lc, rc
        return StepOutcome(
            node=merged, pairs=pairs, lost_var=1.0 - var_kept, batch_size=mag_f,
            skipped=skipped,
            record=None if store is None else _node_record(merged, merged_data))

    corrected, origin, infos = walk_merge_tree(
        nodes, step, merge_order=merge_order, auto_merge=auto_merge,
        count=lambda a, b: _count_pairs_dev(mesh, a, b, k, prop_k, knn_method, memory,
                                           max_bytes),
        checkpointer=store, device=mesh.device,
        output=lambda node: gmaybe(node.data, mesh.group)[:node.n],
    )
    return MNNResult(corrected=corrected, batch=origin, merge_info=infos)
