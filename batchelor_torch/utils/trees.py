"""Merge-tree machinery for hierarchical batch merging.

A copy of ``batchelor_tpu/utils/trees.py`` (the reference's MNN_tree layer,
R/MNN_tree.R:1-226) for the port: host-side control flow over nodes whose
``data`` is a torch tensor. Leaves are 0-based batch indices (ints) or batch
names (strs, resolved to ints at construction). Internal nodes are 2-element
lists after binarization.

:func:`walk_merge_tree` is the merge loop of every MNN engine (fastMNN and
reducedMNN, classic mnnCorrect, ``distributed_fast_mnn``): the order of
the merges, auto-merge's pair counts, checkpoint replay and the epilogue.
An engine hands it only its nodes, its merge step and its pair count.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from .batching import reindex_pairings, restore_original_order, take_rows
from .telemetry import trace_span

__all__ = [
    "MergeNode",
    "MergeStepInfo",
    "StepOutcome",
    "binarize_tree",
    "create_tree_predefined",
    "get_next_merge",
    "tree_weights",
    "update_tree",
    "walk_merge_tree",
]


@dataclass
class MergeStepInfo:
    """Diagnostics for one merge step (reference merge.info, R/fastMNN.R:549-561).

    ``pairs`` holds 0-based cell indices into the *output* ordering;
    ``lost_var`` is per input batch (nan for batches not yet merged).
    """

    left: list
    right: list
    pairs: np.ndarray
    batch_size: float
    skipped: bool
    lost_var: np.ndarray


@dataclass
class MergeNode:
    """Payload of a (merged) set of batches during the merge loop.

    Mirrors the MNN_treenode S4 class (reference R/MNN_tree.R:2-6):
      index: batch ids contained in this node (input order of merging),
      data: (ncells, d) coordinate tensor, rows in concatenation order,
      restrict: 0-based indices of cells usable for correction, or None,
      origin: per-row batch id,
      extras: method-specific payloads (fastMNN: replayed batch vectors;
        classic MNN: the gene-space "out" matrix),
      layout: where an engine keeps it (fastMNN), (row labels, row counts)
        on the data's device: each row's position of its batch in
        ``index``, and each batch's rows; None until then.
    """

    index: List[int]
    data: Any
    restrict: Optional[np.ndarray]
    origin: np.ndarray
    extras: list = field(default_factory=list)
    layout: Any = None

    @staticmethod
    def leaf(i: int, data, restrict=None, extras=None) -> "MergeNode":
        n = data.shape[0]
        return MergeNode(
            index=[i],
            data=data,
            restrict=None if restrict is None else np.asarray(restrict),
            origin=np.full(n, i, dtype=np.int64),
            extras=list(extras) if extras is not None else [],
        )


Tree = Union[int, str, list]


def binarize_tree(tree: Tree) -> Tree:
    """Convert an arbitrary merge tree to a strictly binary one.

    Nodes with >2 children become a progressive (left-deep) merge of their
    children; single-child internal nodes are elided. Mirrors .binarize_tree
    (reference R/MNN_tree.R:21-46).
    """
    if not isinstance(tree, (list, tuple)):
        return tree
    tree = list(tree)
    n = len(tree)
    if n == 0:
        raise ValueError("merge tree contains a node with no children")
    if n == 1:
        return binarize_tree(tree[0])
    current = [binarize_tree(tree[0]), binarize_tree(tree[1])]
    for child in tree[2:]:
        current = [current, binarize_tree(child)]
    return current


def _leaves(tree: Tree) -> list:
    if not isinstance(tree, list):
        return [tree]
    return _leaves(tree[0]) + _leaves(tree[1])


def _map_tree(tree: Tree, fn) -> Tree:
    if not isinstance(tree, list):
        return fn(tree)
    return [_map_tree(tree[0], fn), _map_tree(tree[1], fn)]


def _order_tree(nb: int, merge_order=None, names: Optional[Sequence[str]] = None) -> Tree:
    """The binary merge tree of ``merge_order`` with 0-based int leaves
    (the tree of .create_tree_predefined before .fill_tree, reference
    R/MNN_tree.R:48-59)."""
    if merge_order is None:
        merge_order = list(range(nb))

    if not isinstance(merge_order, list) or not any(
        isinstance(x, (list, tuple)) for x in merge_order
    ):
        # Flat sequence -> left-deep progressive merge.
        mo = list(merge_order)
        if len(mo) > 1:
            tree: Tree = [mo[0], mo[1]]
            for nxt in mo[2:]:
                tree = [tree, nxt]
        else:
            tree = mo[0] if mo else 0
    else:
        tree = list(merge_order)

    tree = binarize_tree(tree)

    def resolve(leaf):
        if isinstance(leaf, str):
            if names is None:
                raise ValueError("character leaves require batch names")
            try:
                return list(names).index(leaf)
            except ValueError:
                raise ValueError("invalid leaf nodes specified in 'merge_order'") from None
        return int(leaf)

    tree = _map_tree(tree, resolve)
    if sorted(_leaves(tree)) != list(range(nb)):
        raise ValueError("invalid leaf nodes specified in 'merge_order'")
    return tree


def create_tree_predefined(
    batches: Sequence[Any],
    restrict: Optional[Sequence[Optional[np.ndarray]]],
    merge_order: Optional[Union[Sequence, list]] = None,
    names: Optional[Sequence[str]] = None,
    *,
    leaf_extras=None,
) -> Tree:
    """Build a filled binary merge tree from a user-specified order/tree.

    ``merge_order`` may be None (input order), a flat sequence (progressive
    merge in that order), or a nested list tree. Leaves may be 0-based ints
    or names resolved against ``names``. Mirrors .create_tree_predefined +
    .fill_tree (reference R/MNN_tree.R:48-109).

    ``leaf_extras``: optional callable mapping batch id -> extras list for
    each leaf (classic MNN uses this to stash the "out" matrices,
    reference R/mnnCorrect.R:240-248).
    """

    def fill(leaf_id: int) -> MergeNode:
        res = None if restrict is None else restrict[leaf_id]
        extras = leaf_extras(leaf_id) if leaf_extras is not None else None
        return MergeNode.leaf(leaf_id, batches[leaf_id], res, extras)

    return _map_tree(_order_tree(len(batches), merge_order, names), fill)


def get_next_merge(tree: Tree):
    """Depth-first search for the next pair of leaf nodes to merge.

    Returns (left_node, right_node, path) where path addresses the parent of
    the pair. Mirrors .get_next_merge (reference R/MNN_tree.R:61-69):
    descend into the right child if it is internal, else the left.
    """
    path: list = []
    cur = tree
    while True:
        l_int = isinstance(cur[0], list)
        r_int = isinstance(cur[1], list)
        if not l_int and not r_int:
            return cur[0], cur[1], path
        if r_int:
            path.append(1)
            cur = cur[1]
        else:
            path.append(0)
            cur = cur[0]


def update_tree(tree: Tree, path: Sequence[int], new_node: MergeNode) -> Tree:
    """Replace the subtree at ``path`` with a merged leaf node.

    Mirrors .update_tree (reference R/MNN_tree.R:71-77)."""
    if len(path) == 0:
        return new_node
    tree = list(tree)
    tree[path[0]] = update_tree(tree[path[0]], path[1:], new_node)
    return tree


@dataclass
class StepOutcome:
    """One merge step as an engine's step function hands it back to
    :func:`walk_merge_tree`.

    node: the merged node, the left side's rows then the right side's;
    pairs: (P, 2) MNN pairs, each side's rows counted from its first row;
    lost_var: per input batch;
    batch_size: a float;
    skipped: whether ``min_batch_skip`` left the step uncorrected;
    record: the node as the checkpoint store keeps it, when that is not
      ``node`` itself.

    ``pairs`` and ``batch_size`` may also be tensors, and ``lost_var`` a
    function that makes it: the walk reads them when it ends, after one
    wait for the card, so a step may leave its copies to the host in
    flight (``.to("cpu", non_blocking=True)``).
    """

    node: Any
    pairs: np.ndarray
    lost_var: np.ndarray
    batch_size: Any = np.nan
    skipped: bool = False
    record: Optional[MergeNode] = None


def _land(infos: List[MergeStepInfo], device) -> None:
    """The steps' outcomes as host values: one wait for the card, when some
    step left its copies in flight, then each read."""
    if device is not None and torch.device(device).type == "cuda" and any(
            callable(i.lost_var) or isinstance(i.pairs, torch.Tensor) for i in infos):
        torch.cuda.synchronize(device)
    for info in infos:
        if callable(info.lost_var):
            info.lost_var = info.lost_var()
        info.pairs = np.asarray(info.pairs)
        info.batch_size = float(info.batch_size)
        info.skipped = bool(info.skipped)


def _pick_best_merge(stats: np.ndarray):
    """First maximal entry in column-major order (R which(..., arr.ind) order)."""
    mx = stats.max()
    cols, rows = np.nonzero(stats.T == mx)
    return int(rows[0]), int(cols[0])


def _count_all(nodes: list, count: Callable) -> np.ndarray:
    """MNN pair counts between every two nodes, below the diagonal
    (reference R/MNN_tree.R:160-167)."""
    n = len(nodes)
    stats = np.zeros((n, n), dtype=np.int64)
    for i in range(n):
        for j in range(i):
            stats[i, j] = count(nodes[i], nodes[j])
    return stats


def _recount(stats: np.ndarray, kept: list, new_counts: list) -> np.ndarray:
    """``stats`` of the ``kept`` nodes, with the merged node's counts
    against them as a new last row (reference R/MNN_tree.R:154-226)."""
    n = len(kept) + 1
    out = np.zeros((n, n), dtype=np.int64)
    out[:n - 1, :n - 1] = stats[np.ix_(kept, kept)]
    out[n - 1, :n - 1] = np.asarray(new_counts, dtype=np.int64)
    return out


def walk_merge_tree(
    leaves: Sequence[Any],
    step: Callable,
    *,
    merge_order=None,
    names: Optional[Sequence[str]] = None,
    auto_merge: bool = False,
    count: Optional[Callable] = None,
    checkpointer=None,
    device=None,
    span: Optional[str] = None,
    output: Optional[Callable] = None,
):
    """Merge ``leaves``, one node per input batch, into one, a pair at a
    time (the loop of .fast_mnn_core, reference R/fastMNN.R:436-562, and
    the auto-merge search, R/MNN_tree.R:154-226). Returns (corrected, batch
    labels, merge_info), cells in input batch order.

    The engine supplies the arithmetic:
      step(mdx, left, right) -> StepOutcome, the merge of two nodes;
      count(a, b) -> int, the MNN pairs between two nodes (``auto_merge``);
      output(node) -> the corrected rows of the last node, a tensor or a
        host array (default: its ``data``).
    A node has ``index`` (its batch ids in merged order) and ``origin``
    (the batch id of each row).

    The next merge is the predefined tree's (``merge_order``; name leaves
    resolved against ``names``) or, under ``auto_merge``, the two nodes
    with the most MNN pairs, the first such in column-major order. The
    counts are made when a step first needs them, so a run that replays
    every step counts nothing. ``checkpointer`` (a ``MergeCheckpointer``, or
    an object with its ``completed_steps``, ``load_step`` and ``save_step``)
    replays its stored steps onto ``device``, each checked against the tree,
    and stores every new one. ``span`` names the telemetry span around each
    step, replayed or not, with its ``step`` attribute. ``names`` also
    labels the batches of the result.
    """
    nb = len(leaves)
    assert nb > 1, "a merge needs two batches"
    if auto_merge:
        remainders = list(leaves)
    else:
        tree = _map_tree(_order_tree(nb, merge_order, names), lambda i: leaves[i])
    stats = None
    infos: List[MergeStepInfo] = []

    for mdx in range(nb - 1):
        replay = checkpointer is not None and mdx < checkpointer.completed_steps
        if auto_merge and stats is None and not replay:
            stats = _count_all(remainders, count)
        with trace_span(span, step=mdx) if span else contextlib.nullcontext():
            if replay:
                path, chosen, merged, diag = checkpointer.load_step(mdx, device)
                info = MergeStepInfo(
                    left=diag["left_set"], right=diag["right_set"], pairs=diag["pairs"],
                    batch_size=diag["batch_size"], skipped=diag["skipped"],
                    lost_var=diag["lost_var"])
                if not auto_merge:
                    # the walk must address the same subtree and the same
                    # batch sets as when the step was stored
                    left, right, expect_path = get_next_merge(tree)
                    if (expect_path != path or list(left.index) != list(info.left)
                            or list(right.index) != list(info.right)):
                        raise ValueError("checkpoint does not match this merge tree")
            else:
                if auto_merge:
                    path, chosen = None, _pick_best_merge(stats)
                    left, right = remainders[chosen[0]], remainders[chosen[1]]
                else:
                    (left, right, path), chosen = get_next_merge(tree), None
                out = step(mdx, left, right)
                merged = out.node
                info = MergeStepInfo(
                    left=list(left.index), right=list(right.index), pairs=out.pairs,
                    batch_size=out.batch_size, skipped=out.skipped, lost_var=out.lost_var)

            if auto_merge:
                kept = [t for t in range(len(remainders)) if t not in chosen]
                if replay:
                    stats = diag["stats"]
                else:
                    stats = _recount(stats, kept,
                                     [count(merged, remainders[t]) for t in kept])
                remainders = [remainders[t] for t in kept] + [merged]
            else:
                tree = update_tree(tree, path, merged)

            if not replay and checkpointer is not None:
                _land([info], device)
                checkpointer.save_step(
                    mdx, path, None if chosen is None else list(chosen),
                    merged if out.record is None else out.record,
                    {
                        "pairs": info.pairs,
                        "lost_var": info.lost_var,
                        "left_set": info.left,
                        "right_set": info.right,
                        "batch_size": info.batch_size,
                        "skipped": info.skipped,
                        "stats": stats,
                    },
                )
            out = None      # the step's record, if any, goes with the step
        infos.append(info)

    final = remainders[0] if auto_merge else tree
    data = final.data if output is None else output(final)
    _land(infos, device)
    order, origin = list(final.index), np.asarray(final.origin)

    # Re-index pairs into final concatenated positions (reference
    # R/fastMNN.R:532-538): each node's cells are one block of the final
    # data, which starts at the block of its first batch.
    ncells = np.bincount(origin, minlength=nb)
    block_start = np.zeros(nb, dtype=np.int64)
    block_start[order] = np.cumsum(ncells[order]) - ncells[order]
    for info in infos:
        p = info.pairs.copy()
        p[:, 0] += int(block_start[info.left[0]])
        p[:, 1] += int(block_start[info.right[0]])
        info.pairs = p

    # Restore input batch order (reference R/fastMNN.R:540-547).
    if any(order[i] > order[i + 1] for i in range(len(order) - 1)):
        ordering = restore_original_order(order, ncells)
        data = take_rows(data, ordering)
        origin = origin[ordering]
        for info, p in zip(infos, reindex_pairings([i.pairs for i in infos], ordering)):
            info.pairs = p

    labels = origin
    if names is not None:
        if len(set(names)) != len(names):
            raise ValueError("names of batches should be unique")
        labels = np.asarray(names)[origin]
        for info in infos:
            info.left = [names[i] for i in info.left]
            info.right = [names[i] for i in info.right]
    return data, labels, infos


def tree_weights(tree, n_batches: int, names: Optional[Sequence[str]] = None) -> np.ndarray:
    """Per-batch weights from a tree-like weighting scheme.

    Each split divides its parent's weight equally among children; flat
    multi-child vectors inside the tree also split equally. Mirrors
    .get_list_weights + the tree branch of .construct_weight_vector
    (reference R/multiBatchPCA.R:329-381).
    """
    out = np.zeros(n_batches, dtype=np.float64)
    seen: list = []

    def resolve(leaf):
        if isinstance(leaf, str):
            if names is None:
                raise ValueError("named tree weights require batch names")
            return list(names).index(leaf)
        return int(leaf)

    def recurse(node, weight):
        if isinstance(node, (list, tuple)):
            w = weight / len(node)
            for child in node:
                recurse(child, w)
        else:
            i = resolve(node)
            out[i] = weight
            seen.append(i)

    recurse(tree, 1.0)
    if sorted(seen) != list(range(n_batches)):
        raise ValueError("invalid indices in tree-like 'weights'")
    return out
