"""Merge-tree machinery for hierarchical batch merging.

A copy of ``batchelor_tpu/utils/trees.py`` (the reference's MNN_tree layer,
R/MNN_tree.R:1-226) for the port: host-side control flow over nodes whose
``data`` is a torch tensor. Leaves are 0-based batch indices (ints) or batch
names (strs, resolved to ints at construction). Internal nodes are 2-element
lists after binarization.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Union

import numpy as np

__all__ = [
    "MergeNode",
    "binarize_tree",
    "create_tree_predefined",
    "get_next_merge",
    "tree_weights",
    "update_tree",
]


@dataclass
class MergeNode:
    """Payload of a (merged) set of batches during the merge loop.

    Mirrors the MNN_treenode S4 class (reference R/MNN_tree.R:2-6):
      index: batch ids contained in this node (input order of merging),
      data: (ncells, d) coordinate tensor, rows in concatenation order,
      restrict: 0-based indices of cells usable for correction, or None,
      origin: per-row batch id,
      extras: method-specific payloads (fastMNN: replayed batch vectors;
        classic MNN: the gene-space "out" matrix).
    """

    index: List[int]
    data: Any
    restrict: Optional[np.ndarray]
    origin: np.ndarray
    extras: list = field(default_factory=list)

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
    nb = len(batches)
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
    leaves = _leaves(tree)
    if sorted(leaves) != list(range(nb)):
        raise ValueError("invalid leaf nodes specified in 'merge_order'")

    def fill(leaf_id: int) -> MergeNode:
        res = None if restrict is None else restrict[leaf_id]
        extras = leaf_extras(leaf_id) if leaf_extras is not None else None
        return MergeNode.leaf(leaf_id, batches[leaf_id], res, extras)

    return _map_tree(tree, fill)


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
