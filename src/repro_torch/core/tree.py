"""Nested dicts of tensors (parameters, caches, spilled pages): map and
flatten them in the dicts' key order."""

from __future__ import annotations

import torch


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of the
    trees in ``rest`` (same keys), as a tree of the results."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree):
    """The leaves of ``tree`` in key order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_stack(trees):
    """Trees of equal keys stacked leaf by leaf along a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)
