"""Nested dicts of tensors (parameters, caches, spilled pages, optimizer
state): map and flatten them in the dicts' key order, or in the
reference's sorted-key order (`tree_items`)."""

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


def tree_items(tree, prefix=()):
    """(path, leaf) pairs of ``tree`` in the reference's flatten order
    (``jax.tree_util.tree_flatten_with_path`` sorts dict keys); ``path`` is
    the tuple of keys from the root."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in tree_items(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def tree_from_items(items):
    """The nested dicts that `tree_items` flattened, from (path, leaf) pairs."""
    out = {}
    for path, leaf in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out
