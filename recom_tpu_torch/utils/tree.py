"""Trees of dicts, lists and tuples of tensors: the parameter trees, the
prepared arrays and the forward's outputs."""

from __future__ import annotations


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts and lists in ``jax.tree_util``'s order:
    a dict's values by sorted key, a list's or tuple's in order; None has
    no leaves."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_map(fn, tree):
    """``tree`` with ``fn`` applied to each leaf, its dicts and lists kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)
