"""Nested dicts and lists of tensors: the port's parameter and state trees.

The port keeps its parameters, gradients and optimizer state as plain
nested dicts and lists (the JAX package's pytrees).  A tree's leaf order
is its own: a dict's entries in sorted key order, a list's or tuple's in
index order, depth first.  The checkpoint's ``leaf_<i>`` numbering and the
optimizer's gradient-norm sum follow it.
"""

from __future__ import annotations


def _items(node):
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    return list(enumerate(node))


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def leaves(tree) -> list:
    """The leaves of ``tree`` in its leaf order."""
    if not _is_node(tree):
        return [tree]
    return [leaf for _, sub in _items(tree) for leaf in leaves(sub)]


def map_tree(fn, tree, *rest):
    """``fn(leaf, *others)`` at every leaf of ``tree``; each tree of
    ``rest`` is indexed by ``tree``'s structure, so its value there may be
    a whole subtree (the optimizer's per-parameter state dicts)."""
    if not _is_node(tree):
        return fn(tree, *rest)
    out = {k: map_tree(fn, sub, *(r[k] for r in rest)) for k, sub in _items(tree)}
    if isinstance(tree, dict):
        return {k: out[k] for k in tree}
    return type(tree)(out[i] for i in range(len(tree)))


def unflatten(like, values: list):
    """A tree of ``like``'s structure holding ``values`` in leaf order."""
    it = iter(values)
    out = map_tree(lambda _: next(it), like)
    if next(it, it) is not it:
        raise ValueError("more values than the tree has leaves")
    return out
