"""Parameter-tree helpers for nested dicts / lists / tuples of tensors (the
port's params, optimizer states and training states), in the leaf order of
``jax.tree_util``: dict entries by sorted key, list and tuple items in
order, None holding no leaf.  The order matters where leaves meet the
reference: the gradient norm's sum and the checkpoint's ``arr_{i}``."""
from __future__ import annotations


def tree_leaves(tree) -> list:
    """The leaves of ``tree``, in ``jax.tree_util``'s order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_leaves_along(tree, other) -> list:
    """The subtrees of ``other`` at the places of ``tree``'s leaves, in
    :func:`tree_leaves` order (``other`` may hold a whole subtree, a spec
    tuple, where ``tree`` has a leaf)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_leaves_along(tree[k], other[k])]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in tree_leaves_along(v, other[i])]
    return [] if tree is None else [other]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree``; the trees in ``rest`` are walked
    along ``tree``'s structure, so where ``tree`` has a leaf they may hold
    a whole subtree (an optimizer state's ``{"q", "s"}``), which ``fn``
    receives as it is."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return None if tree is None else fn(tree, *rest)


def tree_unflatten(like, leaves: list):
    """``leaves``, in :func:`tree_leaves` order, put into ``like``'s
    structure (the inverse of ``tree_leaves``; dicts come back with their
    keys sorted)."""
    it = iter(leaves)

    def build(tree):
        if isinstance(tree, dict):
            return {k: build(tree[k]) for k in sorted(tree)}
        if isinstance(tree, (list, tuple)):
            return type(tree)(build(v) for v in tree)
        return None if tree is None else next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
