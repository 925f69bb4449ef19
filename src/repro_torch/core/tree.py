"""Nested dicts and lists of tensors (the port's parameter and optimizer
trees): their leaves in a fixed order, and a map over trees of one
structure.  The counterpart of the ``jax.tree`` calls the reference makes."""
from __future__ import annotations


def leaves(tree) -> list:
    """Leaves in a fixed order: dict keys sorted, lists in order (the
    order `jax.tree.leaves` gives a dict)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def map_tree(fn, tree, *rest):
    """``fn`` applied leaf by leaf to trees of one structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(tree, flat: list):
    """A tree of ``tree``'s structure whose leaves are ``flat``, in the
    order of `leaves`."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
