"""Nests of tensors: the port's counterpart of ``jax.tree`` for parameter
and optimizer-state trees.

A tree is a nest of dicts, lists and tuples whose leaves are tensors (or
other non-container values).  Leaves are visited in JAX's order: dict keys
sorted, sequences in order, ``None`` holding no leaf.  So ``leaves`` lists
what ``jax.tree.leaves`` lists for the same nest, and ``paths`` names each
leaf as ``repro``'s checkpoints do (``layers/0/w``).
"""
from __future__ import annotations

from typing import Any, Callable


def _children(tree):
    """(key, subtree) pairs of a container in JAX's order, else None."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        if hasattr(tree, "_fields"):
            raise TypeError("tree: named tuples are not supported (JAX names their "
                            "leaves by field)")
        return list(enumerate(tree))
    return None


def leaves(tree) -> list:
    """The leaves of ``tree`` in JAX's order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for _, sub in kids for leaf in leaves(sub)]


def paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``[(path, leaf), ...]`` in JAX's order; a path joins the keys with ``/``."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [pl for k, sub in kids
            for pl in paths(sub, f"{prefix}/{k}" if prefix else str(k))]


def tree_map(fn: Callable, tree, *rest):
    """A tree shaped like ``tree`` whose leaves are ``fn(leaf, *others)``.

    The ``rest`` trees are walked along ``tree``'s structure: where ``tree``
    has a leaf, each of them hands over its whole subtree there (so a
    state tree may carry a dict of moments for each parameter).
    """
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(like, leaves):
    """A tree shaped like ``like`` whose leaves are taken, in JAX's order,
    from the iterable ``leaves``."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            filled = {k: build(t[k]) for k in sorted(t)}
            return {k: filled[k] for k in t}
        if _children(t) is not None:
            return type(t)(build(v) for v in t)
        return next(it)

    return build(like)
