"""Trees of tensors: nests of dicts, lists, tuples and NamedTuples.

The order is ``jax.tree_util``'s (dict keys sorted, sequences and
NamedTuple fields in place), so a tree flattens to the reference's leaf
order and its checkpoint keys. ``None`` holds no leaf, as in JAX.
"""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["children", "leaves", "rebuild", "tree_map"]


def _items(tree):
    """``[(key, child)]`` of a container (a dict key or an index), or None
    for a leaf."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def children(tree):
    """``[(key suffix, child)]`` of a container node as ``keystr`` writes
    them (``['name']``, ``.field``, ``[i]``), or None for a leaf."""
    items = _items(tree)
    if items is None:
        return None
    if isinstance(tree, dict):
        return [(f"[{k!r}]", v) for k, v in items]
    if hasattr(tree, "_fields"):
        return [(f".{f}", v) for f, (_, v) in zip(tree._fields, items)]
    return [(f"[{i}]", v) for i, v in items]


def rebuild(like, vals: list):
    """A container of ``like``'s kind holding ``vals`` in ``_items`` order."""
    if isinstance(like, dict):
        return dict(zip(sorted(like), vals))
    if hasattr(like, "_fields"):
        return type(like)(*vals)
    return type(like)(vals)


def leaves(tree, is_leaf: Callable[[Any], bool] | None = None) -> list:
    """The leaves in order (``None`` subtrees hold none)."""
    if tree is None:
        return []
    items = None if (is_leaf is not None and is_leaf(tree)) else _items(tree)
    if items is None:
        return [tree]
    return [x for _, v in items for x in leaves(v, is_leaf)]


def tree_map(fn: Callable, tree, *rest, is_leaf: Callable[[Any], bool] | None = None):
    """``fn(leaf, *matching leaves of rest)`` over ``tree``'s structure.

    A ``None`` in ``tree`` stays ``None``; where a tree of ``rest`` holds
    ``None`` in place of a subtree, ``fn`` receives ``None`` for each of its
    leaves (a parameter autograd gave no gradient).
    """
    if tree is None:
        return None
    items = None if (is_leaf is not None and is_leaf(tree)) else _items(tree)
    if items is None:
        return fn(tree, *rest)
    vals = [
        tree_map(fn, v, *(None if r is None else r[k] for r in rest), is_leaf=is_leaf)
        for k, v in items
    ]
    return rebuild(tree, vals)
