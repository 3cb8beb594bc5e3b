"""Nested containers of tensors: the parameter dicts and lists of the
models, and the NamedTuples of the training state (the port's stand-in
for ``jax.tree``).

A tree is a dict, a list, a tuple or NamedTuple, a tensor, or None (an
empty subtree, as the training state's ``ef`` without compression).
Leaves come in a fixed order: dicts in their key order, sequences in
theirs.
"""
from __future__ import annotations

from typing import Callable, Iterator


def leaves(tree) -> Iterator:
    """Every leaf of ``tree`` in order (None is no leaf)."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)
    elif tree is not None:
        yield tree


def is_spec(x) -> bool:
    """A logical or mesh spec: a plain tuple of axis names or None (the
    empty tuple of a scalar included), a leaf of a spec tree."""
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        isinstance(e, (str, type(None))) for e in x)


def map_tree(fn: Callable, tree, *rest, is_leaf: Callable | None = None):
    """``fn`` applied leaf by leaf to ``tree`` and the trees ``rest`` of
    the same structure; returns a tree of that structure.  ``is_leaf``
    marks nodes of ``tree`` taken whole as leaves (``is_spec`` for a tree
    of specs, whose leaves are tuples)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[map_tree(fn, *xs, is_leaf=is_leaf)
                            for xs in zip(tree, *rest)])
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, *xs, is_leaf=is_leaf)
                          for xs in zip(tree, *rest))
    if tree is None:
        return None
    return fn(tree, *rest)
