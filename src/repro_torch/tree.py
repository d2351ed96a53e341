"""Nested-container helpers: the port's stand-in for ``jax.tree``.

Parameter and adapter trees are nested dicts (and tuples/lists) of
tensors.  ``None`` is an empty subtree: it maps to ``None``.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping

Tree = Any


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` leafwise over ``tree`` and structurally equal ``rest``."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *[r[k] for r in rest])
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *[r[i] for r in rest])
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list:
    """Every leaf of ``tree`` in traversal order."""
    out: list = []
    tree_map(out.append, tree)
    return out
